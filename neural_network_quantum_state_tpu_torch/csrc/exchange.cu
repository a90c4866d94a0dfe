// Kawasaki pair-exchange proposals for the log-cosh machines, float32,
// Hopper: the n_beta = 1 instances (T = false) of the kernel in exchange.cuh,
// which describes it. The tempered instances are exchange_tempered.cu, a
// translation unit of their own, built in parallel with this one.
//
// Replaces the TPU kernel neural_network_quantum_state_tpu/ops/pallas_exchange.py
// ::_exchange_kernel (both of its branches: the RBM family and the FFNN
// family's output weights c).

#include "exchange.cuh"

// n_beta = 1 only (a tempered call goes to exchange_tempered.cu's function
// of the same name): the interface of exchange.cuh NQS_EXCHANGE_PARAMS.
extern "C" int nqs_exchange_f32(NQS_EXCHANGE_PARAMS) {
  ExchangeArgs p;
  const cudaError_t e = exchange_args(&p, NQS_EXCHANGE_ARGS);
  if (e != cudaSuccess || n_beta != 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c != nullptr ? dispatch<true, false>(p, s) : dispatch<false, false>(p, s);
}

// The lanes per walker of nqs_exchange_f32 at H hidden units.
extern "C" int nqs_exchange_lanes(int H) { return lanes_for(H); }

// Whether nqs_exchange_f32 reads W from shared memory at this shape and
// replica count (1) or through L1/L2 (0).
extern "C" int nqs_exchange_stages_w(int N, int H, int B, int has_c, int n_beta) {
  return stages(N, H, B, has_c != 0, n_beta) ? 1 : 0;
}
