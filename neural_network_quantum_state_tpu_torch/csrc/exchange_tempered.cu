// Kawasaki pair-exchange proposals for the log-cosh machines, float32,
// Hopper: the tempered instances (T = true, 1 < n_beta <= 16: parallel
// tempering with this move class, which the JAX package runs in XLA only,
// sampler/kawasaki.py::tempered_exchange_sweeps) of the kernel in
// exchange.cuh, which describes them. A translation unit of their own, so
// that nvcc builds them in parallel with exchange.cu's n_beta = 1 instances.

#include "exchange.cuh"

// 1 < n_beta <= 16 only (n_beta = 1 goes to exchange.cu's function of the
// same name): the interface of exchange.cuh NQS_EXCHANGE_PARAMS.
extern "C" int nqs_exchange_f32(NQS_EXCHANGE_PARAMS) {
  ExchangeArgs p;
  const cudaError_t e = exchange_args(&p, NQS_EXCHANGE_ARGS);
  if (e != cudaSuccess || n_beta < 2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c != nullptr ? dispatch<true, true>(p, s) : dispatch<false, true>(p, s);
}
