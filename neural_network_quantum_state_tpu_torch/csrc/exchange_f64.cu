// Kawasaki pair-exchange proposals for the log-cosh machines, float64,
// Hopper: the n_beta = 1 instances (T = false) of the kernel in
// exchange_f64.cuh, which describes it. The tempered instances are
// exchange_f64_tempered.cu, a translation unit of their own, built in
// parallel with this one.
//
// Replaces, for float64 machines, what the JAX package computes in XLA
// (sampler/kawasaki.py::_exchange_scan; its TPU kernel
// neural_network_quantum_state_tpu/ops/pallas_exchange.py::_exchange_kernel
// is float32 only).

#include "exchange_f64.cuh"

// n_beta = 1 only (a tempered call goes to exchange_f64_tempered.cu's
// function of the same name): the interface of exchange.cuh
// NQS_EXCHANGE_PARAMS in double (every complex array (re, im) double pairs,
// spins and the caller's uniforms doubles; n_unit, the proposals of a sweep,
// the period of renewing the state from y, n_steps where it is below 1),
// then the table of ops/engine.py::exchange_table_f64: e_tab (B, 2, H)
// e^{4 s (w_i - w_k)} of each bond (i, k) for s = s_i = +1 and -1, a_site
// (N,) a_i + sum_j w_ij (c null) or a_i + sum_j c_j Re w_ij.
extern "C" int nqs_exchange_f64(NQS_EXCHANGE_F64_PARAMS) {
  ExchangeArgsF64 p;
  const cudaError_t e = exchange_args_f64(&p, NQS_EXCHANGE_ARGS, e_tab, a_site);
  if (e != cudaSuccess || n_beta != 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c != nullptr ? dispatch_f64<true, false>(p, s) : dispatch_f64<false, false>(p, s);
}

// The lanes per walker of nqs_exchange_f64 at H hidden units.
extern "C" int nqs_exchange_f64_lanes(int H) { return lanes_f64(H); }
