// Kawasaki pair-exchange proposals for the log-cosh machines, float64,
// Hopper: the tempered instances (T = true, 1 < n_beta <= 16) of the kernel
// in exchange_f64.cuh, which describes them. A translation unit of their
// own, so that nvcc builds them in parallel with exchange_f64.cu's
// n_beta = 1 instances.
//
// Replaces, for float64 machines, what the JAX package computes in XLA
// (sampler/kawasaki.py::tempered_exchange_sweeps).

#include "exchange_f64.cuh"

// 1 < n_beta <= 16 only (n_beta = 1 goes to exchange_f64.cu's function of
// the same name): its interface, with u_swap (n_steps / n_unit, 2, K)
// beside the caller's uniforms and swap_out (K,) accepted swaps with each
// row as the lower member.
extern "C" int nqs_exchange_f64(NQS_EXCHANGE_F64_PARAMS) {
  ExchangeArgsF64 p;
  const cudaError_t e = exchange_args_f64(&p, NQS_EXCHANGE_ARGS, e_tab, a_site);
  if (e != cudaSuccess || n_beta < 2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c != nullptr ? dispatch_f64<true, true>(p, s) : dispatch_f64<false, true>(p, s);
}
