// Fused single-flip Metropolis sweeps for the log-cosh machines, float32,
// Hopper, with in-kernel replica exchange (parallel tempering) for n_beta > 1.
//
// Replaces the TPU kernel neural_network_quantum_state_tpu/ops/pallas_sweep.py
// ::_sweep_kernel, both of its branches: the RBM family (c = 1, instances
// C = false) and the FFNN family's complex output weights (has_c, instances
// C = true). Per walker it runs n_steps proposals over the site schedule:
// y' = y - 2 s_i w_i, Re(c_j ln cosh y'_j) summed over the H hidden units,
// accept when u < exp(2 beta min(dln, 0)), masked commit of y, sa and the
// spin. For n_beta > 1 the walkers are replica-minor (row
// w = chain * n_beta + r holds beta_r = (n_beta - r) / n_beta) and each sweep
// of n_sites proposals is followed by the even-pair and then the odd-pair
// swap phase: rows (r, r+1) exchange when u < exp(2 (1/n_beta) min(ln_{r+1} -
// ln_r, 0)). The uniforms come from the caller, (n_steps, K) for the flips
// and (n_sweeps, 2, K) for the swaps, or from the kernel's own Philox4x32-10
// stream on a key (rbm.cuh SweepArgs); the plain PyTorch version
// takes the same numbers (ops/rng.py::philox_uniforms), so both make the same
// decisions on the same draws.
//
// Design (rbm.cuh): one warp per walker, y in registers (R = ceil(H/32)
// words per lane, tail lanes masked), spins in shared memory. The n_beta = 1
// instances (T = false) carry no beta, no swap phases and no block barrier in
// the proposal loop. The tempered instances (T = true) hold a whole number of
// replica groups per block, so a swap never leaves the block: the warps of a
// group post their Re ln psi to shared memory, synchronise, and a warp whose
// row is swapped takes its partner's row, and with it the partner's beta and
// uniforms, while its configuration stays in its registers. At the end each
// warp writes its state to the row it holds. Idle warps past K stay in the
// block's barriers.
//
// Bound on an H100: the 11 float operations per (walker, step, hidden unit)
// that the function needs (24 with c; chip_smoke.py counts them, the same for
// every form of it), against 16 bytes of y per (walker, hidden unit) read and
// written once per call, so the kernel is bound by operations, and in
// practice by the instructions this log-cosh form issues (about 20 float
// operations an element, 23 with c). C = false takes Re ln cosh by the
// one-cos form with ex2/lg2 on the special-function unit and a reduced
// polynomial cos; C = true keeps cos/sin(Im y) per unit and rotates them by
// the energy kernel's table of cos/sin(2 Im w), with the polynomial atan2
// (rbm.cuh sweep_walker). The library expf/sincosf/logf/atan2f took two to
// three times as many instructions per element (PERF.md).

#include "rbm.cuh"

namespace {

using nqs::SweepArgs;

template <int R, bool C, bool T, bool M>
__global__ void __launch_bounds__(32 * nqs::sweep_block_warps(T),
                                  nqs::min_blocks(C ? nqs::kWideRegs : nqs::narrow_regs(R), nqs::sweep_block_warps(T)))
sweep_kernel(SweepArgs p, const float2* __restrict__ c, const float* __restrict__ spins_in,
             const float2* __restrict__ y_in, const float2* __restrict__ sa_in, float* __restrict__ spins_out,
             float2* __restrict__ y_out, float2* __restrict__ sa_out, int* __restrict__ flip_out,
             int* __restrict__ swap_out) {
  extern __shared__ float smem[];
  const int G = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * G;
  const int k = base + warp;
  const bool active = k < p.K;  // uniform over the warp
  float2* s_c = reinterpret_cast<float2*>(smem);
  float* sp = smem + nqs::c_floats<R, C>() + warp * p.N;
  float* s_ln = smem + nqs::c_floats<R, C>() + G * p.N;
  int* s_flip = reinterpret_cast<int*>(s_ln + 2 * G);
  int* s_swap = s_flip + G;
  if (lane == 0) {
    s_flip[warp] = 0;
    s_swap[warp] = 0;
  }
  float yr[R], yi[R];
  float2 sa = make_float2(0.0f, 0.0f);
  if (active) {
    for (int i = lane; i < p.N; i += 32) sp[i] = spins_in[(size_t)k * p.N + i];
    nqs::load_row<R>(y_in + (size_t)k * p.H, p.H, lane, yr, yi);
    sa = sa_in[k];
  }
  if constexpr (C) nqs::load_c<R>(c, p.H, s_c);  // synchronises the block
  else __syncthreads();

  int row = k;
  nqs::sweep_walker<R, C, T, M>(p, s_c, active, base, row, sp, yr, yi, sa, s_ln, s_flip, s_swap);

  if (active) {
    nqs::store_row<R>(y_out + (size_t)row * p.H, p.H, lane, yr, yi);
    for (int i = lane; i < p.N; i += 32) spins_out[(size_t)row * p.N + i] = sp[i];
    if (lane == 0) sa_out[row] = sa;
  }
  __syncthreads();
  if (active && lane == 0) {
    flip_out[k] = s_flip[warp];
    swap_out[k] = s_swap[warp];
  }
}

template <int R, bool C, bool T, bool M>
cudaError_t launch(const SweepArgs& p, const float2* c, const float* spins_in, const float2* y_in,
                   const float2* sa_in, float* spins_out, float2* y_out, float2* sa_out, int* flip_out,
                   int* swap_out, cudaStream_t stream) {
  const int G = nqs::sweep_warps(p.n_beta);
  const dim3 grid((p.K + G - 1) / G);
  const size_t smem = nqs::sweep_smem_bytes<R, C>(G, p.N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sweep_kernel<R, C, T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sweep_kernel<R, C, T, M><<<grid, 32 * G, smem, stream>>>(p, c, spins_in, y_in, sa_in, spins_out, y_out, sa_out,
                                                        flip_out, swap_out);
  return cudaGetLastError();
}

template <bool C, bool T, bool M>
cudaError_t dispatch(const SweepArgs& p, const void* c, const void* spins_in, const void* y_in,
                     const void* sa_in, void* spins_out, void* y_out, void* sa_out, void* flip_out,
                     void* swap_out, void* stream) {
#define NQS_SWEEP_CASE(R)                                                                          \
  case R:                                                                                          \
    return launch<R, C, T, M>(p, static_cast<const float2*>(c), static_cast<const float*>(spins_in), \
                        static_cast<const float2*>(y_in), static_cast<const float2*>(sa_in),       \
                        static_cast<float*>(spins_out), static_cast<float2*>(y_out),               \
                        static_cast<float2*>(sa_out), static_cast<int*>(flip_out),                 \
                        static_cast<int*>(swap_out), static_cast<cudaStream_t>(stream));
  switch ((p.H + 31) / 32) {
    NQS_FOR_EACH_R(NQS_SWEEP_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_SWEEP_CASE
}

}  // namespace

// All complex arrays are interleaved (re, im) float pairs, row-major:
// w (N, H), a (N,), c (H,) or null (c = 1: the RBM family); wt the (N, H, 4)
// floats (Re w, Im w, cos 2 Im w, sin 2 Im w) of energy.cu, read only with c
// (null without); y (K, H),
// sa (K,); spins (K, N); sched (n_sites,); u (n_steps, K) and u_swap
// (n_steps / n_sites, 2, K), read only for n_beta > 1; or u and u_swap null
// and key (2,) int64 words in [0, 2^32): the Philox stream of rbm.cuh
// SweepArgs, row0 >= 0 the first walker's row in its counter (row0 + K <
// 2^31). n_steps is a multiple of n_sites for n_beta > 1, K a multiple of
// n_beta, n_beta <= 16. row0 comes after the stream, so that a build of a
// source without it is called the same way at row0 = 0.
// flip_out (K,): accepted flips while in each row; swap_out (K,): accepted
// swaps with each row as the lower member. 1 <= H <= 512.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int nqs_sweep_f32(const void* w, const void* a, const void* c, const void* wt, const void* spins_in,
                             const void* y_in, const void* sa_in, const void* sched, const void* u,
                             const void* u_swap, const void* key, void* spins_out, void* y_out, void* sa_out,
                             void* flip_out, void* swap_out, int K, int N, int H, int n_sites, int n_steps,
                             int n_beta, void* stream, int row0) {
  if (K <= 0 || N <= 0 || n_sites <= 0 || n_steps <= 0 || H < 1 || H > 32 * nqs::kMaxR ||
      nqs::sweep_warps(n_beta) == 0 || K % n_beta != 0 || row0 < 0 || row0 > INT_MAX - K)
    return cudaErrorInvalidValue;
  if (n_beta > 1 && n_steps % n_sites != 0) return cudaErrorInvalidValue;
  if (u == nullptr ? key == nullptr : n_beta > 1 && u_swap == nullptr) return cudaErrorInvalidValue;
  if (c != nullptr && wt == nullptr) return cudaErrorInvalidValue;
  const SweepArgs p{static_cast<const float2*>(w), static_cast<const float2*>(a), static_cast<const int*>(sched),
                    static_cast<const float*>(u), static_cast<const float*>(u_swap),
                    static_cast<const long long*>(key), static_cast<const float4*>(wt), K, N, H, n_sites, n_steps,
                    n_beta, row0};
#define NQS_SWEEP_ARGS p, c, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out, swap_out, stream
  // with c, a launch of more than one sweep takes the instance that restarts
  // cos/sin(Im y) at each sweep (M, rbm.cuh sweep_walker)
  if (c != nullptr && n_steps > n_sites)
    return n_beta > 1 ? dispatch<true, true, true>(NQS_SWEEP_ARGS) : dispatch<true, false, true>(NQS_SWEEP_ARGS);
  if (c != nullptr)
    return n_beta > 1 ? dispatch<true, true, false>(NQS_SWEEP_ARGS) : dispatch<true, false, false>(NQS_SWEEP_ARGS);
  return n_beta > 1 ? dispatch<false, true, false>(NQS_SWEEP_ARGS) : dispatch<false, false, false>(NQS_SWEEP_ARGS);
#undef NQS_SWEEP_ARGS
}
