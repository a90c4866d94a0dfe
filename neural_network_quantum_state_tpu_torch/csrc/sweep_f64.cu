// Fused single-flip Metropolis sweeps for the log-cosh machines, float64,
// Hopper, with in-kernel replica exchange (parallel tempering) for
// n_beta > 1: the float64 instances of sweep.cu.
//
// Replaces, for float64 machines, what the JAX package computes in XLA
// (sampler/metropolis.py::_sweep_scan and sampler/tempering.py: its TPU
// kernel neural_network_quantum_state_tpu/ops/pallas_sweep.py::_sweep_kernel
// is float32 only). The same computation as sweep.cu in double: per walker,
// n_steps proposals over the site schedule, y' = y - 2 s_i w_i,
// Re(c_j ln cosh y'_j) summed over the H hidden units, accept when
// u < exp(2 beta min(dln, 0)), masked commit of y, sa and the spin; for
// n_beta > 1 (rows replica-minor, beta_r = (n_beta - r) / n_beta) the
// even-pair and then the odd-pair swap phase after each sweep of n_sites
// proposals. The uniforms are the caller's (float64) or the kernel's own
// Philox4x32-10 stream on a key, the float32 numbers of sweep.cu widened to
// double (rbm_f64.cuh Draws), which the plain float64 version takes too, so
// both make the same decisions. Instances: the RBM family (C = false) and
// the FFNN family's output weights c (C = true), each at n_beta = 1
// (T = false) and n_beta <= 16 (T = true).
//
// Design: one warp per walker; lane l takes the hidden units j = l + 32 r.
// A walker's y lives in shared memory as double2 (16 H bytes a warp), not
// in registers, so one instance per (C, T) serves every 1 <= H <= 512; c is
// copied to shared memory once per block, W is read through L1/L2 (a row
// of 16 H bytes per proposal). A proposal sums its candidate's log-cosh
// terms and holds no candidate y: an accepted flip recomputes y - 2 s w
// from the W row with the same arithmetic (2 s w is exact in double). The
// log-cosh is the plain version's stable form with the library's double
// exp, cos and log (and sincos and atan2 with c, rbm_f64.cuh term): sums of
// logs, which no |Re w| can overflow, and the principal branch with c.
// Re ln psi_0 is recomputed here with the same function, so the accept
// ratio never mixes two log-cosh implementations; the wrapper recomputes
// the final ln psi from the cache with the plain log-cosh.
//
// Bound on an H100: the float32 instance's operations per (walker,
// proposal, hidden unit) (20, 23 with c) at the card's float64 rate outside
// the tensor cores (34 TFLOP/s), against 32 bytes of y per (walker, hidden
// unit) read and written once per call: bound by operations. The library's
// double exp, cos and log take several times that count (PERF.md).

#include "rbm_f64.cuh"

namespace {

struct SweepArgsF64 {
  const double2* w;       // (N, H)
  const double2* a;       // (N,)
  const int* sched;       // (n_sites,)
  const double* u;        // (n_steps, K), or null: the Philox stream
  const double* u_swap;   // (n_steps / n_sites, 2, K) with u, for n_beta > 1
  const long long* key;   // (2,) words in [0, 2^32), read when u is null
  int K, N, H, n_sites, n_steps, n_beta;
  int row0;               // the first walker's row in the Philox counter
};

// Shared memory of a block of G warps: c (H, C = true), then per warp its
// walker's y (H) as double2; two buffers of Re ln psi per row (one per swap
// parity); the spins of each warp's walker as floats (+-1); the per-row
// counts of accepted flips and of accepted swaps as the lower member.
template <bool C>
size_t smem_bytes(int G, int N, int H) {
  return sizeof(double2) * ((C ? (size_t)H : 0) + (size_t)G * H) + sizeof(double) * 2 * (size_t)G +
         sizeof(float) * (size_t)G * N + sizeof(int) * 2 * (size_t)G;
}

template <bool C, bool T>
__global__ void __launch_bounds__(32 * nqs::kMaxWarps)
sweep_kernel_f64(SweepArgsF64 p, const double2* __restrict__ c, const double* __restrict__ spins_in,
                 const double2* __restrict__ y_in, const double2* __restrict__ sa_in, double* __restrict__ spins_out,
                 double2* __restrict__ y_out, double2* __restrict__ sa_out, int* __restrict__ flip_out,
                 int* __restrict__ swap_out) {
  extern __shared__ double2 smem2[];
  const int G = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * G;
  const int k = base + warp;
  const bool active = k < p.K;  // uniform over the warp
  const int H = p.H;
  double2* s_c = smem2;
  double2* s_y = smem2 + (C ? H : 0) + (size_t)warp * H;
  double* s_ln = reinterpret_cast<double*>(smem2 + (C ? H : 0) + (size_t)G * H);
  float* sp = reinterpret_cast<float*>(s_ln + 2 * G) + (size_t)warp * p.N;
  int* s_flip = reinterpret_cast<int*>(reinterpret_cast<float*>(s_ln + 2 * G) + (size_t)G * p.N);
  int* s_swap = s_flip + G;
  if (lane == 0) {
    s_flip[warp] = 0;
    s_swap[warp] = 0;
  }
  if constexpr (C) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) s_c[j] = c[j];
  }
  double2 sa = make_double2(0.0, 0.0);
  double l = 0.0;
  if (active) {
    for (int i = lane; i < p.N; i += 32) sp[i] = spins_in[(size_t)k * p.N + i] > 0.0 ? 1.0f : -1.0f;
    for (int j = lane; j < H; j += 32) s_y[j] = y_in[(size_t)k * H + j];
    sa = sa_in[k];
  }
  __syncthreads();  // s_c
  if (active) {
    for (int j = lane; j < H; j += 32) l += nqs::d::term<C>(s_y[j].x, s_y[j].y, s_c, j);
  }
  double ln0 = active ? nqs::d::warp_allsum(l) + sa.x : 0.0;

  int row = k;
  nqs::d::Draws draws(p.u, p.u_swap, p.key, p.K, p.row0);
  // sweeps of n_sites rounds, or for T = false all n_steps rounds in one run
  // over the schedule
  const int rounds = T ? p.n_sites : p.n_steps;
  const int n_sweeps = T ? p.n_steps / rounds : 1;
  for (int s = 0; s < n_sweeps; ++s) {
    if (active) {
      const double scale = T ? 2.0 * nqs::d::row_beta(row, p.n_beta) : 2.0;
      draws.restart();
      int acc = 0;
      int ts = 0;  // t % n_sites: every sweep of T starts a schedule
      for (int t = s * rounds; t < (s + 1) * rounds; ++t) {
        const double u = draws(t, row, lane);
        const int site = __ldg(p.sched + ts);
        ts = ts + 1 == p.n_sites ? 0 : ts + 1;
        const double two_s = 2.0 * static_cast<double>(sp[site]);
        const double2* wrow = p.w + (size_t)site * H;
        double lc = 0.0;
        for (int j = lane; j < H; j += 32) {
          const double2 yv = s_y[j], wv = __ldg(wrow + j);
          lc += nqs::d::term<C>(yv.x - two_s * wv.x, yv.y - two_s * wv.y, s_c, j);
        }
        const double2 av = __ldg(p.a + site);
        const double ln1 = (nqs::d::warp_allsum(lc) + sa.x) - two_s * av.x;
        const bool accept = u < exp(scale * fmin(ln1 - ln0, 0.0));
        if (accept) {
          for (int j = lane; j < H; j += 32) {
            const double2 yv = s_y[j], wv = __ldg(wrow + j);
            s_y[j] = make_double2(yv.x - two_s * wv.x, yv.y - two_s * wv.y);
          }
          sa.x -= two_s * av.x;
          sa.y -= two_s * av.y;
          ln0 = ln1;
          ++acc;
        }
        __syncwarp();
        if (accept && lane == 0) sp[site] = -sp[site];
        __syncwarp();
      }
      if (lane == 0) s_flip[row - base] += acc;
    }
    if constexpr (T) {
      nqs::d::swap_phase(draws, p.n_beta, active, base, s, 0, row, ln0, s_ln, s_swap);
      nqs::d::swap_phase(draws, p.n_beta, active, base, s, 1, row, ln0, s_ln + G, s_swap);
    }
  }

  if (active) {
    for (int j = lane; j < H; j += 32) y_out[(size_t)row * H + j] = s_y[j];
    for (int i = lane; i < p.N; i += 32) spins_out[(size_t)row * p.N + i] = static_cast<double>(sp[i]);
    if (lane == 0) sa_out[row] = sa;
  }
  __syncthreads();
  if (active && lane == 0) {
    flip_out[k] = s_flip[warp];
    swap_out[k] = s_swap[warp];
  }
}

template <bool C, bool T>
cudaError_t launch(const SweepArgsF64& p, const void* c, const void* spins_in, const void* y_in, const void* sa_in,
                   void* spins_out, void* y_out, void* sa_out, void* flip_out, void* swap_out, cudaStream_t stream) {
  const int G = nqs::sweep_warps(p.n_beta);
  const size_t smem = smem_bytes<C>(G, p.N, p.H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sweep_kernel_f64<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.K + G - 1) / G);
  sweep_kernel_f64<C, T><<<grid, 32 * G, smem, stream>>>(
      p, static_cast<const double2*>(c), static_cast<const double*>(spins_in), static_cast<const double2*>(y_in),
      static_cast<const double2*>(sa_in), static_cast<double*>(spins_out), static_cast<double2*>(y_out),
      static_cast<double2*>(sa_out), static_cast<int*>(flip_out), static_cast<int*>(swap_out));
  return cudaGetLastError();
}

}  // namespace

// All complex arrays are interleaved (re, im) double pairs, row-major:
// w (N, H), a (N,), c (H,) or null (c = 1: the RBM family); y (K, H),
// sa (K,); spins (K, N) of +-1 doubles; sched (n_sites,) int32; u
// (n_steps, K) and u_swap (n_steps / n_sites, 2, K) doubles, u_swap read
// only for n_beta > 1; or u and u_swap null and key (2,) int64 words in
// [0, 2^32): the Philox stream of rbm.cuh SweepArgs, row0 >= 0 the first
// walker's row in its counter (row0 + K < 2^31; after the stream, as in
// sweep.cu). n_steps is a multiple of n_sites for n_beta > 1, K a multiple
// of n_beta, n_beta <= 16.
// flip_out (K,): accepted flips while in each row; swap_out (K,): accepted
// swaps with each row as the lower member. 1 <= H <= 512. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int nqs_sweep_f64(const void* w, const void* a, const void* c, const void* spins_in, const void* y_in,
                             const void* sa_in, const void* sched, const void* u, const void* u_swap,
                             const void* key, void* spins_out, void* y_out, void* sa_out, void* flip_out,
                             void* swap_out, int K, int N, int H, int n_sites, int n_steps, int n_beta,
                             void* stream, int row0) {
  if (K <= 0 || N <= 0 || n_sites <= 0 || n_steps <= 0 || H < 1 || H > 32 * nqs::kMaxR ||
      nqs::sweep_warps(n_beta) == 0 || K % n_beta != 0 || row0 < 0 || row0 > INT_MAX - K)
    return cudaErrorInvalidValue;
  if (n_beta > 1 && n_steps % n_sites != 0) return cudaErrorInvalidValue;
  if (u == nullptr ? key == nullptr : n_beta > 1 && u_swap == nullptr) return cudaErrorInvalidValue;
  const SweepArgsF64 p{static_cast<const double2*>(w), static_cast<const double2*>(a), static_cast<const int*>(sched),
                       static_cast<const double*>(u), static_cast<const double*>(u_swap),
                       static_cast<const long long*>(key), K, N, H, n_sites, n_steps, n_beta, row0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NQS_SWEEP_ARGS p, c, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out, swap_out, s
  if (c != nullptr) return n_beta > 1 ? launch<true, true>(NQS_SWEEP_ARGS) : launch<true, false>(NQS_SWEEP_ARGS);
  return n_beta > 1 ? launch<false, true>(NQS_SWEEP_ARGS) : launch<false, false>(NQS_SWEEP_ARGS);
#undef NQS_SWEEP_ARGS
}
