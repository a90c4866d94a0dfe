// Device code shared by the log-cosh kernels (float32, Hopper): the stable
// log-cosh, warp sums, the hidden-unit layout, the Metropolis sweep of one
// walker with its replica-exchange phases, and the off-diagonal local-energy
// sum of one walker. sweep.cu, energy.cu and sweep_energy.cu run the same
// functions, so the fused kernel makes the decisions and sums of the two
// kernels it fuses with the same arithmetic.
//
// ln psi = sum_j c_j ln cosh(y_j) + sa. The RBM family has c = 1: the
// instances with C = false read no c and sum Re ln cosh alone. The FFNN
// family has complex output weights c (C = true): Re(c_j ln cosh y_j) =
// c_re Re ln cosh - c_im Im ln cosh needs both planes, so every hidden unit
// of every proposal takes one atan2f more. Its kernels copy c, zero-padded to
// 32*R values, into shared memory once per block (at most 4 KB) and the lanes
// read it lane-contiguous; kept in registers it would take 2R of them. The
// phase is the principal value atan2f(Im, Re), as the plain version's and the
// JAX package's, so ln psi jumps by 2 pi i c_j where cosh(y_j) crosses the
// negative real axis: there the kernel and the plain version may take
// opposite sides.
//
// Layout: one warp per walker. Lane l keeps hidden units j = r*32 + l,
// r < R = ceil(H/32), in registers. Rows of W and y have stride H; the lanes
// of the last word with j >= H (the tail) load nothing, store nothing and add
// exactly 0 to every hidden sum, so any 1 <= H <= 32*R runs without padding.

#pragma once

#include <cuda_runtime.h>

namespace nqs {

constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxR = 16;  // H <= 512
constexpr int kMaxNBeta = 16;
// The sweep kernels run 8 warps per block, or for n_beta > 1 a whole number
// of replica groups: n_beta * max(1, 8 / n_beta) warps, at most 16.
constexpr int kMaxWarps = 16;

// The second argument of every kernel's __launch_bounds__: enough resident
// blocks of kW warps to cap a thread at 64 registers for R <= 8 and at 128
// above. These kernels are bound by the latency of one proposal's (or one
// site's) transcendental chain, so resident warps matter more than the few
// bytes the cap may spill (measured on the card: PERF.md). For the
// sweep kernels, whose blocks hold up to 16 warps, the same caps hold with
// kW = 16.
constexpr int min_blocks(int R, int kW) { return 65536 / ((R <= 8 ? 64 : 128) * 32 * kW); }

// Re ln cosh(x + iv), the real plane of the stable split formula.
__device__ __forceinline__ float logcosh_re(float x, float v) {
  const float ax = fabsf(x);
  const float e = expf(-2.0f * ax);
  float s, c;
  sincosf(v, &s, &c);
  const float re = (1.0f + e) * c;
  const float im = (1.0f - e) * s;
  return 0.5f * logf(re * re + im * im) + (ax - kLn2);
}

// Both planes of the stable ln cosh(x + iv).
__device__ __forceinline__ void logcosh_ri(float x, float v, float* lr, float* li) {
  const float ax = fabsf(x);
  const float e = expf(-2.0f * ax);
  float s, c;
  sincosf(v, &s, &c);
  const float re = (1.0f + e) * c;
  const float im = (1.0f - e) * s * (x < 0.0f ? -1.0f : 1.0f);
  *lr = 0.5f * logf(re * re + im * im) + (ax - kLn2);
  *li = atan2f(im, re);
}

// Re(c_j ln cosh(x + iv)) of hidden unit j: Re ln cosh for C = false (c is
// not read), both planes rotated by c_j for C = true.
template <bool C>
__device__ __forceinline__ float re_term(float x, float v, const float2* c, int j) {
  if constexpr (C) {
    float lr, li;
    logcosh_ri(x, v, &lr, &li);
    const float2 cj = c[j];
    return cj.x * lr - cj.y * li;
  } else {
    return logcosh_re(x, v);
  }
}

// Copy c (H,) into the block's shared s_c, zero-padded to 32*R values, and
// synchronise the block. Every thread of the block must call this.
template <int R>
__device__ __forceinline__ void load_c(const float2* __restrict__ c, int H, float2* s_c) {
  for (int j = threadIdx.x; j < 32 * R; j += blockDim.x) s_c[j] = j < H ? c[j] : make_float2(0.0f, 0.0f);
  __syncthreads();
}

// Sum over the warp (the value on lane 0 is the one used).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum over the warp, then lane 0's value on every lane (the butterfly sums in
// lane-dependent order; broadcasting one of them keeps decisions uniform).
__device__ __forceinline__ float warp_allsum(float v) { return __shfl_sync(kFull, warp_sum(v), 0); }

// Hidden unit of lane `lane` in word r.
__device__ __forceinline__ int hidden(int r, int lane) { return r * 32 + lane; }

// Whether that unit exists (is below H). Every word but the last is full, so
// once the loops over r are unrolled only the last word tests against H. The
// tail lanes compute on zeros like the others (no branch in the unrolled
// words) and a select adds exactly 0 for them.
template <int R>
__device__ __forceinline__ bool in_row(int r, int lane, int H) { return r < R - 1 || hidden(r, lane) < H; }

// Load a row of H complex values into the lanes' registers; the tail gets 0.
template <int R>
__device__ __forceinline__ void load_row(const float2* row, int H, int lane, float (&re)[R], float (&im)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 v = in_row<R>(r, lane, H) ? row[hidden(r, lane)] : make_float2(0.0f, 0.0f);
    re[r] = v.x;
    im[r] = v.y;
  }
}

template <int R>
__device__ __forceinline__ void store_row(float2* row, int H, int lane, const float (&re)[R], const float (&im)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (in_row<R>(r, lane, H)) row[hidden(r, lane)] = make_float2(re[r], im[r]);
  }
}

// Everything the sweep of a block needs but the walker state. u is
// (n_steps, K); for n_beta > 1, n_steps = n_sweeps * n_sites and u_swap is
// (n_sweeps, 2, K) (even-pair, then odd-pair uniforms of each sweep).
struct SweepArgs {
  const float2* w;  // (N, H)
  const float2* a;  // (N,)
  const int* sched;  // (n_sites,)
  const float* u;
  const float* u_swap;
  int K, N, H, n_sites, n_steps, n_beta;
};

// Shared memory of a sweep block of G warps: for C = true the 32*R output
// weights first (8-byte aligned), then the spins of each warp's walker, two
// buffers of Re ln psi per walker row (one per swap parity), and the per-row
// counts of accepted flips and of accepted swaps as the lower member.
template <int R, bool C>
__host__ __device__ constexpr int c_floats() { return C ? 2 * 32 * R : 0; }

template <int R, bool C>
__host__ __device__ constexpr size_t sweep_smem_bytes(int G, int N) {
  return sizeof(float) * ((size_t)c_floats<R, C>() + (size_t)G * (N + 2)) + sizeof(int) * 2 * (size_t)G;
}

// One replica-exchange phase: pairs of walker rows (r, r+1) with r of this
// parity, r = row % n_beta. A warp keeps its configuration (y stays in its
// registers) and trades its row, and with it its beta, with its partner's.
// Both members of a pair evaluate the same accept test on the same values.
template <int R>
__device__ __forceinline__ void swap_phase(const SweepArgs& p, bool active, int base, int s, int parity,
                                           int& row, float ln0, float* buf, int* s_swap) {
  const int lane = threadIdx.x & 31;
  if (active && lane == 0) buf[row - base] = ln0;
  __syncthreads();  // every warp of the block, idle ones too
  if (!active) return;
  const int r = row % p.n_beta;
  int lower = -1;
  if (((r - parity) & 1) == 0) {
    if (r >= parity && r + 1 < p.n_beta) lower = row;
  } else if (r > parity) {
    lower = row - 1;
  }
  if (lower < 0) return;
  const float dbeta = 1.0f / static_cast<float>(p.n_beta);
  const float dln = buf[lower + 1 - base] - buf[lower - base];
  const float u = __ldg(p.u_swap + ((size_t)s * 2 + parity) * p.K + lower);
  if (u < expf(2.0f * dbeta * fminf(dln, 0.0f))) {
    if (row == lower) {
      if (lane == 0) s_swap[lower - base] += 1;
      row = lower + 1;
    } else {
      row = lower;
    }
  }
}

// The proposal rounds of one walker (and for n_beta > 1 the two swap phases
// after each sweep of n_sites rounds). On entry yr/yi/sa/sp hold the walker in
// row `row`; on return they hold its final state and `row` the row it ends
// in. Flip uniforms are read at the walker's current row, so a label swap
// takes the same draws as a configuration swap. Re ln psi_0 is recomputed
// here with the same log-cosh as the proposals. s_c is the block's copy of c
// (load_c), read only for C = true. Every warp of the block must call this
// (idle ones with active = false): the swap phases synchronise it.
template <int R, bool C>
__device__ __forceinline__ void sweep_walker(const SweepArgs& p, const float2* s_c, bool active, int base, int& row,
                                             float* sp, float (&yr)[R], float (&yi)[R], float2& sa, float* s_ln,
                                             int* s_flip, int* s_swap) {
  const int lane = threadIdx.x & 31;
  const int G = blockDim.x >> 5;
  const bool tempered = p.n_beta > 1;
  const int rounds = tempered ? p.n_sites : p.n_steps;
  const int n_sweeps = p.n_steps / rounds;
  float ln0 = 0.0f;
  if (active) {
    float l = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      l += in_row<R>(r, lane, p.H) ? re_term<C>(yr[r], yi[r], s_c, hidden(r, lane)) : 0.0f;
    ln0 = warp_allsum(l) + sa.x;
  }
  for (int s = 0; s < n_sweeps; ++s) {
    if (active) {
      // beta_r = (n_beta - r) / n_beta of the walker's current row (1 for n_beta = 1)
      const float beta = static_cast<float>(p.n_beta - row % p.n_beta) / static_cast<float>(p.n_beta);
      int acc = 0;
      for (int t = s * rounds; t < (s + 1) * rounds; ++t) {
        const int site = p.sched[t % p.n_sites];
        const float two_s = 2.0f * sp[site];
        const float2* wrow = p.w + (size_t)site * p.H;
        float xr[R], xi[R];
        float l = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool in = in_row<R>(r, lane, p.H);
          const float2 wv = in ? __ldg(wrow + hidden(r, lane)) : make_float2(0.0f, 0.0f);
          xr[r] = yr[r] - two_s * wv.x;
          xi[r] = yi[r] - two_s * wv.y;
          const float lc = re_term<C>(xr[r], xi[r], s_c, hidden(r, lane));
          l += in ? lc : 0.0f;
        }
        const float2 av = __ldg(p.a + site);
        const float ln1 = (warp_allsum(l) + sa.x) - two_s * av.x;
        const float dln = ln1 - ln0;
        const bool accept = __ldg(p.u + (size_t)t * p.K + row) < expf(2.0f * beta * fminf(dln, 0.0f));
        if (accept) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            yr[r] = xr[r];
            yi[r] = xi[r];
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
    if (tempered) {
      swap_phase<R>(p, active, base, s, 0, row, ln0, s_ln, s_swap);
      swap_phase<R>(p, active, base, s, 1, row, ln0, s_ln + G, s_swap);
    }
  }
}

// sum_i exp(ln psi(flip_i s) - ln psi(s)) over the N sites of one walker,
// complex, on lane 0. s points at the walker's N spins (global or shared).
// Both planes of ln cosh(y_j) are computed once; each site's ratio is formed
// difference-first, sum_j c_j [ln cosh(y'_j) - ln cosh(y_j)], so ln psi_0
// comes from the same log-cosh as ln psi_1 and the O(|ln psi|) totals never
// cancel in float32 (sa cancels in the ratio and is not read). For C = true
// both planes of each difference are rotated by c_j (s_c in shared memory).
template <int R, bool C>
__device__ __forceinline__ float2 offdiag_walker(const float2* __restrict__ w, const float2* __restrict__ a,
                                                 const float2* s_c, const float* s, const float (&yr)[R],
                                                 const float (&yi)[R], int N, int H) {
  const int lane = threadIdx.x & 31;
  float l0r[R], l0i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) logcosh_ri(yr[r], yi[r], &l0r[r], &l0i[r]);
  float acc_re = 0.0f, acc_im = 0.0f;
  for (int i = 0; i < N; ++i) {
    const float two_s = 2.0f * s[i];
    const float2* wrow = w + (size_t)i * H;
    float dr = 0.0f, di = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = in_row<R>(r, lane, H);
      const float2 wv = in ? __ldg(wrow + hidden(r, lane)) : make_float2(0.0f, 0.0f);
      float lr, li;
      logcosh_ri(yr[r] - two_s * wv.x, yi[r] - two_s * wv.y, &lr, &li);
      if constexpr (C) {
        const float2 cj = s_c[hidden(r, lane)];
        const float ddr = lr - l0r[r], ddi = li - l0i[r];
        dr += in ? cj.x * ddr - cj.y * ddi : 0.0f;
        di += in ? cj.x * ddi + cj.y * ddr : 0.0f;
      } else {
        dr += in ? lr - l0r[r] : 0.0f;
        di += in ? li - l0i[r] : 0.0f;
      }
    }
    dr = warp_sum(dr);
    di = warp_sum(di);
    if (lane == 0) {
      const float2 av = __ldg(a + i);
      const float mag = expf(dr - two_s * av.x);
      float sn, cs;
      sincosf(di - two_s * av.y, &sn, &cs);
      acc_re += mag * cs;
      acc_im += mag * sn;
    }
  }
  return make_float2(acc_re, acc_im);
}

// Warps per sweep block for a replica count (0 if n_beta is not taken).
__host__ __forceinline__ int sweep_warps(int n_beta) {
  if (n_beta < 1 || n_beta > kMaxNBeta) return 0;
  return n_beta == 1 ? 8 : n_beta * (n_beta >= 8 ? 1 : 8 / n_beta);
}

}  // namespace nqs

// Expand CASE(R) for every R = 1..16 (H = 1..512), inside a switch on R;
// CASE may use the bool C of the enclosing function.
#define NQS_FOR_EACH_R(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) \
  CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
