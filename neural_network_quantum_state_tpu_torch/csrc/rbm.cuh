// Device code shared by the log-cosh kernels (float32, Hopper): the
// log-cosh arithmetic, warp sums, the hidden-unit layout, the Philox4x32-10
// draws, the replica-exchange pairs and swap uniforms, the Metropolis sweep
// of one walker with its replica-exchange phases, and the off-diagonal
// local-energy sum of one walker. sweep.cu, energy.cu and
// sweep_energy.cu run the same functions, so the fused kernel makes the
// decisions and sums of the two kernels it fuses with the same arithmetic;
// exchange.cu runs the arithmetic and the Philox generator with a layout of
// its own (several walkers per warp).
//
// ln psi = sum_j c_j ln cosh(y_j) + sa. The RBM family has c = 1: the
// instances with C = false read no c and sum Re ln cosh alone. The FFNN
// family has complex output weights c (C = true): Re(c_j ln cosh y_j) =
// c_re Re ln cosh - c_im Im ln cosh needs both planes. Its kernels copy c,
// zero-padded to 32*R values, into shared memory once per block (at most 4 KB)
// and the lanes read it lane-contiguous; kept in registers it would take 2R of
// them. The phase is the principal value of atan2(Im, Re), as the plain
// version's and the JAX package's, so ln psi jumps by 2 pi i c_j where
// cosh(y_j) crosses the negative real axis: there the kernel and the plain
// version may take opposite sides.
//
// The log-cosh arithmetic is the fast form throughout: exp and log on the
// special-function unit (ex2/lg2.approx, about 2 ulp), cos and sin as
// minimax polynomials after a Cody-Waite reduction, and a range-reduced
// minimax atan2 (about 3e-7 rad). Re ln cosh alone takes one cos and no sin
// (logcosh_re_fast: the sweep's and the exchange kernel's instances without
// c); the energy's candidates and the sweep's instances with c take cos/sin
// of their phase by angle addition from the walker's cos/sin(Im y) and a
// per-call (N, H) table of cos/sin(2 Im w), so their site loops have no trig;
// the exchange kernel's instances with c turn theirs the same way from a
// table in shared memory, or take both by sincos_fast where W is not staged.
//
// Layout (sweep, energy, megakernel): one warp per walker. Lane l keeps hidden units j = r*32 + l,
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
// The sweep kernels run kWarps = 8 warps per block at n_beta = 1, or for
// n_beta > 1 a whole number of replica groups: n_beta * max(1, 8 / n_beta)
// warps, at most kMaxWarps = 16.
constexpr int kWarps = 8;
constexpr int kMaxWarps = 16;
// The warps per block a sweep instance is built for (T: n_beta > 1).
constexpr int sweep_block_warps(bool T) { return T ? kMaxWarps : kWarps; }

// The second argument of every kernel's __launch_bounds__: the resident
// blocks of kW warps that cap a thread at `regs` registers (65536 per SM).
constexpr int min_blocks(int regs, int kW) { return 65536 / (regs * 32 * kW); }
// The caps, measured on the card at K = 8192 one-warp walkers (PERF.md
// §6): the sweep's RBM instances take 64 registers for R <= 8 (32 warps per SM, 1.94 waves) and 128 above; the sweep's
// instances with c, the energy kernel and the megakernel take 128 at every R
// (16 warps per SM, 3.88 waves): their per-unit chains are long enough that
// the spills of a 64 cap cost more than the residency it buys. An 85 cap
// (24 warps per SM, 2.59 waves) lost for all of them.
constexpr int kWideRegs = 128;
constexpr int narrow_regs(int R) { return R <= 8 ? 64 : kWideRegs; }

// ---- The fast log-cosh arithmetic ----

constexpr float kPi = 3.14159265358979f;
constexpr float kHalfPi = 1.57079632679490f;
constexpr float kHalfLn2 = 0.34657359027997264f;
constexpr float kM2Log2e = -2.8853900817779268f;  // -2 log2(e)
// Cody-Waite split of pi: the high part has 24 bits, so k * hi is exact and
// v - k * hi loses nothing for the |v| < 2^9 of these kernels.
constexpr float kPiHi = 3.14159274101257324f, kPiLo = -8.74227766e-8f;

// 2^x and log2(x) on the special-function unit (MUFU.EX2, MUFU.LG2): about
// 2 ulp; subnormal results and arguments flush to zero.
__device__ __forceinline__ float ex2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_fast(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// 1/x on the special-function unit (MUFU.RCP, 1 ulp), without the
// subnormal rescaling that __fdividef takes when built without -ftz.
__device__ __forceinline__ float rcp_fast(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// v = k pi + r with |r| <= pi/2 (Cody-Waite); returns r and k.
__device__ __forceinline__ float reduce_halfturns(float v, float* k) {
  *k = rintf(v * (1.0f / kPi));
  return fmaf(-*k, kPiLo, fmaf(-*k, kPiHi, v));
}

// cos r on |r| <= pi/2: an even minimax polynomial of degree 10 (max error
// 9e-8).
__device__ __forceinline__ float cos_poly(float r) {
  const float u = r * r;
  float c = fmaf(u, -2.60516970e-07f, 2.47601747e-05f);
  c = fmaf(c, u, -1.38883619e-03f);
  c = fmaf(c, u, 4.16666381e-02f);
  c = fmaf(c, u, -0.5f);
  return fmaf(c, u, 1.0f);
}

// cos v up to its sign (-1)^k, which is left out, as only cos^2 v is used.
__device__ __forceinline__ float cos_halfturns(float v) {
  float k;
  return cos_poly(reduce_halfturns(v, &k));
}

// sin v and cos v: the reduction of cos_halfturns, cos_poly, and an odd
// minimax polynomial of degree 9 for sin r (max error 1.5e-7 in float32),
// both signed by (-1)^k.
__device__ __forceinline__ void sincos_fast(float v, float* s, float* c) {
  float k;
  const float r = reduce_halfturns(v, &k);
  const float u = r * r;
  float p = fmaf(u, 2.59048829e-06f, -1.98008973e-04f);
  p = fmaf(p, u, 8.33289977e-03f);
  p = fmaf(p, u, -1.66666478e-01f);
  const float sr = fmaf(p * u, r, r);
  const float sg = (static_cast<int>(k) & 1) ? -1.0f : 1.0f;
  *s = sg * sr;
  *c = sg * cos_poly(r);
}

// atan2(y, x), principal value: atan of min/max in [0, 1] as z P(z^2) with a
// minimax P of degree 8 (max error 1e-7), then the reflections; the quotient
// is MUFU.RCP and one product, about 3e-7 rad in all. The floor of the
// denominator gives atan2(0, 0) = 0 (or pi), not a NaN.
__device__ __forceinline__ float atan2_fast(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float z = fminf(ax, ay) * rcp_fast(fmaxf(fmaxf(ax, ay), 1e-30f));
  const float u = z * z;
  float p = fmaf(u, 2.90402654e-03f, -1.62850283e-02f);
  p = fmaf(p, u, 4.30429094e-02f);
  p = fmaf(p, u, -7.53400549e-02f);
  p = fmaf(p, u, 1.06548510e-01f);
  p = fmaf(p, u, -1.42071858e-01f);
  p = fmaf(p, u, 1.99930623e-01f);
  p = fmaf(p, u, -3.33330959e-01f);
  p = fmaf(p, u, 1.0f);
  float t = z * p;
  t = ay > ax ? kHalfPi - t : t;
  t = x < 0.0f ? kPi - t : t;
  return copysignf(t, y);
}

// Re ln cosh(x + iv) from one cos and no sin: with e = exp(-2|x|),
// 4 e^{-2|x|} |cosh(x + iv)|^2 = 1 + e^2 + 2 e cos 2v (the TPU sweep kernel's
// identity) = (1 - e)^2 + 4 e cos^2 v, a sum of two terms >= 0 that does not
// cancel near the zeros of cosh as the first form does; Re = 0.5 ln of it +
// |x| - ln 2 (-inf at an exact zero of cosh, as in the plain version; never
// a NaN).
__device__ __forceinline__ float logcosh_re_fast(float x, float v) {
  const float ax = fabsf(x);
  const float e = ex2_fast(ax * kM2Log2e);
  const float c = cos_halfturns(v);
  const float ome = 1.0f - e;
  return fmaf(kHalfLn2, lg2_fast(fmaf(4.0f * e * c, c, ome * ome)), ax - kLn2);
}

// Both planes of ln cosh(x + iv) from cos v and sin v: the stable split
// planes re = (1 + e) cos v, im = (1 - e) sin v sgn x, Re = 0.5 ln(re^2 +
// im^2) + |x| - ln 2 (no cancellation near the zeros of cosh), Im = atan2.
// The floor keeps Re finite at an exact zero of cosh, so that c_j Re never
// makes a NaN (which would pass the sweep's accept test, whose fminf drops
// it).
__device__ __forceinline__ void logcosh_ri_cs(float x, float cv, float sv, float* lr, float* li) {
  const float ax = fabsf(x);
  const float e = ex2_fast(ax * kM2Log2e);
  const float re = (1.0f + e) * cv;
  const float im = (1.0f - e) * sv;
  *lr = fmaf(kHalfLn2, lg2_fast(fmaxf(fmaf(re, re, im * im), 1e-30f)), ax - kLn2);
  const float t = atan2_fast(im, re);
  *li = x < 0.0f ? -t : t;  // atan2(-b, a) = -atan2(b, a)
}

// Re(c_j ln cosh(x + iv)) of hidden unit j from cos v and sin v: both
// planes, rotated by c_j (s_c in shared memory).
__device__ __forceinline__ float re_c_term(float x, float cv, float sv, const float2* c, int j) {
  float lr, li;
  logcosh_ri_cs(x, cv, sv, &lr, &li);
  const float2 cj = c[j];
  return cj.x * lr - cj.y * li;
}

// (cos, sin) of v - 2 s w by angle addition from (cos v, sin v) and the
// table's (cos 2w, sin 2w); s_sin = s sin 2w for the site's spin s = +-1.
__device__ __forceinline__ float2 rotate(float cv, float sv, float cos2w, float s_sin) {
  return make_float2(fmaf(cv, cos2w, sv * s_sin), fmaf(sv, cos2w, -(cv * s_sin)));
}

// Philox4x32-10 (Salmon et al., SC'11, with the Random123 constants).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// A uniform in [0, 1) from 32 bits: the top 24, as the TPU kernel makes it.
__device__ __forceinline__ float bits_uniform(unsigned b) {
  return __uint2float_rn(b >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---- The replica-exchange phases (sweep.cu, and exchange.cu's tempered
// instance) ----

// Counter word 3 of the swap uniforms' Philox stream (ops/rng.py SWAP_STREAM).
constexpr unsigned kSwapStream = 1;

// The lower row of the pair that walker row `row` belongs to in the swap
// phase of this parity (pairs of rows (r, r+1) with r of this parity, r =
// row % n_beta); -1 where the row sits the phase out.
__device__ __forceinline__ int swap_lower(int row, int n_beta, int parity) {
  const int r = row % n_beta;
  if (((r - parity) & 1) == 0) return r >= parity && r + 1 < n_beta ? row : -1;
  return r > parity ? row - 1 : -1;
}

// The swap uniform of sweep s, parity `parity` and lower row `lower` on the
// Philox stream: word (2s + parity) % 4 of philox(counter ((2s + parity) / 4,
// lower, 0, kSwapStream), key), as ops/rng.py philox_uniforms makes it.
__device__ __forceinline__ float swap_uniform(uint2 key, int s, int parity, int lower) {
  const int tt = 2 * s + parity;
  const uint4 b = philox4x32_10(make_uint4(static_cast<unsigned>(tt >> 2), static_cast<unsigned>(lower), 0u, kSwapStream),
                                key);
  return bits_uniform(word(b, tt & 3));
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

// Everything the sweep of a block needs but the walker state. The
// uniforms come from the caller (u non-null: (n_steps, K) flip uniforms and,
// for n_beta > 1, (n_sweeps, 2, K) swap uniforms, the even-pair then the
// odd-pair ones of each sweep) or from Philox4x32-10 on the chip (u null):
// the flip uniform of round t and walker row k is word t % 4 of
// philox(counter (t / 4, k, 0, 0), key); the swap uniform of sweep s, parity
// p and lower row k is word (2s + p) % 4 of philox(counter ((2s + p) / 4, k,
// 0, 1), key). Every call takes a fresh key. ops/rng.py::philox_uniforms
// makes the same numbers in PyTorch.
struct SweepArgs {
  const float2* w;  // (N, H)
  const float2* a;  // (N,)
  const int* sched;  // (n_sites,)
  const float* u;
  const float* u_swap;
  const long long* key;  // (2,) words in [0, 2^32), read when u is null
  const float4* wt;  // (N, H) table of energy.cu, read by the instances with c
  int K, N, H, n_sites, n_steps, n_beta;
};

// The flip uniforms of one walker. In the Philox mode lane l holds the four
// words of counter block base + l, so one evaluation on the 32 lanes covers
// 128 rounds, and round t's word is read from lane (t / 4) % 32 with one
// shuffle. Every lane makes the same call, so the uniform is warp-uniform.
struct FlipDraws {
  uint2 key;
  uint4 bits;
  int base;  // first counter block of `bits`, -1 before the first evaluation

  __device__ __forceinline__ explicit FlipDraws(const SweepArgs& p) : bits(make_uint4(0u, 0u, 0u, 0u)), base(-1) {
    key = p.u ? make_uint2(0u, 0u) : make_uint2(static_cast<unsigned>(p.key[0]), static_cast<unsigned>(p.key[1]));
  }
  // The rows of a tempered block change between sweeps: start anew.
  __device__ __forceinline__ void restart() { base = -1; }

  __device__ __forceinline__ float operator()(const SweepArgs& p, int t, int row, int lane) {
    if (p.u) return __ldg(p.u + (size_t)t * p.K + row);
    const int blk = t >> 2;
    if ((blk & ~31) != base) {
      base = blk & ~31;
      const uint4 ctr = make_uint4(static_cast<unsigned>(base + lane), static_cast<unsigned>(row), 0u, 0u);
      bits = philox4x32_10(ctr, key);
    }
    return bits_uniform(__shfl_sync(kFull, word(bits, t & 3), blk & 31));
  }

  // The swap uniform of sweep s, parity `parity`, lower row `lower`.
  __device__ __forceinline__ float swap(const SweepArgs& p, int s, int parity, int lower) const {
    if (p.u) return __ldg(p.u_swap + (size_t)(2 * s + parity) * p.K + lower);
    return swap_uniform(key, s, parity, lower);
  }
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
__device__ __forceinline__ void swap_phase(const SweepArgs& p, const FlipDraws& draws, bool active, int base, int s,
                                           int parity, int& row, float ln0, float* buf, int* s_swap) {
  const int lane = threadIdx.x & 31;
  if (active && lane == 0) buf[row - base] = ln0;
  __syncthreads();  // every warp of the block, idle ones too
  if (!active) return;
  const int lower = swap_lower(row, p.n_beta, parity);
  if (lower < 0) return;
  const float dbeta = 1.0f / static_cast<float>(p.n_beta);
  const float dln = buf[lower + 1 - base] - buf[lower - base];
  const float u = draws.swap(p, s, parity, lower);
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
// in. Flip uniforms are drawn at the walker's current row, so a label swap
// takes the same draws as a configuration swap. Re ln psi_0 is recomputed
// here with the same log-cosh as the proposals. A proposal sums its
// candidate's log-cosh terms on the fly and holds no candidate y: an accepted
// flip recomputes y - 2 s w from the W row (an L1 hit) with the same fused
// multiply-adds.
//
// C = false (the RBM family) takes Re ln cosh of the candidate by the
// one-cos form (logcosh_re_fast). C = true needs both planes of every unit:
// the walker keeps cos/sin(Im y) (library sincosf once per call), a candidate
// takes its (cos, sin) by angle addition from the table's cos/sin(2 Im w)
// (the energy kernel's, p.wt), and an accepted flip rotates the kept pair,
// so no proposal evaluates a trig function (the half-angle form of the TPU
// kernel's recur_cos). The rotations round by about 1e-7 each, so their
// drift grows as the square root of the flips accepted; s_c is the block's
// copy of c (load_c). M = true, for a launch of more than one sweep with c,
// restarts them from Im y at every sweep (each n_sites rounds), so such a
// launch drifts no further than one sweep; M = false carries no restart, so
// the one-sweep launch of every SR step keeps the registers it had before.
// T = false is the n_beta = 1 instance (no beta, no swap phases, the walker's
// row fixed); T = true takes any n_beta <= 16, and then every warp of the
// block must call this (idle ones with active = false): the swap phases
// synchronise it.
template <int R, bool C, bool T, bool M = false>
__device__ __forceinline__ void sweep_walker(const SweepArgs& p, const float2* s_c, bool active, int base, int& row,
                                             float* sp, float (&yr)[R], float (&yi)[R], float2& sa, float* s_ln,
                                             int* s_flip, int* s_swap) {
  static_assert(C || !M, "M restarts the instances with c");
  const int lane = threadIdx.x & 31;
  // sweeps of n_sites rounds (for M the last may be partial), or for T = M =
  // false all n_steps rounds in one run over the schedule, repeated
  const int rounds = (T || M) ? p.n_sites : p.n_steps;
  const int n_sweeps = (T || M) ? (p.n_steps + rounds - 1) / rounds : 1;
  FlipDraws draws(p);
  [[maybe_unused]] float cy[C ? R : 1], sy[C ? R : 1];  // C = true: cos/sin(Im y)
  float ln0 = 0.0f;
  if (active) {
    float l = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float lc;
      if constexpr (C) {
        sincosf(yi[r], &sy[r], &cy[r]);
        lc = re_c_term(yr[r], cy[r], sy[r], s_c, hidden(r, lane));
      } else {
        lc = logcosh_re_fast(yr[r], yi[r]);
      }
      l += in_row<R>(r, lane, p.H) ? lc : 0.0f;
    }
    ln0 = warp_allsum(l) + sa.x;
  }
  for (int s = 0; s < n_sweeps; ++s) {
    if (active) {
      if constexpr (M) {
        if (s > 0) {  // a new sweep: cos/sin(Im y) afresh
#pragma unroll
          for (int r = 0; r < R; ++r) sincosf(yi[r], &sy[r], &cy[r]);
        }
      }
      // beta_r = (n_beta - r) / n_beta of the walker's current row
      const float beta = T ? static_cast<float>(p.n_beta - row % p.n_beta) / static_cast<float>(p.n_beta) : 1.0f;
      draws.restart();
      int acc = 0;
      int ts = 0;  // t % n_sites: every sweep of T or M starts a schedule
      const int t1 = M ? min((s + 1) * rounds, p.n_steps) : (s + 1) * rounds;
      for (int t = s * rounds; t < t1; ++t) {
        const float u = draws(p, t, row, lane);
        const int site = p.sched[ts];
        ts = ts + 1 == p.n_sites ? 0 : ts + 1;
        const float sg = sp[site];
        const float two_s = 2.0f * sg;
        const float2* wrow = p.w + (size_t)site * p.H + lane;  // unit r at wrow[32 r]
        const float4* trow = C ? p.wt + (size_t)site * p.H + lane : nullptr;
        float l = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool in = in_row<R>(r, lane, p.H);
          float lc;
          if constexpr (C) {
            const float4 t4 = in ? __ldg(trow + 32 * r) : make_float4(0.0f, 0.0f, 1.0f, 0.0f);
            const float2 cs = rotate(cy[r], sy[r], t4.z, sg * t4.w);
            lc = re_c_term(fmaf(-two_s, t4.x, yr[r]), cs.x, cs.y, s_c, hidden(r, lane));
          } else {
            const float2 wv = in ? __ldg(wrow + 32 * r) : make_float2(0.0f, 0.0f);
            lc = logcosh_re_fast(fmaf(-two_s, wv.x, yr[r]), fmaf(-two_s, wv.y, yi[r]));
          }
          l += in ? lc : 0.0f;
        }
        const float2 av = __ldg(p.a + site);
        const float ln1 = (warp_allsum(l) + sa.x) - two_s * av.x;
        const float dln = ln1 - ln0;
        const bool accept = u < expf((T ? 2.0f * beta : 2.0f) * fminf(dln, 0.0f));
        if (accept) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const bool in = in_row<R>(r, lane, p.H);
            if constexpr (C) {
              const float4 t4 = in ? __ldg(trow + 32 * r) : make_float4(0.0f, 0.0f, 1.0f, 0.0f);
              const float2 cs = rotate(cy[r], sy[r], t4.z, sg * t4.w);
              cy[r] = cs.x;
              sy[r] = cs.y;
              yr[r] = fmaf(-two_s, t4.x, yr[r]);
              yi[r] = fmaf(-two_s, t4.y, yi[r]);
            } else {
              const float2 wv = in ? __ldg(wrow + 32 * r) : make_float2(0.0f, 0.0f);
              yr[r] = fmaf(-two_s, wv.x, yr[r]);
              yi[r] = fmaf(-two_s, wv.y, yi[r]);
            }
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
      if (p.n_beta > 1) {
        const int G = blockDim.x >> 5;
        swap_phase<R>(p, draws, active, base, s, 0, row, ln0, s_ln, s_swap);
        swap_phase<R>(p, draws, active, base, s, 1, row, ln0, s_ln + G, s_swap);
      }
    }
  }
}

// Sites per group of the off-diagonal sum's reduce-scatter.
constexpr int kSiteGroup = 4;

// Reduce-scatter of the 2 * kSiteGroup = 8 values v over the warp: on return
// every lane holds the warp's total of value (lane >> 2) & 7. Three halving
// exchanges, each lane keeping half of what it holds and sending the other
// half to its partner (4 + 2 + 1 shuffles), then a butterfly over the last
// two lane bits (2 shuffles): 9 shuffles for 8 sums, against 40 for eight
// warp_sums. The butterfly adds the same two operands on the four lanes of a
// value, so they hold the same bits.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float u[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) u[q] = (b4 ? v[q + 4] : v[q]) + __shfl_xor_sync(kFull, b4 ? v[q] : v[q + 4], 16);
  float w[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) w[q] = (b3 ? u[q + 2] : u[q]) + __shfl_xor_sync(kFull, b3 ? u[q] : u[q + 2], 8);
  float z = (b2 ? w[1] : w[0]) + __shfl_xor_sync(kFull, b2 ? w[0] : w[1], 4);
  z += __shfl_xor_sync(kFull, z, 2);
  z += __shfl_xor_sync(kFull, z, 1);
  return z;
}

// sum_i exp(ln psi(flip_i s) - ln psi(s)) over the N sites of one walker,
// complex, on lane 0. s points at the walker's N spins (global or shared); wt
// is the (N, H) table (Re w, Im w, cos 2 Im w, sin 2 Im w) of the call.
// cos/sin(Im y) are computed once per walker (library sincosf); a flipped
// unit's cos/sin(Im y - 2 s_i Im w) come by angle addition,
// (cy C + s sy S, sy C - s cy S), so the site loop has no trig. Both planes
// of ln cosh(y_j) are computed once with the same arithmetic as the
// candidates; each site's ratio is formed difference-first,
// sum_j c_j [ln cosh(y'_j) - ln cosh(y_j)], so the O(|ln psi|) totals never
// cancel in float32 (sa cancels in the ratio and is not read). For C = true
// both planes of each difference are rotated by c_j (s_c in shared memory).
// Each lane accumulates the partial (dr, di) of kSiteGroup sites, one
// reduce-scatter leaves every site's totals on its own lanes, and the
// exp and sincos of the kSiteGroup sites run on as many lanes at once.
template <int R, bool C>
__device__ __forceinline__ float2 offdiag_walker(const float4* __restrict__ wt, const float2* __restrict__ a,
                                                 const float2* s_c, const float* s, const float (&yr)[R],
                                                 const float (&yi)[R], int N, int H) {
  const int lane = threadIdx.x & 31;
  float cy[R], sy[R], l0r[R], l0i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sincosf(yi[r], &sy[r], &cy[r]);
    logcosh_ri_cs(yr[r], cy[r], sy[r], &l0r[r], &l0i[r]);
  }
  float acc_re = 0.0f, acc_im = 0.0f;
  for (int i0 = 0; i0 < N; i0 += kSiteGroup) {
    float part[2 * kSiteGroup];
#pragma unroll
    for (int g = 0; g < kSiteGroup; ++g) {
      float dr = 0.0f, di = 0.0f;
      if (i0 + g < N) {  // uniform over the warp
        const float sg = s[i0 + g];
        const float4* row = wt + (size_t)(i0 + g) * H + lane;  // unit r at row[32 r]
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool in = in_row<R>(r, lane, H);
          const float4 t = in ? __ldg(row + 32 * r) : make_float4(0.0f, 0.0f, 1.0f, 0.0f);
          const float2 cs = rotate(cy[r], sy[r], t.z, sg * t.w);  // sin(2 s Im w) = s sin(2 Im w)
          float lr, li;
          logcosh_ri_cs(fmaf(-2.0f * sg, t.x, yr[r]), cs.x, cs.y, &lr, &li);
          const float ddr = lr - l0r[r], ddi = li - l0i[r];
          if constexpr (C) {
            const float2 cj = s_c[hidden(r, lane)];
            dr += in ? cj.x * ddr - cj.y * ddi : 0.0f;
            di += in ? cj.x * ddi + cj.y * ddr : 0.0f;
          } else {
            dr += in ? ddr : 0.0f;
            di += in ? ddi : 0.0f;
          }
        }
      }
      part[2 * g] = dr;
      part[2 * g + 1] = di;
    }
    // site g = (lane >> 3) & 3: its Re total on the lanes with bit 2 clear,
    // its Im total on those with bit 2 set
    const float tot = reduce_scatter8(part, lane);
    const float other = __shfl_xor_sync(kFull, tot, 4);
    const int i = i0 + ((lane >> 3) & 3);
    if ((lane & 7) == 0 && i < N) {
      const float two_s = 2.0f * s[i];
      const float2 av = __ldg(a + i);
      const float mag = expf(tot - two_s * av.x);
      float sn, cs;
      sincosf(other - two_s * av.y, &sn, &cs);
      acc_re += mag * cs;
      acc_im += mag * sn;
    }
  }
  return make_float2(warp_sum(acc_re), warp_sum(acc_im));
}

// Warps per sweep block for a replica count (0 if n_beta is not taken).
__host__ __forceinline__ int sweep_warps(int n_beta) {
  if (n_beta < 1 || n_beta > kMaxNBeta) return 0;
  return n_beta == 1 ? kWarps : n_beta * (n_beta >= 8 ? 1 : 8 / n_beta);
}

}  // namespace nqs

// Expand CASE(R) for every R = 1..16 (H = 1..512), inside a switch on R;
// CASE may use the bool C of the enclosing function.
#define NQS_FOR_EACH_R(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) \
  CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
