// Device code shared by the float64 instances of the sweep and exchange
// kernels (sweep_f64.cu, exchange_f64.cu), Hopper: the log-cosh terms in
// double, group sums and products of doubles, the flip uniforms of the
// sweep's Philox stream widened to double, the replica-exchange phase of
// one-warp walkers, and the parts of the factor form that both kernels run.
//
// The JAX package runs a float64 machine's sampler in XLA (its Pallas
// kernels are float32 only); these instances make the same decisions as the
// port's plain float64 versions (ops/sweep.py sweep_plain, ops/exchange.py
// exchange_plain) on the same uniforms. The log-cosh is the plain version's
// stable split-plane form (ops/logcosh.py) with the library's double exp,
// cos/sin, log and atan2, and the phase is the principal Arg of cosh y, as
// the JAX package's and the plain version's, so ln psi jumps by 2 pi i c_j
// where cosh(y_j) crosses the negative real axis. Both kernels evaluate
// them only where they renew their factor state from y (unit_state, once a
// sweep), and take their proposals as products of factors c_j + u_j E_j
// with running powers of two (the exact test accept_ratio): E_j =
// e^{4 s w_ij} for a flip of site i (sweep_f64.cu), e^{4 s (w_ij - w_kj)}
// for the pair flip of a bond (i, k) (exchange_f64.cu), both from the
// table of ops/engine.py::sweep_table_f64.

#pragma once

#include "rbm.cuh"

namespace nqs {
namespace d {

constexpr double kLn2 = 0.6931471805599453;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kInvTwoPi = 0.15915494309189535;
constexpr double kInvLn2 = 1.4426950408889634;
// ln 2 in two parts: kLn2Hi has 32 significant bits, so k kLn2Hi is exact for |k| < 2^20
constexpr double kLn2Hi = 6.93147180369123816490e-01, kLn2Lo = 1.90821492927058770002e-10;
// The tempered test's float pre-test decides where the log2 of its two sides
// lie this far apart: near a decision |log2 u / beta| <= 24 * 16, where
// __log2f (2 ulp), the float arguments and the float sum err by at most 2e-4.
constexpr float kLog2Gap = 4e-3f;

// Re ln cosh(x + iv) from cos v alone (ops/logcosh.py logcosh_re_cos):
// 4 e^{-2|x|} |cosh(x + iv)|^2 = (1 - e)^2 + 4 e cos^2 v, e = e^{-2|x|}, a
// sum of two terms >= 0 (no cancellation near the zeros of cosh).
__device__ __forceinline__ double logcosh_re(double x, double v) {
  const double ax = fabs(x);
  const double e = exp(-2.0 * ax);
  const double c = cos(v);
  const double ome = 1.0 - e;
  return 0.5 * log(ome * ome + 4.0 * e * c * c) + (ax - kLn2);
}

// Both planes of ln cosh(x + iv) (ops/logcosh.py logcosh_ri): the split
// planes re = (1 + e) cos v, im = (1 - e) sin v sgn x, Re = 0.5 ln(re^2 +
// im^2) + |x| - ln 2, Im = atan2(im, re), the principal branch.
__device__ __forceinline__ void logcosh_ri(double x, double v, double* lr, double* li) {
  const double ax = fabs(x);
  const double e = exp(-2.0 * ax);
  double sv, cv;
  sincos(v, &sv, &cv);
  const double re = (1.0 + e) * cv;
  const double im = (1.0 - e) * sv * (x < 0.0 ? -1.0 : 1.0);
  *lr = 0.5 * log(re * re + im * im) + (ax - kLn2);
  *li = atan2(im, re);
}

// Re(c_j ln cosh(x + iv)) of hidden unit j (C, c in shared memory), or
// Re ln cosh(x + iv).
template <bool C>
__device__ __forceinline__ double term(double x, double v, const double2* c, int j) {
  if constexpr (C) {
    double lr, li;
    logcosh_ri(x, v, &lr, &li);
    const double2 cj = c[j];
    return cj.x * lr - cj.y * li;
  } else {
    return logcosh_re(x, v);
  }
}

// Sum over the warp, then lane 0's value on every lane (the butterfly sums
// in lane-dependent order; broadcasting one of them keeps decisions uniform).
__device__ __forceinline__ double warp_allsum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

// The flip and swap uniforms of one walker, from the caller (u non-null:
// (n_steps, K) flips, (n_sweeps, 2, K) swaps, doubles) or from the sweep's
// Philox stream on `key` at walker rows offset by row0 (rbm.cuh FlipDraws:
// the same float32 numbers, widened), which ops/rng.py::philox_uniforms makes
// for the plain version.
struct Draws {
  const double* u;
  const double* u_swap;
  int K;
  int row0;
  uint2 key;
  uint4 bits;
  int base;  // first counter block of `bits`, -1 before the first evaluation

  __device__ __forceinline__ Draws(const double* u_, const double* u_swap_, const long long* key_, int K_, int row0_)
      : u(u_), u_swap(u_swap_), K(K_), row0(row0_), bits(make_uint4(0u, 0u, 0u, 0u)), base(-1) {
    key = u ? make_uint2(0u, 0u) : make_uint2(static_cast<unsigned>(key_[0]), static_cast<unsigned>(key_[1]));
  }
  // The rows of a tempered block change between sweeps: start anew.
  __device__ __forceinline__ void restart() { base = -1; }

  // The flip uniform of round t at walker row `row` (every lane calls it).
  __device__ __forceinline__ double operator()(int t, int row, int lane) {
    if (u) return __ldg(u + (size_t)t * K + row);
    const int blk = t >> 2;
    if ((blk & ~31) != base) {
      base = blk & ~31;
      const uint4 ctr = make_uint4(static_cast<unsigned>(base + lane), static_cast<unsigned>(row0 + row), 0u, 0u);
      bits = philox4x32_10(ctr, key);
    }
    return static_cast<double>(bits_uniform(__shfl_sync(kFull, word(bits, t & 3), blk & 31)));
  }

  // The swap uniform of sweep s, parity `parity`, lower row `lower`.
  __device__ __forceinline__ double swap(int s, int parity, int lower) const {
    if (u) return __ldg(u_swap + (size_t)(2 * s + parity) * K + lower);
    return static_cast<double>(swap_uniform(key, s, parity, row0 + lower));
  }
};

// One replica-exchange phase of one-warp walkers (rbm.cuh swap_phase in
// double): the warps post Re ln psi by row (buf, one buffer per parity), the
// block synchronises (every warp, idle ones too), and a warp whose pair
// swaps takes its partner's row, and with it the partner's beta, while its
// configuration stays where it is. Both members of a pair evaluate the same
// test on the same values; the lower one's lane 0 counts it.
__device__ __forceinline__ void swap_phase(const Draws& draws, int n_beta, bool active, int base, int s, int parity,
                                           int& row, double ln0, double* buf, int* s_swap) {
  const int lane = threadIdx.x & 31;
  if (active && lane == 0) buf[row - base] = ln0;
  __syncthreads();
  if (!active) return;
  const int lower = swap_lower(row, n_beta, parity);
  if (lower < 0) return;
  const double dbeta = 1.0 / static_cast<double>(n_beta);
  const double dln = buf[lower + 1 - base] - buf[lower - base];
  if (draws.swap(s, parity, lower) < exp(2.0 * dbeta * fmin(dln, 0.0))) {
    if (row == lower) {
      if (lane == 0) s_swap[lower - base] += 1;
      row = lower + 1;
    } else {
      row = lower;
    }
  }
}

// beta_r = (n_beta - r) / n_beta of walker row `row` (ops/sweep.py
// replica_betas).
__device__ __forceinline__ double row_beta(int row, int n_beta) {
  return static_cast<double>(n_beta - row % n_beta) / static_cast<double>(n_beta);
}

// The biased exponent field of x, and its clamp to [1, 2045], so that
// 2^(1023 - e) and its inverse are normal doubles.
__device__ __forceinline__ int exponent_field(double x) { return (__double2hiint(x) >> 20) & 0x7ff; }
__device__ __forceinline__ int clamp_exponent(int e) { return min(max(e, 1), 2045); }
__device__ __forceinline__ int biased_exponent(double x) { return clamp_exponent(exponent_field(x)); }

// 2^(1023 - e) for a biased exponent e in [1, 2045] (exact).
__device__ __forceinline__ double pow2_down(int e) { return __hiloint2double((2046 - e) << 20, 0); }

// 2^k for 0 <= k <= 1023 (exact).
__device__ __forceinline__ double pow2_up(int k) { return __hiloint2double((1023 + k) << 20, 0); }

// m 2^e with m >= 0 brought into [1, 2) by a power of two (0 stays 0).
__device__ __forceinline__ void renorm(double& m, int& e) {
  const int b = biased_exponent(m);
  m *= pow2_down(b);
  e += b - 1023;
}

// renorm for 0 <= m < 2^1023: m's exponent field needs no mask and no upper
// clamp.
__device__ __forceinline__ void renorm_pair(double& m, int& e) {
  const int b = max(__double2hiint(m) >> 20, 1);
  m *= pow2_down(b);
  e += b - 1023;
}

// The sum over the G lanes of a walker (lane groups of G in the warp), on
// each of them: the butterfly pairs add the same two numbers in either
// order, so every lane of the group holds the same bits.
template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, G);
  return v;
}

// The product of m 2^e over the G lanes of a walker, on each of them, for m
// in [1, 2) (a product of 32 such stays below 2^32); every lane holds the
// same bits, as in group_sum.
template <int G>
__device__ __forceinline__ void group_product(double& m, int& e) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const double mo = __shfl_xor_sync(kFull, m, off, G);
    const int eo = __shfl_xor_sync(kFull, e, off, G);
    m *= mo;
    e += eo;
  }
}

// e^f as (m, k), e^f = m 2^k with m in [2^-1/2, 2^1/2]: k = rint(f / ln 2)
// and m = e^{f - k ln 2} with ln 2 in two parts (exact for |k| < 2^20). The
// kernels' per-site factors e^{-4 s Re a'_i}.
__device__ __forceinline__ double2 exp_split(double f) {
  const double k = rint(f * kInvLn2);
  return make_double2(exp(fma(-k, kLn2Lo, fma(-k, kLn2Hi, f))), k);
}

// One unit's renewed state from its y = x + iv, by the stable functions
// above: u = e^{-2 max(x, 0)} e^{-2iv}, c = e^{-2 max(-x, 0)}, |D|^2 =
// (1 - e)^2 + 4 e cos^2 v (e = e^{-2|x|}, logcosh_re's sum of two terms
// >= 0), and with logs ln|D| = 0.5 ln(re^2 + im^2) of logcosh_ri's planes
// (ln cosh y - |x| + ln 2) and its principal Arg cosh y = atan2(im, re).
// Not inlined: a renewal runs once a sweep, and inlined copies of the
// library's exp, sincos, log and atan2 in each of the instances would
// lengthen the build far more than the calls cost.
struct UnitState {
  double2 u;
  double c, d2, lnd, arg;
};

static __device__ __noinline__ UnitState unit_state(double2 yv, bool logs) {
  const double ax = fabs(yv.x), e = exp(-2.0 * ax);
  double sv, cv;
  sincos(yv.y, &sv, &cv);
  const bool pos = yv.x >= 0.0;
  const double us = pos ? e : 1.0, ome = 1.0 - e;
  UnitState out;
  out.u = make_double2(us * ((cv - sv) * (cv + sv)), -us * (2.0 * sv * cv));
  out.c = pos ? 1.0 : e;
  out.d2 = ome * ome + 4.0 * e * cv * cv;
  out.lnd = out.arg = 0.0;
  if (logs) {
    const double re = (1.0 + e) * cv, im = ome * sv * (pos ? 1.0 : -1.0);
    out.lnd = 0.5 * log(re * re + im * im);
    out.arg = atan2(im, re);
  }
  return out;
}

// A unit's state (u, c) after an accepted move to (c, u E): u E, and both
// brought into [1, 2) in their larger part by a power of two, whose biased
// exponent is returned (the carried product or sum corrects by it).
__device__ __forceinline__ int move_state(double2& u, double& c, double2 e) {
  const double ux = fma(u.x, e.x, -u.y * e.y), uy = fma(u.x, e.y, u.y * e.x);
  const int b = clamp_exponent(max(exponent_field(c), max(exponent_field(ux), exponent_field(uy))));
  const double down = pow2_down(b);
  u = make_double2(ux * down, uy * down);
  c *= down;
  return b;
}

// The RBM family's test u < exp(2 beta min(dln, 0)) with |psi'/psi|^2 =
// z 2^ez (z > 0 normal, or 0): u^{1/beta} < z 2^ez, as uu 2^-ez < z, exact
// where it is computed. A tempered row (T) first compares the logs in float
// (MUFU), which decides where they lie kLog2Gap apart, and takes u^{1/beta}
// (the library's double log and exp of the uniform) only where they do not.
template <bool T>
__device__ __forceinline__ bool accept_ratio(double u, double z, int ez, double inv_beta) {
  const float gap = T ? __log2f(static_cast<float>(z)) + static_cast<float>(ez) -
                            __log2f(static_cast<float>(u)) * static_cast<float>(inv_beta)
                      : 0.0f;
  if (T && gap > kLog2Gap) return true;
  if (T && gap < -kLog2Gap) return false;
  const double uu = !T || inv_beta == 1.0 ? u : exp(log(u) * inv_beta);  // u^{1/beta}
  return z > 0.0 && (ez > 0 || (ez >= -1022 ? uu * pow2_up(-ez) < z : uu == 0.0 && ldexp(z, ez) > 0.0));
}

}  // namespace d
}  // namespace nqs
