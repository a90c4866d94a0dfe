// Device code shared by the float64 instances of the sweep and exchange
// kernels (sweep_f64.cu, exchange_f64.cu), Hopper: the log-cosh terms in
// double, warp sums of doubles, the flip uniforms of the sweep's Philox
// stream widened to double, and the replica-exchange phase of one-warp
// walkers.
//
// The JAX package runs a float64 machine's sampler in XLA (its Pallas
// kernels are float32 only); these instances make the same decisions as the
// port's plain float64 versions (ops/sweep.py sweep_plain, ops/exchange.py
// exchange_plain) on the same uniforms. The log-cosh is the plain version's
// stable split-plane form (ops/logcosh.py) with the library's double exp,
// cos/sin, log and atan2, and the phase is the principal Arg of cosh y, as
// the JAX package's and the plain version's, so ln psi jumps by 2 pi i c_j
// where cosh(y_j) crosses the negative real axis. The exchange sums these
// terms per proposal, as logs, so that no product of cosh ratios can
// overflow at any H or |Re w|. The sweep evaluates them once per sweep,
// where it renews its factor state from y, and takes its proposals as
// products of factors c_j + u_j e^{4 s w_ij} with a running power of two
// (sweep_f64.cu).

#pragma once

#include "rbm.cuh"

namespace nqs {
namespace d {

constexpr double kLn2 = 0.6931471805599453;

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

}  // namespace d
}  // namespace nqs
