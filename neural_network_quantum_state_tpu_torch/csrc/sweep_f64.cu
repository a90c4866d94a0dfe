// Fused single-flip Metropolis sweeps for the log-cosh machines, float64,
// Hopper, with in-kernel replica exchange (parallel tempering) for
// n_beta > 1: the float64 instances of sweep.cu.
//
// Replaces, for float64 machines, what the JAX package computes in XLA
// (sampler/metropolis.py::_sweep_scan and sampler/tempering.py: its TPU
// kernel neural_network_quantum_state_tpu/ops/pallas_sweep.py::_sweep_kernel
// is float32 only). The same computation as sweep.cu in double: per walker,
// n_steps proposals over the site schedule, y' = y - 2 s_i w_i, accept when
// u < exp(2 beta min(dln, 0)) with dln = Re ln psi(s') - Re ln psi(s),
// masked commit of y, sa and the spin; for n_beta > 1 (rows replica-minor,
// beta_r = (n_beta - r) / n_beta) the even-pair and then the odd-pair swap
// phase after each sweep of n_sites proposals. The uniforms are the
// caller's (float64) or the kernel's own Philox4x32-10 stream on a key, the
// float32 numbers of sweep.cu widened to double (rbm_f64.cuh Draws), which
// the plain float64 version takes too, so both make the same decisions.
// Instances: the RBM family (C = false) and the FFNN family's output
// weights c (C = true), each at n_beta = 1 (T = false) and n_beta <= 16
// (T = true), for every R = ceil(H/32) = 1..16; and the RBM family's
// tempered instances above R = 8 once more, narrow (Nw), for blocks of at
// most 8 warps (n_beta <= 8).
//
// The form (the energy kernel's float64 instance, energy.cu, carried
// through the sweep): per hidden unit j, with y = x + iv and s = s_i,
//
//     cosh(y - 2 s w_ij) / cosh(y) = e^{-2 s w_ij} (c_j + u_j G_ij) / D_j,
//
// G_ij = e^{4 s w_ij} (ops/engine.py::sweep_table_f64, (site, sign, unit)),
// u_j = e^{-2 max(x, 0)} e^{-2iv}, c_j = e^{-2 max(-x, 0)}, D_j = c_j + u_j:
// the walker's state keeps cosh(y_j) = rho_j e^{i v_j} (c_j + u_j) with
// rho_j > 0. The factor cancels only where cosh of the flipped unit nears a
// zero, as the ratio itself does (the naive cosh(2w) - tanh(y) sinh(2w)
// cancels wherever tanh y tanh 2w nears 1, and tanh has poles).
// RBM family (C = false): |psi'/psi|^2 = e^{-4 s Re(a_i + sum_j w_ij)}
// prod_j |c_j + u_j G_ij|^2 / |D_j|^2. A proposal takes per unit one complex
// multiply-add, |.|^2 and its share of the lane's product (in pairs, each
// pair brought into [1, 2) by its power of two, so that no |Re w| <= 43
// overflows it); the lane multiplies in its carried inverse of prod_j
// |D_j|^2 (mantissa and power of two), the warp's butterfly multiplies the
// lanes, a per-site factor m 2^k (shared memory, from the table's sums)
// the site's term, and the test u < |psi'/psi|^2 is an exact comparison of
// u 2^-k' with the mantissa: no log and no exp per proposal. A tempered row
// compares u^{1/beta} instead: first log2 u / beta against log2 of the ratio
// in float (MUFU), exactly as u^{1/beta} (a double log and exp of the
// uniform) only where the two lie within 4e-3 of each other.
// With c: Re(c_j Log cosh) does not factor, so each element takes
// ln|c_j + u_j G_ij| and Arg(c_j + u_j G_ij) (the library's log and atan2;
// no exp, no sincos), and the flipped unit's principal phase wrap(v_j - 2 s
// Im w_ij + Arg(.)) into [-pi, pi], v_j = Im y_j reduced into [-pi, pi]: the
// branch of each unit's Arg enters Re(c_j Log cosh), so the wrap, not a
// product of ratios, makes the plain version's decisions near the cut; the
// lane's sum of c_j.x ln|D_j| - c_j.y Arg cosh y_j is carried.
//
// An accepted flip moves y_j -= 2 s w_ij exactly as the plain version does
// (y stays its to the bit), and the state (c_j, u_j) to (c_j, u_j G_ij)
// scaled by the power of two that brings its larger part into [1, 2), whose
// exponents correct the carried product or sum; no transcendental per unit
// (one reciprocal per lane without c). Every sweep of n_sites rounds (and
// at the start) renews the state from y with the stable functions of
// rbm_f64.cuh (unit_state: the library's exp and sincos, with c or for the
// swap phases log and atan2), so the drift of the carried state is bounded
// by one sweep; the tempered swap phases read that renewed Re ln psi.
//
// Layout: one warp per walker, lane l on the hidden units j = l + 32 r,
// r < R; its state (u_j, c_j) in registers, y in shared memory (16 H bytes
// a warp), c and the schedule in shared memory once per block; the G row of
// the proposed site (16 H bytes) and w (on an accept, and with c Im w)
// through L1 (staging those rows in shared memory for the block measured
// slower without c, PERF.md). The instances' blocks and register caps are
// the fastest of those timed at H = 256, 384 and 512 (resident_blocks).
//
// Range: with u_j and c_j below 2 in each part, |c_j + u_j G_ij|^2 <
// 8 e^{8 |Re w_ij|}, and a pair of them stays below 2^1023 for |Re w| <= 43
// (G and one factor for |Re w| up to 88); ops/sweep.py refuses larger
// weights (F64_SWEEP_MAX_RE_W).
//
// Bound on an H100: the operations per (walker, proposal, hidden unit) the
// function needs, 11 in the RBM family (the multiply-add c + u G with the
// state's c real 7, |.|^2 3, the product 1) and 24 with c (the multiply-add
// 7, |.|^2 3, the log and its half 2, atan2 1, the phase 3 and its wrap 4,
// the sum 4), at the card's float64 rate outside the tensor cores (34
// TFLOP/s), against 32 bytes of y per (walker, hidden unit) read and written
// once per call: bound by operations. This form's power of two per pair of
// factors (11.5 an element) and its 16 bytes of G per element read from L1
// are its own floors beside it (PERF.md).

#include "rbm_f64.cuh"

namespace {

constexpr int kRenorm = 4;  // factors |D_j|^2 of a renewal's product between renormalisations
constexpr size_t kMaxSmem = 232448;  // the shared memory a block can use on an H100 (227 KB)

using namespace nqs::d;

struct SweepArgsF64 {
  const double2* w;       // (N, H)
  const double2* a;       // (N,)
  const int* sched;       // (n_sites,)
  const double* u;        // (n_steps, K), or null: the Philox stream
  const double* u_swap;   // (n_steps / n_sites, 2, K) with u, for n_beta > 1
  const long long* key;   // (2,) words in [0, 2^32), read when u is null
  int K, N, H, n_sites, n_steps, n_beta;
  int row0;               // the first walker's row in the Philox counter
  const double2* g;       // (N, 2, H): e^{4 s w_ij}, s = +1 then -1
  const double2* a_site;  // (N,): a_i + sum_j w_ij, or with c a_i + sum_j c_j Re w_ij
};

// A lane's hidden units: the state of each (u_j, c_j) and, over them,
// without c the product of |D_j|^2, carried as its inverse dm 2^de, with c
// the sum of c_j.x ln|D_j| - c_j.y Arg cosh y_j (q). A unit past H stays
// at u = 0, c = 1 and enters neither.
template <int R, bool C>
struct Units {
  double2 u[R];
  double c[R];
  double q;
  double dm;
  int de;
  // C = false: the last proposal's product of |c_j + u_j G_ij|^2, pm 2^pe
  double pm;
  int pe;

  // The state from y (the walker's row in shared memory) with the stable
  // functions of rbm_f64.cuh (unit_state); returns the lane's share of
  // sum_j Re(c_j ln cosh y_j) when Ln (the swap phases read it).
  template <bool Ln>
  __device__ __forceinline__ double renew(const double2* s_y, const double2* s_c, int H, int lane) {
    q = 0.0;
    double ln = 0.0, pd = 1.0;
    int ed = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = lane + 32 * r;
      u[r] = make_double2(0.0, 0.0);
      c[r] = 1.0;
      if (r == R - 1 && j >= H) continue;  // only the last word holds units past H
      const double2 yv = s_y[j];
      const UnitState us = unit_state(yv, C || Ln);
      u[r] = us.u;
      c[r] = us.c;
      const double lncosh = us.lnd + (fabs(yv.x) - nqs::d::kLn2);  // Re ln cosh y_j
      if constexpr (C) {
        const double2 cj = s_c[j];
        q += cj.x * us.lnd - cj.y * us.arg;
        if (Ln) ln += cj.x * lncosh - cj.y * us.arg;
      } else {
        pd *= us.d2;
        if (r % kRenorm == kRenorm - 1) renorm(pd, ed);
        if (Ln) ln += lncosh;
      }
    }
    if constexpr (!C) {
      renorm(pd, ed);
      dm = 1.0 / pd;
      de = -ed;
    }
    return ln;
  }

  // One proposal over the row `grow` of G (wrow: the site's row of w,
  // whose Im w the phase reads with c, and the walker's y, whose Im y it
  // reduces to [-pi, pi]). Without c: the lane's product of
  // |c_j + u_j G_ij|^2 / |D_j|^2, returned as m 2^e with m in [1, 2) (pm
  // 2^pe keeps the numerator): the factors multiplied in pairs, each pair
  // brought into [1, 2) by its power of two; with c: the lane's sum of
  // c_j.x (ln|c_j + u_j G_ij| - ln|D_j|) - c_j.y (Arg cosh(y_j - 2 s w_ij) -
  // Arg cosh y_j), as m (e = 0).
  __device__ __forceinline__ double propose(const double2* s_y, const double2* grow, const double2* wrow,
                                            const double2* s_c, double two_s, int H, int lane, int& e_out) {
    double f[R];
    double acc = 0.0;
    int ex = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = lane + 32 * r;
      f[r] = 1.0;
      if (r == R - 1 && j >= H) continue;  // only the last word holds units past H
      const double2 gv = grow[j];
      const double mx = fma(u[r].x, gv.x, fma(-u[r].y, gv.y, c[r]));
      const double my = fma(u[r].x, gv.y, u[r].y * gv.x);
      f[r] = fma(mx, mx, my * my);
      if constexpr (C) {
        const double yy = s_y[j].y;
        double ph = fma(-two_s, wrow[j].y, fma(-kTwoPi, rint(yy * kInvTwoPi), yy)) + atan2(my, mx);
        ph = fma(-kTwoPi, rint(ph * kInvTwoPi), ph);  // the flipped unit's principal Arg cosh
        const double2 cj = s_c[j];
        acc = fma(cj.x, 0.5 * log(f[r]), fma(-cj.y, ph, acc));
      }
    }
    if constexpr (C) {
      pm = acc;
      e_out = 0;
      return acc - q;
    } else {
      double prod = 1.0;
#pragma unroll
      for (int g = 0; g < R; g += 4) {
        double lo = g + 1 < R ? f[g] * f[g + 1] : f[g];
        double hi = g + 3 < R ? f[g + 2] * f[g + 3] : g + 2 < R ? f[g + 2] : 1.0;
        renorm_pair(lo, ex);
        renorm_pair(hi, ex);
        prod *= lo * hi;
      }
      pm = prod;
      pe = ex;
      double z = prod * dm;
      e_out = ex + de;
      renorm(z, e_out);
      return z;
    }
  }

  // An accepted flip: y -= 2 s w exactly, the state to (c_j, u_j G_ij)
  // brought into [1, 2) by a power of two, and the carried product or sum
  // to the proposal's, corrected by those powers.
  __device__ __forceinline__ void accept(double2* s_y, const double2* grow, const double2* wrow,
                                         const double2* s_c, double two_s, int H, int lane) {
    double shift = 0.0;  // C: sum_j c_j.x times the unit's exponent
    int eshift = 0;      // the units' exponents
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = lane + 32 * r;
      if (r == R - 1 && j >= H) continue;  // only the last word holds units past H
      const double2 yv = s_y[j], wv = wrow[j], gv = grow[j];
      const double ny = yv.y - two_s * wv.y;
      s_y[j] = make_double2(yv.x - two_s * wv.x, ny);
      const int e = move_state(u[r], c[r], gv);
      if constexpr (C) {
        shift = fma(s_c[j].x, static_cast<double>(e - 1023), shift);
      } else {
        eshift += e - 1023;
      }
    }
    if constexpr (C) {
      q = fma(-nqs::d::kLn2, shift, pm);  // ln|D'_j| = ln|c_j + u_j G_ij| - (e_j - 1023) ln 2
    } else {
      dm = 1.0 / pm;  // |D'_j|^2 = |c_j + u_j G_ij|^2 2^{-2 (e_j - 1023)}
      de = 2 * eshift - pe;
    }
  }
};

// Shared memory of a block of G warps: c (H, C = true) or without c the
// per-site factors (N, 2) as double2 (m, k), e^{-4 s Re a'_i} = m 2^k; per
// warp its walker's y (H) as double2; two buffers of Re ln psi per row (one
// per swap parity); the spins of each warp's walker as floats (+-1); the
// per-row counts of accepted flips and of accepted swaps as the lower
// member; the schedule.
template <bool C>
size_t smem_bytes(int G, int N, int H, int n_sites) {
  return sizeof(double2) * ((C ? (size_t)H : 2 * (size_t)N) + (size_t)G * H) +
         sizeof(double) * 2 * (size_t)G + sizeof(float) * (size_t)G * N + sizeof(int) * (2 * (size_t)G + n_sites);
}

// The warps a block of an instance holds: nqs::kWarps at n_beta = 1 (T =
// false) and for the narrow tempered instances (Nw: the RBM family above
// R = 8 at n_beta <= kWarps), else kMaxWarps. Resident blocks per SM, which
// cap a thread's registers: one block of 16 warps (128 registers) for the
// other tempered instances; two blocks of 8 (128) with c and in the RBM
// family up to R = 8; one block of 8 (255) for the RBM family above R = 8,
// whose state then fits the registers without spilling (with c, 16 warps
// an SM at 128 registers measured faster than 8 without spilling).
constexpr int block_warps(bool T, bool Nw) { return Nw ? nqs::kWarps : nqs::sweep_block_warps(T); }
constexpr int resident_blocks(int R, bool C, bool T) { return T || (!C && R > 8) ? 1 : 2; }

template <int R, bool C, bool T, bool Nw>
__global__ void __launch_bounds__(32 * block_warps(T, Nw), resident_blocks(R, C, T))
sweep_kernel_f64(SweepArgsF64 p, const double2* __restrict__ c, const double* __restrict__ spins_in,
                 const double2* __restrict__ y_in, const double2* __restrict__ sa_in, double* __restrict__ spins_out,
                 double2* __restrict__ y_out, double2* __restrict__ sa_out, int* __restrict__ flip_out,
                 int* __restrict__ swap_out) {
  extern __shared__ __align__(16) double2 smem2[];
  const int G = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * G;
  const int k = base + warp;
  const bool active = k < p.K;  // uniform over the warp; a warp past K passes the barriers
  const int H = p.H;
  double2* s_c = smem2;     // C
  double2* s_site = smem2;  // !C
  double2* s_ys = smem2 + (C ? H : 2 * p.N);
  double2* s_y = s_ys + (size_t)warp * H;
  double* s_ln = reinterpret_cast<double*>(s_ys + (size_t)G * H);
  float* sp = reinterpret_cast<float*>(s_ln + 2 * G) + (size_t)warp * p.N;
  int* s_flip = reinterpret_cast<int*>(reinterpret_cast<float*>(s_ln + 2 * G) + (size_t)G * p.N);
  int* s_swap = s_flip + G;
  int* s_sched = s_swap + G;

  if (lane == 0) {
    s_flip[warp] = 0;
    s_swap[warp] = 0;
  }
  for (int i = threadIdx.x; i < p.n_sites; i += blockDim.x) s_sched[i] = p.sched[i];
  if constexpr (C) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) s_c[j] = c[j];
  } else {
    // e^{-4 s Re a'_i} = m 2^k for s = +1 and -1 (exp_split)
    for (int n = threadIdx.x; n < 2 * p.N; n += blockDim.x) {
      s_site[n] = exp_split((n & 1 ? 4.0 : -4.0) * p.a_site[n >> 1].x);
    }
  }
  double2 sa = make_double2(0.0, 0.0);
  if (active) {
    for (int i = lane; i < p.N; i += 32) sp[i] = spins_in[(size_t)k * p.N + i] > 0.0 ? 1.0f : -1.0f;
    for (int j = lane; j < H; j += 32) s_y[j] = y_in[(size_t)k * H + j];
    sa = sa_in[k];
  }
  __syncthreads();  // s_c, s_site, s_sched
  Units<R, C> st;
  if (active) st.template renew<false>(s_y, s_c, H, lane);
  __syncwarp();

  int row = k;
  nqs::d::Draws draws(p.u, p.u_swap, p.key, p.K, p.row0);
  // passes of the schedule (the last one of T = false maybe partial): each
  // starts from a renewed state; T ends each with the swap phases
  const int n_pass = (p.n_steps + p.n_sites - 1) / p.n_sites;
  int t = 0;
  for (int s = 0; s < n_pass; ++s) {
    if (!T && s > 0 && active) st.template renew<false>(s_y, s_c, H, lane);
    // beta of the row; without c a tempered proposal is accepted when u^{1/beta} < |psi'/psi|^2
    const double beta = T ? nqs::d::row_beta(row, p.n_beta) : 1.0;
    const double inv_beta = T ? static_cast<double>(p.n_beta) / static_cast<double>(p.n_beta - row % p.n_beta) : 1.0;
    if (active && (T || s == 0)) draws.restart();  // the rows of a tempered block change between sweeps
    int acc = 0;
    const int rounds = min(p.n_sites, p.n_steps - t);
    for (int ts = 0; ts < rounds; ++ts, ++t) {
      if (!active) continue;
      const double u = draws(t, row, lane);
      const int site = s_sched[ts];
      const float spin = sp[site];
      const double two_s = 2.0 * static_cast<double>(spin);
      const int sign = spin < 0.0f ? 1 : 0;
      const double2* grow = p.g + ((size_t)site * 2 + sign) * H;
      const double2* wrow = p.w + (size_t)site * H;
      int ez;
      double z = st.propose(s_y, grow, wrow, s_c, two_s, H, lane, ez);
      // the test u < exp(2 beta min(dln, 0)) (exp(0) = 1 taken as such)
      bool accept;
      if constexpr (C) {
        const double dln = nqs::d::warp_allsum(z) - two_s * __ldg(&p.a_site[site].x);
        accept = dln >= 0.0 ? u < 1.0 : u < exp(2.0 * beta * dln);
      } else {
        // |psi'/psi|^2 = e^{-4 s Re a'_i} prod_j |c_j + u_j G_ij|^2 / |D_j|^2 = z 2^ez, z in [2^-1/2,
        // 2^32.5): u^{1/beta} < z 2^ez as uu 2^-ez < z, exact where it is computed
        group_product<32>(z, ez);
        const double2 f = s_site[2 * site + sign];
        z *= f.x;
        ez += static_cast<int>(f.y);
        // a tempered row compares u^{1/beta}, first the logs in float
        accept = accept_ratio<T>(u, z, ez, inv_beta);
      }
      if (accept) {
        st.accept(s_y, grow, wrow, s_c, two_s, H, lane);
        const double2 av = __ldg(p.a + site);
        sa.x -= two_s * av.x;
        sa.y -= two_s * av.y;
        ++acc;
      }
      __syncwarp();
      if (accept && lane == 0) sp[site] = -spin;
      __syncwarp();
    }
    if (active && lane == 0) s_flip[row - base] += acc;
    if constexpr (T) {
      double ln0 = 0.0;
      if (active) ln0 = nqs::d::warp_allsum(st.template renew<true>(s_y, s_c, H, lane)) + sa.x;
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

template <int R, bool C, bool T, bool Nw>
cudaError_t launch_instance(const SweepArgsF64& p, int G, const void* c, const void* spins_in, const void* y_in,
                            const void* sa_in, void* spins_out, void* y_out, void* sa_out, void* flip_out,
                            void* swap_out, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(G, p.N, p.H, p.n_sites);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sweep_kernel_f64<R, C, T, Nw>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.K + G - 1) / G);
  sweep_kernel_f64<R, C, T, Nw><<<grid, 32 * G, smem, stream>>>(
      p, static_cast<const double2*>(c), static_cast<const double*>(spins_in), static_cast<const double2*>(y_in),
      static_cast<const double2*>(sa_in), static_cast<double*>(spins_out), static_cast<double2*>(y_out),
      static_cast<double2*>(sa_out), static_cast<int*>(flip_out), static_cast<int*>(swap_out));
  return cudaGetLastError();
}

// The instance of R, C and T for a block of G warps: the narrow tempered
// one where it exists and G fits it.
template <int R, bool C, bool T>
cudaError_t launch(const SweepArgsF64& p, const void* c, const void* spins_in, const void* y_in, const void* sa_in,
                   void* spins_out, void* y_out, void* sa_out, void* flip_out, void* swap_out, cudaStream_t stream) {
  const int G = nqs::sweep_warps(p.n_beta);
  if constexpr (T && !C && R > 8) {
    if (G <= nqs::kWarps)
      return launch_instance<R, C, T, true>(p, G, c, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out,
                                            swap_out, stream);
  }
  return launch_instance<R, C, T, false>(p, G, c, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out, swap_out,
                                         stream);
}

template <bool C, bool T>
cudaError_t dispatch(const SweepArgsF64& p, const void* c, const void* spins_in, const void* y_in, const void* sa_in,
                     void* spins_out, void* y_out, void* sa_out, void* flip_out, void* swap_out, cudaStream_t stream) {
#define NQS_SWEEP_F64_CASE(R) \
  case R:                     \
    return launch<R, C, T>(p, c, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out, swap_out, stream);
  switch ((p.H + 31) / 32) {
    NQS_FOR_EACH_R(NQS_SWEEP_F64_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_SWEEP_F64_CASE
}

}  // namespace

// All complex arrays are interleaved (re, im) double pairs, row-major:
// w (N, H), a (N,), c (H,) or null (c = 1: the RBM family); y (K, H),
// sa (K,); spins (K, N) of +-1 doubles; sched (n_sites,) int32; u
// (n_steps, K) and u_swap (n_steps / n_sites, 2, K) doubles, u_swap read
// only for n_beta > 1; or u and u_swap null and key (2,) int64 words in
// [0, 2^32): the Philox stream of rbm.cuh SweepArgs, row0 >= 0 the first
// walker's row in its counter (row0 + K < 2^31; after the stream, as in
// sweep.cu); after it the table of ops/engine.py::sweep_table_f64: g
// (N, 2, H) e^{4 s w} for s = +1 and -1, and a_site (N,) a_i + sum_j w_ij
// (c null) or a_i + sum_j c_j Re w_ij. n_steps is a multiple of n_sites for
// n_beta > 1, K a multiple of n_beta, n_beta <= 16.
// flip_out (K,): accepted flips while in each row; swap_out (K,): accepted
// swaps with each row as the lower member. 1 <= H <= 512. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int nqs_sweep_f64(const void* w, const void* a, const void* c, const void* spins_in, const void* y_in,
                             const void* sa_in, const void* sched, const void* u, const void* u_swap,
                             const void* key, void* spins_out, void* y_out, void* sa_out, void* flip_out,
                             void* swap_out, int K, int N, int H, int n_sites, int n_steps, int n_beta,
                             void* stream, int row0, const void* g, const void* a_site) {
  if (K <= 0 || N <= 0 || n_sites <= 0 || n_steps <= 0 || H < 1 || H > 32 * nqs::kMaxR ||
      nqs::sweep_warps(n_beta) == 0 || K % n_beta != 0 || row0 < 0 || row0 > INT_MAX - K)
    return cudaErrorInvalidValue;
  if (n_beta > 1 && n_steps % n_sites != 0) return cudaErrorInvalidValue;
  if (u == nullptr ? key == nullptr : n_beta > 1 && u_swap == nullptr) return cudaErrorInvalidValue;
  if (g == nullptr || a_site == nullptr) return cudaErrorInvalidValue;
  const SweepArgsF64 p{static_cast<const double2*>(w), static_cast<const double2*>(a), static_cast<const int*>(sched),
                       static_cast<const double*>(u), static_cast<const double*>(u_swap),
                       static_cast<const long long*>(key), K, N, H, n_sites, n_steps, n_beta, row0,
                       static_cast<const double2*>(g), static_cast<const double2*>(a_site)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NQS_SWEEP_ARGS p, c, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out, swap_out, s
  if (c != nullptr) return n_beta > 1 ? dispatch<true, true>(NQS_SWEEP_ARGS) : dispatch<true, false>(NQS_SWEEP_ARGS);
  return n_beta > 1 ? dispatch<false, true>(NQS_SWEEP_ARGS) : dispatch<false, false>(NQS_SWEEP_ARGS);
#undef NQS_SWEEP_ARGS
}
