// Fused sweep + off-diagonal local-energy megakernel for the RBM family
// (c = 1), float32, Hopper, in the factor form. As the TPU kernel, it takes
// no output weights c: the entry point refuses them.
//
// Replaces the TPU kernel
// neural_network_quantum_state_tpu/ops/pallas_sweep_energy.py
// ::_sweep_energy_kernel. One launch runs the Metropolis sweeps of sweep.cu
// (n_beta >= 1, with the replica-exchange phases after each sweep) and then,
// on the post-sweep state that is still on the chip, the off-diagonal sum of
// energy.cu:
//
//     out[k] = sum_i exp( ln psi(flip_i s') - ln psi(s') )
//
// for every walker row k, tempered replicas included (the caller slices the
// beta = 1 rows). On the same uniforms it takes the decisions of the plain
// version but where the two forms' roundings part a near-tie.
//
// Bound on an H100: operations. Per (walker, proposal or site, hidden unit)
// the function needs a complex multiply-add and its |.|^2 for a decision and
// a complex multiply-add and a complex product for a term (chip_smoke.py
// counts them), against 16 bytes of y read and written once per walker. The
// TPU kernel's port ran sweep.cu's and energy.cu's log-cosh arithmetic back
// to back: 48 and 54 instructions an element, exp, log and the polynomial
// cos/atan2 on every unit of every proposal and site, so the fusion saved
// only the (K, H) round trip of y, a few hundredths of its 0.49 ms. This
// form takes no transcendental per element; what holds it back is the
// chain of one proposal (G row load, factors, butterfly, test, accept),
// which issues about half as fast as the card could (PERF.md).
//
// The form (the float64 energy and sweep instances'): per hidden unit
// j, with y = x + iv and s = s_i,
//
//     cosh(y - 2 s w_ij) / cosh(y) = e^{-2 s w_ij} (c_j + u_j G_ij) / D_j,
//
// G_ij = e^{4 s w_ij} (ops/engine.py::sweep_table_f32, (site, sign, unit)),
// u_j = e^{-2 max(x, 0)} e^{-2iv}, c_j = e^{-2 max(-x, 0)}, D_j = c_j + u_j.
// Both phases read that one table and that one state (u_j, c_j) per walker
// and unit, in registers; the per-site factor e^{-2 s (a_i + sum_j w_ij)}
// comes with the table as a mantissa and a power of two.
// - Sweep: |psi'/psi|^2 = |e^{-2 s a'_i}|^2 prod_j |c_j + u_j G_ij|^2 /
//   prod_j |D_j|^2. A proposal takes per unit one complex multiply-add and
//   its |.|^2. Each lane carries the product of its units' |D_j|^2
//   (mantissa and power of two), the walker the product of its lanes'; the
//   walker's butterfly multiplies the lanes' numerators and sums the
//   exponents, and the test u < |psi'/psi|^2 compares u times the
//   denominator's mantissa with the numerator's scaled by a power of two,
//   exactly but for that one product's rounding: no exp, log or reciprocal
//   per proposal. An accepted flip sets each lane's denominator to its own
//   numerator, and the walker's to the butterfly's product, with no exchange.
//   A tempered row compares the logs, log2 u / beta against
//   log2 |psi'/psi|^2 (MUFU), per proposal.
// - Energy: the term of site i is the complex e^{-2 s a'_i} prod_j (c_j +
//   u_j G_ij) / prod_j D_j; for c = 1 the product is the ratio itself, so
//   the 2 pi i branch cut of ln psi drops out. Its sites go in groups of 4
//   and one reduce-scatter of complex products over the walker's lanes
//   leaves each site's on a quarter of them. No exp, sincos, log or atan2 per unit or per site:
//   the powers of two are bit arithmetic on the exponent field.
// An accepted flip moves the state to (c_j, u_j G_ij) brought into [1, 2) in
// its larger part by a power of two, whose exponents turn the lane's
// numerator into its carried denominator, and lists the flip; at the end of
// the sweep y -= 2 s w runs over the list in its order with the fused
// multiply-adds of sweep.cu (y stays the plain version's to the bit where
// the decisions agree), the rows of w loading independently of each other,
// off the proposals' chain. The state is renewed from y at the start and
// after every sweep of n_sites rounds (so the drift of the carried state
// spans one sweep, and the energy phase reads a fresh one) by the
// non-inlined unit_state (the library's expf, expm1f and sincosf, and for
// the swap phases logf).
//
// Range: float32 holds e^{4 * 20} < 2^127, so the table covers |Re w| <= 20
// (ops/engine.py::F32_MAX_RE_W; the wrapper refuses larger weights). Within
// it a factor |c + u G| stays below 2^118, but its |.|^2 or two such factors
// multiplied can leave the float32 range both ways. So the wrapper passes
// the weights' range class: up to |Re w| = 5 (F32_PAIR_RE_W, every recorded
// run: they reach 0.505) a factor's |.|^2 stays below 2^62 and the factors
// multiply in pairs, each pair's product brought into [1, 2) by its power
// of two, as the float64 sweep takes them; above it every factor is brought
// into [1, 2) in its larger part by its own power of two before it is
// squared or multiplied. The class is one uniform branch per proposal and
// per site. The renewal keeps subnormal e^{-2|x|} (no flush to zero), so a
// large |Re y| loses nothing the float32 result could show.
//
// Layout: L lanes per walker, lane l on the hidden units j = l + L r, r < R,
// tail lanes at u = 0, c = 1 (a factor of exactly 1): L = 32 (one warp, R =
// ceil(H/32)), and at n_beta = 1 up to H = 128 L = 16 (two walkers a warp, R
// = 2 ceil(H/32)), whose butterflies take one level less for two walkers at
// once; the state in registers; y, the spins, the list of a sweep's flips,
// the per-site factors and the schedule in shared memory; the G row of a
// proposal or site (8 bytes a unit) through L1.

#include "rbm.cuh"

namespace {

using nqs::SweepArgs;
using nqs::kFull;

constexpr int kSiteGroup = 4;  // sites of one pass of the energy phase's loop (its reduce-scatter's)
constexpr int kNarrowR = 4;  // up to ceil(H/32) = 4 (H = 128) the n_beta = 1 instances take 16 lanes a walker

// The register cap (blocks of 8 warps at n_beta = 1, 16 tempered; rbm.cuh
// min_blocks), the fastest of 64, 85 and 128 at H = 64, 256 and 512 and
// n_beta = 1 and 8 (PERF.md): 64 for the tempered instances up to R = 8 (2
// blocks, 32 warps an SM) and the 16-lane ones up to H = 64 (4 blocks), 85
// for the other n_beta = 1 instances up to R = 8 (3 blocks, 24 warps), else
// 128 (16 warps).
constexpr int regs_cap(int L, int R, bool T) { return R > 8 ? 128 : T || (L == 16 && R <= 4) ? 64 : 85; }

// Hidden unit of lane `lane` (of L a walker) in word r, and whether it
// exists: an instance of R words serves H above L (R - 32 / L) (its last
// word of 32 units), so every word before the last 32 / L is full and once
// the loops over r are unrolled only those test against H.
template <int L>
__device__ __forceinline__ int unit(int r, int lane) { return r * L + lane; }

template <int L, int R>
__device__ __forceinline__ bool in_row(int r, int lane, int H) { return r < R - 32 / L || unit<L>(r, lane) < H; }

// The exponent field of a float >= 0 as bits (e << 23).
__device__ __forceinline__ unsigned exponent_bits(float a) { return __float_as_uint(a) & 0x7f800000u; }

// 2^(127 - e) for exponent bits e << 23, e <= 253 (e = 0, a zero or subnormal: 2^127).
__device__ __forceinline__ float down_scale(unsigned eb) { return __uint_as_float(0x7f000000u - eb); }

// 2^d for -126 <= d <= 127 (exact).
__device__ __forceinline__ float pow2i(int d) { return __uint_as_float(static_cast<unsigned>(d + 127) << 23); }

// x 2^d for any d: the product of two powers of two in the normal range, so
// that |d| up to 252 scales exactly and beyond it the result is 0 or inf.
__device__ __forceinline__ float scale2(float x, int d) {
  d = min(max(d, -252), 254);
  const int h = d / 2;
  return x * pow2i(h) * pow2i(d - h);
}

// z >= 0 as z' 2^k with z' in [1, 2) (0 stays 0); returns k.
__device__ __forceinline__ int renorm(float& z) {
  const unsigned eb = exponent_bits(z);
  z *= down_scale(eb);
  return static_cast<int>(eb >> 23) - 127;
}

// (x, y) brought into [1, 2) in its larger part by 2^(127 - e); returns e << 23.
__device__ __forceinline__ unsigned renorm_pair(float& x, float& y) {
  const unsigned eb = exponent_bits(fmaxf(fabsf(x), fabsf(y)));
  const float r = down_scale(eb);
  x *= r;
  y *= r;
  return eb;
}

// A complex number with its power of two.
struct CE {
  float x, y;
  int e;
};

__device__ __forceinline__ CE cmul(const CE& a, const CE& b) {
  return {fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x), a.e + b.e};
}

__device__ __forceinline__ CE shfl_xor(const CE& v, int off) {
  return {__shfl_xor_sync(kFull, v.x, off), __shfl_xor_sync(kFull, v.y, off), __shfl_xor_sync(kFull, v.e, off)};
}

// b ? p : q field by field, so that the values stay in registers (a select of
// one of two array elements by reference would put the array in local memory).
__device__ __forceinline__ CE select(bool b, const CE& p, const CE& q) {
  return {b ? p.x : q.x, b ? p.y : q.y, b ? p.e : q.e};
}

// The product over a walker's L lanes of the kSiteGroup = 4 complex values
// v, scattered: on return lane l holds the product of value site_of(l) =
// (l / (L/4)) & 3 over the L lanes. Two halving exchanges (each lane keeps
// half of its values and sends the other half to its partner: 2 + 1 values)
// and a butterfly over the remaining lane bits: at L = 32 6 complex
// multiplies and 18 shuffles, against 20 and 60 for four butterflies.
template <int L>
__device__ __forceinline__ int site_of(int lane) { return (lane / (L / 4)) & 3; }

template <int L>
__device__ __forceinline__ CE reduce_scatter4(const CE (&v)[kSiteGroup], int lane) {
  const bool hi = lane & (L / 2), lo = lane & (L / 4);
  CE u[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) u[q] = cmul(select(hi, v[q + 2], v[q]), shfl_xor(select(hi, v[q], v[q + 2]), L / 2));
  CE w = cmul(select(lo, u[1], u[0]), shfl_xor(select(lo, u[0], u[1]), L / 4));
#pragma unroll
  for (int off = L / 8; off > 0; off >>= 1) w = cmul(w, shfl_xor(w, off));
  return w;
}

// The sum over a walker's L lanes (the value on its first lane is the one used).
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The flip uniforms of one walker: rbm.cuh's FlipDraws at L = 32; at L = 16
// in the Philox mode lane l of the walker's 16 holds the words of counter
// block base + l (64 rounds an evaluation), round t's read from lane (t / 4)
// % 16 of the walker's. Both walkers of a warp draw at the same rounds.
template <int L>
struct Draws : nqs::FlipDraws {
  using nqs::FlipDraws::FlipDraws;

  __device__ __forceinline__ float operator()(const SweepArgs& p, int t, int row, int lane) {
    if constexpr (L == 32) {
      return nqs::FlipDraws::operator()(p, t, row, lane);
    } else {
      if (p.u) return __ldg(p.u + (size_t)t * p.K + row);
      const int blk = t >> 2;
      if ((blk & ~(L - 1)) != base) {
        base = blk & ~(L - 1);
        const uint4 ctr = make_uint4(static_cast<unsigned>(base + lane), static_cast<unsigned>(p.row0 + row), 0u, 0u);
        bits = nqs::philox4x32_10(ctr, key);
      }
      return nqs::bits_uniform(__shfl_sync(kFull, nqs::word(bits, t & 3), blk & (L - 1), L));
    }
  }
};

// One unit's renewed state from y = x + iv: u = e^{-2 max(x, 0)} e^{-2iv},
// c = e^{-2 max(-x, 0)}, D = c + u taken as (p + iq) e^{-iv} from the stable
// split planes p = (1 + e) cos v, q = (1 - e) sin v sgn x (e = e^{-2|x|},
// 1 - e by expm1f, so that D keeps its relative precision near a zero of
// cosh), |D|^2 = p^2 + q^2 (the plain log-cosh's sum of squares), and with
// logs Re ln cosh y = 0.5 ln |D|^2 + |x| - ln 2. Not inlined: a renewal runs
// once a sweep, and inlined copies of the library's expf, expm1f, sincosf and
// logf in every instance would lengthen the build far more than the calls
// cost.
struct UnitState {
  float ur, ui, c, dx, dy, d2, lnc;
};

static __device__ __noinline__ UnitState unit_state(float x, float v, bool logs) {
  const float ax = fabsf(x), e = expf(-2.0f * ax);
  float sv, cv;
  sincosf(v, &sv, &cv);
  const bool pos = x >= 0.0f;
  const float us = pos ? e : 1.0f, ome = -expm1f(-2.0f * ax);
  const float p = (1.0f + e) * cv, q = (pos ? ome : -ome) * sv;
  UnitState o;
  o.ur = us * ((cv - sv) * (cv + sv));
  o.ui = -us * (2.0f * sv * cv);
  o.c = pos ? 1.0f : e;
  o.dx = fmaf(p, cv, q * sv);
  o.dy = fmaf(q, cv, -(p * sv));
  o.d2 = fmaf(p, p, q * q);
  o.lnc = logs ? fmaf(0.5f, logf(o.d2), ax - nqs::kLn2) : 0.0f;
  return o;
}

// A lane's share of one walker: the factor state (u_j, c_j) of its R units
// in registers, the product of their |D_j|^2 = dm 2^de, and the walker's
// product over its L lanes of their dm, zd 2^kd (every lane the same bits);
// y stays in shared memory. A unit past H stays at u = 0, c = 1.
template <int L, int R>
struct Walker {
  float ur[R], ui[R], c[R];
  float dm, zd;
  int de, kd;
  CE dinv;  // after a renewal: 1 / prod_j D_j over the walker, the energy phase's

  // The state afresh from y (the walker's row in shared memory); returns the
  // lane's share of sum_j Re ln cosh y_j when Ln (the swap phases read it).
  template <bool Ln>
  __device__ __forceinline__ float renew(const float2* s_y, int H, int lane) {
    float ln = 0.0f, d2 = 1.0f;
    int e2 = 0;
    CE d{1.0f, 0.0f, 0};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ur[r] = ui[r] = 0.0f;
      c[r] = 1.0f;
      if (!in_row<L, R>(r, lane, H)) continue;
      const float2 yv = s_y[unit<L>(r, lane)];
      const UnitState us = unit_state(yv.x, yv.y, Ln);
      ur[r] = us.ur;
      ui[r] = us.ui;
      c[r] = us.c;
      if (Ln) ln += us.lnc;
      float q = us.d2;
      e2 += renorm(q);
      d2 *= q;  // factors in [1, 2): below 2^16
      CE f{us.dx, us.dy, 0};
      f.e = static_cast<int>(renorm_pair(f.x, f.y) >> 23) - 127;
      d = cmul(d, f);  // factors below 2^1.5 in modulus: below 2^24
    }
    dm = d2;
    de = e2 + renorm(dm);
    zd = dm;
    d.e += static_cast<int>(renorm_pair(d.x, d.y) >> 23) - 127;
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      zd *= __shfl_xor_sync(kFull, zd, off);  // factors in [1, 2): below 2^32
      d = cmul(d, shfl_xor(d, off));
    }
    kd = renorm(zd);
    d.e += static_cast<int>(renorm_pair(d.x, d.y) >> 23) - 127;
    const float inv = 1.0f / fmaf(d.x, d.x, d.y * d.y);
    dinv = CE{d.x * inv, -d.y * inv, -d.e};
    return ln;
  }

  // c_j + u_j G_ij of unit r over the G row `grow` (1 for a unit past H).
  __device__ __forceinline__ float2 factor(const float2* __restrict__ grow, int r, int H, int lane) const {
    const float2 gv = in_row<L, R>(r, lane, H) ? __ldg(grow + L * r) : make_float2(0.0f, 0.0f);
    return make_float2(fmaf(ur[r], gv.x, fmaf(-ui[r], gv.y, c[r])), fmaf(ur[r], gv.y, ui[r] * gv.x));
  }

  // One proposal over the row `grow` of G: the lane's prod_j |c_j + u_j
  // G_ij|^2 as p 2^pe, p in [1, 2), and the walker's |psi'/psi|^2 without
  // its per-site factor as zn / zd 2^x, zn in [1, 2) (every lane the same
  // bits).
  // Narrow (every |Re w| <= 5): the factors' |.|^2 multiplied in pairs, each
  // pair's product into [1, 2) by its power of two; else each factor into
  // [1, 2) in its larger part before it is squared. The butterfly multiplies
  // the lanes' numerators and sums their exponents less the denominators'.
  __device__ __forceinline__ void propose(const float2* __restrict__ grow, int H, int lane, bool narrow, float& p,
                                          int& pe, float& zn, int& kn, int& x) const {
    p = 1.0f;
    pe = 0;
    if (narrow) {
#pragma unroll
      for (int r = 0; r < R; r += 2) {
        const float2 ma = factor(grow, r, H, lane);
        const float2 mb = r + 1 < R ? factor(grow, r + 1, H, lane) : make_float2(1.0f, 0.0f);
        p *= fmaf(ma.x, ma.x, ma.y * ma.y) * fmaf(mb.x, mb.x, mb.y * mb.y);  // below 2^123
        pe += renorm(p);
      }
    } else {
      int ex = 0;  // sum of the units' exponents e
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float2 m = factor(grow, r, H, lane);
        ex += renorm_pair(m.x, m.y) >> 23;
        p *= fmaf(m.x, m.x, m.y * m.y);  // factors in [1, 8): below 2^48
      }
      pe = renorm(p) + 2 * (ex - R * 127);
    }
    zn = p;
    x = pe - de;
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      zn *= __shfl_xor_sync(kFull, zn, off);  // factors in [1, 2): below 2^32
      x += __shfl_xor_sync(kFull, x, off);
    }
    kn = renorm(zn);  // prod over the lanes of p = zn 2^kn
    x += kn - kd;
  }

  // An accepted flip: the state to (c_j, u_j G_ij) (the G row read again,
  // from L1) brought into [1, 2) in its larger part by 2^(127 - b_j), the
  // lane's product of |D_j|^2 to its proposal's p 2^pe times
  // 2^(-2 sum_j (b_j - 127)), and the walker's product of the lanes' dm to
  // the proposal's zn. y moves later (apply_flips).
  __device__ __forceinline__ void accept(const float2* __restrict__ grow, int H, int lane, float p, int pe, float zn,
                                         int kn) {
    int bx = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 gv = in_row<L, R>(r, lane, H) ? __ldg(grow + L * r) : make_float2(0.0f, 0.0f);
      const float nx = fmaf(ur[r], gv.x, -(ui[r] * gv.y)), ny = fmaf(ur[r], gv.y, ui[r] * gv.x);
      const unsigned eb = exponent_bits(fmaxf(c[r], fmaxf(fabsf(nx), fabsf(ny))));
      const float down = down_scale(eb);
      ur[r] = nx * down;
      ui[r] = ny * down;
      c[r] *= down;
      bx += static_cast<int>(eb >> 23);
    }
    dm = p;
    de = pe - 2 * (bx - R * 127);
    zd = zn;
    kd = kn;
  }
};

// y -= 2 s w and sa -= 2 s a for the n accepted flips of a sweep in their
// order (list: site << 1 | (s < 0)), with the fused multiply-adds of sweep.cu,
// so that y stays the plain version's to the bit; the flips' rows of w load
// independently of each other, off the proposals' chain.
template <int L, int R>
__device__ __forceinline__ void apply_flips(float2* s_y, const int* list, int n, const float2* __restrict__ w,
                                            const float2* __restrict__ a, int H, int lane, float2& sa) {
  float yr[R], yi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 v = in_row<L, R>(r, lane, H) ? s_y[unit<L>(r, lane)] : make_float2(0.0f, 0.0f);
    yr[r] = v.x;
    yi[r] = v.y;
  }
  for (int q = 0; q < n; ++q) {
    const int f = list[q];
    const float two_s = f & 1 ? -2.0f : 2.0f;
    const float2* wrow = w + (size_t)(f >> 1) * H + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 wv = in_row<L, R>(r, lane, H) ? __ldg(wrow + L * r) : make_float2(0.0f, 0.0f);
      yr[r] = fmaf(-two_s, wv.x, yr[r]);
      yi[r] = fmaf(-two_s, wv.y, yi[r]);
    }
    const float2 av = __ldg(a + (f >> 1));
    sa.x -= two_s * av.x;
    sa.y -= two_s * av.y;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (in_row<L, R>(r, lane, H)) s_y[unit<L>(r, lane)] = make_float2(yr[r], yi[r]);
  }
}

// Shared memory of a block of G walkers: the per-site factors (N, 2) as
// float4 (Re m, Im m, |m|^2, k) of e^{-2 s a'_i} = m 2^k; each walker's y
// (H); its spins; two buffers of Re ln psi per walker row (one per swap
// parity); the per-row counts of accepted flips and of accepted swaps as the
// lower member; the schedule; each walker's list of a sweep's accepted flips.
size_t smem_bytes(int G, int N, int H, int n_sites) {
  return sizeof(float4) * 2 * (size_t)N + sizeof(float2) * (size_t)G * H +
         sizeof(float) * ((size_t)G * N + 2 * (size_t)G) + sizeof(int) * (2 * (size_t)G + n_sites + (size_t)G * n_sites);
}

template <int L, int R, bool T>
__global__ void __launch_bounds__(32 * nqs::sweep_block_warps(T),
                                  nqs::min_blocks(regs_cap(L, R, T), nqs::sweep_block_warps(T)))
sweep_energy_kernel(SweepArgs p, const float2* __restrict__ g, const float4* __restrict__ site_tab,
                    const float* __restrict__ spins_in, const float2* __restrict__ y_in,
                    const float2* __restrict__ sa_in, float* __restrict__ spins_out, float2* __restrict__ y_out,
                    float2* __restrict__ sa_out, int* __restrict__ flip_out, int* __restrict__ swap_out,
                    float2* __restrict__ out, bool narrow) {
  static_assert(L == 32 || !T, "a tempered block keeps one warp a walker row (rbm.cuh swap_phase)");
  extern __shared__ __align__(16) float4 smem4[];
  const int G = blockDim.x / L;  // walkers of the block
  const int lane = threadIdx.x & (L - 1);  // the lane among its walker's L
  const int slot = threadIdx.x / L;
  const int base = blockIdx.x * G;
  const int k = base + slot;
  // uniform over the warp: whether its first walker exists (a warp past K passes the barriers)
  const bool active = base + (threadIdx.x >> 5) * (32 / L) < p.K;
  // a walker past K in the warp of one that exists (L = 16) runs on the last
  // walker's inputs, since the warp's shuffles take both, and writes nothing
  const bool live = k < p.K;
  const int H = p.H, N = p.N;
  float4* s_site = smem4;
  float2* s_ys = reinterpret_cast<float2*>(s_site + 2 * N);
  float2* s_y = s_ys + (size_t)slot * H;
  float* sp = reinterpret_cast<float*>(s_ys + (size_t)G * H) + (size_t)slot * N;
  float* s_ln = reinterpret_cast<float*>(s_ys + (size_t)G * H) + (size_t)G * N;
  int* s_flip = reinterpret_cast<int*>(s_ln + 2 * G);
  int* s_swap = s_flip + G;
  int* s_sched = s_swap + G;
  int* s_list = s_sched + p.n_sites + (size_t)slot * p.n_sites;

  if (lane == 0) {
    s_flip[slot] = 0;
    s_swap[slot] = 0;
  }
  for (int n = threadIdx.x; n < 2 * N; n += blockDim.x) s_site[n] = site_tab[n];
  for (int i = threadIdx.x; i < p.n_sites; i += blockDim.x) s_sched[i] = p.sched[i];
  Walker<L, R> st;
  float2 sa = make_float2(0.0f, 0.0f);
  int row = live ? k : p.K - 1;  // T: the walker's row, which the swap phases change
  if (active) {
    for (int i = lane; i < N; i += L) sp[i] = spins_in[(size_t)row * N + i];
    for (int j = lane; j < H; j += L) s_y[j] = y_in[(size_t)row * H + j];
    sa = sa_in[row];
  }
  __syncthreads();
  if (active) st.template renew<false>(s_y, H, lane);

  Draws<L> draws(p);
  // passes of the schedule (for T = false the last one maybe partial), each
  // ending with a renewal of the state; T ends each with the swap phases
  const int n_pass = (p.n_steps + p.n_sites - 1) / p.n_sites;
  int t = 0;
  for (int s = 0; s < n_pass; ++s) {
    // 1 / beta of the row: a tempered proposal is accepted when u^{1/beta} < |psi'/psi|^2
    const float inv_beta = T ? static_cast<float>(p.n_beta) / static_cast<float>(p.n_beta - row % p.n_beta) : 1.0f;
    if (active && (T || s == 0)) draws.restart();  // the rows of a tempered block change between sweeps
    int acc = 0;
    const int rounds = min(p.n_sites, p.n_steps - t);
    // each round's uniform is loaded (or drawn) a round ahead, off its chain
    float u_next = active && rounds > 0 ? draws(p, t, row, lane) : 0.0f;
    for (int ts = 0; ts < rounds; ++ts, ++t) {
      if (!active) continue;
      const float u = u_next;
      if (ts + 1 < rounds) u_next = draws(p, t + 1, row, lane);
      const int site = s_sched[ts];
      const float spin = sp[site];
      const float two_s = 2.0f * spin;
      const int sign = spin < 0.0f ? 1 : 0;
      const float2* grow = g + ((size_t)site * 2 + sign) * H + lane;
      float pl, zn;
      int pe, kn, x;
      st.propose(grow, H, lane, narrow, pl, pe, zn, kn, x);
      // |psi'/psi|^2 = |m|^2 2^{2k} zn / zd 2^x = a 2^d / zd, a in [1, 2)
      const float4 f = s_site[2 * site + sign];
      const float zd = st.zd;
      float a = f.z * zn;
      const int d = renorm(a) + 2 * __float2int_rn(f.w) + x;
      bool accept;
      if constexpr (T) {
        accept = a > 0.0f && (d >= 1 || nqs::lg2_fast(u) * inv_beta < nqs::lg2_fast(a) - nqs::lg2_fast(zd) +
                                                                              static_cast<float>(d));
      } else {
        accept = a > 0.0f && (d >= 1 || (d > -126 ? u * zd < a * pow2i(d) : u == 0.0f));
      }
      if (accept) {
        st.accept(grow, H, lane, pl, pe, zn, kn);
        if (lane == 0) s_list[acc] = site << 1 | sign;
        ++acc;
      }
      __syncwarp();
      if (accept && lane == 0) sp[site] = -spin;
      __syncwarp();
    }
    if (live && lane == 0) s_flip[row - base] += acc;
    float ln0 = 0.0f;
    if (active) {
      apply_flips<L, R>(s_y, s_list, acc, p.w, p.a, H, lane, sa);
      __syncwarp();
      const float l = st.template renew<T>(s_y, H, lane);
      if (T) ln0 = nqs::warp_allsum(l) + sa.x;
    }
    if constexpr (T) {
      if (p.n_beta > 1) {
        nqs::swap_phase<R>(p, draws, active, base, s, 0, row, ln0, s_ln, s_swap);
        nqs::swap_phase<R>(p, draws, active, base, s, 1, row, ln0, s_ln + G, s_swap);
      }
    }
  }

  if (active) {
    if (live) {
      for (int j = lane; j < H; j += L) y_out[(size_t)row * H + j] = s_y[j];
      for (int i = lane; i < N; i += L) spins_out[(size_t)row * N + i] = sp[i];
    }
    // the off-diagonal sum on the renewed state: site i's term e^{-2 s a'_i}
    // prod_j (c_j + u_j G_ij) / prod_j D_j, each lane taking the sites of
    // its reduce-scatter slot
    float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll 1
    for (int i0 = 0; i0 < N; i0 += kSiteGroup) {
      CE part[kSiteGroup];
#pragma unroll
      for (int gq = 0; gq < kSiteGroup; ++gq) {
        part[gq] = CE{1.0f, 0.0f, 0};
        const int i = i0 + gq;
        if (i >= N) continue;  // uniform over the warp
        const int sign = sp[i] < 0.0f ? 1 : 0;
        const float2* grow = g + ((size_t)i * 2 + sign) * H + lane;
        CE pr{1.0f, 0.0f, 0};
        if (narrow) {  // the factors in pairs; each pair's product (below 2^63) into the product, into [1, 2)
#pragma unroll
          for (int r = 0; r < R; r += 2) {
            const float2 ma = st.factor(grow, r, H, lane);
            const float2 mb = r + 1 < R ? st.factor(grow, r + 1, H, lane) : make_float2(1.0f, 0.0f);
            const float qx = fmaf(ma.x, mb.x, -(ma.y * mb.y)), qy = fmaf(ma.x, mb.y, ma.y * mb.x);
            const float t2 = fmaf(pr.x, qx, -(pr.y * qy));
            pr.y = fmaf(pr.x, qy, pr.y * qx);
            pr.x = t2;
            pr.e += static_cast<int>(renorm_pair(pr.x, pr.y) >> 23) - 127;
          }
        } else {  // each factor into [1, 2) in its larger part before it is multiplied
          int ex = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float2 m = st.factor(grow, r, H, lane);
            ex += renorm_pair(m.x, m.y) >> 23;
            const float t2 = fmaf(pr.x, m.x, -(pr.y * m.y));  // factors below 2^1.5 in modulus: below 2^24
            pr.y = fmaf(pr.x, m.y, pr.y * m.x);
            pr.x = t2;
          }
          pr.e = ex - R * 127 + static_cast<int>(renorm_pair(pr.x, pr.y) >> 23) - 127;
        }
        part[gq] = pr;
      }
      const CE tot = reduce_scatter4<L>(part, lane);  // factors below 2^1.5 in modulus: below 2^48
      const int i = i0 + site_of<L>(lane);
      if ((lane & (L / 4 - 1)) == 0 && i < N) {
        const float4 f = s_site[2 * i + (sp[i] < 0.0f ? 1 : 0)];
        const CE term = cmul(cmul(CE{f.x, f.y, __float2int_rn(f.w)}, tot), st.dinv);
        acc.x += scale2(term.x, term.e);
        acc.y += scale2(term.y, term.e);
      }
    }
    acc.x = group_sum<L>(acc.x);
    acc.y = group_sum<L>(acc.y);
    if (live && lane == 0) {
      sa_out[row] = sa;
      out[row] = acc;
    }
  }
  __syncthreads();
  if (live && lane == 0) {
    flip_out[k] = s_flip[slot];
    swap_out[k] = s_swap[slot];
  }
}

template <int L, int R, bool T>
cudaError_t launch(const SweepArgs& p, const float2* g, const float4* site_tab, const float* spins_in,
                   const float2* y_in, const float2* sa_in, float* spins_out, float2* y_out, float2* sa_out,
                   int* flip_out, int* swap_out, float2* out, bool narrow, cudaStream_t stream) {
  const int warps = nqs::sweep_warps(p.n_beta);
  const int G = warps * 32 / L;  // walkers a block
  const dim3 grid((p.K + G - 1) / G);
  const size_t smem = smem_bytes(G, p.N, p.H, p.n_sites);
  if (smem > 232448) return cudaErrorInvalidValue;  // the shared memory a block can use on an H100
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sweep_energy_kernel<L, R, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sweep_energy_kernel<L, R, T><<<grid, 32 * warps, smem, stream>>>(p, g, site_tab, spins_in, y_in, sa_in, spins_out,
                                                                   y_out, sa_out, flip_out, swap_out, out, narrow);
  return cudaGetLastError();
}

// The instance of H: at n_beta = 1 up to ceil(H/32) = kNarrowR 16 lanes a
// walker with twice the words, else one warp a walker.
template <bool T>
cudaError_t dispatch(const SweepArgs& p, const void* g, const void* site_tab, const void* spins_in, const void* y_in,
                     const void* sa_in, void* spins_out, void* y_out, void* sa_out, void* flip_out, void* swap_out,
                     void* out, bool narrow, void* stream) {
#define NQS_SWEEP_ENERGY_LAUNCH(L, R)                                                                         \
  launch<L, R, T>(p, static_cast<const float2*>(g), static_cast<const float4*>(site_tab),                    \
                  static_cast<const float*>(spins_in), static_cast<const float2*>(y_in),                      \
                  static_cast<const float2*>(sa_in), static_cast<float*>(spins_out), static_cast<float2*>(y_out), \
                  static_cast<float2*>(sa_out), static_cast<int*>(flip_out), static_cast<int*>(swap_out),       \
                  static_cast<float2*>(out), narrow, static_cast<cudaStream_t>(stream))
#define NQS_SWEEP_ENERGY_CASE(R)                  \
  case R:                                         \
    if constexpr (!T && R <= kNarrowR) {          \
      return NQS_SWEEP_ENERGY_LAUNCH(16, 2 * R);  \
    } else {                                      \
      return NQS_SWEEP_ENERGY_LAUNCH(32, R);      \
    }
  switch ((p.H + 31) / 32) {
    NQS_FOR_EACH_R(NQS_SWEEP_ENERGY_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_SWEEP_ENERGY_CASE
#undef NQS_SWEEP_ENERGY_LAUNCH
}

}  // namespace

// The arguments of nqs_sweep_f32 (sweep.cu) without its table, then the table
// of ops/engine.py::sweep_table_f32: g (N, 2, H) complex, e^{4 s w} for
// s = +1 and -1, and site (N, 2, 4) floats (Re m, Im m, |m|^2, k) with
// e^{-2 s (a_i + sum_j w_ij)} = m 2^k; and out (K,) complex, the off-diagonal
// sum of each row's post-sweep state; after the stream narrow, non-zero where
// every |Re w| <= 5 (ops/engine.py F32_PAIR_RE_W), so that the factors
// multiply in pairs. c must be null (the RBM family).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int nqs_sweep_offdiag_f32(const void* w, const void* a, const void* c, const void* spins_in,
                                     const void* y_in, const void* sa_in, const void* sched, const void* u,
                                     const void* u_swap, const void* key, void* spins_out, void* y_out,
                                     void* sa_out, void* flip_out, void* swap_out, const void* g, const void* site,
                                     void* out, int K, int N, int H, int n_sites, int n_steps, int n_beta,
                                     void* stream, int narrow) {
  if (K <= 0 || N <= 0 || n_sites <= 0 || n_steps <= 0 || H < 1 || H > 32 * nqs::kMaxR ||
      nqs::sweep_warps(n_beta) == 0 || K % n_beta != 0 || c != nullptr || g == nullptr || site == nullptr)
    return cudaErrorInvalidValue;
  if (n_beta > 1 && n_steps % n_sites != 0) return cudaErrorInvalidValue;
  if (u == nullptr ? key == nullptr : n_beta > 1 && u_swap == nullptr) return cudaErrorInvalidValue;
  const SweepArgs p{static_cast<const float2*>(w), static_cast<const float2*>(a), static_cast<const int*>(sched),
                    static_cast<const float*>(u), static_cast<const float*>(u_swap),
                    static_cast<const long long*>(key), nullptr, K, N, H, n_sites, n_steps, n_beta};
#define NQS_SWEEP_ENERGY_ARGS \
  p, g, site, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out, swap_out, out, narrow != 0, stream
  return n_beta > 1 ? dispatch<true>(NQS_SWEEP_ENERGY_ARGS) : dispatch<false>(NQS_SWEEP_ENERGY_ARGS);
#undef NQS_SWEEP_ENERGY_ARGS
}
