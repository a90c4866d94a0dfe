// Kawasaki pair-exchange proposals for the log-cosh machines, float64,
// Hopper, untempered and tempered (n_beta <= 16): the float64 instances of
// the exchange kernel. exchange_f64.cu instantiates the n_beta = 1 instances
// (T = false) and exchange_f64_tempered.cu the tempered ones (T = true),
// each its own translation unit, so that nvcc builds the two halves in
// parallel.
//
// Replaces, for float64 machines, what the JAX package computes in XLA
// (sampler/kawasaki.py::_exchange_scan and tempered_exchange_sweeps: its
// TPU kernel neural_network_quantum_state_tpu/ops/pallas_exchange.py
// ::_exchange_kernel is float32 only). The same computation as the float32
// instances (exchange.cuh) in double: per walker, n_steps proposals, each
// picking the (target+1)-th active (anti-aligned) bond with target =
// min(floor(u_sel * nb), nb - 1), flipping both ends, y' = y - 2 s_i w_i -
// 2 s_k w_k, accepted when u_acc < exp(2 beta min(dln, 0)) and nb > 0; for
// n_beta > 1 (rows replica-minor) each sweep of n_unit proposals is followed
// by the even- and the odd-pair swap phase. The uniforms are the caller's
// (float64) or the kernel's own Philox4x32-10 streams on a key, the float32
// numbers of the float32 instances widened to double; as in the plain
// version, the selection product u_sel * nb is then taken in float32 (the
// stream's dtype), in double on the caller's uniforms. Both make the same
// decisions.
//
// The form (the float64 sweep's, sweep_f64.cu, carried to a pair flip): for
// the active bond (i, k), s = s_i = -s_k and d_j = w_ij - w_kj,
//
//     cosh(y_j - 2 s d_j) / cosh(y_j) = e^{-2 s d_j} (c_j + u_j E_j) / D_j,
//
// E_j = e^{4 s d_j} from a table per bond and sign
// (ops/engine.py::exchange_table_f64, (bond, sign, unit), built once per
// weight and bond tensor: one 16-byte row a proposal, where the product of
// two rows of the sweep's per-site table took a second row and a complex
// multiply per element, 17-28% of the time without c, PERF.md); u_j, c_j,
// D_j = c_j + u_j the walker's state of unit j, as in the sweep. RBM family
// (C = false): |psi'/psi|^2 = e^{-4 s Re(a'_i - a'_k)} prod_j |c_j + u_j
// E_j|^2 / |D_j|^2, a' the per-site term of ops/engine.py::_site_term: per
// element one complex multiply-add, |.|^2, its own power of two (each
// factor, not each pair: |E_j| reaches e^{4 (|Re w_ij| + |Re w_kj|)}, so a
// pair of factors would leave the double range below |Re w| = 43) and the
// lane's product; the lane multiplies in its carried inverse of prod_j
// |D_j|^2, the walker's G lanes multiply theirs by a butterfly, the two
// sites' factors e^{-4 s Re a'} = m 2^k (shared memory) follow, and the
// test is rbm_f64.cuh accept_ratio: an exact comparison of u 2^-k with the
// mantissa, a tempered row's u^{1/beta} by a float pre-test of the logs with
// the exact comparison as fallback. No log, exp or sincos per element or
// proposal. With c: Re(c_j Log cosh) does not factor, so each element
// takes ln|c_j + u_j E_j| and Arg(c_j + u_j E_j) (the library's log and
// atan2) and the flipped unit's principal phase wrap(v_j - 2 s Im d_j +
// Arg(.)) into [-pi, pi], as the sweep's instances with c.
//
// An accepted pair flip moves y_j -= 2 s_i w_ij + 2 s_k w_kj exactly as the
// plain version does (2 s is +-2, so y stays its to the bit), and the state
// (c_j, u_j) to (c_j, u_j E_j), brought into [1, 2) by a power of two whose
// exponents correct the carried product or sum. The state is renewed from y
// with the stable functions of rbm_f64.cuh (the non-inlined unit_state) at
// the start and after every sweep of n_unit proposals, so the drift of the
// carried state stays bounded by one sweep; the tempered swap phases read
// the Re ln psi of that renewal.
//
// Design: the float32 instances' dtype-free parts as they are (exchange.cuh):
// each walker's spins and active-bond mask as bit sets (Bits), updated from
// the site -> incident-bonds table after an accepted flip, the bond choice
// by popcounts (Bits::nth), the Philox draws (ExchangeDraws over the
// walker's G lanes), the bond tables staged per block (stage_bonds), the
// swap phases (exchange_swap_phase), one launch for a whole sampler call.
// G lanes per walker (lanes_f64: 16 at H <= 128, else 32; the float32
// instances' 8 at H <= 64 spilled the state of 8 units a lane at 128
// registers and measured slower, PERF.md); lane l of a walker keeps units
// j = u G + l, u < U = ceil(H / G), its state (u_j, c_j) in registers, y in
// the block's shared memory (16 H bytes a walker, read and written by the
// lane that owns the unit, so no barrier), the table's row and, on an
// accept or with c, the two rows of w through L1. Instances: (G, U, c,
// tempered) for the (G, U) that lanes_f64 reaches, and the RBM family's
// narrow tempered ones at G = 32 above U = 8; blocks of 8 warps at 128
// registers, 255 above U = 8 and for the narrow ones.
//
// Range: with u_j and c_j below 2 in each part, |c_j + u_j E_j|^2 < 8
// e^{8 (|Re w_ij| + |Re w_kj|)} < 2^1023 for |Re w| <= 43; ops/exchange.py
// refuses larger weights (ops/engine.py::check_f64_range).
//
// Bound on an H100: the double operations per (walker, proposal, hidden
// unit) the function needs, 11 in the RBM family (the multiply-add with the
// state's c real 7, |.|^2 3, the product 1) and 25 with c (the sweep's 24
// and the difference of the two rows' Im w), and 2 per (walker, proposal,
// bond), at the card's float64 rate outside the tensor cores (34 TFLOP/s),
// against 32 bytes of y per (walker, hidden unit) read and written once per
// call: bound by operations. This form's power of two per factor (12 an
// element) and the 16 bytes of the table's row per element read from L1
// are its own floors beside it (PERF.md).

#pragma once

#include "exchange.cuh"
#include "rbm_f64.cuh"

namespace {

namespace d = nqs::d;  // rbm_f64.cuh (exchange.cuh has float group_sum and term of its own)

constexpr int kRenormF64 = 4;  // factors |D_j|^2 of a renewal's product between renormalisations

// The fields of ExchangeArgs in double (exchange_args fills all but the
// table), then the table of ops/engine.py::exchange_table_f64.
struct ExchangeArgsF64 {
  const double2* w;
  const double2* a;
  const double2* c;
  const int* bonds;
  const int* inc_ptr;
  const int* inc_idx;
  const double* spins_in;
  const double2* y_in;
  const double2* sa_in;
  const double* u_sel;
  const double* u_acc;
  const double* u_swap;
  const long long* key;
  double* spins_out;
  double2* y_out;
  double2* sa_out;
  int* acc_out;
  int* swap_out;
  int K, N, H, B, n_steps;
  int n_unit, n_beta;  // proposals per sweep (the renewal's period), replicas
  int row0;
  const double2* e;       // (B, 2, H): e^{4 s (w_ij - w_kj)} of bond (i, k), s = s_i = +1 then -1
  const double2* a_site;  // (N,): a_i + sum_j w_ij, or with c a_i + sum_j c_j Re w_ij
};

// Byte offsets of a block's shared memory for `slots` walker slots: c (H,
// C = true) or the per-site factors (N, 2) as double2 (m, k), e^{-4 s Re
// a'_i} = m 2^k; the walkers' y (slots x H); for the tempered instances two
// Re ln psi buffers by row; the incidence rows (a uint4 per site), the
// bonds, the CSR table; the walkers' spin and mask words past kRegWords;
// the per-row counts (T).
struct LayoutF64 {
  size_t site, y, ln, rows, bonds, ptr, idx, ext, cnt, total;
  int ext_words;  // per walker
};

__host__ __device__ inline LayoutF64 layout_f64(int N, int H, int B, bool C, bool T, int slots) {
  LayoutF64 L;
  const int nsw = (N + 31) / 32, nw = (B + 31) / 32;
  L.ext_words = (nsw > kRegWords ? nsw - kRegWords : 0) + (nw > kRegWords ? nw - kRegWords : 0);
  L.site = 0;
  L.y = L.site + sizeof(double2) * (C ? (size_t)H : 2 * (size_t)N);
  L.ln = L.y + sizeof(double2) * (size_t)slots * H;
  L.rows = align16(L.ln + (T ? sizeof(double) * 2 * slots : 0));
  L.bonds = L.rows + sizeof(uint4) * N;
  L.ptr = L.bonds + sizeof(int) * 2 * B;
  L.idx = L.ptr + sizeof(int) * (N + 1);
  L.ext = L.idx + sizeof(int) * 2 * B;
  L.cnt = L.ext + sizeof(unsigned) * L.ext_words * slots;
  L.total = L.cnt + (T ? sizeof(int) * 2 * slots : 0);
  return L;
}

// Resident blocks per SM, which cap a thread's registers: two of 8 warps
// (128 registers) up to U = 8 units a lane, one above (255); the tempered
// blocks of 16 warps at G = 32 one (128).
__host__ __device__ constexpr int min_blocks_f64(int G, int U, bool T) {
  return (U > 8 ? 1 : 2) * kThreads / max_threads(G, T) > 0 ? (U > 8 ? 1 : 2) * kThreads / max_threads(G, T) : 1;
}

// The narrow tempered instances (Nw) of the RBM family above U = 8 units a
// lane at G = 32: blocks of at most 8 warps (n_beta <= 8) at 255 registers,
// where the 16-warp blocks' 128 registers spilled 552-1712 B and measured
// 1.8x slower at H = 384 (PERF.md); n_beta = 16 keeps the 16-warp ones.
__host__ __device__ constexpr bool narrow_f64(int G, int U, bool C, bool T) { return T && !C && G == 32 && U > 8; }
__host__ __device__ constexpr int threads_f64(int G, bool T, bool Nw) { return Nw ? kThreads : max_threads(G, T); }

// A lane's U hidden units j = u G + l of its walker: the state of each
// (u_j, c_j) and, over them, without c the product of |D_j|^2, carried as
// its inverse dm 2^de, with c the sum of c_j.x ln|D_j| - c_j.y Arg cosh y_j
// (q). A unit past H stays at u = 0, c = 1 and enters neither.
template <int G, int U, bool C>
struct Units {
  double2 u[U];
  double c[U];
  double q;
  double dm;
  int de;
  // the last proposal's product of |c_j + u_j E_j|^2, pm 2^pe (C = false),
  // or its sum of c_j.x ln|c_j + u_j E_j| - c_j.y Arg cosh y'_j (pm)
  double pm;
  int pe;

  // The state from y (the walker's row in shared memory, s_c its c) by the
  // stable functions of rbm_f64.cuh (unit_state); returns the lane's share
  // of sum_j Re(c_j ln cosh y_j) when Ln (the swap phases read it).
  template <bool Ln>
  __device__ __forceinline__ double renew(const double2* s_y, const double2* s_c, int H, int gl) {
    q = 0.0;
    double ln = 0.0, pd = 1.0;
    int ed = 0;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int j = r * G + gl;
      u[r] = make_double2(0.0, 0.0);
      c[r] = 1.0;
      if (r == U - 1 && j >= H) continue;  // only the last unit of a lane can lie past H
      const double2 yv = s_y[j];
      const d::UnitState us = d::unit_state(yv, C || Ln);
      u[r] = us.u;
      c[r] = us.c;
      const double lncosh = us.lnd + (fabs(yv.x) - d::kLn2);  // Re ln cosh y_j
      if constexpr (C) {
        const double2 cj = s_c[j];
        q += cj.x * us.lnd - cj.y * us.arg;
        if (Ln) ln += cj.x * lncosh - cj.y * us.arg;
      } else {
        pd *= us.d2;
        if (r % kRenormF64 == kRenormF64 - 1) d::renorm(pd, ed);
        if (Ln) ln += lncosh;
      }
    }
    if constexpr (!C) {
      d::renorm(pd, ed);
      dm = 1.0 / pd;
      de = -ed;
    }
    return ln;
  }

  // One proposal over the table's row er = E[bond, s] from the lane's first
  // unit (wi, wk: the rows of w, whose Im w the phase reads with c; t1 =
  // 2 s_i). Without c: the lane's product of |c_j + u_j E_j|^2
  // / |D_j|^2 as m 2^e with m in [1, 2) (pm 2^pe keeps the numerator), each
  // factor brought into [1, 2) by its power of two; with c: the lane's sum of
  // c_j.x (ln|c_j + u_j E_j| - ln|D_j|) - c_j.y (Arg cosh y'_j - Arg cosh
  // y_j), as m (e = 0).
  __device__ __forceinline__ double propose(const double2* er, const double2* wi, const double2* wk,
                                            const double2* s_y, const double2* s_c, double t1, int H, int gl,
                                            int& e_out) {
    double acc = 0.0, prod = 1.0;
    int ex = 0;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int j = r * G + gl;
      if (r == U - 1 && j >= H) continue;  // only the last unit of a lane can lie past H
      const double2 e = __ldg(er + r * G);
      const double mx = fma(u[r].x, e.x, fma(-u[r].y, e.y, c[r]));
      const double my = fma(u[r].x, e.y, u[r].y * e.x);
      double f = fma(mx, mx, my * my);
      if constexpr (C) {
        const double yy = s_y[j].y;
        const double dv = -t1 * (__ldg(&wi[r * G].y) - __ldg(&wk[r * G].y));
        double ph = (fma(-d::kTwoPi, rint(yy * d::kInvTwoPi), yy) + dv) + atan2(my, mx);
        ph = fma(-d::kTwoPi, rint(ph * d::kInvTwoPi), ph);  // the flipped unit's principal Arg cosh
        const double2 cj = s_c[j];
        acc = fma(cj.x, 0.5 * log(f), fma(-cj.y, ph, acc));
      } else {
        d::renorm_pair(f, ex);  // f < 2^1023 in the range
        prod *= f;
      }
    }
    if constexpr (C) {
      pm = acc;
      e_out = 0;
      return acc - q;
    } else {
      pm = prod;
      pe = ex;
      double z = prod * dm;
      e_out = ex + de;
      d::renorm(z, e_out);
      return z;
    }
  }

  // An accepted pair flip: y -= t1 w_i + t2 w_k exactly (t2 = -t1), the
  // state to (c_j, u_j E_j) brought into [1, 2) by a power of two, and the
  // carried product or sum to the proposal's, corrected by those powers.
  __device__ __forceinline__ void accept(double2* s_y, const double2* er, const double2* wi, const double2* wk,
                                         const double2* s_c, double t1, int H, int gl) {
    const double t2 = -t1;
    double shift = 0.0;  // C: sum_j c_j.x times the unit's exponent
    int eshift = 0;      // the units' exponents
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int j = r * G + gl;
      if (r == U - 1 && j >= H) continue;  // only the last unit of a lane can lie past H
      const double2 yv = s_y[j], w1 = __ldg(wi + r * G), w2 = __ldg(wk + r * G);
      s_y[j] = make_double2(yv.x - t1 * w1.x - t2 * w2.x, yv.y - t1 * w1.y - t2 * w2.y);
      const int b = d::move_state(u[r], c[r], __ldg(er + r * G));
      if constexpr (C) {
        shift = fma(s_c[j].x, static_cast<double>(b - 1023), shift);
      } else {
        eshift += b - 1023;
      }
    }
    if constexpr (C) {
      q = fma(-d::kLn2, shift, pm);  // ln|D'_j| = ln|c_j + u_j E_j| - (b_j - 1023) ln 2
    } else {
      dm = 1.0 / pm;  // |D'_j|^2 = |c_j + u_j E_j|^2 2^{-2 (b_j - 1023)}
      de = 2 * eshift - pe;
    }
  }
};

template <int G, int U, bool C, bool T, bool Nw>
__global__ void __launch_bounds__(threads_f64(G, T, Nw), Nw ? 1 : min_blocks_f64(G, U, T))
exchange_kernel_f64(const ExchangeArgsF64 p) {
  constexpr int P = 32 / G;  // walkers per warp
  // walkers per block: 8 warps' worth, or whole replica groups (T), in the
  // block's walker slots (T: a last warp may hold slots past the groups)
  const int wb = T ? block_walkers(G, true, p.n_beta) : kWarpsPerBlock * P;
  const int n_threads = T ? static_cast<int>(blockDim.x) : kThreads;
  const int slots = n_threads / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutF64 L = layout_f64(p.N, p.H, p.B, C, T, slots);
  double2* s_site = reinterpret_cast<double2*>(smem + L.site);  // C: c; else the per-site factors
  int* s_bonds = reinterpret_cast<int*>(smem + L.bonds);
  int* s_ptr = reinterpret_cast<int*>(smem + L.ptr);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx);
  uint4* s_rows = reinterpret_cast<uint4*>(smem + L.rows);
  double* s_ln = reinterpret_cast<double*>(smem + L.ln);  // T: two buffers of `slots`
  int* s_acc = reinterpret_cast<int*>(smem + L.cnt);      // T: accepted proposals by row
  int* s_swap = s_acc + slots;                            // T: accepted swaps by lower row
  const int tid = threadIdx.x;
  stage_bonds(p, tid, n_threads, s_bonds, s_idx, s_ptr, s_rows);
  if constexpr (C) {
    for (int e = tid; e < p.H; e += n_threads) s_site[e] = p.c[e];
  } else {
    for (int n = tid; n < 2 * p.N; n += n_threads) s_site[n] = d::exp_split((n & 1 ? 4.0 : -4.0) * p.a_site[n >> 1].x);
  }
  if constexpr (T) {
    for (int e = tid; e < slots; e += n_threads) s_acc[e] = s_swap[e] = 0;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = lane / G;   // the walker in the warp
  const int gl = lane % G;  // the lane in the walker
  const bool leader = gl == 0;
  const int first = blockIdx.x * wb;   // the block's first walker row
  const int kbase = first + warp * P;  // the warp's first walker row
  const int k = kbase + q;             // the walker's row (T: its first row)
  // a walker row of this block's groups: T blocks may hold idle slots past them
  const auto in_block = [&](int q2) { return (!T || warp * P + q2 < wb) && kbase + q2 < p.K; };
  const bool valid = in_block(q);
  const bool idle_warp = (T && warp * P >= wb) || kbase >= p.K;  // uniform over the warp
  if (!T && idle_warp) return;  // an idle warp past K; T's stay for the block's barriers
  const int N = p.N, H = p.H;
  const int nsw = (N + 31) / 32, nw = (p.B + 31) / 32;
  const int ext_s = nsw > kRegWords ? nsw - kRegWords : 0;
  const bool has_ext = L.ext_words > 0;  // uniform over the block
  unsigned* ext = reinterpret_cast<unsigned*>(smem + L.ext) + (size_t)(warp * P + q) * L.ext_words;
  double2* s_y = reinterpret_cast<double2*>(smem + L.y) + (size_t)(warp * P + q) * H;
  Bits spin{{}, ext, nsw};
  Bits act{{}, ext + ext_s, nw};

  // The spin words and the active-bond words of the warp's walkers, each from
  // one coalesced read and a ballot; the walker's lanes keep theirs.
  for (int m = 0; m < nsw; ++m) {
    const int i = m * 32 + lane;
    for (int q2 = 0; q2 < P; ++q2) {
      const bool up = in_block(q2) && i < N && p.spins_in[(size_t)(kbase + q2) * N + i] > 0.0;
      const unsigned v = __ballot_sync(kFull, up);
      if (q2 == q) spin.set_word(m, v, leader);
    }
  }
  for (int m = 0; m < nw; ++m) {
    const int b = m * 32 + lane;
    const int b0 = b < p.B ? s_bonds[2 * b] : 0;
    const int b1 = b < p.B ? s_bonds[2 * b + 1] : 0;
    for (int q2 = 0; q2 < P; ++q2) {
      const double* srow = p.spins_in + (size_t)(kbase + q2) * N;
      const bool on = b < p.B && in_block(q2) && srow[b0] * srow[b1] < 0.0;
      const unsigned v = __ballot_sync(kFull, on);
      if (q2 == q) act.set_word(m, v, leader);
    }
  }
  if (has_ext) __syncwarp();

  for (int j = gl; j < H; j += G) s_y[j] = valid ? p.y_in[(size_t)k * H + j] : make_double2(0.0, 0.0);
  double2 sa = valid ? p.sa_in[k] : make_double2(0.0, 0.0);
  Units<G, U, C> st;
  st.template renew<false>(s_y, s_site, H, gl);
  int nb = act.count();
  int acc = 0;
  int row = k;              // T: the row the walker holds, and with it its beta
  double scale = 2.0;       // 2 beta
  double inv_beta = 1.0;    // 1 / beta (the RBM family's test)
  ExchangeDraws<G, ExchangeArgsF64> draws(p);

  const auto proposals = [&](int t_begin, int t_end) {
    for (int t = t_begin; t < t_end; ++t) {
      double us, ua;
      draws(p, t, T ? row : k, valid, gl, &us, &ua);
      // u_sel * nb in the uniforms' dtype, as the plain version takes it:
      // the Philox stream's float32 product is the double product rounded
      // to float (both operands are exact in float)
      const double prod = us * static_cast<double>(nb);
      const double sel = p.u_sel ? prod : static_cast<double>(static_cast<float>(prod));
      const int target = min(static_cast<int>(floor(sel)), nb - 1);
      const int bond = nb > 0 ? act.nth(target) : 0;
      const int i = s_bonds[2 * bond];
      const int j = s_bonds[2 * bond + 1];
      const int sign = spin.bit(i) ? 0 : 1;  // s_i = +1: row 0 of site i, row 1 of site j (s_j = -s_i)
      const double t1 = sign ? -2.0 : 2.0;
      const uint4 ri = s_rows[i], rj = s_rows[j];  // the bonds whose state the flip changes
      const double2* er = p.e + ((size_t)bond * 2 + sign) * H + gl;
      const double2* wi = p.w + (size_t)i * H + gl;
      const double2* wk = p.w + (size_t)j * H + gl;
      int ez;
      double z = st.propose(er, wi, wk, s_y, s_site, t1, H, gl, ez);
      bool accept;
      if constexpr (C) {
        const double dln = d::group_sum<G>(z) - t1 * (__ldg(&p.a_site[i].x) - __ldg(&p.a_site[j].x));
        accept = nb > 0 && (dln >= 0.0 ? ua < 1.0 : ua < exp(scale * dln));
      } else {
        // |psi'/psi|^2 = e^{-4 s Re a'_i} e^{4 s Re a'_k} prod_j |c_j + u_j E_j|^2 / |D_j|^2 = z 2^ez
        d::group_product<G>(z, ez);
        const double2 fi = s_site[2 * i + sign], fk = s_site[2 * j + 1 - sign];
        z *= fi.x * fk.x;
        ez += static_cast<int>(fi.y) + static_cast<int>(fk.y);
        accept = nb > 0 && d::accept_ratio<T>(ua, z, ez, inv_beta);
      }
      if (has_ext) __syncwarp();  // every lane has read this proposal's shared words
      if (accept) {
        st.accept(s_y, er, wi, wk, s_site, t1, H, gl);
        const double2 ai = __ldg(p.a + i), aj = __ldg(p.a + j);
        sa.x = sa.x - t1 * ai.x + t1 * aj.x;
        sa.y = sa.y - t1 * ai.y + t1 * aj.y;
        ++acc;
        spin.toggle(i, leader);
        spin.toggle(j, leader);
        act.r[0] ^= ri.x ^ rj.x;
        act.r[1] ^= ri.y ^ rj.y;
        act.r[2] ^= ri.z ^ rj.z;
        act.r[3] ^= ri.w ^ rj.w;
        if (nw > kRegWords) {  // and those past the register words, from the table itself
#pragma unroll 1
          for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e)
            if (s_idx[e] >= 32 * kRegWords) act.toggle(s_idx[e], leader);
#pragma unroll 1
          for (int e = s_ptr[j]; e < s_ptr[j + 1]; ++e)
            if (s_idx[e] >= 32 * kRegWords) act.toggle(s_idx[e], leader);
        }
      }
      if (has_ext) __syncwarp();  // the leaders' shared words
      if (accept) nb = act.count();
    }
  };
  if constexpr (T) {
    // sweeps of n_unit proposals at the row's beta, each followed by the
    // renewal, whose Re ln psi the even and the odd swap phase read
    const int n_sweeps = p.n_steps / p.n_unit;
    for (int s = 0; s < n_sweeps; ++s) {
      scale = 2.0 * d::row_beta(row, p.n_beta);
      inv_beta = static_cast<double>(p.n_beta) / static_cast<double>(p.n_beta - row % p.n_beta);
      acc = 0;
      double ln0 = 0.0;
      if (!idle_warp) {
        proposals(s * p.n_unit, (s + 1) * p.n_unit);
        ln0 = d::group_sum<G>(st.template renew<true>(s_y, s_site, H, gl)) + sa.x;
      }
      if (valid && leader) s_acc[row - first] += acc;
      exchange_swap_phase<G>(p, draws, valid, leader, first, s, 0, row, ln0, s_ln, s_swap);
      exchange_swap_phase<G>(p, draws, valid, leader, first, s, 1, row, ln0, s_ln + slots, s_swap);
      draws.restart();
    }
  } else {
    // sweeps of n_unit proposals, each from a renewed state
    const int period = p.n_unit < 1 ? p.n_steps : p.n_unit;
    for (int t0 = 0; t0 < p.n_steps; t0 += period) {
      if (t0 > 0) st.template renew<false>(s_y, s_site, H, gl);
      proposals(t0, min(t0 + period, p.n_steps));
    }
  }

  if (valid) {
    for (int j = gl; j < H; j += G) p.y_out[(size_t)row * H + j] = s_y[j];
  }
  for (int m = 0; m < nsw; ++m) {
    const unsigned own = spin.word(m);
    const int i = m * 32 + lane;
    for (int q2 = 0; q2 < P; ++q2) {
      const unsigned v = __shfl_sync(kFull, own, q2 * G);
      const int row2 = T ? __shfl_sync(kFull, row, q2 * G) : kbase + q2;
      if (in_block(q2) && i < N) p.spins_out[(size_t)row2 * N + i] = (v >> lane) & 1u ? 1.0 : -1.0;
    }
  }
  if (valid && leader) p.sa_out[row] = sa;
  if constexpr (T) {
    __syncthreads();  // every count is in
    if (valid && leader) {
      p.acc_out[k] = s_acc[k - first];
      p.swap_out[k] = s_swap[k - first];
    }
  } else {
    if (valid && leader) p.acc_out[k] = acc;
  }
}

template <int G, int U, bool C, bool T, bool Nw>
cudaError_t launch_f64(const ExchangeArgsF64& p, cudaStream_t stream) {
  const int walkers = block_walkers(G, T, p.n_beta);
  const int warps = (walkers + 32 / G - 1) / (32 / G);
  const int threads = 32 * (T ? warps : kWarpsPerBlock);
  const size_t smem = layout_f64(p.N, p.H, p.B, C, T, threads / G).total;
  if (smem > kSmemMax || threads > threads_f64(G, T, Nw)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(exchange_kernel_f64<G, U, C, T, Nw>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.K + walkers - 1) / walkers);
  exchange_kernel_f64<G, U, C, T, Nw><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instances of G lanes per walker for U = U0..U1 units per lane.
template <int G, int U, int U1, bool C, bool T>
cudaError_t launch_units_f64(const ExchangeArgsF64& p, int units, cudaStream_t stream) {
  if (units == U) {
    if constexpr (narrow_f64(G, U, C, T)) {
      if (block_walkers(G, T, p.n_beta) <= kWarpsPerBlock) return launch_f64<G, U, C, T, true>(p, stream);
    }
    return launch_f64<G, U, C, T, false>(p, stream);
  }
  if constexpr (U < U1) return launch_units_f64<G, U + 1, U1, C, T>(p, units, stream);
  return cudaErrorInvalidValue;
}

// The lanes per walker G at H hidden units: 16 at H <= 128, else 32 (about
// 4 to 8 units a lane).
__host__ __device__ constexpr int lanes_f64(int H) { return H <= 128 ? 16 : 32; }

// The instances lanes_f64 reaches: G = 16 for H <= 128 (U = 1..8), 32 for
// H = 129..512 (U = 5..16).
template <bool C, bool T>
cudaError_t dispatch_f64(const ExchangeArgsF64& p, cudaStream_t stream) {
  const int G = lanes_f64(p.H), U = (p.H + G - 1) / G;
  if (G == 16) return launch_units_f64<16, 1, 8, C, T>(p, U, stream);
  return launch_units_f64<32, 5, 16, C, T>(p, U, stream);
}

}  // namespace

// The checked arguments of the C interface of exchange_f64.cu and
// exchange_f64_tempered.cu (exchange.cuh NQS_EXCHANGE_PARAMS in double, then
// the table), or cudaErrorInvalidValue.
#define NQS_EXCHANGE_F64_PARAMS NQS_EXCHANGE_PARAMS, const void *e_tab, const void *a_site

namespace {

inline cudaError_t exchange_args_f64(ExchangeArgsF64* p, NQS_EXCHANGE_F64_PARAMS) {
  const cudaError_t e = exchange_args(p, NQS_EXCHANGE_ARGS);
  if (e != cudaSuccess) return e;
  if (e_tab == nullptr || a_site == nullptr) return cudaErrorInvalidValue;
  p->e = static_cast<const double2*>(e_tab);
  p->a_site = static_cast<const double2*>(a_site);
  return cudaSuccess;
}

}  // namespace
