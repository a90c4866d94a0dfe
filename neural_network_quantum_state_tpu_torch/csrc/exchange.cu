// Kawasaki pair-exchange proposals for the log-cosh machines, float32, Hopper.
//
// Replaces the TPU kernel neural_network_quantum_state_tpu/ops/pallas_exchange.py
// ::_exchange_kernel, both of its branches: the RBM family (c = 1, instances
// C = false) and the FFNN family's complex output weights (has_c, instances
// C = true). Per walker it runs n_steps proposals: take nb = the number of
// active (anti-aligned) bonds of the (B, 2) bond table and target =
// min(floor(u_sel * nb), nb - 1), pick the (target+1)-th active bond in bond
// order, flip both ends: y' = y - 2 s_i w_i - 2 s_j w_j, Re(c_j ln cosh y'_j)
// summed over the H hidden units, accept when u_acc < exp(2 min(dln, 0)) and
// nb > 0 (no active bond: rejected), masked commit of y, sa and both spins.
// As in the TPU kernel, one launch runs every proposal of a sampler call
// (n_sweeps * n_unit_steps of them). The uniforms come from the kernel's own
// Philox4x32-10 stream on a key (ExchangeDraws below; ops/rng.py
// ExchangeDraws makes the same numbers) or from the caller as two
// (n_steps, K) tensors; the plain PyTorch version takes the same numbers
// either way, so both make the same decisions.
//
// Bound on an H100: about 22 float operations per (walker, proposal, hidden
// unit) (25 with c) and 2 per (walker, proposal, bond), against 16 bytes of y
// per (walker, hidden unit) read and written once per call and a 16-byte key:
// bound by operations (0.006 ms at the Hubbard flagship's N = 64, H = 64,
// K = 4096, 64 proposals), and in practice by the serial chain of one
// proposal (draw, pick, two W rows, log-cosh, hidden sum, accept, mask
// update) and the instructions that the walker's lanes issue for it, with
// few resident warps to hide the chain (PERF.md). The TPU kernel turns every
// per-walker choice into one-hot selector matmuls because Mosaic has no
// dynamic indexing; here the choice is a bit search and the W rows a
// gather. What the design does:
// - The active-bond mask is a bit set kept per walker and updated, not
//   rescanned: flipping spin i changes the state of every bond that touches i
//   (once per touching end), so an accepted flip of (i, j) XORs the mask with
//   the rows of i and j of the site -> incident-bonds table (CSR, built once
//   per bond table on the host, turned into one uint4 of bits per site in
//   shared memory at the block's start); the chosen bond (i, j) is in both
//   rows and stays active. nb is a popcount of the mask words, and the pick
//   a running popcount over them and a popcount bisection in the chosen word
//   (measured against __fns, PERF.md). The spins are
//   a bit set too. Both keep their first kRegWords words in registers, the
//   same on every lane of the walker (N <= 128 and B <= 128 need nothing
//   else and no warp barrier); further words live in the walker's shared
//   memory, written by its leader lane, and bonds past 32 kRegWords are
//   toggled from the CSR entries themselves.
// - G lanes per walker, 32 / G walkers per warp (lanes_for: 8 at H <= 64,
//   measured against 4, 16 and 32 at the flagship, PERF.md); lane
//   l of a walker keeps hidden units j = u * G + l, u < U = ceil(H / G), of
//   y in registers. The hidden sum is a butterfly over the G lanes (log2 G
//   shuffles): IEEE addition commutes, so every lane of the walker ends with
//   the same bits and its decision is uniform over its lanes without a
//   broadcast.
// - The fast log-cosh of rbm.cuh: logcosh_re_fast for C = false, and for
//   C = true logcosh_ri_cs with the rotation by c of both planes, from
//   cos/sin(Im y') by angle addition where W is staged (the walker keeps
//   cos/sin(Im y) of its units, a candidate turns them by the rows i and j of
//   a table of cos/sin(2 Im w) that the block builds in shared memory, as
//   ops/engine.py kernel_table tabulates them for the energy kernel; measured
//   against sincos_fast, PERF.md) and from sincos_fast where W is read
//   through L1 or a lane holds more than 8 units; ex2_fast for the
//   acceptance. Re ln psi_0 is recomputed here
//   with the same functions (the rotation starts from sincos_fast of Im y),
//   so the accept ratio never mixes two log-cosh implementations.
// - W is staged in shared memory once per block by a bulk asynchronous copy
//   (cp.async.bulk on an mbarrier, overlapped with the walkers' set-up) where
//   the whole layout fits kSmemBudget (measured faster than L1 at the
//   flagship, PERF.md), and read through L1/L2 otherwise, each in a proposal
//   loop of its own; with c the threads stage the rotation's table instead,
//   where it fits kSmemBudgetTable. a and c are staged always. The register cap (two
//   blocks of 8 warps per SM) was measured against 1, 3 and 4.
// - One Philox evaluation per lane gives four uniforms; the G lanes of a
//   walker hold G/2 counter blocks of each stream and a proposal's two
//   uniforms come out by two shuffles.

#include <cstdint>
#include <type_traits>

#include "rbm.cuh"

// Measurement switches: scripts/exchange_ablation.py builds this file with
// one of them to time an alternative to a measured choice; the package's
// build defines none.
// - NQS_EXCHANGE_LANES=g: g lanes per walker at every H <= 64;
// - NQS_EXCHANGE_W_L1: W read through L1/L2 at every shape;
// - NQS_EXCHANGE_FNS: the bit in the chosen mask word picked by __fns;
// - NQS_EXCHANGE_C_SINCOS: with c and W staged, cos/sin(Im y') by
//   sincos_fast, as where W is read through L1, in place of the rotation
//   (and w staged, not its table);
// - NQS_EXCHANGE_MIN_BLOCKS=m: the second argument of __launch_bounds__
//   (m resident blocks of 8 warps per SM cap a thread at 65536 / (256 m)
//   registers).

namespace {

using nqs::kFull;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
#ifdef NQS_EXCHANGE_MIN_BLOCKS
constexpr int kMinBlocks = NQS_EXCHANGE_MIN_BLOCKS;
#else
constexpr int kMinBlocks = nqs::min_blocks(nqs::kWideRegs, kWarpsPerBlock);
#endif
#ifdef NQS_EXCHANGE_C_SINCOS
constexpr bool kRotate = false;
#else
constexpr bool kRotate = true;
#endif
// Bit words of a walker's spins and of its active-bond mask kept in registers.
constexpr int kRegWords = 4;
static_assert(kRegWords == 4, "the incidence bits of a site are one uint4");
// Shared memory a block takes without opting in: W is staged where the whole
// layout fits. The rotation's table (16 bytes per weight) is staged where two
// blocks still fit an SM.
constexpr size_t kSmemBudget = 48 * 1024;
constexpr size_t kSmemBudgetTable = 112 * 1024;
constexpr size_t kSmemMax = 227 * 1024;
// Counter word 3 of the selection and acceptance streams (ops/rng.py).
constexpr unsigned kSelectStream = 2, kAcceptStream = 3;
constexpr float kTwoLog2e = 2.8853900817779268f;  // 2 log2(e)

struct ExchangeArgs {
  const float2* w;         // (N, H)
  const float2* a;         // (N,)
  const float2* c;         // (H,), null for C = false
  const int* bonds;        // (B, 2), entries in [0, N)
  const int* inc_ptr;      // (N + 1,) CSR site -> incident bonds
  const int* inc_idx;      // (2B,)
  const float* spins_in;   // (K, N)
  const float2* y_in;      // (K, H)
  const float2* sa_in;     // (K,)
  const float* u_sel;      // (n_steps, K), or null: the Philox stream
  const float* u_acc;      // (n_steps, K), or null
  const long long* key;    // (2,) words in [0, 2^32), read when u_sel is null
  float* spins_out;
  float2* y_out;
  float2* sa_out;
  int* acc_out;  // (K,) accepted proposals per walker
  int K, N, H, B, n_steps;
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// The lanes per walker G at H hidden units: about 8 units per lane.
__host__ __device__ constexpr int lanes_for(int H) {
#ifdef NQS_EXCHANGE_LANES
  if (H <= 64) return NQS_EXCHANGE_LANES;
#endif
  return H <= 64 ? 8 : H <= 128 ? 16 : 32;
}

// Whether staged W is the rotation's table (Re w, Im w, cos 2 Im w, sin 2 Im
// w) of an instance with c, rather than w itself: at most 8 units per lane,
// as the rotation keeps 2U more registers live (the instances with c spilled
// under the 128 cap from U = 13 with it, PERF.md); wider ones take
// sincos_fast.
__host__ __device__ constexpr bool table_w(bool C, int U) { return C && kRotate && U <= 8; }

// Byte offsets of the block's shared memory: the mbarrier of the W copy, W
// or its table (staged only), a, c (C = true, zero-padded to U * G), the bonds, the CSR
// table, its rows as bits of the bonds below 32 kRegWords (a uint4 per
// site), and per walker the spin and mask words past kRegWords.
struct Layout {
  size_t w, a, c, bonds, ptr, idx, rows, ext, total;
  int ext_words;  // per walker
};

__host__ __device__ inline Layout layout(int N, int H, int B, int units, bool C, bool tab, bool staged, int walkers) {
  Layout L;
  const int nsw = (N + 31) / 32, nw = (B + 31) / 32;
  L.ext_words = (nsw > kRegWords ? nsw - kRegWords : 0) + (nw > kRegWords ? nw - kRegWords : 0);
  L.w = 16;  // after the mbarrier
  L.a = align16(L.w + (staged ? (tab ? sizeof(float4) : sizeof(float2)) * N * H : 0));
  L.c = align16(L.a + sizeof(float2) * N);
  L.bonds = align16(L.c + (C ? sizeof(float2) * units : 0));
  L.ptr = align16(L.bonds + sizeof(int) * 2 * B);
  L.idx = align16(L.ptr + sizeof(int) * (N + 1));
  L.rows = align16(L.idx + sizeof(int) * 2 * B);
  L.ext = L.rows + sizeof(uint4) * N;
  L.total = L.ext + sizeof(unsigned) * L.ext_words * walkers;
  return L;
}

// The position of the (n+1)-th set bit of v, for n < popc(v): halving by
// popcounts, five steps without branches.
__device__ __forceinline__ int nth_bit(unsigned v, int n) {
#ifdef NQS_EXCHANGE_FNS
  return static_cast<int>(__fns(v, 0u, n + 1));
#else
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned lo = v & ((1u << w) - 1u);
    const int c = __popc(lo);
    const bool up = n >= c;
    n = up ? n - c : n;
    v = up ? v >> w : lo;
    pos += up ? w : 0;
  }
  return pos;
#endif
}

// A walker's bit set (its spins, bit set for s = +1, or its active bonds):
// words 0..kRegWords-1 in registers, the same on every lane of the walker;
// words kRegWords..n-1 in the walker's shared memory, written by its leader
// lane only. Register words past n stay 0.
struct Bits {
  unsigned r[kRegWords];
  unsigned* ext;
  int n;

  __device__ __forceinline__ unsigned word(int m) const {
    if (m >= kRegWords) return ext[m - kRegWords];
    unsigned v = r[0];
#pragma unroll
    for (int q = 1; q < kRegWords; ++q) v = m == q ? r[q] : v;
    return v;
  }
  __device__ __forceinline__ bool bit(int i) const { return (word(i >> 5) >> (i & 31)) & 1u; }
  __device__ __forceinline__ void set_word(int m, unsigned v, bool leader) {
#pragma unroll
    for (int q = 0; q < kRegWords; ++q) r[q] = m == q ? v : r[q];
    if (m >= kRegWords && leader) ext[m - kRegWords] = v;
  }
  __device__ __forceinline__ void toggle(int i, bool leader) {
    const int m = i >> 5;
    const unsigned b = 1u << (i & 31);
#pragma unroll
    for (int q = 0; q < kRegWords; ++q) r[q] ^= m == q ? b : 0u;
    if (m >= kRegWords && leader) ext[m - kRegWords] ^= b;
  }
  __device__ __forceinline__ int count() const {
    int c = 0;
#pragma unroll
    for (int q = 0; q < kRegWords; ++q) c += __popc(r[q]);
#pragma unroll 1
    for (int m = kRegWords; m < n; ++m) c += __popc(ext[m - kRegWords]);
    return c;
  }
  // The position of the (target+1)-th set bit, for 0 <= target < count():
  // the word by a running popcount (without branches over the registers),
  // the bit by nth_bit.
  __device__ __forceinline__ int nth(int target) const {
    int q = 0, base = 0, sum = __popc(r[0]);
#pragma unroll
    for (int m = 1; m < kRegWords; ++m) {
      if (target >= sum) {
        q = m;
        base = sum;
      }
      sum += __popc(r[m]);
    }
    unsigned v = r[0];
#pragma unroll
    for (int m = 1; m < kRegWords; ++m) v = q == m ? r[m] : v;
    if (target >= sum) {  // past the register words (B > 32 kRegWords)
      base = sum;
#pragma unroll 1
      for (q = kRegWords; q < n; ++q) {
        v = ext[q - kRegWords];
        const int c = __popc(v);
        if (target < base + c) break;
        base += c;
      }
    }
    return q * 32 + nth_bit(v, target - base);
  }
};

// Sum over the G lanes of a walker; every lane gets the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, G);
  return v;
}

// The selection and acceptance uniforms of walker row k. In the Philox mode
// the uniform of proposal t is word t % 4 of philox(counter (t / 4, k, 0,
// stream), key), as ops/rng.py philox_uniforms makes it: lanes l < G/2 of the
// walker hold selection block base + l, lanes G/2 + l acceptance block
// base + l, so one evaluation per lane covers 2G proposals, and a proposal's
// two uniforms come out by two shuffles. t is uniform over the warp, so every
// lane refills together.
template <int G>
struct ExchangeDraws {
  static constexpr int kHalf = G / 2;
  uint2 key;
  uint4 bits;
  int base;  // first counter block of `bits`, -1 before the first evaluation

  __device__ __forceinline__ explicit ExchangeDraws(const ExchangeArgs& p) : bits(make_uint4(0u, 0u, 0u, 0u)), base(-1) {
    key = p.u_sel ? make_uint2(0u, 0u) : make_uint2(static_cast<unsigned>(p.key[0]), static_cast<unsigned>(p.key[1]));
  }

  __device__ __forceinline__ void operator()(const ExchangeArgs& p, int t, int k, bool valid, int gl, float* us,
                                             float* ua) {
    if (p.u_sel) {
      const size_t at = (size_t)t * p.K + (valid ? k : 0);
      *us = __ldg(p.u_sel + at);
      *ua = __ldg(p.u_acc + at);
      return;
    }
    const int blk = t >> 2;
    if ((blk & ~(kHalf - 1)) != base) {
      base = blk & ~(kHalf - 1);
      const uint4 ctr = make_uint4(static_cast<unsigned>(base + (gl & (kHalf - 1))), static_cast<unsigned>(k), 0u,
                                   gl < kHalf ? kSelectStream : kAcceptStream);
      bits = nqs::philox4x32_10(ctr, key);
    }
    const unsigned w = nqs::word(bits, t & 3);
    *us = nqs::bits_uniform(__shfl_sync(kFull, w, blk & (kHalf - 1), G));
    *ua = nqs::bits_uniform(__shfl_sync(kFull, w, kHalf + (blk & (kHalf - 1)), G));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for phase 0 of the mbarrier at `bar` (the W copy).
__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// Re(c_j ln cosh(x + iv)) of hidden unit j (c in shared memory, C = true),
// or Re ln cosh(x + iv) (C = false).
template <bool C>
__device__ __forceinline__ float term(float x, float v, const float2* s_c, int j) {
  if constexpr (C) {
    float sv, cv;
    nqs::sincos_fast(v, &sv, &cv);
    return nqs::re_c_term(x, cv, sv, s_c, j);
  } else {
    return nqs::logcosh_re_fast(x, v);
  }
}

// The candidate y' = y - t1 w_i - t2 w_j of the walker's units (into xr,
// xi) and this lane's part of Re ln psi' - sa; W read from shared memory
// (S = true: w is the staged copy) or through L1/L2.
template <int G, int U, bool C, bool S>
__device__ __forceinline__ float candidate(const float2* __restrict__ w, int i, int j, int H, int gl, float t1,
                                           float t2, const float (&yr)[U], const float (&yi)[U], float (&xr)[U],
                                           float (&xi)[U], const float2* s_c) {
  const float2* wi = S ? w + i * H + gl : w + (size_t)i * H + gl;  // unit u at wi[u * G]
  const float2* wj = S ? w + j * H + gl : w + (size_t)j * H + gl;
  float l = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < U - 1 || u * G + gl < H;
    float2 w1 = make_float2(0.0f, 0.0f), w2 = w1;
    if (in) {
      w1 = S ? wi[u * G] : __ldg(wi + u * G);
      w2 = S ? wj[u * G] : __ldg(wj + u * G);
    }
    xr[u] = fmaf(-t2, w2.x, fmaf(-t1, w1.x, yr[u]));
    xi[u] = fmaf(-t2, w2.y, fmaf(-t1, w1.y, yi[u]));
    const float lc = term<C>(xr[u], xi[u], s_c, u * G + gl);
    l += in ? lc : 0.0f;
  }
  return l;
}

// The same for C = true with W staged, cos/sin(Im y') by angle addition: the
// walker's cos/sin(Im y) (cs, sn) turned by the staged table's rows i and j
// (t1 = 2 s_i, s_j = -s_i), into xc, xs; Im y' is not formed. The turned
// pair drifts from the unit circle by a few float32 roundings per accepted
// proposal; each launch starts it afresh from Im y.
template <int G, int U>
__device__ __forceinline__ float candidate_rot(const float4* tab, int i, int j, int H, int gl, float t1,
                                               const float (&yr)[U], const float (&cs)[U], const float (&sn)[U],
                                               float (&xr)[U], float (&xc)[U], float (&xs)[U], const float2* s_c) {
  const float4* ti = tab + i * H + gl;
  const float4* tj = tab + j * H + gl;
  const float si = 0.5f * t1;
  float l = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < U - 1 || u * G + gl < H;
    float4 wi = make_float4(0.0f, 0.0f, 1.0f, 0.0f), wj = wi;
    if (in) {
      wi = ti[u * G];
      wj = tj[u * G];
    }
    xr[u] = fmaf(t1, wj.x, fmaf(-t1, wi.x, yr[u]));
    const float2 r1 = nqs::rotate(cs[u], sn[u], wi.z, si * wi.w);
    const float2 r2 = nqs::rotate(r1.x, r1.y, wj.z, -si * wj.w);
    xc[u] = r2.x;
    xs[u] = r2.y;
    const float lc = nqs::re_c_term(xr[u], r2.x, r2.y, s_c, u * G + gl);
    l += in ? lc : 0.0f;
  }
  return l;
}

template <int G, int U, bool C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
exchange_kernel(const ExchangeArgs p, const int staged) {
  constexpr int P = 32 / G;  // walkers per warp
  constexpr int kWalkers = kWarpsPerBlock * P;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kTab = table_w(C, U);
  const Layout L = layout(p.N, p.H, p.B, U * G, C, kTab, staged != 0, kWalkers);
  const float2* s_w = reinterpret_cast<const float2*>(smem + L.w);
  float2* s_a = reinterpret_cast<float2*>(smem + L.a);
  float2* s_c = reinterpret_cast<float2*>(smem + L.c);
  int* s_bonds = reinterpret_cast<int*>(smem + L.bonds);
  int* s_ptr = reinterpret_cast<int*>(smem + L.ptr);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx);
  uint4* s_rows = reinterpret_cast<uint4*>(smem + L.rows);
  const uint32_t bar = smem_addr(smem);
  const int tid = threadIdx.x;

  // W: one bulk copy of its 16-byte-aligned body, overlapped with the set-up
  // below; a misaligned W (a view) and the 8-byte tail of an odd N * H are
  // copied by the threads. The rotation's table is made by the threads.
  const size_t w_bytes = sizeof(float2) * p.N * p.H;
  const bool bulk = !kTab && staged && (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  const size_t bulk_bytes = bulk ? (w_bytes & ~static_cast<size_t>(15)) : 0;
  if (bulk_bytes > 0 && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(static_cast<unsigned>(bulk_bytes))
                 : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_addr(s_w)),
                 "l"(reinterpret_cast<uint64_t>(p.w)), "r"(static_cast<unsigned>(bulk_bytes)), "r"(bar)
                 : "memory");
  }
  if (kTab && staged) {
    float4* dst = reinterpret_cast<float4*>(smem + L.w);
    for (int e = tid; e < p.N * p.H; e += kThreads) {
      const float2 v = p.w[e];
      float sw, cw;
      nqs::sincos_fast(2.0f * v.y, &sw, &cw);
      dst[e] = make_float4(v.x, v.y, cw, sw);
    }
  } else if (staged) {
    float2* dst = reinterpret_cast<float2*>(smem + L.w);
    for (size_t e = bulk_bytes / sizeof(float2) + tid; e < (size_t)p.N * p.H; e += kThreads) dst[e] = p.w[e];
  }
  for (int e = tid; e < 2 * p.B; e += kThreads) {
    const int v = p.bonds[e];
    const int b = p.inc_idx[e];
    if (v < 0 || v >= p.N || b < 0 || b >= p.B) __trap();  // a bond end outside [0, N), or a bad table
    s_bonds[e] = v;
    s_idx[e] = b;
  }
  for (int e = tid; e <= p.N; e += kThreads) {
    const int v = p.inc_ptr[e];
    if (v < 0 || v > 2 * p.B) __trap();
    s_ptr[e] = v;
  }
  for (int e = tid; e < p.N; e += kThreads) {
    s_a[e] = p.a[e];
    unsigned rw[kRegWords] = {};  // the bonds below 32 kRegWords that touch site e, once per end
    const int f1 = min(p.inc_ptr[e + 1], 2 * p.B);  // inside the table even before a bad one traps
    for (int f = max(p.inc_ptr[e], 0); f < f1; ++f) {
      const int b = p.inc_idx[f];
#pragma unroll
      for (int q = 0; q < kRegWords; ++q) rw[q] ^= (b >> 5) == q ? 1u << (b & 31) : 0u;
    }
    s_rows[e] = make_uint4(rw[0], rw[1], rw[2], rw[3]);
  }
  if constexpr (C) {
    for (int e = tid; e < U * G; e += kThreads) s_c[e] = e < p.H ? p.c[e] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = lane / G;  // the walker in the warp
  const int gl = lane % G;  // the lane in the walker
  const bool leader = gl == 0;
  const int kbase = (blockIdx.x * kWarpsPerBlock + warp) * P;  // the warp's first walker row
  const int k = kbase + q;
  const bool valid = k < p.K;
  if (kbase >= p.K) return;  // an idle warp past K (uniform over the warp)
  const int N = p.N, H = p.H;
  const int nsw = (N + 31) / 32, nw = (p.B + 31) / 32;
  const int ext_s = nsw > kRegWords ? nsw - kRegWords : 0;
  const bool has_ext = L.ext_words > 0;  // uniform over the block
  unsigned* ext = reinterpret_cast<unsigned*>(smem + L.ext) + (size_t)(warp * P + q) * L.ext_words;
  Bits spin{{}, ext, nsw};
  Bits act{{}, ext + ext_s, nw};

  // The spin words and the active-bond words of the warp's walkers, each from
  // one coalesced read and a ballot; the walker's lanes keep theirs.
  for (int m = 0; m < nsw; ++m) {
    const int i = m * 32 + lane;
    for (int q2 = 0; q2 < P; ++q2) {
      const bool up = kbase + q2 < p.K && i < N && p.spins_in[(size_t)(kbase + q2) * N + i] > 0.0f;
      const unsigned v = __ballot_sync(kFull, up);
      if (q2 == q) spin.set_word(m, v, leader);
    }
  }
  for (int m = 0; m < nw; ++m) {
    const int b = m * 32 + lane;
    const int b0 = b < p.B ? s_bonds[2 * b] : 0;
    const int b1 = b < p.B ? s_bonds[2 * b + 1] : 0;
    for (int q2 = 0; q2 < P; ++q2) {
      const float* row = p.spins_in + (size_t)(kbase + q2) * N;
      const bool on = b < p.B && kbase + q2 < p.K && row[b0] * row[b1] < 0.0f;
      const unsigned v = __ballot_sync(kFull, on);
      if (q2 == q) act.set_word(m, v, leader);
    }
  }
  if (has_ext) __syncwarp();

  float yr[U], yi[U];
  float cs[U], sn[U];  // cos/sin(Im y), kept by the rotation alone
  float l = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = u * G + gl;
    const bool in = u < U - 1 || j < H;
    const float2 v = valid && in ? p.y_in[(size_t)k * H + j] : make_float2(0.0f, 0.0f);
    yr[u] = v.x;
    yi[u] = v.y;
    nqs::sincos_fast(v.y, &sn[u], &cs[u]);
    const float lc = term<C>(v.x, v.y, s_c, j);
    l += in ? lc : 0.0f;
  }
  float2 sa = valid ? p.sa_in[k] : make_float2(0.0f, 0.0f);
  float ln0 = group_sum<G>(l) + sa.x;
  int nb = act.count();
  int acc = 0;
  ExchangeDraws<G> draws(p);
  if (bulk_bytes > 0) wait_phase0(bar);

  // The proposals, in one of two loops: W from shared memory or through L1.
  const auto proposals = [&](auto w_in_smem) {
    for (int t = 0; t < p.n_steps; ++t) {
      float us, ua;
      draws(p, t, k, valid, gl, &us, &ua);
      const int target = min(static_cast<int>(floorf(us * static_cast<float>(nb))), nb - 1);
      const int bond = nb > 0 ? act.nth(target) : 0;
      const int i = s_bonds[2 * bond];
      const int j = s_bonds[2 * bond + 1];
      const float t1 = spin.bit(i) ? 2.0f : -2.0f;
      const float t2 = -t1;  // an active bond is anti-aligned
      const uint4 ri = s_rows[i], rj = s_rows[j];  // the bonds whose state the flip changes
      const float2 ai = s_a[i], aj = s_a[j];
      constexpr bool S = decltype(w_in_smem)::value;
      constexpr bool R = kTab && S;  // the rotation
      const float4* tab = reinterpret_cast<const float4*>(smem + L.w);
      float xr[U], xi[U];  // Re y', and Im y' or (R) cos(Im y')
      float xs[U];         // (R) sin(Im y')
      float part;
      if constexpr (R) part = candidate_rot<G, U>(tab, i, j, H, gl, t1, yr, cs, sn, xr, xi, xs, s_c);
      else part = candidate<G, U, C, S>(S ? s_w : p.w, i, j, H, gl, t1, t2, yr, yi, xr, xi, s_c);
      const float ln1 = (group_sum<G>(part) + sa.x) + (-t1 * ai.x - t2 * aj.x);
      const bool accept = nb > 0 && ua < nqs::ex2_fast(kTwoLog2e * fminf(ln1 - ln0, 0.0f));
      if (has_ext) __syncwarp();  // every lane has read this proposal's shared words
      if (accept) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          yr[u] = xr[u];
          if constexpr (R) {
            const bool in = u < U - 1 || u * G + gl < H;
            const float wi = in ? tab[i * H + u * G + gl].y : 0.0f, wj = in ? tab[j * H + u * G + gl].y : 0.0f;
            yi[u] = fmaf(-t2, wj, fmaf(-t1, wi, yi[u]));
            cs[u] = xi[u];
            sn[u] = xs[u];
          } else {
            yi[u] = xi[u];
          }
        }
        sa.x = sa.x - t1 * ai.x - t2 * aj.x;
        sa.y = sa.y - t1 * ai.y - t2 * aj.y;
        ln0 = ln1;
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
  if (staged) proposals(std::true_type{});
  else proposals(std::false_type{});

#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = u * G + gl;
    if (valid && (u < U - 1 || j < H)) p.y_out[(size_t)k * H + j] = make_float2(yr[u], yi[u]);
  }
  for (int m = 0; m < nsw; ++m) {
    const unsigned own = spin.word(m);
    const int i = m * 32 + lane;
    for (int q2 = 0; q2 < P; ++q2) {
      const unsigned v = __shfl_sync(kFull, own, q2 * G);
      if (kbase + q2 < p.K && i < N) p.spins_out[(size_t)(kbase + q2) * N + i] = (v >> lane) & 1u ? 1.0f : -1.0f;
    }
  }
  if (valid && leader) {
    p.sa_out[k] = sa;
    p.acc_out[k] = acc;
  }
}

// Whether the kernel stages W at this shape: where the block's whole layout
// fits the budget.
bool stages(int N, int H, int B, bool C) {
#ifdef NQS_EXCHANGE_W_L1
  return false;
#else
  const int G = lanes_for(H), U = (H + G - 1) / G;
  const bool tab = table_w(C, U);
  return layout(N, H, B, U * G, C, tab, true, kWarpsPerBlock * 32 / G).total <= (tab ? kSmemBudgetTable : kSmemBudget);
#endif
}

template <int G, int U, bool C>
cudaError_t launch(const ExchangeArgs& p, cudaStream_t stream) {
  constexpr int kWalkers = kWarpsPerBlock * 32 / G;
  const bool staged = stages(p.N, p.H, p.B, C);
  const size_t smem = layout(p.N, p.H, p.B, U * G, C, table_w(C, U), staged, kWalkers).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(exchange_kernel<G, U, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.K + kWalkers - 1) / kWalkers);
  exchange_kernel<G, U, C><<<grid, kThreads, smem, stream>>>(p, staged ? 1 : 0);
  return cudaGetLastError();
}

// The instances of G lanes per walker for U = U0..U1 units per lane.
template <int G, int U, int U1, bool C>
cudaError_t launch_units(const ExchangeArgs& p, int units, cudaStream_t stream) {
  if (units == U) return launch<G, U, C>(p, stream);
  if constexpr (U < U1) return launch_units<G, U + 1, U1, C>(p, units, stream);
  return cudaErrorInvalidValue;
}

// The instances lanes_for reaches: G = 8 for H <= 64 (U = 1..8), 16 for
// H = 65..128 (U = 5..8), 32 for H = 129..512 (U = 5..16).
template <bool C>
cudaError_t dispatch(const ExchangeArgs& p, cudaStream_t stream) {
  const int G = lanes_for(p.H), U = (p.H + G - 1) / G;
#ifdef NQS_EXCHANGE_LANES
  if (p.H <= 64) return launch_units<NQS_EXCHANGE_LANES, 1, 64 / NQS_EXCHANGE_LANES, C>(p, U, stream);
#endif
  switch (G) {
    case 8:
      return launch_units<8, 1, 8, C>(p, U, stream);
    case 16:
      return launch_units<16, 5, 8, C>(p, U, stream);
    case 32:
      return launch_units<32, 5, 16, C>(p, U, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// All complex arrays are interleaved (re, im) float pairs, row-major:
// w (N, H), a (N,), c (H,) or null (c = 1: the RBM family), y (K, H),
// sa (K,); bonds (B, 2) int32 with entries in [0, N), 1 <= B <= N; inc_ptr
// (N + 1,) and inc_idx (2B,) the CSR site -> incident-bonds table of the
// bonds (ops/exchange.py incidence_table); spins (K, N) of +-1; u_sel and
// u_acc (n_steps, K), or both null and key (2,) int64 words in [0, 2^32)
// (the Philox stream); acc_out (K,) accepted proposals per walker;
// 1 <= H <= 512. Returns the cudaError_t of the launch (0 on success).
extern "C" int nqs_exchange_f32(const void* w, const void* a, const void* c, const void* bonds, const void* inc_ptr,
                                const void* inc_idx, const void* spins_in, const void* y_in, const void* sa_in,
                                const void* u_sel, const void* u_acc, const void* key, void* spins_out, void* y_out,
                                void* sa_out, void* acc_out, int K, int N, int H, int B, int n_steps, void* stream) {
  if (K <= 0 || N <= 0 || B <= 0 || B > N || n_steps <= 0 || H < 1 || H > 32 * nqs::kMaxR)
    return cudaErrorInvalidValue;
  if ((u_sel == nullptr) != (u_acc == nullptr) || (u_sel == nullptr && key == nullptr)) return cudaErrorInvalidValue;
  const ExchangeArgs p{static_cast<const float2*>(w),     static_cast<const float2*>(a),
                       static_cast<const float2*>(c),     static_cast<const int*>(bonds),
                       static_cast<const int*>(inc_ptr),  static_cast<const int*>(inc_idx),
                       static_cast<const float*>(spins_in), static_cast<const float2*>(y_in),
                       static_cast<const float2*>(sa_in), static_cast<const float*>(u_sel),
                       static_cast<const float*>(u_acc),  static_cast<const long long*>(key),
                       static_cast<float*>(spins_out),    static_cast<float2*>(y_out),
                       static_cast<float2*>(sa_out),      static_cast<int*>(acc_out),
                       K, N, H, B, n_steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c != nullptr ? dispatch<true>(p, s) : dispatch<false>(p, s);
}

// The lanes per walker of nqs_exchange_f32 at H hidden units.
extern "C" int nqs_exchange_lanes(int H) { return lanes_for(H); }

// Whether nqs_exchange_f32 reads W from shared memory at this shape (1) or
// through L1/L2 (0).
extern "C" int nqs_exchange_stages_w(int N, int H, int B, int has_c) { return stages(N, H, B, has_c != 0) ? 1 : 0; }
