// Kawasaki pair-exchange proposals for the log-cosh machines, float64,
// Hopper, untempered and tempered (n_beta <= 16): the float64 instances of
// the exchange kernel.
//
// Replaces, for float64 machines, what the JAX package computes in XLA
// (sampler/kawasaki.py::_exchange_scan and tempered_exchange_sweeps: its
// TPU kernel neural_network_quantum_state_tpu/ops/pallas_exchange.py
// ::_exchange_kernel is float32 only). The same computation as the float32
// instances (exchange.cuh) in double: per walker, n_steps proposals, each
// picking the (target+1)-th active (anti-aligned) bond with target =
// min(floor(u_sel * nb), nb - 1), flipping both ends, y' = y - 2 s_i w_i -
// 2 s_j w_j, Re(c_j ln cosh y'_j) summed over the H hidden units, accepted
// when u_acc < exp(2 beta min(dln, 0)) and nb > 0; for n_beta > 1 (rows
// replica-minor) each sweep of n_unit proposals is followed by the even-
// and the odd-pair swap phase. The uniforms are the caller's (float64) or
// the kernel's own Philox4x32-10 streams on a key, the float32 numbers of
// the float32 instances widened to double; as in the plain version, the
// selection product u_sel * nb is then taken in float32 (the stream's
// dtype), in double on the caller's uniforms. Both make the same decisions.
//
// Design: it keeps the float32 instances' dtype-free parts as they are
// (exchange.cuh): each walker's spins and active-bond mask as bit sets
// (Bits), updated from the site -> incident-bonds table after an accepted
// flip, the bond choice by popcounts (Bits::nth), the Philox draws
// (ExchangeDraws over 32 lanes) and the bond tables staged per block
// (stage_bonds); one launch runs a whole sampler call. The arithmetic is
// the float64 sweep's (rbm_f64.cuh): one warp per walker, lane l on the
// hidden units j = l + 32 r, y in shared memory as double2 (16 H bytes a
// warp), so one instance per (C, T) serves every 1 <= H <= 512; W read
// through L1/L2 (two rows of 16 H bytes per proposal); the library's
// double log-cosh, summed as logs, with the principal branch for c.
//
// Bound on an H100: the float32 instances' operations per (walker,
// proposal, hidden unit) (22, 25 with c) and per (walker, proposal, bond)
// (2) at the card's float64 rate outside the tensor cores (34 TFLOP/s),
// against 32 bytes of y per (walker, hidden unit) read and written once per
// call: bound by operations, and in practice by the serial chain of one
// proposal and the library's double exp, cos and log (PERF.md).

#include "exchange.cuh"
#include "rbm_f64.cuh"

namespace {

// The fields of ExchangeArgs in double (exchange_args fills both).
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
  int n_unit, n_beta;
  int row0;
};

// Byte offsets of a block's shared memory for W walkers (one a warp): a
// (N), c (H, C = true), the walkers' y (W x H), two Re ln psi buffers by
// row (T), the incidence rows (a uint4 per site), the bonds, the CSR table,
// the walkers' spin and mask words past kRegWords, the per-row counts (T).
struct LayoutF64 {
  size_t a, c, y, ln, rows, bonds, ptr, idx, ext, cnt, total;
  int ext_words;  // per walker
};

__host__ __device__ inline LayoutF64 layout_f64(int N, int H, int B, bool C, int walkers) {
  LayoutF64 L;
  const int nsw = (N + 31) / 32, nw = (B + 31) / 32;
  L.ext_words = (nsw > kRegWords ? nsw - kRegWords : 0) + (nw > kRegWords ? nw - kRegWords : 0);
  L.a = 0;
  L.c = L.a + sizeof(double2) * N;
  L.y = L.c + (C ? sizeof(double2) * H : 0);
  L.ln = L.y + sizeof(double2) * (size_t)walkers * H;
  L.rows = align16(L.ln + sizeof(double) * 2 * walkers);
  L.bonds = L.rows + sizeof(uint4) * N;
  L.ptr = L.bonds + sizeof(int) * 2 * B;
  L.idx = L.ptr + sizeof(int) * (N + 1);
  L.ext = L.idx + sizeof(int) * 2 * B;
  L.cnt = L.ext + sizeof(unsigned) * L.ext_words * walkers;
  L.total = L.cnt + sizeof(int) * 2 * walkers;
  return L;
}

// The walkers of a block: 8, or for the tempered instances whole replica
// groups (block_walkers at one walker a warp: at most 16).
__host__ __device__ inline int walkers_f64(bool T, int n_beta) { return block_walkers(32, T, n_beta); }

template <bool C, bool T>
__global__ void __launch_bounds__(32 * kMaxWarpsT) exchange_kernel_f64(const ExchangeArgsF64 p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wb = blockDim.x >> 5;  // walkers of the block, one a warp
  const int tid = threadIdx.x;
  const LayoutF64 L = layout_f64(p.N, p.H, p.B, C, wb);
  double2* s_a = reinterpret_cast<double2*>(smem + L.a);
  double2* s_c = reinterpret_cast<double2*>(smem + L.c);
  int* s_bonds = reinterpret_cast<int*>(smem + L.bonds);
  int* s_ptr = reinterpret_cast<int*>(smem + L.ptr);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx);
  uint4* s_rows = reinterpret_cast<uint4*>(smem + L.rows);
  double* s_ln = reinterpret_cast<double*>(smem + L.ln);  // T: two buffers of wb
  int* s_acc = reinterpret_cast<int*>(smem + L.cnt);      // T: accepted proposals by row
  int* s_swap = s_acc + wb;                               // T: accepted swaps by lower row
  stage_bonds(p, tid, blockDim.x, s_bonds, s_idx, s_ptr, s_rows);
  for (int e = tid; e < p.N; e += blockDim.x) s_a[e] = p.a[e];
  if constexpr (C) {
    for (int e = tid; e < p.H; e += blockDim.x) s_c[e] = p.c[e];
  }
  for (int e = tid; e < wb; e += blockDim.x) s_acc[e] = s_swap[e] = 0;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool leader = lane == 0;
  const int first = blockIdx.x * wb;  // the block's first walker row
  const int k = first + warp;          // the walker's row (T: its first row)
  const bool valid = k < p.K;          // uniform over the warp; T's idle warps stay for the barriers
  if (!T && !valid) return;
  const int N = p.N, H = p.H;
  double2* s_y = reinterpret_cast<double2*>(smem + L.y) + (size_t)warp * H;
  const int nsw = (N + 31) / 32, nw = (p.B + 31) / 32;
  const int ext_s = nsw > kRegWords ? nsw - kRegWords : 0;
  const bool has_ext = L.ext_words > 0;  // uniform over the block
  unsigned* ext = reinterpret_cast<unsigned*>(smem + L.ext) + (size_t)warp * L.ext_words;
  Bits spin{{}, ext, nsw};
  Bits act{{}, ext + ext_s, nw};
  const double* srow = p.spins_in + (size_t)(valid ? k : 0) * N;
  for (int m = 0; m < nsw; ++m) {
    const int i = m * 32 + lane;
    spin.set_word(m, __ballot_sync(kFull, valid && i < N && srow[i] > 0.0), leader);
  }
  for (int m = 0; m < nw; ++m) {
    const int b = m * 32 + lane;
    const bool on = valid && b < p.B && srow[s_bonds[2 * b]] * srow[s_bonds[2 * b + 1]] < 0.0;
    act.set_word(m, __ballot_sync(kFull, on), leader);
  }
  if (has_ext) __syncwarp();

  double l = 0.0;
  for (int j = lane; j < H; j += 32) {
    const double2 v = valid ? p.y_in[(size_t)k * H + j] : make_double2(0.0, 0.0);
    s_y[j] = v;
    l += nqs::d::term<C>(v.x, v.y, s_c, j);
  }
  double2 sa = valid ? p.sa_in[k] : make_double2(0.0, 0.0);
  double ln0 = nqs::d::warp_allsum(l) + sa.x;
  int nb = act.count();
  int acc = 0;
  int row = k;  // T: the row the walker holds, and with it its beta
  double scale = 2.0;  // T: 2 beta
  ExchangeDraws<32, ExchangeArgsF64> draws(p);

  const auto proposals = [&](int t_begin, int t_end) {
    for (int t = t_begin; t < t_end; ++t) {
      double us, ua;
      draws(p, t, row, valid, lane, &us, &ua);
      // u_sel * nb in the uniforms' dtype, as the plain version takes it:
      // the Philox stream's float32 product is the double product rounded
      // to float (both operands are exact in float)
      const double prod = us * static_cast<double>(nb);
      const double sel = p.u_sel ? prod : static_cast<double>(static_cast<float>(prod));
      const int target = min(static_cast<int>(floor(sel)), nb - 1);
      const int bond = nb > 0 ? act.nth(target) : 0;
      const int i = s_bonds[2 * bond];
      const int j = s_bonds[2 * bond + 1];
      const double t1 = spin.bit(i) ? 2.0 : -2.0;
      const double t2 = -t1;  // an active bond is anti-aligned
      const uint4 ri = s_rows[i], rj = s_rows[j];  // the bonds whose state the flip changes
      const double2 ai = s_a[i], aj = s_a[j];
      const double2* wi = p.w + (size_t)i * H;
      const double2* wj = p.w + (size_t)j * H;
      double part = 0.0;
      for (int u = lane; u < H; u += 32) {
        const double2 yv = s_y[u], w1 = __ldg(wi + u), w2 = __ldg(wj + u);
        part += nqs::d::term<C>(yv.x - t1 * w1.x - t2 * w2.x, yv.y - t1 * w1.y - t2 * w2.y, s_c, u);
      }
      const double ln1 = (nqs::d::warp_allsum(part) + sa.x) + (-t1 * ai.x - t2 * aj.x);
      const bool accept = nb > 0 && ua < exp(scale * fmin(ln1 - ln0, 0.0));
      if (has_ext) __syncwarp();  // every lane has read this proposal's shared words
      if (accept) {
        for (int u = lane; u < H; u += 32) {
          const double2 yv = s_y[u], w1 = __ldg(wi + u), w2 = __ldg(wj + u);
          s_y[u] = make_double2(yv.x - t1 * w1.x - t2 * w2.x, yv.y - t1 * w1.y - t2 * w2.y);
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
      if (has_ext) __syncwarp();  // the leader's shared words
      if (accept) nb = act.count();
    }
  };
  if constexpr (T) {
    // sweeps of n_unit proposals at the row's beta, each followed by the even
    // and the odd swap phase
    const nqs::d::Draws swaps(p.u_sel, p.u_swap, p.key, p.K, p.row0);
    const int n_sweeps = p.n_steps / p.n_unit;
    for (int s = 0; s < n_sweeps; ++s) {
      scale = 2.0 * nqs::d::row_beta(row, p.n_beta);
      acc = 0;
      if (valid) proposals(s * p.n_unit, (s + 1) * p.n_unit);
      if (valid && leader) s_acc[row - first] += acc;
      nqs::d::swap_phase(swaps, p.n_beta, valid, first, s, 0, row, ln0, s_ln, s_swap);
      nqs::d::swap_phase(swaps, p.n_beta, valid, first, s, 1, row, ln0, s_ln + wb, s_swap);
      draws.restart();
    }
  } else {
    proposals(0, p.n_steps);
  }

  if (valid) {
    for (int j = lane; j < H; j += 32) p.y_out[(size_t)row * H + j] = s_y[j];
    for (int m = 0; m < nsw; ++m) {
      const int i = m * 32 + lane;
      if (i < N) p.spins_out[(size_t)row * N + i] = (spin.word(m) >> lane) & 1u ? 1.0 : -1.0;
    }
    if (leader) p.sa_out[row] = sa;
  }
  if constexpr (T) {
    __syncthreads();  // every count is in
    if (valid && leader) {
      p.acc_out[k] = s_acc[k - first];
      p.swap_out[k] = s_swap[k - first];
    }
  } else {
    if (leader) p.acc_out[k] = acc;
  }
}

template <bool C, bool T>
cudaError_t launch_f64(const ExchangeArgsF64& p, cudaStream_t stream) {
  const int walkers = walkers_f64(T, p.n_beta);
  const size_t smem = layout_f64(p.N, p.H, p.B, C, walkers).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(exchange_kernel_f64<C, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.K + walkers - 1) / walkers);
  exchange_kernel_f64<C, T><<<grid, 32 * walkers, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The interface of exchange.cuh NQS_EXCHANGE_PARAMS in double: every complex
// array (re, im) double pairs, spins and the caller's uniforms doubles;
// n_beta = 1 runs an untempered instance, 1 < n_beta <= 16 a tempered one.
extern "C" int nqs_exchange_f64(NQS_EXCHANGE_PARAMS) {
  ExchangeArgsF64 p;
  const cudaError_t e = exchange_args(&p, NQS_EXCHANGE_ARGS);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_beta > 1) return c != nullptr ? launch_f64<true, true>(p, s) : launch_f64<false, true>(p, s);
  return c != nullptr ? launch_f64<true, false>(p, s) : launch_f64<false, false>(p, s);
}
