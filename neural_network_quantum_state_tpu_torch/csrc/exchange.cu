// Kawasaki pair-exchange sweeps for the log-cosh machines, float32, Hopper.
//
// Replaces the TPU kernel neural_network_quantum_state_tpu/ops/pallas_exchange.py
// ::_exchange_kernel, both of its branches: the RBM family (c = 1, instances
// C = false) and the FFNN family's complex output weights (has_c, instances
// C = true, c in shared memory as in rbm.cuh). Per walker it runs n_steps
// proposals: mask the active (anti-aligned) bonds of the (B, 2) bond table,
// take nb = their count and target = min(floor(u_sel * nb), nb - 1), pick the
// (target+1)-th active bond in bond order, flip both ends:
// y' = y - 2 s_i w_i - 2 s_j w_j, Re(c_j ln cosh y'_j) summed over the H
// hidden units, accept when u_acc < exp(2 min(dln, 0)) and nb > 0, masked
// commit of y, sa and both spins. The uniforms come from the caller as two (n_steps, K)
// tensors, so the kernel and the plain PyTorch version make the same
// decisions on the same draws.
//
// The TPU kernel turns every per-walker choice into one-hot selector matmuls
// because Mosaic has no dynamic indexing; here the choice is a gather.
// Design: one warp per walker, walkers independent, eight warps per block.
// Lane l keeps hidden units j = r*32 + l (r < R = ceil(H/32), tail lanes
// masked as in rbm.cuh) of y in registers for
// the whole call. The walker's spins and the block's copy of the bond table
// sit in shared memory. Each proposal builds the active mask 32 bonds at a
// time with __ballot_sync: a first pass counts nb with __popc, a second finds
// the word that holds the (target+1)-th set bit and the bit within it. Both
// passes give the same mask on every lane, so the choice is warp-uniform. The
// two W rows are read through the L1/L2 caches; the hidden sum is a warp
// shuffle reduction broadcast from lane 0, so every lane takes the same
// decision. Re ln psi_0 is recomputed here with the same log-cosh as the
// proposals, so the accept ratio never mixes two log-cosh implementations.
//
// Bound on an H100: about 22 float operations per (walker, proposal, hidden
// unit) (about 25 with c: the atan2f and the two products of Re(c l)) and
// about 8 per (walker, proposal, bond), against 16 bytes of y per (walker,
// hidden unit) read and written once per call and 8 bytes of uniforms per
// (walker, proposal); the kernel is bound by operations, and in practice by
// the latency of one proposal's serial chain (mask, count, pick,
// expf/sincosf/logf and with c atan2f, shuffle sum), which the resident
// warps hide only in part.

#include "rbm.cuh"

namespace {

using nqs::kFull;
using nqs::re_term;
using nqs::warp_allsum;

constexpr int kWarpsPerBlock = 8;

// Bonds wd*32 .. wd*32+31 that are active (anti-aligned), one bit each.
__device__ __forceinline__ unsigned active_word(const int* bonds, const float* sp, int B, int wd,
                                                int lane) {
  const int b = wd * 32 + lane;
  const bool act = b < B && sp[bonds[2 * b]] * sp[bonds[2 * b + 1]] < 0.0f;
  return __ballot_sync(kFull, act);
}

template <int R, bool C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, nqs::min_blocks(nqs::narrow_regs(R), kWarpsPerBlock))
exchange_kernel(const float2* __restrict__ w, const float2* __restrict__ a, const float2* __restrict__ c,
                const int* __restrict__ bonds, const float* __restrict__ spins_in,
                const float2* __restrict__ y_in, const float2* __restrict__ sa_in,
                const float* __restrict__ u_sel, const float* __restrict__ u_acc,
                float* __restrict__ spins_out, float2* __restrict__ y_out,
                float2* __restrict__ sa_out, int* __restrict__ acc_out, int K, int N, int H, int B,
                int n_steps) {
  extern __shared__ float smem[];
  float2* s_c = reinterpret_cast<float2*>(smem);  // (32*R,) for C = true, first for alignment
  float* rest = smem + nqs::c_floats<R, C>();
  int* s_bonds = reinterpret_cast<int*>(rest);  // (B, 2), shared by the block
  for (int i = threadIdx.x; i < 2 * B; i += blockDim.x) {
    const int v = bonds[i];
    if (v < 0 || v >= N) __trap();  // a bond end outside [0, N)
    s_bonds[i] = v;
  }
  if constexpr (C) nqs::load_c<R>(c, H, s_c);  // synchronises the block
  else __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarpsPerBlock + warp;
  if (k >= K) return;  // uniform over the warp
  float* sp = rest + 2 * B + warp * N;
  for (int i = lane; i < N; i += 32) sp[i] = spins_in[(size_t)k * N + i];
  __syncwarp();

  float yr[R], yi[R];
  nqs::load_row<R>(y_in + (size_t)k * H, H, lane, yr, yi);
  float l = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    l += nqs::in_row<R>(r, lane, H) ? re_term<C>(yr[r], yi[r], s_c, nqs::hidden(r, lane)) : 0.0f;
  float2 sa = sa_in[k];
  float ln0 = warp_allsum(l) + sa.x;
  int acc = 0;
  const int n_words = (B + 31) / 32;

  for (int t = 0; t < n_steps; ++t) {
    int nb = 0;
    for (int wd = 0; wd < n_words; ++wd) nb += __popc(active_word(s_bonds, sp, B, wd, lane));
    if (nb == 0) continue;  // no active bond: the proposal is rejected
    const float us = __ldg(u_sel + (size_t)t * K + k);
    const int target = min(static_cast<int>(floorf(us * static_cast<float>(nb))), nb - 1);
    int bond = 0;
    for (int wd = 0, base = 0; wd < n_words; ++wd) {
      unsigned m = active_word(s_bonds, sp, B, wd, lane);
      const int c = __popc(m);
      if (target < base + c) {  // the chosen bond is in this word
        for (int r = target - base; r > 0; --r) m &= m - 1;  // drop the lower set bits
        bond = wd * 32 + __ffs(m) - 1;
        break;
      }
      base += c;
    }
    const int i = s_bonds[2 * bond];
    const int j = s_bonds[2 * bond + 1];
    const float t1 = 2.0f * sp[i];
    const float t2 = 2.0f * sp[j];
    const float2* wi = w + (size_t)i * H;
    const float2* wj = w + (size_t)j * H;
    float xr[R], xi[R];
    l = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = nqs::in_row<R>(r, lane, H);
      const float2 w1 = in ? __ldg(wi + nqs::hidden(r, lane)) : make_float2(0.0f, 0.0f);
      const float2 w2 = in ? __ldg(wj + nqs::hidden(r, lane)) : make_float2(0.0f, 0.0f);
      xr[r] = yr[r] - t1 * w1.x - t2 * w2.x;
      xi[r] = yi[r] - t1 * w1.y - t2 * w2.y;
      const float lc = re_term<C>(xr[r], xi[r], s_c, nqs::hidden(r, lane));
      l += in ? lc : 0.0f;
    }
    const float2 ai = __ldg(a + i);
    const float2 aj = __ldg(a + j);
    const float ln1 = (warp_allsum(l) + sa.x) + (-t1 * ai.x - t2 * aj.x);
    const float dln = ln1 - ln0;
    const bool accept = __ldg(u_acc + (size_t)t * K + k) < expf(2.0f * fminf(dln, 0.0f));
    if (accept) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        yr[r] = xr[r];
        yi[r] = xi[r];
      }
      sa.x = sa.x - t1 * ai.x - t2 * aj.x;
      sa.y = sa.y - t1 * ai.y - t2 * aj.y;
      ln0 = ln1;
      ++acc;
    }
    __syncwarp();  // every lane has read the spins of this proposal
    if (accept && lane == 0) {
      sp[i] = -sp[i];
      sp[j] = -sp[j];
    }
    __syncwarp();
  }

  nqs::store_row<R>(y_out + (size_t)k * H, H, lane, yr, yi);
  for (int i = lane; i < N; i += 32) spins_out[(size_t)k * N + i] = sp[i];
  if (lane == 0) {
    sa_out[k] = sa;
    acc_out[k] = acc;
  }
}

template <int R, bool C>
cudaError_t launch(const float2* w, const float2* a, const float2* c, const int* bonds, const float* spins_in,
                   const float2* y_in, const float2* sa_in, const float* u_sel, const float* u_acc,
                   float* spins_out, float2* y_out, float2* sa_out, int* acc_out, int K, int N,
                   int H, int B, int n_steps, cudaStream_t stream) {
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = sizeof(float) * nqs::c_floats<R, C>() + sizeof(int) * 2 * B + sizeof(float) * kWarpsPerBlock * N;
  exchange_kernel<R, C><<<grid, 32 * kWarpsPerBlock, smem, stream>>>(
      w, a, c, bonds, spins_in, y_in, sa_in, u_sel, u_acc, spins_out, y_out, sa_out, acc_out, K, N,
      H, B, n_steps);
  return cudaGetLastError();
}

template <bool C>
cudaError_t dispatch(const void* w, const void* a, const void* c, const void* bonds, const void* spins_in,
                     const void* y_in, const void* sa_in, const void* u_sel, const void* u_acc,
                     void* spins_out, void* y_out, void* sa_out, void* acc_out, int K, int N, int H, int B,
                     int n_steps, void* stream) {
#define NQS_EXCHANGE_CASE(R)                                                                     \
  case R:                                                                                        \
    return launch<R, C>(static_cast<const float2*>(w), static_cast<const float2*>(a),           \
                        static_cast<const float2*>(c), static_cast<const int*>(bonds),           \
                        static_cast<const float*>(spins_in), static_cast<const float2*>(y_in),   \
                        static_cast<const float2*>(sa_in), static_cast<const float*>(u_sel),     \
                        static_cast<const float*>(u_acc), static_cast<float*>(spins_out),        \
                        static_cast<float2*>(y_out), static_cast<float2*>(sa_out),               \
                        static_cast<int*>(acc_out), K, N, H, B, n_steps,                         \
                        static_cast<cudaStream_t>(stream));
  switch ((H + 31) / 32) {
    NQS_FOR_EACH_R(NQS_EXCHANGE_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_EXCHANGE_CASE
}

}  // namespace

// All complex arrays are interleaved (re, im) float pairs, row-major:
// w (N, H), a (N,), c (H,) or null (c = 1: the RBM family), y (K, H),
// sa (K,); bonds (B, 2) int32 with entries in [0, N); spins (K, N); u_sel
// and u_acc (n_steps, K); acc_out (K,) accepted proposals per walker;
// 1 <= H <= 512. Returns the cudaError_t of the launch (0 on success).
extern "C" int nqs_exchange_f32(const void* w, const void* a, const void* c, const void* bonds,
                                const void* spins_in, const void* y_in, const void* sa_in,
                                const void* u_sel, const void* u_acc, void* spins_out, void* y_out,
                                void* sa_out, void* acc_out, int K, int N, int H, int B,
                                int n_steps, void* stream) {
  if (K <= 0 || N <= 0 || B <= 0 || B > N || n_steps <= 0 || H < 1 || H > 32 * nqs::kMaxR)
    return cudaErrorInvalidValue;
  if (c != nullptr)
    return dispatch<true>(w, a, c, bonds, spins_in, y_in, sa_in, u_sel, u_acc, spins_out, y_out, sa_out, acc_out,
                          K, N, H, B, n_steps, stream);
  return dispatch<false>(w, a, c, bonds, spins_in, y_in, sa_in, u_sel, u_acc, spins_out, y_out, sa_out, acc_out,
                         K, N, H, B, n_steps, stream);
}
