// Off-diagonal local-energy sum for the log-cosh machines, float32, Hopper.
//
// Replaces the TPU kernel neural_network_quantum_state_tpu/ops/pallas_energy.py
// ::_energy_kernel (no phase_product), both of its branches: the RBM family
// (c = 1, instances C = false) and the FFNN family's complex output weights
// (has_c: both ln cosh planes rotated by c, instances C = true). Per walker k
// it computes the complex
//
//     out[k] = sum_i exp( ln psi(flip_i s) - ln psi(s) )
//
// over all N sites, where flipping site i moves y to y - 2 s_i w_i and sa to
// sa - 2 s_i a_i (sa cancels in the ratio and is not read).
//
// Design: one warp per walker, eight warps per block, at most 128 registers
// a thread (16 warps per SM: rbm.cuh kWideRegs). Lane l keeps hidden
// units j = r*32 + l (r < R = ceil(H/32), tail lanes masked) of Re y,
// cos/sin(Im y) and both planes of ln cosh(y_j) in registers, computed once.
// The caller passes the (N, H) table (Re w, Im w, cos 2 Im w, sin 2 Im w),
// one 16-byte load per (site, hidden unit): a candidate's cos/sin come by
// angle addition, so the site loop has no trig, and its log-cosh takes exp and
// log on the special-function unit and the polynomial atan2 (rbm.cuh
// offdiag_walker). Each site's ratio is formed difference-first; each lane
// sums the differences of 4 sites, one reduce-scatter over the warp leaves
// every site's (Re, Im) totals on its own lanes, and 4 lanes take the exp and
// sincos of the 4 sites at once (library expf/sincosf: the phase sum may be
// large).
//
// Bound on an H100: K*N*H evaluations of the complex ln cosh (about 25 float
// operations each counting exp, log and atan2 as one, 4 more with c: the
// products of the rotation c (l' - l)) against 16 bytes of y per (walker,
// hidden unit) read once, so the kernel is bound by operations (K*N*H*25 /
// 67 TFLOP/s); what it issues is about 45 floating-point and MUFU
// instructions per element, 20 of them the polynomial atan2 (PERF.md). For
// C = true the block copies c into shared memory once (rbm.cuh load_c).

#include "rbm.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int R, bool C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, nqs::min_blocks(nqs::kWideRegs, kWarpsPerBlock))
offdiag_kernel(const float4* __restrict__ wt, const float2* __restrict__ a, const float2* __restrict__ c,
               const float* __restrict__ spins, const float2* __restrict__ y,
               float2* __restrict__ out, int K, int N, int H) {
  extern __shared__ float2 s_c[];  // (32*R,) for C = true, else empty
  if constexpr (C) nqs::load_c<R>(c, H, s_c);  // before any warp leaves
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= K) return;  // uniform over the warp
  float yr[R], yi[R];
  nqs::load_row<R>(y + (size_t)k * H, H, lane, yr, yi);
  const float2 acc = nqs::offdiag_walker<R, C>(wt, a, s_c, spins + (size_t)k * N, yr, yi, N, H);
  if (lane == 0) out[k] = acc;
}

template <int R, bool C>
cudaError_t launch(const float4* wt, const float2* a, const float2* c, const float* spins, const float2* y,
                   float2* out, int K, int N, int H, cudaStream_t stream) {
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = sizeof(float) * nqs::c_floats<R, C>();
  offdiag_kernel<R, C><<<grid, 32 * kWarpsPerBlock, smem, stream>>>(wt, a, c, spins, y, out, K, N, H);
  return cudaGetLastError();
}

template <bool C>
cudaError_t dispatch(const void* wt, const void* a, const void* c, const void* spins, const void* y, void* out,
                     int K, int N, int H, void* stream) {
#define NQS_OFFDIAG_CASE(R)                                                                       \
  case R:                                                                                         \
    return launch<R, C>(static_cast<const float4*>(wt), static_cast<const float2*>(a),            \
                        static_cast<const float2*>(c), static_cast<const float*>(spins),          \
                        static_cast<const float2*>(y), static_cast<float2*>(out), K, N, H,        \
                        static_cast<cudaStream_t>(stream));
  switch ((H + 31) / 32) {
    NQS_FOR_EACH_R(NQS_OFFDIAG_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_OFFDIAG_CASE
}

}  // namespace

// Complex arrays are interleaved (re, im) float pairs, row-major: wt
// (N, H, 4) floats (Re w, Im w, cos 2 Im w, sin 2 Im w), a (N,), c (H,) or
// null (c = 1: the RBM family), y (K, H), out (K,); spins (K, N);
// 1 <= H <= 512. Returns the cudaError_t of the launch (0 on success).
extern "C" int nqs_offdiag_f32(const void* wt, const void* a, const void* c, const void* spins, const void* y,
                               void* out, int K, int N, int H, void* stream) {
  if (K <= 0 || N <= 0 || H < 1 || H > 32 * nqs::kMaxR) return cudaErrorInvalidValue;
  if (c != nullptr) return dispatch<true>(wt, a, c, spins, y, out, K, N, H, stream);
  return dispatch<false>(wt, a, c, spins, y, out, K, N, H, stream);
}
