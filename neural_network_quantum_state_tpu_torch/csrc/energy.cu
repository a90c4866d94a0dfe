// Off-diagonal local-energy sum for the RBM family, float32, Hopper.
//
// Replaces the TPU kernel neural_network_quantum_state_tpu/ops/pallas_energy.py
// ::_energy_kernel (no output weights c, no phase_product). Per walker k it
// computes the complex
//
//     out[k] = sum_i exp( ln psi(flip_i s) - ln psi(s) )
//
// over all N sites, where flipping site i moves y to y - 2 s_i w_i and sa to
// sa - 2 s_i a_i (sa cancels in the ratio and is not read).
//
// Design: one warp per walker, eight warps per block. Lane l keeps hidden
// units j = r*32 + l (r < R = H/32) of y in registers together with both
// planes of ln cosh(y_j), computed once. Each site's ratio is formed
// difference-first, sum_j [ln cosh(y'_j) - ln cosh(y_j)], so ln psi_0 comes
// from the same log-cosh as ln psi_1 and the O(|ln psi|) totals never cancel
// in float32. The two planes are reduced with warp shuffles and lane 0
// accumulates exp(d) with native expf/sincosf; the phase uses atan2f.
//
// Bound on an H100: K*N*H evaluations of the complex ln cosh (exp, sin, cos,
// log, atan2 and some 25 float operations each) against 16 bytes of y per
// (walker, hidden unit) read once, so the kernel is bound by operations
// (K*N*H*25 / 67 TFLOP/s); the library atan2f and sincosf dominate them.

#include <cuda_runtime.h>

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Both planes of the stable ln cosh(x + iv).
__device__ __forceinline__ void logcosh_ri(float x, float v, float* lr, float* li) {
  const float ax = fabsf(x);
  const float e = expf(-2.0f * ax);
  float s, c;
  sincosf(v, &s, &c);
  const float re = (1.0f + e) * c;
  const float im = (1.0f - e) * s * (x < 0.0f ? -1.0f : 1.0f);
  *lr = 0.5f * logf(re * re + im * im) + (ax - kLn2);
  *li = atan2f(im, re);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
offdiag_kernel(const float2* __restrict__ w, const float2* __restrict__ a,
               const float* __restrict__ spins, const float2* __restrict__ y,
               float2* __restrict__ out, int K, int N) {
  constexpr int H = 32 * R;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= K) return;  // uniform over the warp

  float yr[R], yi[R], l0r[R], l0i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 v = y[(size_t)k * H + r * 32 + lane];
    yr[r] = v.x;
    yi[r] = v.y;
    logcosh_ri(v.x, v.y, &l0r[r], &l0i[r]);
  }

  float acc_re = 0.0f, acc_im = 0.0f;
  for (int i = 0; i < N; ++i) {
    const float two_s = 2.0f * __ldg(spins + (size_t)k * N + i);
    const float2* wrow = w + (size_t)i * H;
    float dr = 0.0f, di = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 wv = __ldg(wrow + r * 32 + lane);
      float lr, li;
      logcosh_ri(yr[r] - two_s * wv.x, yi[r] - two_s * wv.y, &lr, &li);
      dr += lr - l0r[r];
      di += li - l0i[r];
    }
    dr = warp_sum(dr);
    di = warp_sum(di);
    if (lane == 0) {
      const float2 av = __ldg(a + i);
      const float mag = expf(dr - two_s * av.x);
      float s, c;
      sincosf(di - two_s * av.y, &s, &c);
      acc_re += mag * c;
      acc_im += mag * s;
    }
  }
  if (lane == 0) out[k] = make_float2(acc_re, acc_im);
}

template <int R>
cudaError_t launch(const float2* w, const float2* a, const float* spins, const float2* y,
                   float2* out, int K, int N, cudaStream_t stream) {
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  offdiag_kernel<R><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(w, a, spins, y, out, K, N);
  return cudaGetLastError();
}

}  // namespace

// Complex arrays are interleaved (re, im) float pairs, row-major: w (N, H),
// a (N,), y (K, H), out (K,); spins (K, N). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int nqs_offdiag_f32(const void* w, const void* a, const void* spins, const void* y,
                               void* out, int K, int N, int H, void* stream) {
  if (K <= 0 || N <= 0 || H % 32 != 0) return cudaErrorInvalidValue;
#define NQS_OFFDIAG_CASE(R)                                                                      \
  case R:                                                                                        \
    return launch<R>(static_cast<const float2*>(w), static_cast<const float2*>(a),              \
                     static_cast<const float*>(spins), static_cast<const float2*>(y),            \
                     static_cast<float2*>(out), K, N, static_cast<cudaStream_t>(stream));
  switch (H / 32) {
    NQS_OFFDIAG_CASE(1)
    NQS_OFFDIAG_CASE(2)
    NQS_OFFDIAG_CASE(4)
    NQS_OFFDIAG_CASE(8)
    NQS_OFFDIAG_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_OFFDIAG_CASE
}
