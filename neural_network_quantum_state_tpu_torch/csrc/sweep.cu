// Fused single-flip Metropolis sweeps for the RBM family, float32, Hopper.
//
// Replaces the TPU kernel neural_network_quantum_state_tpu/ops/pallas_sweep.py
// ::_sweep_kernel (n_beta = 1, no output weights c). Per walker it runs
// n_steps proposals over the site schedule: y' = y - 2 s_i w_i, Re ln cosh
// summed over the H hidden units, accept when u < exp(2 min(dln, 0)), masked
// commit of y, sa and the spin. The acceptance uniforms come from the caller
// as an (n_steps, K) tensor, so the kernel and the plain PyTorch sweep make
// the same decisions on the same draws.
//
// Design: one warp per walker, walkers independent, eight warps per block.
// Lane l keeps hidden units j = r*32 + l (r < R = H/32) of y in registers for
// the whole call, so y is read and written once; the hidden sum is a warp
// shuffle reduction, broadcast from lane 0 so that every lane takes the same
// decision. The walker's spins sit in shared memory. W rows (N*H complex,
// 128 KB at N=64, H=256) are read through the L1/L2 caches.
// Re ln psi_0 is recomputed here with the same log-cosh as the proposals, so
// the accept ratio never mixes two log-cosh implementations.
//
// Bound on an H100: about 20 float operations per (walker, step, hidden unit),
// against 16 bytes of y per (walker, hidden unit) read and written once per
// call, so the kernel is bound by operations (K*n_steps*H*20 / 67 TFLOP/s),
// and in practice by the latency of the expf/sincosf/logf chain of one
// proposal, which the eight resident walkers per block hide only in part.

#include <cuda_runtime.h>

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Re ln cosh(x + iv), the real plane of the stable split formula.
__device__ __forceinline__ float logcosh_re(float x, float v) {
  const float ax = fabsf(x);
  const float e = expf(-2.0f * ax);
  float s, c;
  sincosf(v, &s, &c);
  const float re = (1.0f + e) * c;
  const float im = (1.0f - e) * s;
  return 0.5f * logf(re * re + im * im) + (ax - kLn2);
}

// Sum over the warp, then lane 0's value on every lane (the butterfly sums in
// lane-dependent order; broadcasting one of them keeps decisions uniform).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sweep_kernel(const float2* __restrict__ w, const float2* __restrict__ a,
             const float* __restrict__ spins_in, const float2* __restrict__ y_in,
             const float2* __restrict__ sa_in, const int* __restrict__ sched,
             const float* __restrict__ u, float* __restrict__ spins_out,
             float2* __restrict__ y_out, float2* __restrict__ sa_out,
             int* __restrict__ acc_out, int K, int N, int n_sites, int n_steps) {
  extern __shared__ float s_spins[];
  constexpr int H = 32 * R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarpsPerBlock + warp;
  if (k >= K) return;  // uniform over the warp
  float* sp = s_spins + warp * N;
  for (int i = lane; i < N; i += 32) sp[i] = spins_in[(size_t)k * N + i];
  __syncwarp();

  float yr[R], yi[R];
  float l = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 v = y_in[(size_t)k * H + r * 32 + lane];
    yr[r] = v.x;
    yi[r] = v.y;
    l += logcosh_re(v.x, v.y);
  }
  float2 sa = sa_in[k];
  float ln0 = warp_sum(l) + sa.x;
  int acc = 0;

  for (int t = 0; t < n_steps; ++t) {
    const int site = sched[t % n_sites];
    const float two_s = 2.0f * sp[site];
    const float2* wrow = w + (size_t)site * H;
    float xr[R], xi[R];
    l = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 wv = __ldg(wrow + r * 32 + lane);
      xr[r] = yr[r] - two_s * wv.x;
      xi[r] = yi[r] - two_s * wv.y;
      l += logcosh_re(xr[r], xi[r]);
    }
    const float2 av = __ldg(a + site);
    const float ln1 = (warp_sum(l) + sa.x) - two_s * av.x;
    const float dln = ln1 - ln0;
    const bool accept = __ldg(u + (size_t)t * K + k) < expf(2.0f * fminf(dln, 0.0f));
    if (accept) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        yr[r] = xr[r];
        yi[r] = xi[r];
      }
      sa.x -= two_s * av.x;
      sa.y -= two_s * av.y;
      ln0 = ln1;
      ++acc;
    }
    __syncwarp();
    if (accept && lane == 0) sp[site] = -sp[site];
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) y_out[(size_t)k * H + r * 32 + lane] = make_float2(yr[r], yi[r]);
  for (int i = lane; i < N; i += 32) spins_out[(size_t)k * N + i] = sp[i];
  if (lane == 0) {
    sa_out[k] = sa;
    acc_out[k] = acc;
  }
}

template <int R>
cudaError_t launch(const float2* w, const float2* a, const float* spins_in, const float2* y_in,
                   const float2* sa_in, const int* sched, const float* u, float* spins_out,
                   float2* y_out, float2* sa_out, int* acc_out, int K, int N, int n_sites,
                   int n_steps, cudaStream_t stream) {
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = sizeof(float) * kWarpsPerBlock * N;
  sweep_kernel<R><<<grid, 32 * kWarpsPerBlock, smem, stream>>>(
      w, a, spins_in, y_in, sa_in, sched, u, spins_out, y_out, sa_out, acc_out, K, N, n_sites,
      n_steps);
  return cudaGetLastError();
}

}  // namespace

// All complex arrays are interleaved (re, im) float pairs, row-major:
// w (N, H), a (N,), y (K, H), sa (K,); spins (K, N); sched (n_sites,);
// u (n_steps, K); acc_out (K,) accepted proposals per walker.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int nqs_sweep_f32(const void* w, const void* a, const void* spins_in, const void* y_in,
                             const void* sa_in, const void* sched, const void* u, void* spins_out,
                             void* y_out, void* sa_out, void* acc_out, int K, int N, int H,
                             int n_sites, int n_steps, void* stream) {
  if (K <= 0 || N <= 0 || n_sites <= 0 || n_steps <= 0 || H % 32 != 0) return cudaErrorInvalidValue;
#define NQS_SWEEP_CASE(R)                                                                    \
  case R:                                                                                    \
    return launch<R>(static_cast<const float2*>(w), static_cast<const float2*>(a),          \
                     static_cast<const float*>(spins_in), static_cast<const float2*>(y_in),  \
                     static_cast<const float2*>(sa_in), static_cast<const int*>(sched),      \
                     static_cast<const float*>(u), static_cast<float*>(spins_out),           \
                     static_cast<float2*>(y_out), static_cast<float2*>(sa_out),              \
                     static_cast<int*>(acc_out), K, N, n_sites, n_steps,                     \
                     static_cast<cudaStream_t>(stream));
  switch (H / 32) {
    NQS_SWEEP_CASE(1)
    NQS_SWEEP_CASE(2)
    NQS_SWEEP_CASE(4)
    NQS_SWEEP_CASE(8)
    NQS_SWEEP_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_SWEEP_CASE
}
