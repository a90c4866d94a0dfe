// The hot-math chain-rate probe, float32, Hopper: how many elements per
// second the card sustains on the sweep's and the energy kernel's
// per-(site, hidden unit) arithmetic alone.
//
// Replaces the TPU kernel bench.py::_vpu_chain_rate_f32.<locals>.kernel: for
// x and y of n elements it applies a body chain_len times as a dependent
// chain in registers, each element loaded once and stored once. The bodies
// are bench.py's, on this port's device functions, so that the probe runs
// the lowering the production kernels run (the TPU probe's own point,
// bench.py:75-96): an exp or a log lowered another way (the library's, or
// Triton's) would measure another rate.
// - Body 0, the sweep (bench.py _sweep_hot_body): x1 = x - 0.6 y, r = Re ln
//   cosh(x1 + i y) by rbm.cuh logcosh_re_fast (ex2/lg2 on the
//   special-function unit, the polynomial cos), then x' = 0.25 r + 0.1 x,
//   y' = 0.99 y + 0.01 x1.
// - Body 1, the energy (bench.py _energy_hot_body): the angle addition with
//   the constants (cos 2w, sin 2w) = (c2, s2), c1 = y c2 + x s2, s1 = x c2 -
//   y s2, x1 = x - 0.6 y, then both planes of ln cosh from (c1, s1) by
//   rbm.cuh logcosh_ri_cs (ex2, lg2 and the polynomial atan2_fast, the
//   functions energy.cu calls), then x' = 0.2 Re + 0.1 x, y' = 0.2 Im + 0.9 y.
//
// Bound on an H100: 8 bytes in and 8 out per element against chain_len
// bodies of about 38 (sweep) or 60 (energy) float operations (a fused
// multiply-add counts two), two (sweep) or three (energy) of them on the
// special-function unit (MUFU ex2, lg2, and rcp in the atan2): bound by
// operations, at the FMA pipes' 67 TFLOP/s or at the MUFU's 16 results per
// SM per clock, whichever binds (chip_smoke.py states both). One element
// per thread, a grid of n / 256 blocks of 256 threads: every SM holds its
// full 64 warps, whose independent chains hide the latency of each.

#include "rbm.cuh"

namespace {

constexpr int kThreads = 256;

template <int Body>
__device__ __forceinline__ void body(float& x, float& y) {
  if constexpr (Body == 0) {
    const float x1 = fmaf(-0.6f, y, x);
    const float r = nqs::logcosh_re_fast(x1, y);
    x = fmaf(0.25f, r, 0.1f * x);
    y = fmaf(0.99f, y, 0.01f * x1);
  } else {
    constexpr float c2 = 0.8253356149096783f, s2 = 0.5646424733950354f;
    const float c1 = fmaf(y, c2, x * s2);
    const float s1 = fmaf(x, c2, -(y * s2));
    const float x1 = fmaf(-0.6f, y, x);
    float lr, li;
    nqs::logcosh_ri_cs(x1, c1, s1, &lr, &li);
    x = fmaf(0.2f, lr, 0.1f * x);
    y = fmaf(0.2f, li, 0.9f * y);
  }
}

template <int Body>
__global__ void __launch_bounds__(kThreads) chain_kernel(const float* __restrict__ x_in, const float* __restrict__ y_in,
                                                        float* __restrict__ x_out, float* __restrict__ y_out, int n,
                                                        int chain_len) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = x_in[i], y = y_in[i];
#pragma unroll 4
  for (int c = 0; c < chain_len; ++c) body<Body>(x, y);
  x_out[i] = x;
  y_out[i] = y;
}

}  // namespace

// x and y (n,) float32 in, x_out and y_out (n,) out; body 0 (sweep) or 1
// (energy); chain_len >= 0. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int nqs_chain_f32(const void* x, const void* y, void* x_out, void* y_out, int n, int chain_len, int body,
                             void* stream) {
  if (n <= 0 || chain_len < 0 || (body != 0 && body != 1)) return cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  const float* yi = static_cast<const float*>(y);
  float* xo = static_cast<float*>(x_out);
  float* yo = static_cast<float*>(y_out);
  if (body == 0) chain_kernel<0><<<grid, kThreads, 0, s>>>(xi, yi, xo, yo, n, chain_len);
  else chain_kernel<1><<<grid, kThreads, 0, s>>>(xi, yi, xo, yo, n, chain_len);
  return cudaGetLastError();
}
