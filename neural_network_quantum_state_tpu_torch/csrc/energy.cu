// Off-diagonal local-energy sum for the log-cosh machines, Hopper: float32
// instances (below) and a float64 instance (offdiag_kernel_f64, further down).
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

// ---- The float64 instance (energy_dtype = float64) ----
//
// The same sum in double precision, for the estimators that the JAX package
// sends to its XLA path in float64 (hamiltonians/ising.py::_offdiag_sum: the
// Pallas kernel is float32 only). A simple kernel: one warp per walker,
// eight per block; lane l keeps units j = r*32 + l of Re y, cos/sin(Im y) and
// both planes of ln cosh(y_j) in registers (cos/sin by the library's
// double sincos, once per walker). Per site, a unit's candidate cos/sin
// come by angle addition from the (N, H, 4) float64 table (Re w, Im w,
// cos 2 Im w, sin 2 Im w), and its ln cosh by the library's double exp, log
// and atan2 (no fast path, no polynomial); the differences
// sum_j c_j [ln cosh(y'_j) - ln cosh(y_j)] are summed over the warp by a
// butterfly, and every lane takes the site's exp and sincos (double). The
// bound: the float32 instance's operations per element over the card's
// float64 rate outside the tensor cores (34 TFLOP/s on an H100 SXM).

template <int R, bool C>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
offdiag_kernel_f64(const double2* __restrict__ wt, const double2* __restrict__ a, const double2* __restrict__ c,
                   const double* __restrict__ spins, const double2* __restrict__ y, double2* __restrict__ out,
                   int K, int N, int H) {
  constexpr double kLn2d = 0.6931471805599453;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= K) return;  // uniform over the warp
  double yr[R], cy[R], sy[R], l0r[R], l0i[R];
  double2 cj[C ? R : 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    const double2 v = j < H ? y[(size_t)k * H + j] : make_double2(0.0, 0.0);
    yr[r] = v.x;
    sincos(v.y, &sy[r], &cy[r]);
    const double e = exp(-2.0 * fabs(v.x));
    const double pre = (1.0 + e) * cy[r], pim = (1.0 - e) * sy[r] * (v.x < 0.0 ? -1.0 : 1.0);
    l0r[r] = 0.5 * log(pre * pre + pim * pim) + (fabs(v.x) - kLn2d);
    l0i[r] = atan2(pim, pre);
    if constexpr (C) cj[r] = j < H ? __ldg(c + j) : make_double2(0.0, 0.0);
  }
  const double* s = spins + (size_t)k * N;
  double acc_re = 0.0, acc_im = 0.0;
  for (int i = 0; i < N; ++i) {
    const double sg = s[i];
    double dr = 0.0, di = 0.0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = r * 32 + lane;
      if (j < H) {
        const double2 w = __ldg(wt + 2 * ((size_t)i * H + j));  // (Re w, Im w)
        const double2 t = __ldg(wt + 2 * ((size_t)i * H + j) + 1);  // (cos 2 Im w, sin 2 Im w)
        const double x = yr[r] - 2.0 * sg * w.x;
        // cos/sin(Im y - 2 s Im w), with sin(2 s Im w) = s sin(2 Im w)
        const double cv = cy[r] * t.x + sy[r] * (sg * t.y);
        const double sv = sy[r] * t.x - cy[r] * (sg * t.y);
        const double e = exp(-2.0 * fabs(x));
        const double pre = (1.0 + e) * cv, pim = (1.0 - e) * sv * (x < 0.0 ? -1.0 : 1.0);
        const double ddr = 0.5 * log(pre * pre + pim * pim) + (fabs(x) - kLn2d) - l0r[r];
        const double ddi = atan2(pim, pre) - l0i[r];
        if constexpr (C) {
          dr += cj[r].x * ddr - cj[r].y * ddi;
          di += cj[r].x * ddi + cj[r].y * ddr;
        } else {
          dr += ddr;
          di += ddi;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dr += __shfl_xor_sync(nqs::kFull, dr, o);
      di += __shfl_xor_sync(nqs::kFull, di, o);
    }
    const double2 av = __ldg(a + i);
    double sn, cs;
    sincos(di - 2.0 * sg * av.y, &sn, &cs);
    const double mag = exp(dr - 2.0 * sg * av.x);
    acc_re += mag * cs;
    acc_im += mag * sn;
  }
  if (lane == 0) out[k] = make_double2(acc_re, acc_im);
}

template <int R, bool C>
cudaError_t launch_f64(const double2* wt, const double2* a, const double2* c, const double* spins, const double2* y,
                       double2* out, int K, int N, int H, cudaStream_t stream) {
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  offdiag_kernel_f64<R, C><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(wt, a, c, spins, y, out, K, N, H);
  return cudaGetLastError();
}

template <bool C>
cudaError_t dispatch_f64(const void* wt, const void* a, const void* c, const void* spins, const void* y, void* out,
                         int K, int N, int H, void* stream) {
#define NQS_OFFDIAG64_CASE(R)                                                                       \
  case R:                                                                                           \
    return launch_f64<R, C>(static_cast<const double2*>(wt), static_cast<const double2*>(a),        \
                            static_cast<const double2*>(c), static_cast<const double*>(spins),      \
                            static_cast<const double2*>(y), static_cast<double2*>(out), K, N, H,    \
                            static_cast<cudaStream_t>(stream));
  switch ((H + 31) / 32) {
    NQS_FOR_EACH_R(NQS_OFFDIAG64_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_OFFDIAG64_CASE
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

// The float64 instance: the same layout with double (re, im) pairs: wt
// (N, H, 4) doubles, a (N,), c (H,) or null, y (K, H), out (K,) complex128;
// spins (K, N) double. 1 <= H <= 512. Returns the cudaError_t of the launch.
extern "C" int nqs_offdiag_f64(const void* wt, const void* a, const void* c, const void* spins, const void* y,
                               void* out, int K, int N, int H, void* stream) {
  if (K <= 0 || N <= 0 || H < 1 || H > 32 * nqs::kMaxR) return cudaErrorInvalidValue;
  if (c != nullptr) return dispatch_f64<true>(wt, a, c, spins, y, out, K, N, H, stream);
  return dispatch_f64<false>(wt, a, c, spins, y, out, K, N, H, stream);
}
