// Off-diagonal local-energy sum for the log-cosh machines, Hopper: float32
// instances (below) and float64 instances (offdiag_kernel_f64, further down,
// a design of their own).
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
// Bound on an H100: the 13 float operations per (walker, site, hidden unit)
// that the function needs (a complex multiply-add and a complex product; 28
// with c; chip_smoke.py counts them, the same for every form of it) against
// 16 bytes of y per (walker, hidden unit) read once, so the kernel is bound
// by operations; this log-cosh form evaluates the complex ln cosh (about 25
// float operations counting exp, log and atan2 as one) and issues about 45
// floating-point and MUFU instructions per element, 20 of them the
// polynomial atan2 (PERF.md). For
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
// Pallas kernel is float32 only). Per walker, site i and hidden unit j, with
// y = x + iv and s = s_i,
//
//     cosh(y - 2 s w_ij) / cosh(y) = e^{-2 s w_ij} (c_j + u_j G_ij) / D_j,
//
// where G_ij = e^{4 s w_ij} (the table), u_j = e^{-2 max(x, 0)} e^{-2iv} and
// c_j = e^{-2 max(-x, 0)} (so |u_j| <= 1 and c_j <= 1), and D_j = c_j + u_j,
// taken as (p + iq) e^{-iv} from the stable split planes p = (1 + e) cos v,
// q = (1 - e) sin v sgn x, e = e^{-2|x|} (no cancellation near a zero of
// cosh). So a factor costs one complex multiply-add and no transcendental:
// u_j and c_j are computed once per walker and unit, e^{4sw} once per weight
// tensor (ops/engine.py::kernel_table_f64), and the e^{-2 s w_ij} of a site
// fold into one per-site term, a_i + sum_j w_ij (the wrapper passes that
// shifted a). The factor c_j + u_j G_ij cancels only where cosh of the
// flipped unit nears a zero, as the ratio itself does; the naive
// cosh(2w) - tanh(y) sinh(2w) cancels wherever tanh y tanh 2w nears 1.
//
// RBM family (C = false): the ratio of site i is e^{-2 s (a_i + sum_j w_ij)}
// prod_j (c_j + u_j G_ij) / prod_j D_j; each product keeps its own power of
// two (renorm every kRenorm = 4 factors: |factor| <= 1 + e^{4|Re w|}, and
// four of them times a product in [1, 2) stay below 2^1023 for every
// |Re w| <= 43, the range of ops/engine.py::check_f64_range, at any H), and
// one exp and sincos per site close it. The exponent's large parts cancel
// exactly (-2 s Re a'_i against k ln 2, ln 2 in two parts), and then the
// rounding error of a'_i (a second per-site term) enters, so that a large
// a' (|Re w| = 25 at every unit of a site puts it near 6400) costs no
// relative error of order |a'| 2^-52. FFNN family (C = true): c_j Log cosh does not factor, so each element
// takes ln|c_j + u_j G_ij| and Arg(c_j + u_j G_ij) (the library's double log
// and atan2; no exp) and the principal branch of the flipped unit,
// Im Log cosh(y') = wrap(v - 2 s Im w_ij + Arg(c_j + u_j G_ij)) into
// [-pi, pi] (v reduced once per walker and unit), the JAX package's
// principal log-cosh; the walker's sum_j c_j (-ln|D_j| - i Arg cosh y_j) and
// the site's -2 s sum_j c_j Re w_ij are terms once per walker and per site.
//
// Layout: 16 warps a block, one walker a warp; lane l takes the sites
// pass*64 + q*32 + l, q = 0, 1, so no sum crosses lanes before the walker's
// last. The block streams the table in tiles of 64 sites x 32 hidden units,
// both orientations (s = +1, -1; a lane reads its site's), double-buffered
// in shared memory by cp.async, so the block's 16 walkers share one copy of
// each tile; a warp writes its walker's state of the tile's 32 units (u, c;
// with C also v and c_j) to shared memory (a unit per lane, its y and c_j
// loaded a tile ahead) and every lane reads it as a broadcast. No per-unit
// state lives in registers, so one instance per family serves every
// 1 <= H <= 512.
//
// Bound: the float32 instance's operations per element at the card's float64
// rate outside the tensor cores (34 TFLOP/s on an H100 SXM). Without c this
// form does 8 double operations per element (the complex multiply-add and
// the complex product), fewer than that count; its shared-memory reads (16
// bytes of G per element, the lanes on distinct sites) set a floor of their
// own (PERF.md). With c the library's log and atan2 dominate.

namespace f64 {

constexpr int kWarps = 16;   // walkers of a block: they share every tile
constexpr int kSites = 64;   // sites of a pass: two per lane
constexpr int kUnits = 32;   // hidden units of a tile: one per lane in the state phase
constexpr int kRenorm = 4;   // factors between renormalisations of a product
constexpr int kUnroll = 8;   // units of a tile in one pass of the unrolled unit loop (a multiple of kRenorm)
constexpr int kTileG = 2 * kUnits * kSites;  // double2 entries of a tile: both orientations
constexpr int kTileW = kUnits * kSites;      // doubles of Im w in a tile (C)
// ln 2 in two parts: kLn2Hi has 32 significant bits, so k kLn2Hi is exact for |k| < 2^20
constexpr double kLn2Hi = 6.93147180369123816490e-01, kLn2Lo = 1.90821492927058770002e-10;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kInvTwoPi = 0.15915494309189535;

// doubles of a walker's state per unit: (Re u, Im u, c, -) or, with C,
// (Re u, Im u, c, v reduced, Re c_j, Im c_j, -, -)
template <bool C>
__host__ __device__ constexpr int state_doubles() { return C ? 8 : 4; }

template <bool C>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(double2) * 2 * kTileG + (C ? sizeof(double) * 2 * kTileW : 0) +
         sizeof(double) * kWarps * kUnits * state_doubles<C>();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending)); }

__device__ __forceinline__ double2 cmul(double2 p, double2 q) {
  return make_double2(fma(p.x, q.x, -p.y * q.y), fma(p.x, q.y, p.y * q.x));
}

// p scaled by a power of two so that its larger part lies in [1, 2); the
// power is added to ex (exact: only the exponent field moves).
__device__ __forceinline__ void renorm(double2& p, int& ex) {
  const int er = (__double2hiint(p.x) >> 20) & 0x7ff, ei = (__double2hiint(p.y) >> 20) & 0x7ff;
  const int e = min(max(max(er, ei), 1), 2045);
  const double scale = __hiloint2double((2046 - e) << 20, 0);  // 2^(1023 - e)
  p.x *= scale;
  p.y *= scale;
  ex += e - 1023;
}

// The walker's state of a unit (one per lane) from its y and c_j into st;
// on the first pass also the lane's share of the walker's term: with C the
// sum of c_j (-ln|D_j| - i Arg cosh y_j), else the product of the D_j (dacc,
// dex). A unit past H (valid false) is padding: u = 0 and c = 1, so its
// factor is exactly 1 (and c_j = 0).
template <bool C>
__device__ __forceinline__ void unit_state(double2 yv, double2 cj, bool valid, bool first, double* st, double2& dacc,
                                           int& dex) {
  if (!valid) {
    st[0] = st[1] = 0.0;
    st[2] = 1.0;
    if constexpr (C) st[3] = st[4] = st[5] = 0.0;
    return;
  }
  const double ax = fabs(yv.x), e = exp(-2.0 * ax);
  double sv, cv;
  sincos(yv.y, &sv, &cv);
  const bool pos = yv.x >= 0.0;
  const double us = pos ? e : 1.0;
  st[0] = us * ((cv - sv) * (cv + sv));  // u = e^{-2 max(x, 0)} (cos 2v, -sin 2v)
  st[1] = -us * (2.0 * sv * cv);
  st[2] = pos ? 1.0 : e;  // c = e^{-2 max(-x, 0)}
  if constexpr (C) {
    st[3] = fma(-kTwoPi, rint(yv.y * kInvTwoPi), yv.y);
    st[4] = cj.x;
    st[5] = cj.y;
  }
  if (!first) return;
  const double p = (1.0 + e) * cv, q = (pos ? -1.0 : 1.0) * expm1(-2.0 * ax) * sv;
  if constexpr (C) {
    const double lnd = 0.5 * log(fma(p, p, q * q)), th = atan2(q, p);
    dacc.x -= fma(cj.x, lnd, -cj.y * th);
    dacc.y -= fma(cj.x, th, cj.y * lnd);
  } else {
    dacc = cmul(dacc, make_double2(fma(p, cv, q * sv), fma(q, cv, -p * sv)));  // D = (p + iq) e^{-iv}
    renorm(dacc, dex);
  }
}

template <bool C>
__global__ void __launch_bounds__(32 * kWarps, 1)
offdiag_kernel_f64(const double2* __restrict__ tab, const double2* __restrict__ a, const double2* __restrict__ a_lo,
                   const double2* __restrict__ c, const double* __restrict__ spins, const double2* __restrict__ y,
                   double2* __restrict__ out, int K, int N, int H) {
  extern __shared__ __align__(16) double s_f64[];
  double2* s_tile = reinterpret_cast<double2*>(s_f64);  // [2 buffers][kTileG]
  double* s_wim = s_f64 + 2 * 2 * kTileG;                // C: [2 buffers][kTileW]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* st = s_f64 + 2 * 2 * kTileG + (C ? 2 * kTileW : 0) + warp * kUnits * state_doubles<C>();
  const int k = blockIdx.x * kWarps + warp;
  const bool live = k < K;  // uniform over the warp; a warp past K stages tiles and passes the barriers
  const int n_pass = (N + kSites - 1) / kSites, n_tile = (H + kUnits - 1) / kUnits, total = n_pass * n_tile;
  const double* wim = reinterpret_cast<const double*>(tab + (size_t)total * kTileG);  // C: after the G tiles

  auto stage = [&](int it) {  // tile it = pass * n_tile + t into buffer it & 1
    const double2* src = tab + (size_t)it * kTileG;
    double2* dst = s_tile + (it & 1) * kTileG;
    for (int n = threadIdx.x; n < kTileG; n += blockDim.x) cp_async16(dst + n, src + n);
    if constexpr (C) {
      const double* wsrc = wim + (size_t)it * kTileW;
      double* wdst = s_wim + (it & 1) * kTileW;
      for (int n = 2 * threadIdx.x; n < kTileW; n += 2 * blockDim.x) cp_async16(wdst + n, wsrc + n);
    }
    cp_async_commit();
  };

  double2 tot = make_double2(0.0, 0.0);
  double2 dacc = make_double2(C ? 0.0 : 1.0, 0.0);  // the walker's term (unit_state)
  int dex = 0;
  // the lane's unit of the next tile: its y and c_j, loaded a tile ahead
  auto unit_in = [&](int it, double2& yv, double2& cj) {
    const int j = (it % n_tile) * kUnits + lane;
    if (live && j < H) {
      yv = y[(size_t)k * H + j];
      if constexpr (C) cj = c[j];
    }
  };
  double2 yv = make_double2(0.0, 0.0), cj = make_double2(1.0, 0.0);
  unit_in(0, yv, cj);
  stage(0);
#pragma unroll 1
  for (int p = 0; p < n_pass; ++p) {
    double sg[2];
    int off[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = p * kSites + q * 32 + lane;
      sg[q] = live && i < N ? spins[(size_t)k * N + i] : 1.0;
      off[q] = (sg[q] > 0.0 ? 0 : kUnits * kSites) + q * 32 + lane;  // the orientation of the lane's site
    }
    // per site: with C the sum of c_j Log of the factors, else their product and its power of two
    double2 acc[2] = {make_double2(C ? 0.0 : 1.0, 0.0), make_double2(C ? 0.0 : 1.0, 0.0)};
    int ex[2] = {0, 0};
#pragma unroll 1
    for (int t = 0; t < n_tile; ++t) {
      const int it = p * n_tile + t;
      if (it + 1 < total) stage(it + 1);  // its buffer was last read before the previous trailing barrier
      if (live) unit_state<C>(yv, cj, t * kUnits + lane < H, p == 0, st + lane * state_doubles<C>(), dacc, dex);
      if (it + 1 < total)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < total) unit_in(it + 1, yv, cj);
      if (live) {
        const double2* tile = s_tile + (it & 1) * kTileG;
        const double* tw = s_wim + (it & 1) * kTileW;
#pragma unroll 1
        for (int j0 = 0; j0 < kUnits; j0 += kUnroll) {
#pragma unroll
          for (int jj = j0; jj < j0 + kUnroll; ++jj) {
            const double* e = st + jj * state_doubles<C>();
            const double2 u = *reinterpret_cast<const double2*>(e);
            const double cc = e[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const double2 g = tile[off[q] + jj * kSites];
              const double2 m = make_double2(fma(u.x, g.x, fma(-u.y, g.y, cc)), fma(u.x, g.y, u.y * g.x));
              if constexpr (C) {
                const double2 cj = *reinterpret_cast<const double2*>(e + 4);
                const double lr = 0.5 * log(fma(m.x, m.x, m.y * m.y));
                double ph = fma(-2.0 * sg[q], tw[q * 32 + lane + jj * kSites], e[3]) + atan2(m.y, m.x);
                ph = fma(-kTwoPi, rint(ph * kInvTwoPi), ph);  // the flipped unit's principal Arg cosh
                acc[q].x = fma(cj.x, lr, fma(-cj.y, ph, acc[q].x));
                acc[q].y = fma(cj.x, ph, fma(cj.y, lr, acc[q].y));
              } else {
                acc[q] = cmul(acc[q], m);
              }
            }
            if constexpr (!C) {
              if ((jj - j0) % kRenorm == kRenorm - 1) {
                renorm(acc[0], ex[0]);
                renorm(acc[1], ex[1]);
              }
            }
          }
        }
      }
      __syncthreads();
    }
    if (!live) continue;
    if (p == 0) {  // the walker's term over the lanes' units
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const double2 other =
            make_double2(__shfl_xor_sync(nqs::kFull, dacc.x, o), __shfl_xor_sync(nqs::kFull, dacc.y, o));
        if constexpr (C) {
          dacc.x += other.x;
          dacc.y += other.y;
        } else {
          dex += __shfl_xor_sync(nqs::kFull, dex, o);
          dacc = cmul(dacc, other);
          renorm(dacc, dex);
        }
      }
      if constexpr (!C) {  // 1 / prod D_j, whose power of two is -dex
        const double inv = 1.0 / fma(dacc.x, dacc.x, dacc.y * dacc.y);
        dacc = make_double2(dacc.x * inv, -dacc.y * inv);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = p * kSites + q * 32 + lane;
      if (i >= N) continue;
      const double2 av = a[i], al = a_lo[i];  // a_i + sum_j w_ij, or with C a_i + sum_j c_j Re w_ij, in two parts
      double zr = -2.0 * sg[q] * av.x, zi = -2.0 * sg[q] * av.y;
      double2 mant = make_double2(1.0, 0.0);
      if constexpr (C) {
        zr += acc[q].x + dacc.x;
        zi += acc[q].y + dacc.y;
      } else {
        // the exponent's large parts first: -2 s Re a' and k ln 2 (exact, k < 2^20) cancel exactly
        const double kk = static_cast<double>(ex[q] - dex);
        zr = fma(kk, kLn2Lo, fma(kk, kLn2Hi, zr));
        mant = cmul(acc[q], dacc);
      }
      zr = fma(-2.0 * sg[q], al.x, zr);
      zi = fma(-2.0 * sg[q], al.y, zi);
      const double mag = exp(zr);
      double sn, cs;
      sincos(zi, &sn, &cs);
      tot.x += mag * fma(mant.x, cs, -mant.y * sn);
      tot.y += mag * fma(mant.x, sn, mant.y * cs);
    }
  }
  if (!live) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tot.x += __shfl_xor_sync(nqs::kFull, tot.x, o);
    tot.y += __shfl_xor_sync(nqs::kFull, tot.y, o);
  }
  if (lane == 0) out[k] = tot;
}

template <bool C>
cudaError_t launch_f64(const void* tab, const void* a, const void* a_lo, const void* c, const void* spins,
                       const void* y, void* out, int K, int N, int H, void* stream) {
  // over 48 KB of dynamic shared memory must be allowed (per device, so on every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      offdiag_kernel_f64<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes<C>()));
  if (attr != cudaSuccess) return attr;
  offdiag_kernel_f64<C><<<(K + kWarps - 1) / kWarps, 32 * kWarps, smem_bytes<C>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(tab), static_cast<const double2*>(a), static_cast<const double2*>(a_lo),
      static_cast<const double2*>(c), static_cast<const double*>(spins), static_cast<const double2*>(y),
      static_cast<double2*>(out), K, N, H);
  return cudaGetLastError();
}

}  // namespace f64

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

// The float64 instance: tab is ops/engine.py::kernel_table_f64's flat
// float64 table (e^{4 s w} in tiles of 64 sites x 32 hidden units, both
// orientations, zero-padded; with c then Im w in the same tiles), a (N,) the
// per-site term a_i + sum_j w_ij (c null) or a_i + sum_j c_j Re w_ij, c (H,)
// or null, y (K, H), out (K,) complex128; spins (K, N) double; after the
// stream a_lo (N,), the rounding error of the per-site term
// (ops/engine.py::_site_term_lo). 1 <= H <= 512. Returns the cudaError_t of
// the launch.
extern "C" int nqs_offdiag_f64_tiled(const void* tab, const void* a, const void* c, const void* spins, const void* y,
                                     void* out, int K, int N, int H, void* stream, const void* a_lo) {
  if (K <= 0 || N <= 0 || H < 1 || H > 32 * nqs::kMaxR || a_lo == nullptr) return cudaErrorInvalidValue;
  if (c != nullptr) return f64::launch_f64<true>(tab, a, a_lo, c, spins, y, out, K, N, H, stream);
  return f64::launch_f64<false>(tab, a, a_lo, c, spins, y, out, K, N, H, stream);
}
