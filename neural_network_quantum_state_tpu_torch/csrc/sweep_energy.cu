// Fused sweep + off-diagonal local-energy megakernel for the RBM family
// (c = 1), float32, Hopper. As the TPU kernel, it takes no output weights c:
// the entry point refuses them.
//
// Replaces the TPU kernel
// neural_network_quantum_state_tpu/ops/pallas_sweep_energy.py
// ::_sweep_energy_kernel. One launch runs the Metropolis sweeps of sweep.cu
// (n_beta >= 1, with the replica-exchange phases after each sweep) and then,
// on the post-sweep state that is still in registers (y) and shared memory
// (spins), the off-diagonal sum of energy.cu:
//
//     out[k] = sum_i exp( ln psi(flip_i s') - ln psi(s') )
//
// for every walker row k, tempered replicas included (the caller slices the
// beta = 1 rows). The two phases are the device functions of rbm.cuh that
// sweep.cu and energy.cu run, so on the same uniforms the megakernel takes the
// same decisions and forms the same sums as the two kernels; ln psi_0 of the
// energy phase is recomputed with the energy phase's complex log-cosh. What
// the fusion saves is the (K, H) round trip of y and the spins through device
// memory between the two kernels, and one launch.
//
// The sweep phase runs the tempered instance of the sweep's device function
// (any n_beta, T = true) or its n_beta = 1 instance, as sweep.cu does; the
// energy phase reads the caller's (N, H) table of energy.cu.
//
// Bound on an H100: the sum of the two kernels' operations (about 20 per
// (walker, proposal, hidden unit) and 25 per (walker, site, hidden unit)),
// against the bytes of one kernel's state read and written once, so it is
// bound by operations; in practice by the latency of the transcendental chain
// of one proposal or site, which the resident walkers hide only in part.

#include "rbm.cuh"

namespace {

using nqs::SweepArgs;

template <int R, bool T>
__global__ void __launch_bounds__(32 * nqs::sweep_block_warps(T),
                                  nqs::min_blocks(nqs::kWideRegs, nqs::sweep_block_warps(T)))
sweep_energy_kernel(SweepArgs p, const float4* __restrict__ wt, const float* __restrict__ spins_in,
                    const float2* __restrict__ y_in, const float2* __restrict__ sa_in, float* __restrict__ spins_out,
                    float2* __restrict__ y_out, float2* __restrict__ sa_out, int* __restrict__ flip_out,
                    int* __restrict__ swap_out, float2* __restrict__ out) {
  extern __shared__ float smem[];
  const int G = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * G;
  const int k = base + warp;
  const bool active = k < p.K;  // uniform over the warp
  float* sp = smem + warp * p.N;
  float* s_ln = smem + G * p.N;
  int* s_flip = reinterpret_cast<int*>(s_ln + 2 * G);
  int* s_swap = s_flip + G;
  if (lane == 0) {
    s_flip[warp] = 0;
    s_swap[warp] = 0;
  }
  float yr[R], yi[R];
  float2 sa = make_float2(0.0f, 0.0f);
  if (active) {
    for (int i = lane; i < p.N; i += 32) sp[i] = spins_in[(size_t)k * p.N + i];
    nqs::load_row<R>(y_in + (size_t)k * p.H, p.H, lane, yr, yi);
    sa = sa_in[k];
  }
  __syncthreads();

  int row = k;
  nqs::sweep_walker<R, false, T>(p, nullptr, active, base, row, sp, yr, yi, sa, s_ln, s_flip, s_swap);

  if (active) {
    nqs::store_row<R>(y_out + (size_t)row * p.H, p.H, lane, yr, yi);
    for (int i = lane; i < p.N; i += 32) spins_out[(size_t)row * p.N + i] = sp[i];
    const float2 acc = nqs::offdiag_walker<R, false>(wt, p.a, nullptr, sp, yr, yi, p.N, p.H);
    if (lane == 0) {
      sa_out[row] = sa;
      out[row] = acc;
    }
  }
  __syncthreads();
  if (active && lane == 0) {
    flip_out[k] = s_flip[warp];
    swap_out[k] = s_swap[warp];
  }
}

template <int R, bool T>
cudaError_t launch(const SweepArgs& p, const float4* wt, const float* spins_in, const float2* y_in,
                   const float2* sa_in, float* spins_out, float2* y_out, float2* sa_out, int* flip_out, int* swap_out,
                   float2* out, cudaStream_t stream) {
  const int G = nqs::sweep_warps(p.n_beta);
  const dim3 grid((p.K + G - 1) / G);
  const size_t smem = nqs::sweep_smem_bytes<R, false>(G, p.N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sweep_energy_kernel<R, T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  sweep_energy_kernel<R, T><<<grid, 32 * G, smem, stream>>>(p, wt, spins_in, y_in, sa_in, spins_out, y_out,
                                                            sa_out, flip_out, swap_out, out);
  return cudaGetLastError();
}

template <bool T>
cudaError_t dispatch(const SweepArgs& p, const void* wt, const void* spins_in, const void* y_in, const void* sa_in,
                     void* spins_out, void* y_out, void* sa_out, void* flip_out, void* swap_out, void* out,
                     void* stream) {
#define NQS_SWEEP_ENERGY_CASE(R)                                                                   \
  case R:                                                                                          \
    return launch<R, T>(p, static_cast<const float4*>(wt), static_cast<const float*>(spins_in),   \
                        static_cast<const float2*>(y_in), static_cast<const float2*>(sa_in),       \
                        static_cast<float*>(spins_out), static_cast<float2*>(y_out),               \
                        static_cast<float2*>(sa_out), static_cast<int*>(flip_out),                 \
                        static_cast<int*>(swap_out), static_cast<float2*>(out),                    \
                        static_cast<cudaStream_t>(stream));
  switch ((p.H + 31) / 32) {
    NQS_FOR_EACH_R(NQS_SWEEP_ENERGY_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef NQS_SWEEP_ENERGY_CASE
}

}  // namespace

// The arguments of nqs_sweep_f32 (sweep.cu), with the energy kernel's table
// wt (N, H, 4) floats (energy.cu) and out (K,) complex, the off-diagonal sum
// of each row's post-sweep state, after swap_out. c must be null (the RBM
// family). Returns the cudaError_t of the launch (0 on success).
extern "C" int nqs_sweep_offdiag_f32(const void* w, const void* a, const void* c, const void* spins_in,
                                     const void* y_in, const void* sa_in, const void* sched, const void* u,
                                     const void* u_swap, const void* key, void* spins_out, void* y_out,
                                     void* sa_out, void* flip_out, void* swap_out, const void* wt, void* out,
                                     int K, int N, int H, int n_sites, int n_steps, int n_beta, void* stream) {
  if (K <= 0 || N <= 0 || n_sites <= 0 || n_steps <= 0 || H < 1 || H > 32 * nqs::kMaxR ||
      nqs::sweep_warps(n_beta) == 0 || K % n_beta != 0 || c != nullptr || wt == nullptr)
    return cudaErrorInvalidValue;
  if (n_beta > 1 && n_steps % n_sites != 0) return cudaErrorInvalidValue;
  if (u == nullptr ? key == nullptr : n_beta > 1 && u_swap == nullptr) return cudaErrorInvalidValue;
  const SweepArgs p{static_cast<const float2*>(w), static_cast<const float2*>(a), static_cast<const int*>(sched),
                    static_cast<const float*>(u), static_cast<const float*>(u_swap),
                    static_cast<const long long*>(key), static_cast<const float4*>(wt), K, N, H, n_sites, n_steps,
                    n_beta};
#define NQS_SWEEP_ENERGY_ARGS p, wt, spins_in, y_in, sa_in, spins_out, y_out, sa_out, flip_out, swap_out, out, stream
  return n_beta > 1 ? dispatch<true>(NQS_SWEEP_ENERGY_ARGS) : dispatch<false>(NQS_SWEEP_ENERGY_ARGS);
#undef NQS_SWEEP_ENERGY_ARGS
}
