// Bundle-adjustment residual/Jacobian and cost kernels for NVIDIA Hopper.
//
// Replace the two Pallas kernels of opensfm_tpu/ops/pallas_kernels/ba_resjac.py:
//   fused_residual_jacobian  (_make_kernel, math chain_fwd_jac)
//   fused_cost               (_make_cost_kernel, math _chain)
// for the mono perspective configuration (identity rig, camera [k1, k2, f]).
//
// Per observation o the chain is
//   X  = R(w_i) x_p + t_i                      (Rodrigues, small-angle series)
//   uv = X[:2] / X[2];  d = 1 + r2 (k1 + k2 r2);  pred = f d uv
//   e  = (pred - obs_uv) * inv_sd;  s = |e|^2;  cost = 0.5 a^2 rho(s / a^2)
// and the Jacobian columns (6 pose, k1/k2/f, 3 point) come from the closed
// form d(Rx)/dw (Gallego & Yezzi) composed with the 2x3 projection Jacobian,
// scaled by inv_sd * sqrt(rho'), exactly as the reference's kernel.
//
// What bounds them on the card: memory.  fused_residual_jacobian reads about
// 36 B per observation in f64 (uv, inv_sd, three int32 indices; the pose,
// camera and point tables are tiny and stay in L2) and writes 216 B (r, 18 Jc,
// 6 Jp, cost).  At O = 262,144 that is about 66 MB, about 20 us at 3.35 TB/s;
// its ~300 flops per observation are far below the f64 rate.  The design
// therefore gives each observation one thread that gathers its own table rows
// (no [16, O] pack or transpose pass as the TPU wrapper needs), keeps the
// whole chain in registers and writes each output once, row-major, straight
// into the [O, 2, 9] / [O, 2, 3] layouts the reduced-system assembly reads.
// fused_cost reads the same 36 B and writes nothing per observation: a
// grid-stride loop sums into registers, a fixed shared-memory tree reduces
// each block, and a second single-block pass reduces the block partials.  No
// atomics: the sum is the same from run to run, which the LM accept/reject
// comparison of costs relies on.
//
// Interface: plain C functions (ctypes), launched on the caller's stream; each
// returns cudaGetLastError() after its launches (or -1 for an unknown loss).
// Observations whose indices fall outside the tables produce NaN.  The chain
// itself is in ba_chain.cuh, shared with ba_assemble.cu.

#include <cuda_runtime.h>

#include "ba_chain.cuh"

namespace {

struct Tables {
  int n_inst, n_cam, cam_stride, n_points;
};

// Gathers observation o's 12 chain inputs; false when an index is invalid.
template <typename T>
__device__ __forceinline__ bool gather(const T* inst, const T* cam,
                                       const T* points, const int* obs_inst,
                                       const int* obs_cam, const int* obs_point,
                                       Tables tb, long long o, T* v) {
  const int ii = obs_inst[o], ic = obs_cam[o], ip = obs_point[o];
  if (ii < 0 || ii >= tb.n_inst || ic < 0 || ic >= tb.n_cam || ip < 0 ||
      ip >= tb.n_points) {
    return false;
  }
  const T* pi = inst + 6LL * ii;
  const T* pc = cam + (long long)tb.cam_stride * ic;
  const T* pp = points + 3LL * ip;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = pi[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[6 + k] = pc[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[9 + k] = pp[k];
  return true;
}

template <typename T, int LOSS>
__global__ void resjac_kernel(const T* __restrict__ inst,
                              const T* __restrict__ cam,
                              const T* __restrict__ points,
                              const int* __restrict__ obs_inst,
                              const int* __restrict__ obs_cam,
                              const int* __restrict__ obs_point,
                              const T* __restrict__ obs_uv,
                              const T* __restrict__ obs_inv_sd, Tables tb,
                              long long n_obs, T a2, T* __restrict__ r,
                              T* __restrict__ Jc, T* __restrict__ Jp,
                              T* __restrict__ cost) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_obs) return;
  T v[12];
  T p0, p1, J0[12], J1[12];
  T isd = obs_inv_sd[o];
  if (gather(inst, cam, points, obs_inst, obs_cam, obs_point, tb, o, v)) {
    chain_fwd_jac(v, p0, p1, J0, J1);
  } else {
    const T nan = quiet_nan<T>();
    p0 = p1 = isd = nan;
#pragma unroll
    for (int k = 0; k < 12; ++k) J0[k] = J1[k] = nan;
  }
  const T e0 = (p0 - obs_uv[2 * o]) * isd;
  const T e1 = (p1 - obs_uv[2 * o + 1]) * isd;
  const T s = e0 * e0 + e1 * e1;
  T rho, drho;
  loss_eval<T, LOSS>(s / a2, rho, drho);
  const T sw = sqrt_weight(drho);
  const T scale = isd * sw;
  r[2 * o] = e0 * sw;
  r[2 * o + 1] = e1 * sw;
  T* jc = Jc + 18 * o;
  T* jp = Jp + 6 * o;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    jc[k] = J0[k] * scale;
    jc[9 + k] = J1[k] * scale;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    jp[k] = J0[9 + k] * scale;
    jp[3 + k] = J1[9 + k] * scale;
  }
  cost[o] = T(0.5) * a2 * rho;
}

template <typename T, int LOSS>
__global__ void __launch_bounds__(kCostBlock)
    cost_partials_kernel(const T* __restrict__ inst, const T* __restrict__ cam,
                         const T* __restrict__ points,
                         const int* __restrict__ obs_inst,
                         const int* __restrict__ obs_cam,
                         const int* __restrict__ obs_point,
                         const T* __restrict__ obs_uv,
                         const T* __restrict__ obs_inv_sd, Tables tb,
                         long long n_obs, T a2, T* __restrict__ partials) {
  T acc = T(0);
  const long long stride = (long long)gridDim.x * kCostBlock;
  for (long long o = (long long)blockIdx.x * kCostBlock + threadIdx.x;
       o < n_obs; o += stride) {
    T v[12];
    T p0, p1;
    T isd = obs_inv_sd[o];
    if (gather(inst, cam, points, obs_inst, obs_cam, obs_point, tb, o, v)) {
      chain_fwd(v, p0, p1);
    } else {
      p0 = p1 = isd = quiet_nan<T>();
    }
    const T e0 = (p0 - obs_uv[2 * o]) * isd;
    const T e1 = (p1 - obs_uv[2 * o + 1]) * isd;
    T rho, drho;
    loss_eval<T, LOSS>((e0 * e0 + e1 * e1) / a2, rho, drho);
    acc += T(0.5) * a2 * rho;
  }
  const T total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T, int LOSS>
void launch_resjac(const T* inst, const T* cam, const T* points,
                   const int* obs_inst, const int* obs_cam,
                   const int* obs_point, const T* obs_uv, const T* obs_inv_sd,
                   Tables tb, long long n_obs, T a2, T* r, T* Jc, T* Jp,
                   T* cost, cudaStream_t stream) {
  const int block = 128;
  const long long grid = (n_obs + block - 1) / block;
  resjac_kernel<T, LOSS><<<(unsigned)grid, block, 0, stream>>>(
      inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd, tb,
      n_obs, a2, r, Jc, Jp, cost);
}

template <typename T>
int resjac(const T* inst, int n_inst, const T* cam, int n_cam, int cam_stride,
           const T* points, int n_points, const int* obs_inst,
           const int* obs_cam, const int* obs_point, const T* obs_uv,
           const T* obs_inv_sd, long long n_obs, int loss, T loss_threshold,
           T* r, T* Jc, T* Jp, T* cost, void* stream) {
  const Tables tb{n_inst, n_cam, cam_stride, n_points};
  const T a2 = loss_threshold * loss_threshold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OSFM_RESJAC(L)                                                       \
  launch_resjac<T, L>(inst, cam, points, obs_inst, obs_cam, obs_point,      \
                      obs_uv, obs_inv_sd, tb, n_obs, a2, r, Jc, Jp, cost, s)
  switch (loss) {
    case 0: OSFM_RESJAC(0); break;
    case 1: OSFM_RESJAC(1); break;
    case 2: OSFM_RESJAC(2); break;
    case 3: OSFM_RESJAC(3); break;
    case 4: OSFM_RESJAC(4); break;
    default: return -1;
  }
#undef OSFM_RESJAC
  return (int)cudaGetLastError();
}

template <typename T>
int cost(const T* inst, int n_inst, const T* cam, int n_cam, int cam_stride,
         const T* points, int n_points, const int* obs_inst, const int* obs_cam,
         const int* obs_point, const T* obs_uv, const T* obs_inv_sd,
         long long n_obs, int loss, T loss_threshold, int n_blocks,
         T* partials, T* out, void* stream) {
  const Tables tb{n_inst, n_cam, cam_stride, n_points};
  const T a2 = loss_threshold * loss_threshold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OSFM_COST(L)                                                        \
  cost_partials_kernel<T, L><<<n_blocks, kCostBlock, 0, s>>>(               \
      inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd,  \
      tb, n_obs, a2, partials)
  switch (loss) {
    case 0: OSFM_COST(0); break;
    case 1: OSFM_COST(1); break;
    case 2: OSFM_COST(2); break;
    case 3: OSFM_COST(3); break;
    case 4: OSFM_COST(4); break;
    default: return -1;
  }
#undef OSFM_COST
  cost_final_kernel<T><<<1, kCostBlock, 0, s>>>(partials, n_blocks, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ba_resjac_f32(const float* inst, int n_inst, const float* cam, int n_cam,
                  int cam_stride, const float* points, int n_points,
                  const int* obs_inst, const int* obs_cam, const int* obs_point,
                  const float* obs_uv, const float* obs_inv_sd, long long n_obs,
                  int loss, double loss_threshold, float* r, float* Jc,
                  float* Jp, float* cost_out, void* stream) {
  return resjac<float>(inst, n_inst, cam, n_cam, cam_stride, points, n_points,
                       obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd, n_obs,
                       loss, (float)loss_threshold, r, Jc, Jp, cost_out,
                       stream);
}

int ba_resjac_f64(const double* inst, int n_inst, const double* cam,
                  int n_cam, int cam_stride, const double* points,
                  int n_points, const int* obs_inst, const int* obs_cam,
                  const int* obs_point, const double* obs_uv,
                  const double* obs_inv_sd, long long n_obs, int loss,
                  double loss_threshold, double* r, double* Jc, double* Jp,
                  double* cost_out, void* stream) {
  return resjac<double>(inst, n_inst, cam, n_cam, cam_stride, points,
                        n_points, obs_inst, obs_cam, obs_point, obs_uv,
                        obs_inv_sd, n_obs, loss, loss_threshold, r, Jc, Jp,
                        cost_out, stream);
}

int ba_cost_f32(const float* inst, int n_inst, const float* cam, int n_cam,
                int cam_stride, const float* points, int n_points,
                const int* obs_inst, const int* obs_cam, const int* obs_point,
                const float* obs_uv, const float* obs_inv_sd, long long n_obs,
                int loss, double loss_threshold, int n_blocks, float* partials,
                float* out, void* stream) {
  return cost<float>(inst, n_inst, cam, n_cam, cam_stride, points, n_points,
                     obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd, n_obs,
                     loss, (float)loss_threshold, n_blocks, partials, out,
                     stream);
}

int ba_cost_f64(const double* inst, int n_inst, const double* cam, int n_cam,
                int cam_stride, const double* points, int n_points,
                const int* obs_inst, const int* obs_cam, const int* obs_point,
                const double* obs_uv, const double* obs_inv_sd, long long n_obs,
                int loss, double loss_threshold, int n_blocks,
                double* partials, double* out, void* stream) {
  return cost<double>(inst, n_inst, cam, n_cam, cam_stride, points, n_points,
                      obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd, n_obs,
                      loss, loss_threshold, n_blocks, partials, out, stream);
}

}  // extern "C"
