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
// (no [16, O] pack or transpose pass as the TPU wrapper needs) and keeps the
// whole chain in registers.  Its 27 outputs go to padded shared-memory rows;
// the block then writes its contiguous spans of the row-major [O, 2],
// [O, 2, 9], [O, 2, 3] and [O] outputs (the layouts the reduced-system
// assembly reads) with 16-byte stores from consecutive threads, so every
// written sector is whole.
// fused_cost reads the same 36 B and writes nothing per observation.  Its
// time went to latency and tails, not to bytes: a launch per observation
// block, a second launch for the block sums, a rotation (sqrt, sin, cos,
// divides) per observation though only n_inst rotations exist.  So it is one
// launch (cost_kernel): a grid of about kCostMinBlocks blocks per SM, several
// observations per thread with all their loads in flight, the rotation
// coefficients computed once per block into shared memory (a larger map in
// tiles of the table's rows), and a one-pass sum:
// the last block to finish adds the block sums in block order.  The only
// atomic elects that block, so the sum is the same from run to run, which
// the LM accept/reject comparison of costs relies on.
//
// Interface: plain C functions (ctypes), launched on the caller's stream; each
// returns cudaGetLastError() after its launches (or -1 for an unknown loss,
// -2 for an instance table larger than kInstTableBytes).
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

constexpr int kResjacBlock = 128;  // observations per block of resjac_kernel

template <typename T>
struct Vec16;  // a 16-byte store
template <>
struct Vec16<double> {
  using type = double2;
};
template <>
struct Vec16<float> {
  using type = float4;
};

// Writes the block's span out[0, nb * W) of one output from its staging rows
// (stride S >= W, odd, so that the per-thread staging writes are
// conflict-free): 16-byte stores from consecutive threads, then the span's
// ragged tail element by element.
template <typename T, int W, int S>
__device__ __forceinline__ void store_span(const T* __restrict__ st, int nb,
                                           T* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);
  using V = typename Vec16<T>::type;
  const int len = nb * W;
  const int n_vec = len / kVec;
  for (int q = threadIdx.x; q < n_vec; q += kResjacBlock) {
    V val;
    T* x = reinterpret_cast<T*>(&val);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int e = q * kVec + i;
      x[i] = st[(e / W) * S + e % W];
    }
    reinterpret_cast<V*>(out)[q] = val;
  }
  for (int e = n_vec * kVec + threadIdx.x; e < len; e += kResjacBlock) {
    out[e] = st[(e / W) * S + e % W];
  }
}

// One thread per observation computes its 27 outputs into shared-memory rows;
// after one barrier the block writes its contiguous spans of r [O, 2],
// Jc [O, 2, 9], Jp [O, 2, 3] and cost [O] with coalesced 16-byte stores
// (writing them straight from each thread touches 32 sectors per warp store,
// 144 B apart in Jc).  The span starts at o0 * W elements, 16-byte aligned for
// any W since o0 is a multiple of the block.
template <typename T, int LOSS>
__global__ void __launch_bounds__(kResjacBlock)
    resjac_kernel(const T* __restrict__ inst, const T* __restrict__ cam,
                  const T* __restrict__ points,
                  const int* __restrict__ obs_inst,
                  const int* __restrict__ obs_cam,
                  const int* __restrict__ obs_point,
                  const T* __restrict__ obs_uv,
                  const T* __restrict__ obs_inv_sd, Tables tb, long long n_obs,
                  T a2, T* __restrict__ r, T* __restrict__ Jc,
                  T* __restrict__ Jp, T* __restrict__ cost) {
  constexpr int kSr = 3, kSjc = 19, kSjp = 7;  // odd staging strides
  __shared__ T st_r[kResjacBlock * kSr];
  __shared__ T st_jc[kResjacBlock * kSjc];
  __shared__ T st_jp[kResjacBlock * kSjp];
  __shared__ T st_c[kResjacBlock];
  const long long o0 = (long long)blockIdx.x * kResjacBlock;
  const long long rest = n_obs - o0;
  const int nb = rest < kResjacBlock ? (int)rest : kResjacBlock;
  const int a = threadIdx.x;
  if (a < nb) {
    const long long o = o0 + a;
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
    const auto uv = reinterpret_cast<const typename Vec2<T>::type*>(obs_uv)[o];
    const T e0 = (p0 - uv.x) * isd;
    const T e1 = (p1 - uv.y) * isd;
    const T s = e0 * e0 + e1 * e1;
    T rho, drho;
    loss_eval<T, LOSS>(s / a2, rho, drho);
    const T sw = sqrt_weight(drho);
    const T scale = isd * sw;
    st_r[a * kSr] = e0 * sw;
    st_r[a * kSr + 1] = e1 * sw;
    T* jc = st_jc + a * kSjc;
    T* jp = st_jp + a * kSjp;
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
    st_c[a] = T(0.5) * a2 * rho;
  }
  __syncthreads();
  store_span<T, 2, kSr>(st_r, nb, r + 2 * o0);
  store_span<T, 18, kSjc>(st_jc, nb, Jc + 18 * o0);
  store_span<T, 6, kSjp>(st_jp, nb, Jp + 6 * o0);
  store_span<T, 1, 1>(st_c, nb, cost + o0);
}

// One observation's own inputs (its indices, inv_sd and (u, v)), loaded
// ahead of the chain.
template <typename T>
struct ObsIn {
  int ii, ic, ip;
  T isd;
  typename Vec2<T>::type uv;
};

template <typename T>
__device__ __forceinline__ void load_obs(const int* __restrict__ obs_inst,
                                         const int* __restrict__ obs_cam,
                                         const int* __restrict__ obs_point,
                                         const T* __restrict__ obs_uv,
                                         const T* __restrict__ obs_inv_sd,
                                         long long o, ObsIn<T>& in) {
  in.ii = obs_inst[o];
  in.ic = obs_cam[o];
  in.ip = obs_point[o];
  in.isd = obs_inv_sd[o];
  in.uv = reinterpret_cast<const typename Vec2<T>::type*>(obs_uv)[o];
}

// One observation's cost term 0.5 a^2 rho(|e|^2 / a^2), e = (pred - uv) isd,
// given its point x (loaded by the caller when ip is valid) and its
// instance's row of the block's table (pose and rotation coefficients):
// chain_fwd's arithmetic, so the term has the same bits as the two-pass
// kernels' chain_fwd; NaN for an index outside the tables (row unread).
template <typename T, int LOSS>
__device__ __forceinline__ T cost_term(const T* __restrict__ cam,
                                       const T* row, Tables tb,
                                       const ObsIn<T>& in, const T* x, T a2) {
  T p0, p1, isd = in.isd;
  if (in.ii < 0 || in.ii >= tb.n_inst || in.ic < 0 || in.ic >= tb.n_cam ||
      in.ip < 0 || in.ip >= tb.n_points) {
    p0 = p1 = isd = quiet_nan<T>();
  } else {
    T v[12];
    const T* pc = cam + (long long)tb.cam_stride * in.ic;
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = row[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[6 + k] = pc[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[9 + k] = x[k];
    chain_fwd(v, row[6], row[7], row[8], p0, p1);
  }
  const T e0 = (p0 - in.uv.x) * isd;
  const T e1 = (p1 - in.uv.y) * isd;
  T rho, drho;
  loss_eval<T, LOSS>((e0 * e0 + e1 * e1) / a2, rho, drho);
  return T(0.5) * a2 * rho;
}

constexpr int kCostBatch = 4;  // observations a thread has in flight

// fused_cost in one launch.  Block b sums the span of per_thread *
// kCostBlock observations from b * per_thread * kCostBlock, thread t those
// of its span at t + kCostBlock * k, k < per_thread, in k order, kCostBatch
// at a time: the batch's own inputs (indices, inv_sd, uv) are loaded
// together, then its point rows, then its chains run; at the plan's
// per_thread (kCostBatch up to 270,336 observations) a thread's whole work
// is in flight at once.  Each block first builds the instance table (pose
// and rotation coefficients of tile_rows instances) in dynamic shared
// memory, one Rodrigues per thread, while the first batch's loads are in
// flight: the chain then runs no sqrt, sin, cos or divide of the rotation
// and gathers no instance row.  When n_inst > tile_rows the block walks its
// span once per tile of tile_rows instances, each pass adding the terms
// whose instance lies in the tile.  The point rows are loaded before the
// tile test, as soon as their indices arrive (testing first read slower on
// the card).  The block sums go out through
// grid_sum_last_block.  The grid, per_thread and tile_rows come from the
// wrapper's cost_plan and cost_table_rows, functions of the shapes alone, so
// the sum's order, and its bits, are the same on every call.
template <typename T, int LOSS>
__global__ void __launch_bounds__(kCostBlock, kCostMinBlocks)
    cost_kernel(const T* __restrict__ inst, const T* __restrict__ cam,
                const T* __restrict__ points, const int* __restrict__ obs_inst,
                const int* __restrict__ obs_cam,
                const int* __restrict__ obs_point,
                const T* __restrict__ obs_uv,
                const T* __restrict__ obs_inv_sd, Tables tb, long long n_obs,
                int per_thread, int tile_rows, T a2, T* partials,
                unsigned* ticket, T* out) {
  extern __shared__ __align__(16) unsigned char cost_smem[];
  T* tab = reinterpret_cast<T*>(cost_smem);  // [tile_rows][kInstCols]
  __shared__ T warp_sums[32];
  const long long base =
      (long long)blockIdx.x * per_thread * kCostBlock + threadIdx.x;
  T acc = T(0);
  for (int lo = 0; lo == 0 || lo < tb.n_inst; lo += tile_rows) {
    const int rows = min(tile_rows, tb.n_inst - lo);
    for (int k0 = 0; k0 < per_thread; k0 += kCostBatch) {
      ObsIn<T> in[kCostBatch];
      bool act[kCostBatch];
#pragma unroll
      for (int u = 0; u < kCostBatch; ++u) {
        const long long o = base + (long long)(k0 + u) * kCostBlock;
        act[u] = k0 + u < per_thread && o < n_obs;
        if (act[u]) {
          load_obs(obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd, o, in[u]);
        }
      }
      if (k0 == 0) {
        if (lo > 0) __syncthreads();  // the last tile's readers are done
        fill_inst_table(inst, lo, rows, tab);
      }
      T x[kCostBatch][3];
#pragma unroll
      for (int u = 0; u < kCostBatch; ++u) {
        if (act[u] && in[u].ip >= 0 && in[u].ip < tb.n_points) {
#pragma unroll
          for (int k = 0; k < 3; ++k) x[u][k] = points[3LL * in[u].ip + k];
        }
      }
      if (k0 == 0) __syncthreads();
#pragma unroll
      for (int u = 0; u < kCostBatch; ++u) {
        // The term is this tile's when its instance's row is here; one with
        // an index outside the tables (NaN) is the first tile's.
        if (act[u]) {
          const bool valid = in[u].ii >= 0 && in[u].ii < tb.n_inst &&
                             in[u].ic >= 0 && in[u].ic < tb.n_cam &&
                             in[u].ip >= 0 && in[u].ip < tb.n_points;
          act[u] = valid ? in[u].ii >= lo && in[u].ii - lo < rows : lo == 0;
        }
        if (act[u]) {
          acc += cost_term<T, LOSS>(cam, tab + kInstCols * (in[u].ii - lo),
                                    tb, in[u], x[u], a2);
        }
      }
    }
  }
  grid_sum_last_block(block_sum_warps(acc, warp_sums), partials, ticket, out);
}

template <typename T, int LOSS>
void launch_resjac(const T* inst, const T* cam, const T* points,
                   const int* obs_inst, const int* obs_cam,
                   const int* obs_point, const T* obs_uv, const T* obs_inv_sd,
                   Tables tb, long long n_obs, T a2, T* r, T* Jc, T* Jp,
                   T* cost, cudaStream_t stream) {
  const long long grid = (n_obs + kResjacBlock - 1) / kResjacBlock;
  resjac_kernel<T, LOSS><<<(unsigned)grid, kResjacBlock, 0, stream>>>(
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
         int per_thread, int tile_rows, T* partials, unsigned* ticket, T* out,
         void* stream) {
  const size_t smem = sizeof(T) * kInstCols * (size_t)tile_rows;
  if (tile_rows < 1 || smem > kInstTableBytes) return -2;
  const Tables tb{n_inst, n_cam, cam_stride, n_points};
  const T a2 = loss_threshold * loss_threshold;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Past 48 KB of dynamic shared memory a kernel must opt in.
#define OSFM_COST(L)                                                        \
  if (smem > 48 * 1024) {                                                   \
    cudaFuncSetAttribute(cost_kernel<T, L>,                                 \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                         kInstTableBytes);                                  \
  }                                                                         \
  cost_kernel<T, L><<<n_blocks, kCostBlock, smem, s>>>(                     \
      inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd,  \
      tb, n_obs, per_thread, tile_rows, a2, partials, ticket, out)
  switch (loss) {
    case 0: OSFM_COST(0); break;
    case 1: OSFM_COST(1); break;
    case 2: OSFM_COST(2); break;
    case 3: OSFM_COST(3); break;
    case 4: OSFM_COST(4); break;
    default: return -1;
  }
#undef OSFM_COST
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
                int loss, double loss_threshold, int n_blocks, int per_thread,
                int tile_rows, float* partials, unsigned* ticket, float* out,
                void* stream) {
  return cost<float>(inst, n_inst, cam, n_cam, cam_stride, points, n_points,
                     obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd, n_obs,
                     loss, (float)loss_threshold, n_blocks, per_thread, tile_rows,
                     partials, ticket, out, stream);
}

int ba_cost_f64(const double* inst, int n_inst, const double* cam, int n_cam,
                int cam_stride, const double* points, int n_points,
                const int* obs_inst, const int* obs_cam, const int* obs_point,
                const double* obs_uv, const double* obs_inv_sd, long long n_obs,
                int loss, double loss_threshold, int n_blocks, int per_thread,
                int tile_rows, double* partials, unsigned* ticket, double* out,
                void* stream) {
  return cost<double>(inst, n_inst, cam, n_cam, cam_stride, points, n_points,
                      obs_inst, obs_cam, obs_point, obs_uv, obs_inv_sd, n_obs,
                      loss, loss_threshold, n_blocks, per_thread, tile_rows,
                      partials, ticket, out, stream);
}

}  // extern "C"
