// Device code shared by the bundle-adjustment kernels (ba_resjac.cu,
// ba_assemble.cu, assembly_variants.cu): the robust losses, the Rodrigues
// coefficients, the per-observation projection chain and its closed-form
// Jacobian, the one-pass cost helpers of fused_cost and fused_cost_dense
// (the chain from given rotation coefficients, the block's rotation table,
// a shuffle block sum and the last-block grid sum), and the asynchronous
// copies (cp.async) of the staged kernels.
//
// Per observation the chain is
//   X  = R(w_i) x_p + t_i                      (Rodrigues, small-angle series)
//   uv = X[:2] / X[2];  d = 1 + r2 (k1 + k2 r2);  pred = f d uv
// and the Jacobian columns (6 pose, k1/k2/f, 3 point) come from the closed
// form d(Rx)/dw (Gallego & Yezzi) composed with the 2x3 projection Jacobian,
// as opensfm_tpu/ops/pallas_kernels/ba_resjac.py (chain_fwd_jac) computes
// them.

#pragma once

#include <cuda_runtime.h>

namespace {

// Loss ids: TrivialLoss 0, SoftLOneLoss 1, CauchyLoss 2, HuberLoss 3,
// TukeyLoss 4 (opensfm_tpu_torch/ops/kernels/ba_resjac.py LOSS_IDS).
template <typename T, int LOSS>
__device__ __forceinline__ void loss_eval(T u, T& rho, T& drho) {
  const T one = T(1);
  if (LOSS == 0) {
    rho = u;
    drho = one;
  } else if (LOSS == 1) {
    T s = sqrt(one + u);
    rho = T(2) * (s - one);
    drho = one / s;
  } else if (LOSS == 2) {
    rho = log1p(u);
    drho = one / (one + u);
  } else if (LOSS == 3) {
    T um = (u < one) ? one : u;  // max(u, 1), NaN-propagating
    T s = sqrt(um);
    rho = (u <= one) ? u : T(2) * s - one;
    drho = (u <= one) ? one : one / s;
  } else {
    T m = one - u;
    rho = (u <= one) ? (one - m * m * m) / T(3) : one / T(3);
    drho = (u <= one) ? m * m : T(0);
  }
}

template <typename T>
struct Rodrigues {
  T cos_t, sinc, ccos, sp, gp;
  __device__ __forceinline__ Rodrigues(T w0, T w1, T w2, bool derivs) {
    const T th2 = w0 * w0 + w1 * w1 + w2 * w2;
    const bool small = th2 < T(1e-14);
    const T safe2 = small ? T(1) : th2;
    const T th = sqrt(safe2);
    cos_t = small ? T(1) - th2 / T(2) : cos(th);
    sinc = small ? T(1) - th2 / T(6) : sin(th) / th;
    ccos = small ? T(0.5) - th2 / T(24) : (T(1) - cos_t) / safe2;
    if (derivs) {
      // d(sinc)/dw_i = w_i sp ; d(ccos)/dw_i = w_i gp
      sp = small ? T(-1) / T(3) + th2 / T(30) : (cos_t - sinc) / safe2;
      gp = small ? T(-1) / T(12) + th2 / T(180)
                 : (sinc - T(2) * ccos) / safe2;
    }
  }
};

// v = (w0, w1, w2, t0, t1, t2, k1, k2, f, x0, x1, x2)
template <typename T>
__device__ __forceinline__ void chain_fwd(const T* v, T& p0, T& p1) {
  const T w0 = v[0], w1 = v[1], w2 = v[2];
  const T x0 = v[9], x1 = v[10], x2 = v[11];
  const Rodrigues<T> R(w0, w1, w2, false);
  const T cxx = w1 * x2 - w2 * x1;
  const T cyy = w2 * x0 - w0 * x2;
  const T czz = w0 * x1 - w1 * x0;
  const T rdx = w0 * x0 + w1 * x1 + w2 * x2;
  const T X0 = x0 * R.cos_t + cxx * R.sinc + w0 * rdx * R.ccos + v[3];
  const T X1 = x1 * R.cos_t + cyy * R.sinc + w1 * rdx * R.ccos + v[4];
  const T X2 = x2 * R.cos_t + czz * R.sinc + w2 * rdx * R.ccos + v[5];
  const T iz = T(1) / X2;
  const T u = X0 * iz, vv = X1 * iz;
  const T r2 = u * u + vv * vv;
  const T d = T(1) + r2 * (v[6] + v[7] * r2);
  p0 = v[8] * d * u;
  p1 = v[8] * d * vv;
}

// The chain and its Jacobian with the rotation's coefficients R = the
// Rodrigues<T>(v[0], v[1], v[2], true) of the instance, computed by the
// caller: a caller that runs one instance over many points computes them once.
template <typename T>
__device__ __forceinline__ void chain_fwd_jac(const T* v, const Rodrigues<T>& R,
                                              T& p0, T& p1, T* J0, T* J1) {
  const T w0 = v[0], w1 = v[1], w2 = v[2];
  const T k1 = v[6], k2 = v[7], f = v[8];
  const T x0 = v[9], x1 = v[10], x2 = v[11];
  const T cos_t = R.cos_t, sinc = R.sinc, ccos = R.ccos;
  const T cxx = w1 * x2 - w2 * x1;
  const T cyy = w2 * x0 - w0 * x2;
  const T czz = w0 * x1 - w1 * x0;
  const T rdx = w0 * x0 + w1 * x1 + w2 * x2;
  const T X0 = x0 * cos_t + cxx * sinc + w0 * rdx * ccos + v[3];
  const T X1 = x1 * cos_t + cyy * sinc + w1 * rdx * ccos + v[4];
  const T X2 = x2 * cos_t + czz * sinc + w2 * rdx * ccos + v[5];

  const T iz = T(1) / X2;
  const T u = X0 * iz, vv = X1 * iz;
  const T r2 = u * u + vv * vv;
  const T d = T(1) + r2 * (k1 + k2 * r2);
  p0 = f * d * u;
  p1 = f * d * vv;

  // P = d(pred)/d(u, v); A = P [[1, 0, -u], [0, 1, -v]] / z  (2x3)
  const T fdd = T(2) * f * (k1 + T(2) * k2 * r2);
  const T fd = f * d;
  const T P00 = fd + fdd * u * u;
  const T P01 = fdd * u * vv;
  const T P11 = fd + fdd * vv * vv;
  const T A00 = P00 * iz, A01 = P01 * iz, A02 = -(P00 * u + P01 * vv) * iz;
  const T A10 = P01 * iz, A11 = P11 * iz, A12 = -(P01 * u + P11 * vv) * iz;

  // R = cos I + sinc [w]x + ccos w w^T  (its columns are dX/dx)
  const T R00 = cos_t + ccos * w0 * w0;
  const T R01 = ccos * w0 * w1 - sinc * w2;
  const T R02 = ccos * w0 * w2 + sinc * w1;
  const T R10 = ccos * w0 * w1 + sinc * w2;
  const T R11 = cos_t + ccos * w1 * w1;
  const T R12 = ccos * w1 * w2 - sinc * w0;
  const T R20 = ccos * w0 * w2 - sinc * w1;
  const T R21 = ccos * w1 * w2 + sinc * w0;
  const T R22 = cos_t + ccos * w2 * w2;

  // dX/dw_i = w_i V + sinc (e_i x x) + ccos (rdx e_i + x_i w)
  const T V0 = -sinc * x0 + R.sp * cxx + R.gp * rdx * w0;
  const T V1 = -sinc * x1 + R.sp * cyy + R.gp * rdx * w1;
  const T V2 = -sinc * x2 + R.sp * czz + R.gp * rdx * w2;
  const T D[3][3] = {
      {w0 * V0 + ccos * (rdx + x0 * w0), w0 * V1 - sinc * x2 + ccos * x0 * w1,
       w0 * V2 + sinc * x1 + ccos * x0 * w2},
      {w1 * V0 + sinc * x2 + ccos * x1 * w0, w1 * V1 + ccos * (rdx + x1 * w1),
       w1 * V2 - sinc * x0 + ccos * x1 * w2},
      {w2 * V0 - sinc * x1 + ccos * x2 * w0, w2 * V1 + sinc * x0 + ccos * x2 * w1,
       w2 * V2 + ccos * (rdx + x2 * w2)},
  };
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    J0[i] = A00 * D[i][0] + A01 * D[i][1] + A02 * D[i][2];
    J1[i] = A10 * D[i][0] + A11 * D[i][1] + A12 * D[i][2];
  }
  J0[3] = A00; J0[4] = A01; J0[5] = A02;
  J1[3] = A10; J1[4] = A11; J1[5] = A12;
  const T fu = f * u, fv = f * vv;
  J0[6] = fu * r2;      J1[6] = fv * r2;       // k1
  J0[7] = fu * r2 * r2; J1[7] = fv * r2 * r2;  // k2
  J0[8] = d * u;        J1[8] = d * vv;        // f
  const T Rc[3][3] = {{R00, R10, R20}, {R01, R11, R21}, {R02, R12, R22}};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    J0[9 + j] = A00 * Rc[j][0] + A01 * Rc[j][1] + A02 * Rc[j][2];
    J1[9 + j] = A10 * Rc[j][0] + A11 * Rc[j][1] + A12 * Rc[j][2];
  }
}

template <typename T>
__device__ __forceinline__ void chain_fwd_jac(const T* v, T& p0, T& p1,
                                              T* J0, T* J1) {
  chain_fwd_jac(v, Rodrigues<T>(v[0], v[1], v[2], true), p0, p1, J0, J1);
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// sqrt(max(rho', 1e-12)): the square-root IRLS weight of a residual.
template <typename T>
__device__ __forceinline__ T sqrt_weight(T drho) {
  const T wmin = T(1e-12);
  return sqrt(drho < wmin ? wmin : drho);
}

template <typename T>
struct Vec2;  // one observation's (u, v): a single 16- or 8-byte load
template <>
struct Vec2<double> {
  using type = double2;
};
template <>
struct Vec2<float> {
  using type = float2;
};

// Threads of a cost block (fused_cost, fused_cost_dense) and the blocks of
// it kept resident on an SM (registers and the instance table allow two).
constexpr int kCostBlock = 256;
constexpr int kCostMinBlocks = 2;

// ---------------------------------------------------------------------------
// One-pass cost helpers (fused_cost, fused_cost_dense).
// ---------------------------------------------------------------------------

// A cost block's instance table in shared memory: a row is (w0, w1, w2,
// t0, t1, t2, cos t, sinc, ccos), kInstCols values.  A block holds at most
// kInstTableBytes of rows (1,365 instances in f64, 2,730 in f32), so that
// two blocks stay resident on an SM at any n_inst; a larger map is walked in
// tiles of that many rows.
constexpr int kInstCols = 9;
constexpr int kInstTableBytes = 96 * 1024;

// The chain_fwd chain with the rotation's coefficients (cos t, sinc, ccos) of
// Rodrigues<T>(v[0], v[1], v[2], false) given: the same operations in the
// same order, so the same bits as chain_fwd.
template <typename T>
__device__ __forceinline__ void chain_fwd(const T* v, T cos_t, T sinc,
                                          T ccos, T& p0, T& p1) {
  const T w0 = v[0], w1 = v[1], w2 = v[2];
  const T x0 = v[9], x1 = v[10], x2 = v[11];
  const T cxx = w1 * x2 - w2 * x1;
  const T cyy = w2 * x0 - w0 * x2;
  const T czz = w0 * x1 - w1 * x0;
  const T rdx = w0 * x0 + w1 * x1 + w2 * x2;
  const T X0 = x0 * cos_t + cxx * sinc + w0 * rdx * ccos + v[3];
  const T X1 = x1 * cos_t + cyy * sinc + w1 * rdx * ccos + v[4];
  const T X2 = x2 * cos_t + czz * sinc + w2 * rdx * ccos + v[5];
  const T iz = T(1) / X2;
  const T u = X0 * iz, vv = X1 * iz;
  const T r2 = u * u + vv * vv;
  const T d = T(1) + r2 * (v[6] + v[7] * r2);
  p0 = v[8] * d * u;
  p1 = v[8] * d * vv;
}

// tab[kInstCols i + k] = instance lo + i's pose (k < 6) and the (cos t,
// sinc, ccos) of Rodrigues<T>(w, false) (k = 6, 7, 8), for i < rows, one
// Rodrigues per thread; the caller synchronises before reading.
template <typename T>
__device__ __forceinline__ void fill_inst_table(const T* __restrict__ inst,
                                                int lo, int rows, T* tab) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    T* row = tab + kInstCols * i;
#pragma unroll
    for (int k = 0; k < 6; ++k) row[k] = inst[6LL * (lo + i) + k];
    const Rodrigues<T> R(row[0], row[1], row[2], false);
    row[6] = R.cos_t;
    row[7] = R.sinc;
    row[8] = R.ccos;
  }
}

// Sum over a block of blockDim.x (a multiple of 32, <= 1024) threads: a
// shuffle tree in each warp, then thread 0 adds the warp sums in warp order.
// A fixed order, so the same bits on every run; one barrier.  The total is
// valid in thread 0 only.
template <typename T>
__device__ __forceinline__ T block_sum_warps(T acc, T* sh /* [32] */) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = acc;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0) {
    total = sh[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) total += sh[w];
  }
  return total;
}

// The end of a one-pass grid sum.  Each block stores its total to
// partials[blockIdx.x] and takes a ticket; the block that takes the last one
// adds all partials in block order (a fixed tree, so the bits depend on the
// grid alone, not on which block finishes last), writes out[0], and sets the
// ticket counter back to 0 for the next launch.  The counter is one per
// device, zero between launches: two launches that use it must not run at
// once (calls on two concurrent streams would mix their tickets).
template <typename T>
__device__ __forceinline__ void grid_sum_last_block(T block_total,
                                                    T* partials,
                                                    unsigned* ticket,
                                                    T* out) {
  __shared__ bool last;
  __shared__ T sh[32];
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block_total;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T acc = T(0);
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) {
    acc += __ldcg(partials + i);  // from L2: written by other blocks
  }
  const T total = block_sum_warps(acc, sh);
  if (threadIdx.x == 0) {
    out[0] = total;
    *ticket = 0u;
  }
}

// ---------------------------------------------------------------------------
// Asynchronous global -> shared copies (cp.async), one set for every staged
// kernel.  Each asm names memory as clobbered: the compiler sees no store to
// the staged shared memory otherwise, and could treat a read of it as a read
// of memory never written, or move it above the wait (a register-capped
// variant of the back-substitution read wrong values without the clobber).
// ---------------------------------------------------------------------------

// A 16-byte copy that reads src_bytes (0..16) of gmem and zero-fills the
// rest (0: the whole piece is zero, gmem is not read); both addresses
// 16-byte aligned.  .cg: cached in L2, not in L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
// An N-byte (4, 8 or 16) copy, both addresses N-byte aligned.
template <int N>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp_async_wait<min(n, 7)>: at most 7 pending, which completes every group
// but the last 7.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n < 7 ? n : 7) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

}  // namespace
