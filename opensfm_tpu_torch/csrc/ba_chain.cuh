// Device code shared by the bundle-adjustment kernels (ba_resjac.cu,
// ba_assemble.cu): the robust losses, the Rodrigues coefficients, the
// per-observation projection chain and its closed-form Jacobian, and the
// deterministic block sum of the cost kernels.
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

constexpr int kCostBlock = 256;

// Sum over the kCostBlock threads of a block by a fixed shared-memory tree:
// the same inputs give the same bits on every run.
template <typename T>
__device__ __forceinline__ T block_sum(T acc) {
  __shared__ T sh[kCostBlock];
  sh[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kCostBlock / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// Second pass of a cost: one block sums the first pass's block partials.
template <typename T>
__global__ void __launch_bounds__(kCostBlock)
    cost_final_kernel(const T* __restrict__ partials, int n_partials,
                      T* __restrict__ out) {
  T acc = T(0);
  for (int i = threadIdx.x; i < n_partials; i += kCostBlock) acc += partials[i];
  const T total = block_sum(acc);
  if (threadIdx.x == 0) out[0] = total;
}

}  // namespace
