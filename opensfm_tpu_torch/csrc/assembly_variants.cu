// Five ablation variants of a simplified dense Schur assembly, for Hopper.
//
// Replaces the Pallas kernel of profile_kernel_variants.py
// (make_variant(mode).run_once), a profiler that times parts of the dense
// assembly kernel by leaving them out.  On the dense [NP, NI] instance-slot
// grid (slot == instance, one camera [k1, k2, f], points broadcast along each
// row) every slot runs the projection chain and its 12 derivatives J0, J1
// (directions w0..2, t0..2, k1, k2, f, x0..2), then
//   out_obs [32, NP, NI]: rows 0-1 e = (pred - uv) * inv_sd, rows 2-13 J0,
//                         rows 14-25 J1, rows 26-31 zero;
//   s_ii [6 NI, 6 NI] = sum_k A_k^T G_k over the K = 3 NP rows (p, k), with
//     A_k[(p, k), x NI + a] = J0[x] J0[9 + k],  G_k[...] = J1[x] J1[9 + k]
//   (a full product, not a symmetric one).
// The modes: 0 full; 1 nopush (J0[j] = p0 (0.1 + j), J1[j] = p1 (0.1 + j):
// no derivatives); 2 nomatmul (s_ii zero); 3 noout (out_obs rows 2-31 not
// written); 4 fwdonly (the forward chain only: rows 0-1, the rest zero, s_ii
// zero).  The Jacobian comes in closed form (ba_chain.cuh), where the TPU
// kernel pushes 12 tangents through jax.linearize.
//
// What bounds it on the card.  At 64 x 8,192 the product is
// 2 * 384 * 384 * 24,576 = 7.2 GFLOP of float32, 0.11 ms at the 67 TFLOP/s
// FP32 rate, while the inputs are ~6 MB and out_obs is 67 MB, ~22 us at
// 3.35 TB/s.  So operations bound the modes with the product, bytes those
// without.  That bound follows from a choice of this port: the TPU kernel's
// dot_general runs at default precision (no precision argument, which on
// the TPU's matrix unit may round the operands to bfloat16), while this
// product stays in FP32 on the
// SIMT pipes (no TF32) so that it can be held to its float32 plain version
// within 1e-4.  A tensor-core product at the reference's precision would
// have a bound several times lower.
//
// Design.  The TPU kernel walks 128-point blocks in order, keeps the two
// product operands (cat_a, cat_g) in VMEM scratch and carries s_ii across
// the grid.  Here, as in ba_assemble.cu:
//  1. slots_kernel: one thread per slot writes its out_obs rows and, for the
//     modes with the product, its 6 x 3 entries of each operand into
//     [3 NP, 6 NI] scratch matrices (the TPU kernel's cat_a and cat_g; on
//     this card they go through device memory: 75 MB written and read back).
//  2. product_kernel: 64 x 64 output tiles of A^T G, split over K so that
//     ~2 blocks run on each SM; a plain shared-memory FP32 product with
//     explicit fmaf (the build turns contraction off).
//  3. product_sum_kernel adds the K splits in split order (no atomics: the
//     same inputs give the same bits).
// The modes without the product clear s_ii with a memset and launch only
// pass 1.  A simple kernel: this is a profiler of where a dense assembly
// spends its time, not a solver path.
//
// Interface: a plain C function (ctypes), launched on the caller's stream;
// returns the first non-zero cudaGetLastError() (or -1 for an unknown mode).

#include <cuda_runtime.h>

#include "ba_chain.cuh"

namespace {

constexpr int kFull = 0, kNoPush = 1, kNoMatmul = 2, kNoOut = 3,
              kFwdOnly = 4;
constexpr int kRows = 32;      // out_obs rows
constexpr int kSlotThreads = 256;
constexpr int kTile = 64;      // product output tile
constexpr int kTileK = 16;     // product depth per shared-memory stage

template <int MODE>
__global__ void __launch_bounds__(kSlotThreads)
    slots_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ isd,
                 const float* __restrict__ points,
                 const float* __restrict__ inst_t,
                 const float* __restrict__ cam_row, int np, int ni,
                 float* __restrict__ out_obs, float* __restrict__ op_a,
                 float* __restrict__ op_g) {
  const long long n_slots = (long long)np * ni;
  const long long o = (long long)blockIdx.x * kSlotThreads + threadIdx.x;
  if (o >= n_slots) return;
  const long long p = o / ni;
  const int a = (int)(o - p * ni);
  float vals[12];
#pragma unroll
  for (int k = 0; k < 6; ++k) vals[k] = inst_t[k * ni + a];
#pragma unroll
  for (int k = 0; k < 3; ++k) vals[6 + k] = cam_row[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) vals[9 + k] = points[3 * p + k];
  float p0, p1, J0[12], J1[12];
  if (MODE == kFwdOnly || MODE == kNoPush) {
    chain_fwd(vals, p0, p1);
  } else {
    chain_fwd_jac(vals, p0, p1, J0, J1);
  }
  const float w = isd[o];
  out_obs[o] = (p0 - u[o]) * w;
  out_obs[n_slots + o] = (p1 - v[o]) * w;
  if (MODE == kFwdOnly) {
#pragma unroll
    for (int r = 2; r < kRows; ++r) out_obs[r * n_slots + o] = 0.f;
    return;
  }
  if (MODE == kNoPush) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float c = (float)(0.1 + (double)j);  // as the Python float rounds
      J0[j] = p0 * c;
      J1[j] = p1 * c;
    }
  }
  if (MODE != kNoOut) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      out_obs[(2 + j) * n_slots + o] = J0[j];
      out_obs[(14 + j) * n_slots + o] = J1[j];
    }
#pragma unroll
    for (int r = 26; r < kRows; ++r) out_obs[r * n_slots + o] = 0.f;
  }
  if (MODE != kNoMatmul) {
    const long long n6 = 6LL * ni;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* ra = op_a + (3 * p + k) * n6 + a;
      float* rg = op_g + (3 * p + k) * n6 + a;
#pragma unroll
      for (int x = 0; x < 6; ++x) {
        ra[x * ni] = J0[x] * J0[9 + k];
        rg[x * ni] = J1[x] * J1[9 + k];
      }
    }
  }
}

// part[split] = A[k-range]^T G[k-range], every 64 x 64 output tile; A and G
// are [K, n] row-major.  256 threads, each 4 x 4 outputs.
__global__ void __launch_bounds__(256)
    product_kernel(const float* __restrict__ op_a,
                   const float* __restrict__ op_g, long long K, int n,
                   long long k_split, float* __restrict__ part) {
  const int tiles = (n + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / tiles) * kTile;
  const int j0 = (blockIdx.x % tiles) * kTile;
  const long long k0 = (long long)blockIdx.y * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  __shared__ float As[kTileK][kTile];
  __shared__ float Gs[kTileK][kTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
  }
  for (long long kb = k0; kb < k1; kb += kTileK) {
    for (int l = threadIdx.x; l < kTileK * kTile; l += 256) {
      const int kk = l / kTile, c = l % kTile;
      const long long k = kb + kk;
      const bool in_k = k < k1;
      As[kk][c] = (in_k && i0 + c < n) ? op_a[k * n + i0 + c] : 0.f;
      Gs[kk][c] = (in_k && j0 + c < n) ? op_g[k * n + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[4], gv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) av[m] = As[kk][ty + 16 * m];
#pragma unroll
      for (int q = 0; q < 4; ++q) gv[q] = Gs[kk][tx + 16 * q];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(av[m], gv[q], acc[m][q]);
      }
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.y * n * n;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 16 * m, j = j0 + tx + 16 * q;
      if (i < n && j < n) out[(long long)i * n + j] = acc[m][q];
    }
  }
}

// s_ii[i] = sum over splits of part[split][i], in split order.
__global__ void product_sum_kernel(const float* __restrict__ part,
                                   long long nn, int n_split,
                                   float* __restrict__ s_ii) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn) return;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) acc += part[s * nn + i];
  s_ii[i] = acc;
}

template <int MODE>
int launch(const float* u, const float* v, const float* isd,
           const float* points, const float* inst_t, const float* cam_row,
           int np, int ni, float* out_obs, float* op_a, float* op_g,
           int n_split, long long k_split, float* part, float* s_ii,
           cudaStream_t s) {
  const long long n_slots = (long long)np * ni;
  const int n = 6 * ni;
  const long long nn = (long long)n * n;
  if (n_slots > 0) {
    slots_kernel<MODE><<<(unsigned)((n_slots + kSlotThreads - 1) /
                                    kSlotThreads),
                         kSlotThreads, 0, s>>>(u, v, isd, points, inst_t,
                                               cam_row, np, ni, out_obs, op_a,
                                               op_g);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (MODE == kNoMatmul || MODE == kFwdOnly || n_slots == 0) {
    const cudaError_t e =
        cudaMemsetAsync(s_ii, 0, sizeof(float) * (size_t)nn, s);
    return (int)e;
  }
  const int tiles = (n + kTile - 1) / kTile;
  product_kernel<<<dim3(tiles * tiles, n_split), 256, 0, s>>>(
      op_a, op_g, 3LL * np, n, k_split, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  product_sum_kernel<<<(unsigned)((nn + 255) / 256), 256, 0, s>>>(
      part, nn, n_split, s_ii);
  e = cudaGetLastError();
  return (int)e;
}

}  // namespace

extern "C" {

// u, v, isd [np, ni]; points [np, 3]; inst_t [8, ni] (rows 0-5 the pose);
// cam_row [>= 3] (k1, k2, f first).  Outputs out_obs [32, np, ni] and s_ii
// [6 ni, 6 ni]; scratch op_a, op_g [3 np, 6 ni] and part [n_split, 6 ni,
// 6 ni] (unused by the modes without the product).
int assembly_variant_f32(int mode, const float* u, const float* v,
                         const float* isd, const float* points,
                         const float* inst_t, const float* cam_row, int np,
                         int ni, float* out_obs, float* op_a, float* op_g,
                         int n_split, long long k_split, float* part,
                         float* s_ii, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OSFM_VARIANT(M)                                                      \
  return launch<M>(u, v, isd, points, inst_t, cam_row, np, ni, out_obs,      \
                   op_a, op_g, n_split, k_split, part, s_ii, s)
  switch (mode) {
    case kFull: OSFM_VARIANT(kFull);
    case kNoPush: OSFM_VARIANT(kNoPush);
    case kNoMatmul: OSFM_VARIANT(kNoMatmul);
    case kNoOut: OSFM_VARIANT(kNoOut);
    case kFwdOnly: OSFM_VARIANT(kFwdOnly);
    default: return -1;
  }
#undef OSFM_VARIANT
}

}  // extern "C"
