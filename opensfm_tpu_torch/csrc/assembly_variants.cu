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
//     [3 NP, ld] scratch matrices (the TPU kernel's cat_a and cat_g, column
//     x NI + a; ld = 6 NI rounded up to 4, so that every row starts on 16
//     bytes; on this card they go through device memory: 75 MB written and
//     read back at 64 x 8,192).
//  2. product_kernel: 128 x 128 output tiles of A^T G (nine at 6 NI = 384,
//     ragged tiles past n masked), split over K (product_plan) so that tiles
//     x splits fill the 132 SMs about twice.  A block of 256 threads stages
//     kPTileK rows of both operand stripes (512 contiguous bytes a row) per
//     stage by 16-byte cp.async into a ring of kPStages stages, one barrier
//     a stage; each thread keeps 8 x 8 outputs in registers and per k reads
//     two float4 of A and two of G (rows 4 ty.. and 64 + 4 ty.., columns
//     4 tx.. and 64 + 4 tx..) for 64 explicit fmaf (the build turns
//     contraction off).  The staged rows need no padding: a k row is read
//     whole, a warp's A fragment is two broadcast float4 and its G fragment
//     16 consecutive float4, so no two lanes of a quarter-warp meet in a
//     bank.  Operand pieces past n or past the split's end are zero-filled.
//  3. product_sum_kernel adds the K splits in split order, four outputs a
//     thread (no atomics: the same inputs give the same bits).
// The modes without the product clear s_ii with a memset and launch only
// pass 1.  FP32 on the SIMT pipes: a profiler of where a dense assembly
// spends its time, not a solver path.
//
// Interface: plain C functions (ctypes), launched on the caller's stream;
// each returns the first non-zero cudaGetLastError() (or -1 for an unknown
// mode, -2 for a layout the product does not take).

#include <cuda_runtime.h>

#include "ba_chain.cuh"

namespace {

constexpr int kFull = 0, kNoPush = 1, kNoMatmul = 2, kNoOut = 3,
              kFwdOnly = 4;
constexpr int kRows = 32;      // out_obs rows
constexpr int kSlotThreads = 256;
constexpr int kPTile = 128;    // product output tile
constexpr int kPTileK = 16;    // k rows per stage
constexpr int kPStages = 3;    // cp.async ring depth
constexpr int kPThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPMinBlocks = 2;  // resident product blocks per SM
constexpr size_t kPSmem =
    sizeof(float) * kPStages * 2 * kPTileK * kPTile;  // 49,152 B

template <int MODE>
__global__ void __launch_bounds__(kSlotThreads)
    slots_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ isd,
                 const float* __restrict__ points,
                 const float* __restrict__ inst_t,
                 const float* __restrict__ cam_row, int np, int ni, int ld,
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
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* ra = op_a + (3 * p + k) * ld + a;
      float* rg = op_g + (3 * p + k) * ld + a;
#pragma unroll
      for (int x = 0; x < 6; ++x) {
        ra[x * ni] = J0[x] * J0[9 + k];
        rg[x * ni] = J1[x] * J1[9 + k];
      }
    }
  }
}

// One stage: rows [kb, kb + kPTileK) (those below k1) of the operand
// stripes at columns i0 (A, to As) and j0 (G, to Gs), 16-byte pieces from
// consecutive threads on consecutive addresses; a piece reads only its
// columns below n and zero-fills the rest.
__device__ __forceinline__ void product_load_stage(
    const float* __restrict__ op_a, const float* __restrict__ op_g,
    long long kb, long long k1, int n, int ld, int i0, int j0, float* As,
    float* Gs) {
  constexpr int kPieces = kPTileK * kPTile / 4;  // per operand and stage
#pragma unroll
  for (int r = 0; r < kPieces / kPThreads; ++r) {
    const int piece = threadIdx.x + r * kPThreads;
    const int kk = piece / (kPTile / 4), c = 4 * (piece % (kPTile / 4));
    const long long k = kb + kk;
    const bool in_k = k < k1;
    const int ba = in_k ? min(max(4 * (n - (i0 + c)), 0), 16) : 0;
    const int bg = in_k ? min(max(4 * (n - (j0 + c)), 0), 16) : 0;
    cp_async16(As + kk * kPTile + c, ba ? op_a + k * ld + i0 + c : op_a, ba);
    cp_async16(Gs + kk * kPTile + c, bg ? op_g + k * ld + j0 + c : op_g, bg);
  }
}

// part[split] = A[k-range]^T G[k-range] on one 128 x 128 output tile
// (blockIdx.x, row-major over the tiles) and one K split (blockIdx.y); A
// and G are [K, ld] row-major, part [n_split, n, ld].
__global__ void __launch_bounds__(kPThreads, kPMinBlocks)
    product_kernel(const float* __restrict__ op_a,
                   const float* __restrict__ op_g, long long K, int n, int ld,
                   long long k_split, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int tiles = (n + kPTile - 1) / kPTile;
  const int i0 = (blockIdx.x / tiles) * kPTile;
  const int j0 = (blockIdx.x % tiles) * kPTile;
  const long long k0 = (long long)blockIdx.y * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  const int n_steps = (int)((k1 - k0 + kPTileK - 1) / kPTileK);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  auto a_stage = [&](int s) { return ring + (2 * s) * kPTileK * kPTile; };
  auto g_stage = [&](int s) { return ring + (2 * s + 1) * kPTileK * kPTile; };

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < n_steps) {
      product_load_stage(op_a, op_g, k0 + (long long)s * kPTileK, k1, n, ld,
                         i0, j0, a_stage(s), g_stage(s));
    }
    cp_async_commit();  // one group per stage, empty or not
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();  // the stage has landed; the oldest buffer is free
    const int next = step + kPStages - 1;
    if (next < n_steps) {
      const int s = next % kPStages;
      product_load_stage(op_a, op_g, k0 + (long long)next * kPTileK, k1, n,
                         ld, i0, j0, a_stage(s), g_stage(s));
    }
    cp_async_commit();
    const float* As = a_stage(step % kPStages) + 4 * ty;
    const float* Gs = g_stage(step % kPStages) + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < kPTileK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kPTile);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * kPTile + 64);
      const float4 g0 = *reinterpret_cast<const float4*>(Gs + kk * kPTile);
      const float4 g1 =
          *reinterpret_cast<const float4*>(Gs + kk * kPTile + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(av[m], gv[q], acc[m][q]);
      }
    }
  }
  cp_async_wait<0>();
  float* out = part + (long long)blockIdx.y * n * ld;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = i0 + 4 * ty + (m & 3) + 64 * (m >> 2);
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 4 * tx + 64 * h;  // j < n: j + 3 < ld
      if (j < n) {
        *reinterpret_cast<float4*>(out + (long long)i * ld + j) =
            make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2],
                        acc[m][4 * h + 3]);
      }
    }
  }
}

// s_ii[i][j..j+3] = the sum over splits of part[split][i][j..j+3], in split
// order: one thread per four columns of a row.
__global__ void product_sum_kernel(const float* __restrict__ part, int n,
                                   int ld, int n_split,
                                   float* __restrict__ s_ii) {
  const int q4 = ld / 4;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)n * q4) return;
  const long long i = q / q4;
  const int j = 4 * (int)(q - i * q4);
  if (j >= n) return;
  const float4* src = reinterpret_cast<const float4*>(part) + q;
  const long long stride = (long long)n * q4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float4 x = src[s * stride];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  float* dst = s_ii + i * n + j;
  if (n % 4 == 0) {
    *reinterpret_cast<float4*>(dst) = acc;
  } else {
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
    for (int c = 0; c < 4 && j + c < n; ++c) dst[c] = v[c];
  }
}

// s_ii [n, n] = A^T G of the [K, ld] operands: the split product and its
// fixed-order sum.
int launch_product(const float* op_a, const float* op_g, long long K, int n,
                   int ld, int n_split, long long k_split, float* part,
                   float* s_ii, cudaStream_t s) {
  if (n < 1 || ld < n || ld % 4 != 0 || n_split < 1 || k_split < 1 ||
      (long long)n_split * k_split < K) {
    return -2;
  }
  const int tiles = (n + kPTile - 1) / kPTile;
  product_kernel<<<dim3(tiles * tiles, n_split), kPThreads, kPSmem, s>>>(
      op_a, op_g, K, n, ld, k_split, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long quads = (long long)n * (ld / 4);
  product_sum_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      part, n, ld, n_split, s_ii);
  e = cudaGetLastError();
  return (int)e;
}

template <int MODE>
int launch(const float* u, const float* v, const float* isd,
           const float* points, const float* inst_t, const float* cam_row,
           int np, int ni, int ld, float* out_obs, float* op_a, float* op_g,
           int n_split, long long k_split, float* part, float* s_ii,
           cudaStream_t s) {
  const long long n_slots = (long long)np * ni;
  const int n = 6 * ni;
  if (n_slots > 0) {
    slots_kernel<MODE><<<(unsigned)((n_slots + kSlotThreads - 1) /
                                    kSlotThreads),
                         kSlotThreads, 0, s>>>(u, v, isd, points, inst_t,
                                               cam_row, np, ni, ld, out_obs,
                                               op_a, op_g);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (MODE == kNoMatmul || MODE == kFwdOnly || n_slots == 0) {
    const cudaError_t e = cudaMemsetAsync(
        s_ii, 0, sizeof(float) * (size_t)n * (size_t)n, s);
    return (int)e;
  }
  return launch_product(op_a, op_g, 3LL * np, n, ld, n_split, k_split, part,
                        s_ii, s);
}

}  // namespace

extern "C" {

// u, v, isd [np, ni]; points [np, 3]; inst_t [8, ni] (rows 0-5 the pose);
// cam_row [>= 3] (k1, k2, f first).  Outputs out_obs [32, np, ni] and s_ii
// [6 ni, 6 ni]; scratch op_a, op_g [3 np, ld] (ld >= 6 ni, a multiple of 4)
// and part [n_split, 6 ni, ld] (unused by the modes without the product).
int assembly_variant_f32(int mode, const float* u, const float* v,
                         const float* isd, const float* points,
                         const float* inst_t, const float* cam_row, int np,
                         int ni, int ld, float* out_obs, float* op_a,
                         float* op_g, int n_split, long long k_split,
                         float* part, float* s_ii, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OSFM_VARIANT(M)                                                      \
  return launch<M>(u, v, isd, points, inst_t, cam_row, np, ni, ld, out_obs,  \
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

// The product step alone: s_ii [n, n] = op_a^T op_g for op_a, op_g [K, ld]
// (16-byte aligned, ld a multiple of 4), scratch part [n_split, n, ld].
int assembly_product_f32(const float* op_a, const float* op_g, long long K,
                         int n, int ld, int n_split, long long k_split,
                         float* part, float* s_ii, void* stream) {
  return launch_product(op_a, op_g, K, n, ld, n_split, k_split, part, s_ii,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
