// Exact top-2 nearest-descriptor search for NVIDIA Hopper.
//
// Replaces the Pallas kernel of opensfm_tpu/ops/pallas_kernels/top2.py,
// top2_sqdist_pallas (bodies _top2_kernel and _top2_kernel_masked, helpers
// _tile_top2 and _merge).  For every row r of a [N, D] and the rows c < n2 of
// b [M, D] (and, masked, only where mask[r, c] != 0) it finds
//   dist(r, c) = (|a_r|^2 + |b_c|^2) - 2 a_r . b_c          (float32)
//   d1 = min_c dist,  i1 = the LOWEST column attaining d1,
//   d2 = min over every allowed column except i1,
// so two columns tied for the best give d2 == d1.  A row with no allowed
// column gets d1 = d2 = +inf and i1 = 0, as the Pallas kernel gives.
//
// What bounds it on the card: operations.  At N = M = 8,192 and D = 128 the
// distance product is 2 N M D = 17.2 GFLOP, 0.26 ms at the 67 TFLOP/s FP32
// rate outside the tensor cores, while a and b are 1 MB (uint8) to 4 MB
// (float32) each, a few microseconds of memory time; the masked variant adds
// 67 MB of mask, 0.02 ms.  The product stays on the FP32 pipes: uint8
// descriptors give integer products and partial sums below 2^24
// (128 * 255^2 = 8.3 M), so every float32 distance is exact in any order of
// summation and the kernel agrees bitwise with its plain twin and with the
// JAX package.  A TF32 or lower-precision product would lose that.
//
// Design.  The TPU kernel keeps a running (best, argbest, second) per query
// row in VMEM across a sequential grid over M.  Here each block owns 128
// query rows and one contiguous slice of the columns (the columns are split
// across blocks so that 8,192 query rows still give ~512 blocks for 132
// SMs).  A block walks its slice in 128-column tiles: a classic shared-memory
// SGEMM micro-kernel (256 threads, 8 x 8 distances each, 16-deep k stages;
// the inner product is written with explicit fmaf, since the build turns FMA
// contraction off) and, fused into its epilogue, a running top-2 per thread
// and row.  The 16 threads that share a row merge their states with warp
// shuffles, and the block writes one partial (d1, i1, d2) per row and slice;
// a second small kernel merges the slices.  Every merge orders candidates by
// (distance, column), so the result is the same whatever the order of the
// merges: deterministic, and equal to the sequential scan's.  Row norms come
// from a third small kernel (one warp per row).
//
// Interface: plain C functions (ctypes), launched on the caller's stream; each
// returns cudaGetLastError() after its launches.  The caller allocates the
// scratch (norms and partials) and the outputs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;    // query rows per block
constexpr int kTileM = 128;    // database columns per tile
constexpr int kTileK = 16;     // descriptor entries per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 8;       // query rows per thread: ty * 8 + i
constexpr int kCols = 8;       // columns per thread: tx * 4 + j, 64 + tx * 4 + j
constexpr int kPad = 4;        // keeps float4 alignment, spreads the stores

// Running top-2 state (b1, i1, b2): b1 / i1 the smallest (distance, column)
// seen, b2 the smallest distance seen at any other column.
__device__ __forceinline__ void push(float& b1, int& i1, float& b2, float d,
                                     int j) {
  if (d < b1 || (d == b1 && j < i1)) {
    b2 = b1;
    b1 = d;
    i1 = j;
  } else if (d < b2) {
    b2 = d;
  }
}

// Merges state c into state a.  Commutative and associative: the result is
// the top-2 of the union of the columns both have seen.
__device__ __forceinline__ void merge(float& a1, int& ai, float& a2, float c1,
                                      int ci, float c2) {
  if (c1 < a1 || (c1 == a1 && ci < ai)) {
    a2 = fminf(a1, c2);
    a1 = c1;
    ai = ci;
  } else {
    a2 = fminf(a2, c1);
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);
}

// |x_r|^2 per row, one warp per row: lane-strided fmaf sums, then a fixed
// butterfly.  Deterministic; exact for uint8 rows.
template <typename T>
__global__ void sqnorm_kernel(const T* __restrict__ x, int n, int d,
                              float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const T* row = x + (long long)warp * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = to_f32(row[k]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

// One block: rows [row0, row0 + 128) against columns
// [blockIdx.y * cols_per_split, ... + cols_per_split) clipped to n2.
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
top2_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ sq_a,
                    const float* __restrict__ sq_b,
                    const uint8_t* __restrict__ mask, int n, int m, int d,
                    int n2, int cols_per_split, float* __restrict__ part_d1,
                    int* __restrict__ part_i1, float* __restrict__ part_d2) {
  __shared__ __align__(16) float As[kTileK][kTileN + kPad];
  __shared__ __align__(16) float Bs[kTileK][kTileM + kPad];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * kTileN;
  const int col_begin = blockIdx.y * cols_per_split;
  const int col_end = min(n2, col_begin + cols_per_split);

  // Tile loads: thread t reads descriptor entry t & 15 of rows t >> 4,
  // t >> 4 + 16, ...: 16 neighbouring threads read one row's 16 entries.
  const int lk = tid & 15;
  const int lr = tid >> 4;

  float sqa[kRows];
  float b1[kRows], b2[kRows];
  int bi[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + ty * kRows + i;
    sqa[i] = r < n ? sq_a[r] : 0.f;
    b1[i] = CUDART_INF_F;
    b2[i] = CUDART_INF_F;
    bi[i] = 0;
  }

  for (int col0 = col_begin; col0 < col_end; col0 += kTileM) {
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kTileK) {
      const int k = k0 + lk;
#pragma unroll
      for (int s = 0; s < kTileN / 16; ++s) {
        const int r = lr + 16 * s;
        const int gr = row0 + r;
        As[lk][r] = (gr < n && k < d) ? to_f32(a[(long long)gr * d + k]) : 0.f;
        const int gc = col0 + r;
        Bs[lk][r] = (gc < col_end && k < d) ? to_f32(b[(long long)gc * d + k])
                                            : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        float av[kRows], bv[kCols];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
        const float4 c0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 c1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
        bv[0] = c0.x; bv[1] = c0.y; bv[2] = c0.z; bv[3] = c0.w;
        bv[4] = c1.x; bv[5] = c1.y; bv[6] = c1.z; bv[7] = c1.w;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue: distances of this tile into the running top-2.
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c >= col_end) continue;
      const float sqb = sq_b[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = row0 + ty * kRows + i;
        float dist = (sqa[i] + sqb) - 2.f * acc[i][j];
        if (kMasked) {
          if (r >= n || mask[(long long)r * m + c] == 0) dist = CUDART_INF_F;
        }
        push(b1[i], bi[i], b2[i], dist, c);
      }
    }
  }

  // The 16 threads of a row (lanes tx of one half-warp) merge their states.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, b1[i], off, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off, 16);
      const float o2 = __shfl_xor_sync(0xffffffffu, b2[i], off, 16);
      merge(b1[i], bi[i], b2[i], o1, oi, o2);
    }
  }
  if (tx == 0) {
    const long long base = (long long)blockIdx.y * n;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = row0 + ty * kRows + i;
      if (r < n) {
        part_d1[base + r] = b1[i];
        part_i1[base + r] = bi[i];
        part_d2[base + r] = b2[i];
      }
    }
  }
}

// One thread per row: merges the column slices' partial states.
__global__ void top2_merge_kernel(const float* __restrict__ part_d1,
                                  const int* __restrict__ part_i1,
                                  const float* __restrict__ part_d2, int n,
                                  int splits, float* __restrict__ out_dist,
                                  int* __restrict__ out_idx) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float b1 = CUDART_INF_F, b2 = CUDART_INF_F;
  int bi = 0;
  for (int s = 0; s < splits; ++s) {
    const long long o = (long long)s * n + r;
    merge(b1, bi, b2, part_d1[o], part_i1[o], part_d2[o]);
  }
  out_dist[2LL * r] = b1;
  out_dist[2LL * r + 1] = b2;
  out_idx[r] = bi;
}

template <typename T>
int top2(const T* a, const T* b, const uint8_t* mask, int n, int m, int d,
         int n2, int splits, int cols_per_split, float* sq_a, float* sq_b,
         float* part_d1, int* part_i1, float* part_d2, float* out_dist,
         int* out_idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps_per_block = 8;
  if (n > 0) {
    sqnorm_kernel<T><<<(n + warps_per_block - 1) / warps_per_block,
                       32 * warps_per_block, 0, st>>>(a, n, d, sq_a);
  }
  if (n2 > 0) {
    sqnorm_kernel<T><<<(n2 + warps_per_block - 1) / warps_per_block,
                       32 * warps_per_block, 0, st>>>(b, n2, d, sq_b);
  }
  const dim3 grid((n + kTileN - 1) / kTileN, splits);
  if (mask != nullptr) {
    top2_partial_kernel<T, true><<<grid, kThreads, 0, st>>>(
        a, b, sq_a, sq_b, mask, n, m, d, n2, cols_per_split, part_d1, part_i1,
        part_d2);
  } else {
    top2_partial_kernel<T, false><<<grid, kThreads, 0, st>>>(
        a, b, sq_a, sq_b, mask, n, m, d, n2, cols_per_split, part_d1, part_i1,
        part_d2);
  }
  top2_merge_kernel<<<(n + 255) / 256, 256, 0, st>>>(part_d1, part_i1,
                                                     part_d2, n, splits,
                                                     out_dist, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a [n, d], b [m, d] row-major; mask [n, m] bytes or null; n >= 1; only the
// first n2 <= m rows of b are searched.  Scratch: sq_a [n], sq_b [m],
// partials [splits, n] each.  Outputs: dist [n, 2], idx [n].
int top2_sqdist_f32(const float* a, const float* b, const uint8_t* mask,
                    int n, int m, int d, int n2, int splits,
                    int cols_per_split, float* sq_a, float* sq_b,
                    float* part_d1, int* part_i1, float* part_d2,
                    float* out_dist, int* out_idx, void* stream) {
  return top2<float>(a, b, mask, n, m, d, n2, splits, cols_per_split, sq_a,
                     sq_b, part_d1, part_i1, part_d2, out_dist, out_idx,
                     stream);
}

int top2_sqdist_u8(const uint8_t* a, const uint8_t* b, const uint8_t* mask,
                   int n, int m, int d, int n2, int splits,
                   int cols_per_split, float* sq_a, float* sq_b,
                   float* part_d1, int* part_i1, float* part_d2,
                   float* out_dist, int* out_idx, void* stream) {
  return top2<uint8_t>(a, b, mask, n, m, d, n2, splits, cols_per_split, sq_a,
                       sq_b, part_d1, part_i1, part_d2, out_dist, out_idx,
                       stream);
}

}  // extern "C"
