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
// Two kernels compute it, by the descriptors' type.
//
// uint8 descriptors with D <= 129 (top2_sqdist_u8): the INT8 tensor cores.
// The product a_r . b_c runs as mma.sync m16n8k32 u8 x u8 -> s32, which is
// exact.  The plain twin computes (float(|a|^2) + float(|b|^2)) - 2 dot in
// float32; while 2 D * 255^2 < 2^24 (D <= 129: SIFT and HAHOG's 128, with
// or without a segment column, ORB's 32, AKAZE's 61) every term and sum is
// an integer below 2^24, so the twin is exact too.  The epilogue computes
// that value in integers, compares integers, and converts only the row's
// result: bitwise equal to the twin.  Wider uint8 descriptors take the
// float32 kernel (the wrapper routes them), which is bitwise equal to the
// twin as well up to D = 258: it forms the same float32 expression in the
// same order from products that stay exact while D * 255^2 < 2^24.
//   What bounds it: at N = M = 8,192 and D = 128 the product is
// 2 N M D = 17.2 G integer operations, 8.7 us at the card's 1,979 TOP/s; a
// and b are 1 MB each; the masked form reads 67 MB of mask, 20 us.  But the
// top-2 epilogue runs on the SIMT pipes, ~8 instructions for each of the
// 67 M distances, which is more than the product: the epilogue, and the
// mask's bytes when masked, set the pace.  Hence the integer epilogue (no
// int-to-float conversion, which runs at a quarter of the FP32 rate) and a
// running top-2 that rejects most candidates with one compare.
//   Design.  A block owns 128 query rows and a slice of the columns (split
// across blocks as below), 8 warps of 16 rows each.  The query tile stays in
// shared memory for the whole slice; 128-column database tiles (and, masked,
// their 128 x 128 mask bytes) stream through a double-buffered ring of
// 16-byte cp.async copies, K zero-padded to a multiple of 64 (zeros change
// neither dot products nor norms).  Rows are padded to a stride of 64 mod
// 128 bytes and k is permuted consistently for A and B inside each 64-byte
// chunk, so each lane loads a fragment pair with one conflict-free 16-byte
// shared load.  A warp sweeps its 16 rows against 64 columns at a time (8 n8
// accumulators, 32 registers; all 128 at once spilled), then pushes its
// 2 rows x 16 columns per lane into a running (d1, i1, d2) per row; the
// query rows' fragments are reread for the second half (1/8 of the shared
// loads).  The norms come from the tiles in
// shared memory (__dp4a, exact).  At the end of the slice the quad of lanes
// that shares a row merges by shuffles.  One launch when a single slice
// covers the columns, else two (the slice merge below).
//
// float32 descriptors, and wider uint8 ones (top2_sqdist_f32): a classic
// shared-memory SGEMM micro-kernel (256 threads, 8 x 8 distances each,
// 16-deep k stages, explicit fmaf since the build turns FMA contraction off)
// with the running top-2 fused into its epilogue; row norms from a small
// kernel (one warp per row).  Operations bound it (0.26 ms of FP32 at the
// shape above); TF32 would lose exactness.  Four launches.
//
// Both follow the TPU kernel's running (best, argbest, second) per query row,
// which it keeps in VMEM across a sequential grid over M.  Here each block
// owns 128 query rows and one contiguous slice of the columns (the columns
// are split across blocks so that 8,192 query rows still give ~512 blocks for
// 132 SMs); the block writes one partial (d1, i1, d2) per row and slice and
// a second small kernel merges the slices.  Every merge orders candidates by
// (distance, column), so the result is the same whatever the order of the
// merges: deterministic, and equal to the sequential scan's.
//
// Interface: plain C functions (ctypes), launched on the caller's stream; each
// returns cudaGetLastError() after its launches (-2 for a uint8 width the
// tensor-core kernel does not take).  The caller allocates the scratch
// (norms and partials) and the outputs.

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

// |x_r|^2 per row, one warp per row: lane-strided fmaf sums, then a fixed
// butterfly.  Deterministic.
__global__ void sqnorm_kernel(const float* __restrict__ x, int n, int d,
                              float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const float* row = x + (long long)warp * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = row[k];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

// One block: rows [row0, row0 + 128) against columns
// [blockIdx.y * cols_per_split, ... + cols_per_split) clipped to n2.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
top2_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
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
        As[lk][r] = (gr < n && k < d) ? a[(long long)gr * d + k] : 0.f;
        const int gc = col0 + r;
        Bs[lk][r] = (gc < col_end && k < d) ? b[(long long)gc * d + k] : 0.f;
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

// ---------------------------------------------------------------------------
// uint8: the INT8 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMaxD8 = 129;    // 2 D * 255^2 < 2^24: |a|^2 + |b|^2 exact in f32
constexpr int kMaskLd = 144;   // mask tile row stride: conflict-free u16 reads
constexpr int kNone = 1 << 30; // no candidate; above every distance (< 2^24)
constexpr int kHalfNb = 8;     // n8 blocks a warp sweeps at once (64 columns)

// push() for one state that sees its columns in increasing order, in
// integers: a later column never wins a tie, so one compare rejects most.
__device__ __forceinline__ void push_ordered(int& b1, int& i1, int& b2, int d,
                                             int j) {
  if (d < b2) {
    if (d < b1) {
      b2 = b1;
      b1 = d;
      i1 = j;
    } else {
      b2 = d;
    }
  }
}

__device__ __forceinline__ float as_dist(int x) {
  return x >= kNone ? CUDART_INF_F : static_cast<float>(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies 128 rows into shared memory: row r of src at src + r * ld, the
// first `valid` rows of `width` bytes each, to dst + r * dst_ld, `chunks`
// 16-byte chunks a row.  Bytes past `width` and rows past `valid` are zero.
// With `vec` (src, ld and width multiples of 16) as 16-byte cp.async copies,
// else by byte loads (ragged widths).
__device__ __forceinline__ void load_rows(uint8_t* dst, int dst_ld,
                                          const uint8_t* src, long long ld,
                                          int valid, int width, int chunks,
                                          bool vec) {
  for (int q = threadIdx.x; q < kTileN * chunks; q += kThreads) {
    const int r = q / chunks;
    const int k = (q - r * chunks) * 16;
    uint8_t* to = dst + r * dst_ld + k;
    const uint8_t* from = src + r * ld + k;
    if (vec) {
      const bool in = r < valid && k < width;
      cp_async16(to, in ? from : src, in ? 16 : 0);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (r < valid) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (k + j < width) w[j >> 2] |= unsigned(from[j]) << (8 * (j & 3));
        }
      }
      *reinterpret_cast<uint4*>(to) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// |row|^2 of a padded shared-memory row, two threads a row (`half` 0 and 1
// of its dp bytes), exact in integers; both threads get the total.
__device__ __forceinline__ int row_sqnorm(const uint8_t* row, int half,
                                          int dp) {
  const int h = dp >> 1;
  unsigned s = 0u;
  for (int k = half * h; k < half * h + h; k += 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + k);
    s = __dp4a(w.x, w.x, s);
    s = __dp4a(w.y, w.y, s);
    s = __dp4a(w.z, w.z, s);
    s = __dp4a(w.w, w.w, s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return static_cast<int>(s);
}

// c += A (16 x 32, row) B (32 x 8, col), u8 x u8 -> s32.
__device__ __forceinline__ void mma_u8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block: rows [row0, row0 + 128) against the columns of slice
// blockIdx.y clipped to n2.  Shared memory (dynamic): the query tile, two
// database tiles (128 rows of ld_s bytes each), masked two mask tiles
// (128 x kMaskLd), and the tiles' norms.  Warp w owns rows 16 w .. 16 w + 15;
// lane (g = lane / 4, t = lane % 4) holds rows 16 w + g and + 8, columns
// 8 nb + 2 t and + 1 of each n8 block nb (the m16n8 accumulator layout).
// Within each 64-byte chunk of K, logical k of the mma maps to byte
// 16 t + 4 (2 s + h) + j for step s in {0, 1}, half h (registers a0/a1 vs
// a2/a3, b0 vs b1) and byte j: the same map for A and B, so the dot products
// are unchanged and each lane reads its four fragment words at once.
//   The epilogue stays in integers: the distance the plain twin computes in
// float32, (|a|^2 + |b|^2) - 2 a.b, is an exact integer, so the running
// top-2 compares exactly what the twin compares; excluded candidates
// (masked, or columns past the slice, whose norm is set to kNone) never
// enter it.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
top2_u8_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               const uint8_t* __restrict__ mask, int n, int m, int d, int n2,
               int cols_per_split, int dp, int ld_s, bool vec_ab,
               bool vec_mask, float* __restrict__ part_d1,
               int* __restrict__ part_i1, float* __restrict__ part_d2,
               float* __restrict__ out_dist, int* __restrict__ out_idx) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = As + kTileN * ld_s;
  uint8_t* Ms = Bs + 2 * kTileM * ld_s;
  int* sqa_s =
      reinterpret_cast<int*>(Ms + (kMasked ? 2 * kTileN * kMaskLd : 0));
  int* sqb_s = sqa_s + kTileN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_loc = (tid >> 5) * 16 + g;  // this lane's first row in the tile
  const int row0 = blockIdx.x * kTileN;
  const int col_begin = blockIdx.y * cols_per_split;
  const int col_end = min(n2, col_begin + cols_per_split);
  const int chunks = dp >> 4;

  load_rows(As, ld_s, a + (long long)row0 * d, d, n - row0, d, chunks,
            vec_ab);
  auto load_tile = [&](int col0, int buf) {
    load_rows(Bs + buf * kTileM * ld_s, ld_s, b + (long long)col0 * d, d,
              col_end - col0, d, chunks, vec_ab);
    if (kMasked) {
      load_rows(Ms + buf * kTileN * kMaskLd, kMaskLd,
                mask + (long long)row0 * m + col0, m, n - row0, m - col0,
                kTileM / 16, vec_mask);
    }
  };
  if (col_begin < col_end) load_tile(col_begin, 0);
  cp_async_commit();

  int b1[2] = {kNone, kNone};
  int b2[2] = {kNone, kNone};
  int bi[2] = {0, 0};
  const uint8_t* a_frag = As + r_loc * ld_s + 16 * t;

  int buf = 0;
  for (int col0 = col_begin; col0 < col_end; col0 += kTileM, buf ^= 1) {
    if (col0 + kTileM < col_end) load_tile(col0 + kTileM, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this tile (and the query tile) have landed
    __syncthreads();
    const uint8_t* Bt = Bs + buf * kTileM * ld_s;
    {
      const int r = tid >> 1, half = tid & 1;
      if (col0 == col_begin) {
        const int s = row_sqnorm(As + r * ld_s, half, dp);
        if (half == 0) sqa_s[r] = s;
      }
      const int s = row_sqnorm(Bt + r * ld_s, half, dp);
      if (half == 0) sqb_s[r] = col0 + r < col_end ? s : kNone;
    }
    __syncthreads();

    // Two halves of 64 columns each: 32 accumulator registers, not 64, so
    // the epilogue's state fits beside them without spilling.
    const int sa0 = sqa_s[r_loc], sa1 = sqa_s[r_loc + 8];
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      int acc[kHalfNb][4];
#pragma unroll
      for (int nb = 0; nb < kHalfNb; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nb][i] = 0;
      }
      const uint8_t* b_frag = Bt + (h * kHalfNb * 8 + g) * ld_s + 16 * t;
      for (int k = 0; k < dp; k += 64) {
        const uint4 lo = *reinterpret_cast<const uint4*>(a_frag + k);
        const uint4 hi =
            *reinterpret_cast<const uint4*>(a_frag + 8 * ld_s + k);
#pragma unroll
        for (int nb = 0; nb < kHalfNb; ++nb) {
          const uint4 bv =
              *reinterpret_cast<const uint4*>(b_frag + nb * 8 * ld_s + k);
          mma_u8(acc[nb], lo.x, hi.x, lo.y, hi.y, bv.x, bv.y);
          mma_u8(acc[nb], lo.z, hi.z, lo.w, hi.w, bv.z, bv.w);
        }
      }

      // Epilogue: the distances of these columns into the running top-2.
      const uint8_t* m_row = Ms + buf * kTileN * kMaskLd + r_loc * kMaskLd +
                             h * kHalfNb * 8 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < kHalfNb; ++nb) {
        const int cl = (h * kHalfNb + nb) * 8 + 2 * t;
        const int sb0 = sqb_s[cl], sb1 = sqb_s[cl + 1];
        int d00 = sa0 + sb0 - 2 * acc[nb][0];
        int d01 = sa0 + sb1 - 2 * acc[nb][1];
        int d10 = sa1 + sb0 - 2 * acc[nb][2];
        int d11 = sa1 + sb1 - 2 * acc[nb][3];
        if (kMasked) {
          const unsigned m0 =
              *reinterpret_cast<const uint16_t*>(m_row + nb * 8);
          const unsigned m1 = *reinterpret_cast<const uint16_t*>(
              m_row + 8 * kMaskLd + nb * 8);
          if ((m0 & 0xffu) == 0u) d00 = kNone;
          if ((m0 >> 8) == 0u) d01 = kNone;
          if ((m1 & 0xffu) == 0u) d10 = kNone;
          if ((m1 >> 8) == 0u) d11 = kNone;
        }
        const int c = col0 + cl;
        push_ordered(b1[0], bi[0], b2[0], d00, c);
        push_ordered(b1[1], bi[1], b2[1], d10, c);
        push_ordered(b1[0], bi[0], b2[0], d01, c + 1);
        push_ordered(b1[1], bi[1], b2[1], d11, c + 1);
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }

  // The quad of lanes that shares a row merges its states, as distances.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float e1 = as_dist(b1[i]), e2 = as_dist(b2[i]);
    int ei = bi[i];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, e1, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ei, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, e2, off);
      merge(e1, ei, e2, o1, oi, o2);
    }
    const int r = row0 + r_loc + 8 * i;
    if (t != 0 || r >= n) continue;
    if (gridDim.y == 1) {
      out_dist[2LL * r] = e1;
      out_dist[2LL * r + 1] = e2;
      out_idx[r] = ei;
    } else {
      const long long o = (long long)blockIdx.y * n + r;
      part_d1[o] = e1;
      part_i1[o] = ei;
      part_d2[o] = e2;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

template <bool kMasked>
int launch_u8(const uint8_t* a, const uint8_t* b, const uint8_t* mask, int n,
              int m, int d, int n2, int splits, int cols_per_split,
              float* part_d1, int* part_i1, float* part_d2, float* out_dist,
              int* out_idx, cudaStream_t st) {
  const int dp = (d + 63) / 64 * 64;
  const int ld_s = dp % 128 == 0 ? dp + 64 : dp;  // 64 mod 128 bytes
  const int smem = 3 * kTileN * ld_s + (kMasked ? 2 * kTileN * kMaskLd : 0) +
                   2 * kTileN * static_cast<int>(sizeof(float));
  auto* kernel = top2_u8_kernel<kMasked>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // All of the SM's unified memory as shared memory: two blocks fit.
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec_ab = d % 16 == 0 && aligned16(a) && aligned16(b);
  const bool vec_mask = kMasked && m % 16 == 0 && aligned16(mask);
  const dim3 grid((n + kTileN - 1) / kTileN, splits);
  kernel<<<grid, kThreads, smem, st>>>(
      a, b, mask, n, m, d, n2, cols_per_split, dp, ld_s, vec_ab, vec_mask,
      part_d1, part_i1, part_d2, out_dist, out_idx);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  top2_merge_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      part_d1, part_i1, part_d2, n, splits, out_dist, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 (the wrapper converts wider uint8 sets): the SIMT kernels.
// a [n, d], b [m, d] row-major; mask [n, m] bytes or null; n >= 1; only the
// first n2 <= m rows of b are searched.  Scratch: sq_a [n], sq_b [m],
// partials [splits, n] each.  Outputs: dist [n, 2], idx [n].
int top2_sqdist_f32(const float* a, const float* b, const uint8_t* mask,
                    int n, int m, int d, int n2, int splits,
                    int cols_per_split, float* sq_a, float* sq_b,
                    float* part_d1, int* part_i1, float* part_d2,
                    float* out_dist, int* out_idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps_per_block = 8;
  if (n > 0) {
    sqnorm_kernel<<<(n + warps_per_block - 1) / warps_per_block,
                    32 * warps_per_block, 0, st>>>(a, n, d, sq_a);
  }
  if (n2 > 0) {
    sqnorm_kernel<<<(n2 + warps_per_block - 1) / warps_per_block,
                    32 * warps_per_block, 0, st>>>(b, n2, d, sq_b);
  }
  const dim3 grid((n + kTileN - 1) / kTileN, splits);
  if (mask != nullptr) {
    top2_partial_kernel<true><<<grid, kThreads, 0, st>>>(
        a, b, sq_a, sq_b, mask, n, m, d, n2, cols_per_split, part_d1, part_i1,
        part_d2);
  } else {
    top2_partial_kernel<false><<<grid, kThreads, 0, st>>>(
        a, b, sq_a, sq_b, mask, n, m, d, n2, cols_per_split, part_d1, part_i1,
        part_d2);
  }
  top2_merge_kernel<<<(n + 255) / 256, 256, 0, st>>>(part_d1, part_i1,
                                                     part_d2, n, splits,
                                                     out_dist, out_idx);
  return static_cast<int>(cudaGetLastError());
}

// The same for uint8 a and b with 1 <= d <= 129, on the tensor cores; no norm
// scratch.  With splits == 1 the search writes the outputs itself (one
// launch), else its partials and the merge (two).
int top2_sqdist_u8(const uint8_t* a, const uint8_t* b, const uint8_t* mask,
                   int n, int m, int d, int n2, int splits,
                   int cols_per_split, float* part_d1, int* part_i1,
                   float* part_d2, float* out_dist, int* out_idx,
                   void* stream) {
  if (d < 1 || d > kMaxD8) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) {
    return launch_u8<true>(a, b, mask, n, m, d, n2, splits, cols_per_split,
                           part_d1, part_i1, part_d2, out_dist, out_idx, st);
  }
  return launch_u8<false>(a, b, mask, n, m, d, n2, splits, cols_per_split,
                          part_d1, part_i1, part_d2, out_dist, out_idx, st);
}

}  // extern "C"
