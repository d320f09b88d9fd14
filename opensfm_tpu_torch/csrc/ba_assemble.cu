// Dense-layout Schur assembly, back-substitution and cost kernels for Hopper.
//
// Replace the three Pallas kernels of
// opensfm_tpu/ops/pallas_kernels/ba_assemble.py, the dense mono fast path of
// the LM bundle adjuster (slot == instance, one perspective camera
// [k1, k2, f], identity rig; observations on the [NP, NI] grid, dead slots
// with inv_sd == 0):
//   fused_schur_assembly   (_make_kernel)           -> schur_assembly below
//   fused_back_substitute  (_make_backsub_kernel)   -> backsub_kernel
//   fused_cost_dense       (_make_cost_kernel_dense) -> cost_dense_kernel
//
// fused_schur_assembly computes, from the raw inputs, everything the reduced
// camera system needs: per point the damped 3x3 Hessian's inverse Hinv, bp
// and Hinv bp (out_pt [NP, 16]); the Schur product
//   S_II = sum_p B_p B_p^T,   B_p = Ga_p L_p,   Hinv_p = L_p L_p^T
// as a symmetric [6 NI, 6 NI] matrix in (x, a) order (row x * NI + a); and
// the per-instance direct blocks and right-hand sides (aux [96, NI], the
// Pallas kernel's row layout).  The TPU kernel carries the S_II sum in VMEM
// across a sequential grid.  Blocks of a GPU run in no order, so the work is
// split in two passes, each followed by a sum of its block partials in a
// fixed order (no atomics, so the result is the same on every run):
//  1. assemble_kernel: one block per chunk of points, one thread per instance
//     slot.  Each thread computes its slot's rotation coefficients once, then
//     runs the chain of its slot for each point of the chunk; the per-point
//     3x3 sums are a warp reduce-scatter and one barrier; the thread writes
//     its slot's column of B (bmat [3 NP, 6 NI]) and accumulates its slot's
//     81 direct and RHS sums in its own column of shared memory; the block's
//     sums go out as one partial per chunk (aux_part [chunks, 96, NI]), which
//     sum_chunks_kernel adds up in chunk order, in two levels.
//  2. S_II = bmat^T bmat, only the 64 x 64 tiles on and below the diagonal,
//     split over K = 3 NP so that enough blocks fill the card: in f64 on the
//     f64 tensor cores (syrk_dmma_kernel, mma.sync m16n8k8 .f64), in f32 on
//     FP32 FMAs (syrk_kernel; full FP32, no TF32); syrk_reduce_kernel adds
//     the splits in order and mirrors the lower triangle above.
//
// What bounds them on the card.  At the 64 x 8,192 dense lane in f64 the
// assembly reads ~13 MB of observations and writes 75 MB of bmat that the
// product reads back; the product is 3.6 GFLOP (the lower half of a
// [384, 24,576] x [24,576, 384] product): operations bound it, ~0.05 ms at
// 67 TFLOP/s.  The slot pass is held by its registers (~255 a thread, so
// few warps in flight) and its per-point reduction; PERF.md has the times of
// each part.  Keeping bmat out of device memory, as the TPU kernel does,
// needs the product fused into pass 1 and is later work.
//
// fused_back_substitute recomputes the chain instead of keeping the
// Jacobians: dx_p = Hinv (bp - sum_a Jp^T (J_pose dx_a + J_cam dx_cam)).  It
// reads ~24 B per slot in f64 and its chain's operations bound it (the
// operations of forming and contracting the 24 Jacobian entries per slot).
// So backsub_kernel, like assemble_kernel, runs one block per chunk of points
// and one thread per slot, with everything that depends on the slot alone
// (the rotation, its derivative along the update, the camera) computed once
// per slot, the Jacobian contracted as it forms into fused multiply-adds
// (about a quarter of the operations), and one barrier per chunk instead of
// a block reduction per point.
// fused_cost_dense is the cost over the dense grid with the indices implied
// by the slot number (no index arrays): a grid-stride loop, a fixed tree per
// block and a second single-block pass.  It reads ~24 B per slot in f64 and
// is memory- and latency-bound.
//
// Interface: plain C functions (ctypes), launched on the caller's stream; each
// returns the first non-zero cudaGetLastError() after its launches (or -1 for
// an unknown loss).

#include <cuda_runtime.h>

#include <type_traits>

#include "ba_chain.cuh"

namespace {

constexpr int kMaxThreads = 256;  // one thread per instance slot, NI <= 256
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kAuxRows = 96;      // aux rows (the Pallas kernel's layout)
constexpr int kPt = 16;           // out_pt columns
constexpr int kAcc = 81;          // per-slot accumulators of assemble_kernel
constexpr int kPointSums = 18;    // per-point sums over the slots: Hpp, bp, Vg
constexpr int kChunkGroup = 32;   // chunk partials per first-level group sum
constexpr int kTile = 64;         // syrk output tile
constexpr int kTileK = 16;        // syrk depth per shared-memory stage

// Index of (x, y), x <= y, in the row-major upper triangle of an n x n block.
__host__ __device__ constexpr int tri(int n, int x, int y) {
  return x * n - x * (x - 1) / 2 + (y - x);
}

// Warp reduce-scatter of N <= 32 values per lane: five halving steps, each
// lane keeping half of the current values and adding its partner's copy of
// them (keep + received, a fixed order), 20 exchanges for N = 18 where a
// butterfly per value takes 5 N.  Afterwards x[0] of each lane with
// scatter_value<N>(lane) = i >= 0 holds the warp's sum of value i.  C is the
// values still held per lane, O the partner's lane bit.
template <typename T, int N, int C = N, int O = 16>
__device__ __forceinline__ void warp_reduce_scatter(T (&x)[N]) {
  if constexpr (O > 0) {
    constexpr int lo = (C + 1) / 2;
    const bool up = (threadIdx.x & O) != 0;
#pragma unroll
    for (int i = 0; i < lo; ++i) {
      const T hi_v = lo + i < C ? x[lo + i] : T(0);
      const T send = up ? x[i] : hi_v;
      const T keep = up ? hi_v : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    warp_reduce_scatter<T, N, lo, O / 2>(x);
  }
}

// The value whose warp sum `lane` holds after warp_reduce_scatter<N>, or -1:
// the upper half of each step's lanes takes the values from lo on.
template <int N>
__host__ __device__ constexpr int scatter_value(int lane) {
  int off = 0, n = N, c = N;
  for (int o = 16; o > 0; o >>= 1) {
    const int lo = (c + 1) / 2;
    if (lane & o) {
      off += lo;
      n -= lo;
    } else if (n > lo) {
      n = lo;
    }
    c = lo;
  }
  return n >= 1 ? off : -1;
}

// Block-wide sum of N values per thread; every thread gets the totals: a
// warp reduce-scatter, then the warp partials in warp order, so the same
// inputs give the same bits on every run.  One barrier: `sh` must not be
// written again before every thread has passed the next barrier.
template <typename T, int N>
__device__ __forceinline__ void block_allreduce(T (&x)[N], T (*sh)[N]) {
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int mine = scatter_value<N>(threadIdx.x & 31);
  warp_reduce_scatter(x);
  if (mine >= 0) sh[warp][mine] = x[0];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T t = sh[0][i];
    for (int w = 1; w < n_warps; ++w) t += sh[w][i];
    x[i] = t;
  }
}

template <typename T>
__device__ __forceinline__ T clamp0(T x) {
  return x > T(0) ? x : T(0);
}

// Closed-form inverse of a symmetric 3x3 given its upper triangle h
// (xx, xy, xz, yy, yz, zz); a (near) singular block inverts to 0.
template <typename T>
__device__ __forceinline__ void sym3_inv(const T* h, T* hi) {
  const T c_xx = h[3] * h[5] - h[4] * h[4];
  const T c_xy = h[2] * h[4] - h[1] * h[5];
  const T c_xz = h[1] * h[4] - h[2] * h[3];
  const T c_yy = h[0] * h[5] - h[2] * h[2];
  const T c_yz = h[1] * h[2] - h[0] * h[4];
  const T c_zz = h[0] * h[3] - h[1] * h[1];
  const T det = h[0] * c_xx + h[1] * c_xy + h[2] * c_xz;
  const bool sing = fabs(det) < T(1e-30);
  const T inv_det = sing ? T(0) : T(1) / det;
  hi[0] = c_xx * inv_det;
  hi[1] = c_xy * inv_det;
  hi[2] = c_xz * inv_det;
  hi[3] = c_yy * inv_det;
  hi[4] = c_yz * inv_det;
  hi[5] = c_zz * inv_det;
}

// Loads the instance row of slot a, the camera and point p into v.
template <typename T>
__device__ __forceinline__ void dense_vals(const T* inst, const T* cam,
                                           const T* points, int a, long long p,
                                           T* v) {
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = inst[6 * a + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[6 + k] = cam[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[9 + k] = points[3 * p + k];
}

// Accumulator rows of assemble_kernel (each a column of blockDim.x values):
//   0-20  direct_II upper triangle   21-38 direct_IC (x * 3 + y)
//   39-44 direct_CC upper triangle   45-62 schur_IC (x * 3 + y)
//   63-68 b_i                        69-71 b_c direct
//   72-74 b_c schur (per point, lane 0)   75-80 schur_CC upper (lane 0)
template <typename T, int LOSS>
__global__ void __launch_bounds__(kMaxThreads)
    assemble_kernel(const T* __restrict__ inst, const T* __restrict__ cam,
                    const T* __restrict__ points,
                    const T* __restrict__ obs_uv,
                    const T* __restrict__ obs_inv_sd,
                    const unsigned char* __restrict__ opt_inst,
                    const unsigned char* __restrict__ opt_cam,
                    const unsigned char* __restrict__ opt_points,
                    const T* __restrict__ point_prior,
                    const T* __restrict__ pp_inv, T lam1, int ni, int np,
                    int chunk, T a2, T* __restrict__ out_pt,
                    T* __restrict__ bmat, T* __restrict__ aux_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [kAcc][blockDim.x]
  // The per-point sums' warp partials, double-buffered: one barrier a point.
  __shared__ T red_sh[2][kMaxWarps][kPointSums];
  const int nt = blockDim.x;
  const int a = threadIdx.x;
  const bool valid = a < ni;
  const long long ni6 = 6LL * ni;
  T* ac = acc + a;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) ac[i * nt] = T(0);

  T v[12];
  T opt_i = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = valid ? inst[6 * a + k] : T(0);
  if (valid) opt_i = opt_inst[a] ? T(1) : T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[6 + k] = cam[k];
  const T opt_c[3] = {opt_cam[0] ? T(1) : T(0), opt_cam[1] ? T(1) : T(0),
                      opt_cam[2] ? T(1) : T(0)};
  // The slot's rotation coefficients (sqrt, sin, cos, divides), once.
  const Rodrigues<T> rod(v[0], v[1], v[2], true);

  const long long p_begin = (long long)blockIdx.x * chunk;
  const long long p_end =
      p_begin + chunk < (long long)np ? p_begin + chunk : (long long)np;
  int buf = 0;
  for (long long p = p_begin; p < p_end; ++p, buf ^= 1) {
    const T optp = opt_points[p] ? T(1) : T(0);
    T J0[12], J1[12];
    T r0 = T(0), r1 = T(0);
    if (valid) {
#pragma unroll
      for (int k = 0; k < 3; ++k) v[9 + k] = points[3 * p + k];
      T q0, q1;
      chain_fwd_jac(v, rod, q0, q1, J0, J1);
      const long long o = p * ni + a;
      const T isd = obs_inv_sd[o];
      const T e0 = (q0 - obs_uv[2 * o]) * isd;
      const T e1 = (q1 - obs_uv[2 * o + 1]) * isd;
      T rho, drho;
      loss_eval<T, LOSS>((e0 * e0 + e1 * e1) / a2, rho, drho);
      const T sw = sqrt_weight(drho);
      const T scale = isd * sw;
      r0 = e0 * sw;
      r1 = e1 * sw;
      // Optimization masks: instance, camera dims, point.
      T m[12];
#pragma unroll
      for (int j = 0; j < 6; ++j) m[j] = opt_i;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        m[6 + j] = opt_c[j];
        m[9 + j] = optp;
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        J0[j] = J0[j] * scale * m[j];
        J1[j] = J1[j] * scale * m[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) J0[j] = J1[j] = T(0);
    }

    // Per-point sums over the slots: Hpp (upper), bp, Vg = Jc^T Jp.
    T s[kPointSums];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
#pragma unroll
      for (int y = x; y < 3; ++y) {
        s[tri(3, x, y)] = J0[9 + x] * J0[9 + y] + J1[9 + x] * J1[9 + y];
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) s[6 + j] = J0[9 + j] * r0 + J1[9 + j] * r1;
#pragma unroll
    for (int y = 0; y < 3; ++y) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        s[9 + 3 * y + j] = J0[6 + y] * J0[9 + j] + J1[6 + y] * J1[9 + j];
      }
    }
    // The buffer written here was last read before the previous point's
    // barrier.
    block_allreduce(s, red_sh[buf]);

    // Point priors, damping, the inverse and its Cholesky factor (every
    // thread computes the same values).
    T h[6], bp[3];
#pragma unroll
    for (int i = 0; i < 6; ++i) h[i] = s[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T w = pp_inv[3 * p + j];
      const T rr = (points[3 * p + j] - point_prior[3 * p + j]) * w;
      h[tri(3, j, j)] = h[tri(3, j, j)] + w * w;
      bp[j] = s[6 + j] + rr * w;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      h[tri(3, j, j)] = h[tri(3, j, j)] * lam1 + T(1e-12);
    }
    T hi[6];
    sym3_inv(h, hi);
#pragma unroll
    for (int i = 0; i < 6; ++i) hi[i] = hi[i] * optp;
    const T H[3][3] = {{hi[0], hi[1], hi[2]},
                       {hi[1], hi[3], hi[4]},
                       {hi[2], hi[4], hi[5]}};
    T hib[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      hib[j] = H[j][0] * bp[0] + H[j][1] * bp[1] + H[j][2] * bp[2];
    }
    const T tiny = T(1e-30);
    const T l00 = sqrt(clamp0(hi[0]));
    const T il00 = l00 > tiny ? T(1) / l00 : T(0);
    const T l10 = hi[1] * il00;
    const T l20 = hi[2] * il00;
    const T l11 = sqrt(clamp0(hi[3] - l10 * l10));
    const T il11 = l11 > tiny ? T(1) / l11 : T(0);
    const T l21 = (hi[4] - l20 * l10) * il11;
    const T l22 = sqrt(clamp0(hi[5] - l20 * l20 - l21 * l21));
    T Vg[3][3], Cg[3][3];
#pragma unroll
    for (int y = 0; y < 3; ++y) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Vg[y][j] = s[9 + 3 * y + j];
      Cg[y][0] = Vg[y][0] * l00 + Vg[y][1] * l10 + Vg[y][2] * l20;
      Cg[y][1] = Vg[y][1] * l11 + Vg[y][2] * l21;
      Cg[y][2] = Vg[y][2] * l22;
    }
    if (threadIdx.x == 0) {
      T* pt = out_pt + p * kPt;
#pragma unroll
      for (int i = 0; i < 6; ++i) pt[i] = hi[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        pt[6 + j] = bp[j];
        pt[9 + j] = hib[j];
      }
#pragma unroll
      for (int i = 12; i < kPt; ++i) pt[i] = T(0);
      // The camera-family Schur terms, once per point (slot 0 is valid).
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        ac[(72 + y) * nt] +=
            Vg[y][0] * hib[0] + Vg[y][1] * hib[1] + Vg[y][2] * hib[2];
      }
      T Ug[3][3];
#pragma unroll
      for (int y = 0; y < 3; ++y) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          Ug[y][k] =
              Vg[y][0] * H[0][k] + Vg[y][1] * H[1][k] + Vg[y][2] * H[2][k];
        }
      }
#pragma unroll
      for (int x = 0; x < 3; ++x) {
#pragma unroll
        for (int y = x; y < 3; ++y) {
          ac[(75 + tri(3, x, y)) * nt] +=
              Ug[x][0] * Vg[y][0] + Ug[x][1] * Vg[y][1] + Ug[x][2] * Vg[y][2];
        }
      }
    }
    if (!valid) continue;

    // This slot's couplings Ga = Ji^T Jp: its Schur right-hand side, then
    // the Schur factor B = Ga L (written to bmat) and its coupling to the
    // camera, so that Ga and B are not live at once with the direct sums.
    T B[6][3];
#pragma unroll
    for (int x = 0; x < 6; ++x) {
      T Ga[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) Ga[j] = J0[x] * J0[9 + j] + J1[x] * J1[9 + j];
      const T direct = J0[x] * r0 + J1[x] * r1;
      const T gsch = Ga[0] * hib[0] + Ga[1] * hib[1] + Ga[2] * hib[2];
      ac[(63 + x) * nt] += direct - gsch;
      B[x][0] = Ga[0] * l00 + Ga[1] * l10 + Ga[2] * l20;
      B[x][1] = Ga[1] * l11 + Ga[2] * l21;
      B[x][2] = Ga[2] * l22;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T* row = bmat + (3 * p + k) * ni6 + a;
#pragma unroll
      for (int x = 0; x < 6; ++x) row[x * ni] = B[x][k];
    }
#pragma unroll
    for (int x = 0; x < 6; ++x) {
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        ac[(45 + 3 * x + y) * nt] +=
            B[x][0] * Cg[y][0] + B[x][1] * Cg[y][1] + B[x][2] * Cg[y][2];
      }
    }

    // Direct blocks and right-hand sides of this slot.
#pragma unroll
    for (int x = 0; x < 6; ++x) {
#pragma unroll
      for (int y = x; y < 6; ++y) {
        ac[tri(6, x, y) * nt] += J0[x] * J0[y] + J1[x] * J1[y];
      }
    }
#pragma unroll
    for (int x = 0; x < 6; ++x) {
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        ac[(21 + 3 * x + y) * nt] += J0[x] * J0[6 + y] + J1[x] * J1[6 + y];
      }
    }
#pragma unroll
    for (int x = 0; x < 3; ++x) {
#pragma unroll
      for (int y = x; y < 3; ++y) {
        ac[(39 + tri(3, x, y)) * nt] +=
            J0[6 + x] * J0[6 + y] + J1[6 + x] * J1[6 + y];
      }
    }
#pragma unroll
    for (int y = 0; y < 3; ++y) {
      ac[(69 + y) * nt] += J0[6 + y] * r0 + J1[6 + y] * r1;
    }
  }

  // This chunk's partial of aux, in the Pallas kernel's row layout.
  if (!valid) return;
  T* out = aux_part + (long long)blockIdx.x * kAuxRows * ni + a;
#pragma unroll
  for (int x = 0; x < 6; ++x) {
#pragma unroll
    for (int y = 0; y < 6; ++y) {
      out[(x * 6 + y) * ni] = ac[(x <= y ? tri(6, x, y) : tri(6, y, x)) * nt];
    }
  }
#pragma unroll
  for (int i = 0; i < 18; ++i) out[(36 + i) * ni] = ac[(21 + i) * nt];
#pragma unroll
  for (int i = 0; i < 6; ++i) out[(54 + i) * ni] = ac[(39 + i) * nt];
#pragma unroll
  for (int i = 0; i < 18; ++i) out[(60 + i) * ni] = ac[(45 + i) * nt];
#pragma unroll
  for (int i = 0; i < 6; ++i) out[(78 + i) * ni] = ac[(63 + i) * nt];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[(84 + i) * ni] = ac[(69 + i) * nt];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    out[(87 + i) * ni] = a == 0 ? ac[(72 + i) * nt] : T(0);
  }
}

// out[g * n + i] = the sum over chunks c of group g = blockIdx.y (c from
// g * group to the smaller of (g + 1) * group and n_chunks) of part[c * n + i],
// in chunk order.  Run twice, groups of kChunkGroup chunks and then the group
// sums, so ~16 times more threads share the sum than one per element.
template <typename T>
__global__ void sum_chunks_kernel(const T* __restrict__ part, int n_chunks,
                                  int group, long long n, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c0 = blockIdx.y * group;
  const int c1 = c0 + group < n_chunks ? c0 + group : n_chunks;
  T acc = T(0);
  for (int c = c0; c < c1; ++c) acc += part[(long long)c * n + i];
  out[blockIdx.y * n + i] = acc;
}

// Output tile (tr, tc), tr >= tc, of product block b: the lower tiles row by
// row (ops/kernels/ba_assemble.py's product_tiles mirrors this order).
__device__ __forceinline__ void lower_tile(int b, int& tr, int& tc) {
  tr = 0;
  while ((tr + 1) * (tr + 2) / 2 <= b) ++tr;
  tc = b - tr * (tr + 1) / 2;
}

// f32: part[split] = bmat[k-range]^T bmat[k-range] on the output tiles on and
// below the diagonal; bmat is [K, n] row-major.  256 threads, each 4 x 4
// outputs, FMAs on the FP32 pipes (full FP32: no TF32).
template <typename T>
__global__ void __launch_bounds__(256)
    syrk_kernel(const T* __restrict__ bmat, long long K, int n,
                long long k_split, T* __restrict__ part) {
  int tr, tc;
  lower_tile(blockIdx.x, tr, tc);
  const int i0 = tr * kTile, j0 = tc * kTile;
  const long long k0 = (long long)blockIdx.y * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  __shared__ T As[kTileK][kTile];
  __shared__ T Bs[kTileK][kTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  T acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = T(0);
  }
  for (long long kb = k0; kb < k1; kb += kTileK) {
    for (int l = threadIdx.x; l < kTileK * kTile; l += 256) {
      const int kk = l / kTile, c = l % kTile;
      const long long k = kb + kk;
      const bool in_k = k < k1;
      As[kk][c] = (in_k && i0 + c < n) ? bmat[k * n + i0 + c] : T(0);
      Bs[kk][c] = (in_k && j0 + c < n) ? bmat[k * n + j0 + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) av[m] = As[kk][ty + 16 * m];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[kk][tx + 16 * q];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fma(av[m], bv[q], acc[m][q]);
      }
    }
    __syncthreads();
  }
  T* out = part + (long long)blockIdx.y * n * n;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 16 * m, j = j0 + tx + 16 * q;
      if (i < n && j < n) out[(long long)i * n + j] = acc[m][q];
    }
  }
}

// ---------------------------------------------------------------------------
// f64: the product on the f64 tensor cores (DMMA, mma.sync m16n8k8 .f64).
// A block of 4 warps owns one 64 x 64 lower output tile and one K split; warp
// w computes the 32 x 32 quadrant (w / 2, w % 2) as 2 x 4 m16n8 fragments.
// Both operands are column stripes of bmat (A[i][k] = bmat[k][i0 + i]), so a
// stage is kDmmaK rows of 64 doubles per stripe, 512 contiguous bytes a row,
// copied by cp.async in 16-byte pieces (consecutive threads on consecutive
// addresses) into a ring of kDmmaStages stages.  A diagonal tile loads its one
// stripe once and skips its strictly upper quadrant, which the reduce never
// reads.  Rows are padded to kDmmaLd = 68 doubles: a fragment's half-warp
// reads (k0 + t) * 68 + g, t, g < 4, i.e. 16 distinct 8-byte bank pairs, so
// the LDS.64 fragment loads are conflict-free (ldmatrix has no 64-bit form).
// Ragged edges: columns >= n and rows >= the split's end are zero-filled by
// cp.async (source size 0); n = 6 NI is even, so a 16-byte piece is wholly in
// or out.  Every sum runs in a fixed order (k-steps in order within a split,
// splits in order in the reduce): the same inputs give the same bits.
constexpr int kDmmaK = 16;       // k rows per stage
constexpr int kDmmaStages = 3;   // cp.async ring depth
constexpr int kDmmaLd = kTile + 4;  // padded row, in doubles
constexpr int kDmmaThreads = 128;
constexpr size_t kDmmaSmem =
    sizeof(double) * kDmmaStages * 2 * kDmmaK * kDmmaLd;  // 52,224 B

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// The back-substitution's copies.  Their asm names memory as clobbered:
// the compiler sees no store to the staged shared memory otherwise, and
// may then treat its reads as reads of memory never written (with other
// register limits this kernel read wrong values without it).  The product's
// helpers above stay as they are, with the code they compile to.
//
// An N-byte (4, 8 or 16) asynchronous copy, both addresses N-byte aligned.
template <int N>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_m() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_m() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most n of this thread's copy groups are pending (n >= 7:
// at most 7, which completes every group but the last 7).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n < 7 ? n : 7) {
    case 0: cp_async_wait_m<0>(); break;
    case 1: cp_async_wait_m<1>(); break;
    case 2: cp_async_wait_m<2>(); break;
    case 3: cp_async_wait_m<3>(); break;
    case 4: cp_async_wait_m<4>(); break;
    case 5: cp_async_wait_m<5>(); break;
    case 6: cp_async_wait_m<6>(); break;
    default: cp_async_wait_m<7>(); break;
  }
}

// d += a (16 x 8, row) * b (8 x 8, col), f64, one warp.  Fragments (g = lane
// / 4, t = lane % 4): a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] =
// B[t + 4 i][g], d[i] = D[g + 8 (i / 2)][2 t + i % 2].
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4],
                                            const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One stage: rows [kb, kb + kDmmaK) of the stripes at columns i0 (to As) and
// j0 (to Bs, unless diag).
__device__ __forceinline__ void dmma_load_stage(
    const double* __restrict__ bmat, long long kb, long long k1, int n, int i0,
    int j0, bool diag, double* As, double* Bs) {
  constexpr int kPieces = kDmmaK * kTile / 2;  // 16-byte pieces per stripe
#pragma unroll
  for (int r = 0; r < kPieces / kDmmaThreads; ++r) {
    const int piece = threadIdx.x + r * kDmmaThreads;
    const int kk = piece / (kTile / 2), c = 2 * (piece % (kTile / 2));
    const long long k = kb + kk;
    const bool in_k = k < k1;
    const int ia = i0 + c;
    cp_async16(As + kk * kDmmaLd + c, in_k && ia < n ? bmat + k * n + ia : bmat,
               in_k && ia < n ? 16 : 0);
    if (!diag) {
      const int jb = j0 + c;
      cp_async16(Bs + kk * kDmmaLd + c,
                 in_k && jb < n ? bmat + k * n + jb : bmat,
                 in_k && jb < n ? 16 : 0);
    }
  }
}

__global__ void __launch_bounds__(kDmmaThreads)
    syrk_dmma_kernel(const double* __restrict__ bmat, long long K, int n,
                     long long k_split, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  int tr, tc;
  lower_tile(blockIdx.x, tr, tc);
  const bool diag = tr == tc;
  const int i0 = tr * kTile, j0 = tc * kTile;
  const long long k0 = (long long)blockIdx.y * k_split;
  const long long k1 = k0 + k_split < K ? k0 + k_split : K;
  const int n_steps = (int)((k1 - k0 + kDmmaK - 1) / kDmmaK);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const bool idle = diag && wm < wn;  // the diagonal tile's upper quadrant
  auto a_stage = [&](int s) { return ring + (2 * s) * kDmmaK * kDmmaLd; };
  auto b_stage = [&](int s) {
    return diag ? a_stage(s) : ring + (2 * s + 1) * kDmmaK * kDmmaLd;
  };

  double acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0;
    }
  }

#pragma unroll
  for (int s = 0; s < kDmmaStages - 1; ++s) {
    if (s < n_steps) {
      dmma_load_stage(bmat, k0 + (long long)s * kDmmaK, k1, n, i0, j0, diag,
                      a_stage(s), b_stage(s));
    }
    cp_async_commit();  // one group per stage, empty or not
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kDmmaStages - 2>();
    __syncthreads();  // the stage has landed; the oldest buffer is free
    const int next = step + kDmmaStages - 1;
    if (next < n_steps) {
      const int s = next % kDmmaStages;
      dmma_load_stage(bmat, k0 + (long long)next * kDmmaK, k1, n, i0, j0, diag,
                      a_stage(s), b_stage(s));
    }
    cp_async_commit();
    if (idle) continue;
    const double* As = a_stage(step % kDmmaStages) + 32 * wm;
    const double* Bs = b_stage(step % kDmmaStages) + 32 * wn;
#pragma unroll
    for (int kk = 0; kk < kDmmaK; kk += 8) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[mi][i] = As[(kk + t + 4 * (i / 2)) * kDmmaLd + 16 * mi + g +
                        8 * (i % 2)];
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          b[ni][i] = Bs[(kk + t + 4 * i) * kDmmaLd + 8 * ni + g];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) dmma_16x8x8(acc[mi][ni], a[mi], b[ni]);
      }
    }
  }
  cp_async_wait<0>();
  if (idle) return;
  double* out = part + (long long)blockIdx.y * n * n;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 32 * wm + 16 * mi + g + 8 * h;
      if (i >= n) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int j = j0 + 32 * wn + 8 * ni + 2 * t;  // even; n is even
        if (j < n) {
          *reinterpret_cast<double2*>(out + (long long)i * n + j) =
              make_double2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
      }
    }
  }
}

// s_ii = the sum over splits of part, in split order, on the lower triangle,
// and its mirror above: s_ii[i][j] = s_ii[j][i] = sum_s part[s][max][min], so
// the result is exactly symmetric and only the lower triangle of each partial
// is read.  One block of 16 x 16 threads, one entry each, per lower 16 x 16
// tile (300 blocks at 6 NI = 384); the mirror goes out through a shared-memory
// transpose, so reads and writes coalesce.
constexpr int kRedTile = 16;

template <typename T>
__global__ void __launch_bounds__(kRedTile * kRedTile)
    syrk_reduce_kernel(const T* __restrict__ part, int n, int n_split,
                       T* __restrict__ s_ii) {
  __shared__ T tile[kRedTile][kRedTile + 1];
  int tr, tc;
  lower_tile(blockIdx.x, tr, tc);
  const int tx = threadIdx.x % kRedTile, ty = threadIdx.x / kRedTile;
  const long long nn = (long long)n * n;
  int i = tr * kRedTile + ty, j = tc * kRedTile + tx;
  T acc = T(0);
  if (i < n && j < n && (tr != tc || ty >= tx)) {
    const long long src = (long long)i * n + j;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) acc += part[s * nn + src];
    s_ii[src] = acc;
  }
  tile[ty][tx] = acc;
  __syncthreads();
  i = tc * kRedTile + ty;  // the mirror: row ty of the transposed tile
  j = tr * kRedTile + tx;
  if (i < n && j < n && (tr != tc || tx > ty)) {
    s_ii[(long long)i * n + j] = tile[tx][ty];
  }
}

// What the back-substitution needs of one instance slot, computed once per
// slot: the rotation R(w), the directional derivative of R along the pose
// update's dw, M = dR[dw] (so that dX = M x + dt is the derivative of
// X = R x + t along (dw, dt), for any point x), the translation and its
// update, and the camera and its update.  M follows from the Gallego-Yezzi
// column d(Rx)/dw_i = w_i V + sinc (e_i x x) + ccos (rdx e_i + x_i w) of
// chain_fwd_jac, V = -sinc x + sp (w x x) + gp rdx w, summed against dw:
//   M = -(w.dw) sinc I + (w.dw) sp [w]x + (w.dw) gp w w^T + sinc [dw]x
//       + ccos (dw w^T + w dw^T).
template <typename T>
struct BacksubSlot {
  T R[3][3], M[3][3], t[3], dt[3];
  T k1, k2, f, dk1, dk2, df;
  __device__ __forceinline__ void init(const T* __restrict__ pose,
                                       const T* __restrict__ cam,
                                       const T* __restrict__ dpose,
                                       const T* __restrict__ dcam) {
    const T w[3] = {pose[0], pose[1], pose[2]};
    const T dw[3] = {dpose[0], dpose[1], dpose[2]};
    const Rodrigues<T> rod(w[0], w[1], w[2], true);
    const T wd = w[0] * dw[0] + w[1] * dw[1] + w[2] * dw[2];
    const T al = -wd * rod.sinc, be = wd * rod.sp, ga = wd * rod.gp;
    // [a]x[m][n] = sum_k eps(m, k, n) a_k
    const T W[3][3] = {{T(0), -w[2], w[1]}, {w[2], T(0), -w[0]},
                       {-w[1], w[0], T(0)}};
    const T DW[3][3] = {{T(0), -dw[2], dw[1]}, {dw[2], T(0), -dw[0]},
                        {-dw[1], dw[0], T(0)}};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const T id = m == n ? T(1) : T(0);
        R[m][n] = rod.cos_t * id + rod.sinc * W[m][n] + rod.ccos * w[m] * w[n];
        M[m][n] = al * id + be * W[m][n] + ga * w[m] * w[n] +
                  rod.sinc * DW[m][n] + rod.ccos * (dw[m] * w[n] + w[m] * dw[n]);
      }
      t[m] = pose[3 + m];
      dt[m] = dpose[3 + m];
    }
    k1 = cam[0];
    k2 = cam[1];
    f = cam[2];
    dk1 = dcam[0];
    dk2 = dcam[1];
    df = dcam[2];
  }
};

// 1 / x for x finite and nonzero.  f64: the hardware's approximation and
// two Newton steps, within an ulp of the IEEE divide, as a straight line:
// the divide branches to a slow-path call, and across that call ptxas
// spilled the trivial loss's point loop.  f32: the IEEE divide.
__device__ __forceinline__ double recip(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  y = fma(y, fma(-x, y, 1.0), y);
  return fma(y, fma(-x, y, 1.0), y);
}
__device__ __forceinline__ float recip(float x) { return 1.0f / x; }

// max(rho'(q), 1e-12) of the robust losses (loss_eval's drho, clamped as
// sqrt_weight clamps it), with SoftLOne's 1 / sqrt(1 + q) and Huber's
// 1 / sqrt(q) as one rsqrt instead of a square root and a divide.  NaN
// stays NaN.
template <typename T, int LOSS>
__device__ __forceinline__ T loss_weight(T q) {
  const T one = T(1);
  T w;
  if (LOSS == 0) {
    w = one;
  } else if (LOSS == 1) {
    w = rsqrt(one + q);
  } else if (LOSS == 2) {
    w = one / (one + q);
  } else if (LOSS == 3) {
    w = (q <= one) ? one : rsqrt(q);
  } else {
    const T m = one - q;
    w = (q <= one) ? m * m : T(0);
  }
  const T wmin = T(1e-12);
  return w < wmin ? wmin : w;
}

// u = Jp^T (J_pose dx_a + J_cam dx_cam) of one slot and point, every row
// weighted by s = inv_sd sqrt(rho'), contracted as it forms: with A the 2x3
// projection Jacobian, J_pose dx_a + J_cam dx_cam = A dX + (u, v) c for the
// camera's c = f r2 (dk1 + dk2 r2) + df d, and Jp = A R, so
// u = s^2 R^T A^T (A dX + (u, v) c), and s^2 = inv_sd^2 max(rho', 1e-12)
// needs no square root.  The f64 pipes bound this kernel, so its sums of
// products are explicit fused multiply-adds (the build's -fmad=false keeps
// every other kernel's rounding): with the contraction, about 100
// operations a slot and point against ~400 for forming the 24 Jacobian
// entries and contracting them (chain_fwd_jac), and one reciprocal and one
// reciprocal square root where that chain and its loss weight take five
// divides and square roots.  The same function up to rounding.
template <typename T, int LOSS>
__device__ __forceinline__ void backsub_u(const BacksubSlot<T>& S, T x0, T x1,
                                          T x2, T uv0, T uv1, T isd,
                                          T inv_a2, T* ug) {
  T X[3], dX[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    X[m] = fma(S.R[m][2], x2, fma(S.R[m][1], x1, fma(S.R[m][0], x0, S.t[m])));
    dX[m] =
        fma(S.M[m][2], x2, fma(S.M[m][1], x1, fma(S.M[m][0], x0, S.dt[m])));
  }
  const T iz = recip(X[2]);
  const T u = X[0] * iz, vv = X[1] * iz;
  const T r2 = fma(u, u, vv * vv);
  const T d = fma(r2, fma(S.k2, r2, S.k1), T(1));
  const T fd = S.f * d;
  const T e0 = fma(fd, u, -uv0) * isd;
  const T e1 = fma(fd, vv, -uv1) * isd;
  const T s2 =
      isd * isd * loss_weight<T, LOSS>(fma(e0, e0, e1 * e1) * inv_a2);
  const T fdd = T(2) * S.f * fma(T(2) * S.k2, r2, S.k1);
  const T fdu = fdd * u, fdv = fdd * vv;
  const T P00 = fma(fdu, u, fd);
  const T P01 = fdu * vv;
  const T P11 = fma(fdv, vv, fd);
  const T A[2][3] = {{P00 * iz, P01 * iz, -fma(P00, u, P01 * vv) * iz},
                     {P01 * iz, P11 * iz, -fma(P01, u, P11 * vv) * iz}};
  const T c = fma(S.f * r2, fma(S.dk2, r2, S.dk1), S.df * d);
  const T t0 = fma(A[0][0], dX[0], fma(A[0][1], dX[1], fma(A[0][2], dX[2],
                                                           u * c)));
  const T t1 = fma(A[1][0], dX[0], fma(A[1][1], dX[1], fma(A[1][2], dX[2],
                                                           vv * c)));
  T g[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) g[m] = fma(A[0][m], t0, A[1][m] * t1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ug[j] = s2 * fma(S.R[0][j], g[0], fma(S.R[1][j], g[1], S.R[2][j] * g[2]));
  }
}

constexpr int kPtStage = 12;  // staged per point: x (3), Hinv (6), bp (3)

// fused_back_substitute: one block per chunk of points (backsub_plan), one
// thread per instance slot.  Each block first starts asynchronous copies
// (cp.async) of everything the chunk reads into shared memory, one copy
// group per point: each slot's (uv, inv_sd) of the point, and the point's
// x, Hinv and bp.  All are in flight at once, and every thread builds its
// slot's BacksubSlot meanwhile.  Then each thread walks the chunk, waiting
// only for the point's group (and a barrier, for the point row other
// threads copied), so the chains of the first points run while the later
// points are still arriving.  Each point's three u values go to shared
// memory [chunk][3][nt].  After the last point a warp per point adds the
// slots' values in slot order (lane sums, then a shuffle tree) and lanes 0-2
// apply the point's Hinv to bp - u.  No atomics: the same bits on every run.
// Shared memory: chunk (6 nt + kPtStage) values.
template <typename T, int LOSS>
__global__ void __launch_bounds__(kMaxThreads)
    backsub_kernel(const T* __restrict__ inst, const T* __restrict__ cam,
                   const T* __restrict__ points, const T* __restrict__ obs_uv,
                   const T* __restrict__ obs_inv_sd,
                   const T* __restrict__ out_pt, const T* __restrict__ dx_i,
                   const T* __restrict__ dx_cam, int ni, int np, int chunk,
                   T inv_a2, T* __restrict__ dx_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using V2 = typename Vec2<T>::type;
  const int nt = blockDim.x;
  const int a = threadIdx.x;
  V2* uv_s = reinterpret_cast<V2*>(smem_raw);   // [chunk][nt]
  T* isd_s = reinterpret_cast<T*>(uv_s + chunk * nt);  // [chunk][nt]
  T* us = isd_s + chunk * nt;                   // [chunk][3][nt]
  T* pt_s = us + 3 * chunk * nt;                // [chunk][kPtStage]
  const long long p0 = (long long)blockIdx.x * chunk;
  const int n_here = (int)(np - p0 < chunk ? np - p0 : chunk);
  for (int c = 0; c < n_here; ++c) {
    const long long p = p0 + c;
    if (a < ni) {
      const long long o = p * ni + a;
      cp_async_n<sizeof(V2)>(uv_s + c * nt + a, obs_uv + 2 * o);
      cp_async_n<sizeof(T)>(isd_s + c * nt + a, obs_inv_sd + o);
    }
    if (a < kPtStage) {  // kPtStage <= 32 <= nt
      cp_async_n<sizeof(T)>(pt_s + kPtStage * c + a,
                            a < 3 ? points + 3 * p + a
                                  : out_pt + p * kPt + a - 3);
    }
    cp_async_commit_m();
  }
  // Every thread builds a slot (threads past NI that of slot NI - 1, unused).
  BacksubSlot<T> S;
  const int sa = a < ni ? a : ni - 1;
  S.init(inst + 6 * sa, cam, dx_i + 6 * sa, dx_cam);
  for (int c = 0; c < n_here; ++c) {
    cp_async_wait_upto(n_here - 1 - c);  // groups 0..c have landed
    __syncthreads();
    T ug[3] = {T(0), T(0), T(0)};
    if (a < ni) {
      const T* x = pt_s + kPtStage * c;
      const V2 uv = uv_s[c * nt + a];
      backsub_u<T, LOSS>(S, x[0], x[1], x[2], uv.x, uv.y, isd_s[c * nt + a],
                         inv_a2, ug);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) us[(3 * c + j) * nt + a] = ug[j];
  }
  __syncthreads();
  const int lane = a & 31, n_warps = nt >> 5;
  for (int c = a >> 5; c < n_here; c += n_warps) {
    T sum[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T* row = us + (3 * c + j) * nt;
      T acc = row[lane];
      for (int b = lane + 32; b < nt; b += 32) acc += row[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      }
      sum[j] = __shfl_sync(0xffffffffu, acc, 0);
    }
    if (lane < 3) {
      const T* pt = pt_s + kPtStage * c + 3;  // out_pt's columns 0-8
      const int j = lane;
      // Row j of the symmetric Hinv from its upper triangle (xx xy xz yy yz
      // zz at columns 0-5).
      const T h0 = pt[j == 0 ? 0 : j == 1 ? 1 : 2];
      const T h1 = pt[j == 0 ? 1 : j == 1 ? 3 : 4];
      const T h2 = pt[j == 0 ? 2 : j == 1 ? 4 : 5];
      const T d0 = pt[6] - sum[0], d1 = pt[7] - sum[1], d2 = pt[8] - sum[2];
      dx_p[3 * (p0 + c) + j] = h0 * d0 + h1 * d1 + h2 * d2;
    }
  }
}

template <typename T, int LOSS>
__global__ void __launch_bounds__(kCostBlock)
    cost_dense_kernel(const T* __restrict__ inst, const T* __restrict__ cam,
                      const T* __restrict__ points,
                      const T* __restrict__ obs_uv,
                      const T* __restrict__ obs_inv_sd, int ni,
                      long long n_slots, T a2, T* __restrict__ partials) {
  T acc = T(0);
  const long long stride = (long long)gridDim.x * kCostBlock;
  for (long long o = (long long)blockIdx.x * kCostBlock + threadIdx.x;
       o < n_slots; o += stride) {
    const long long p = o / ni;
    const int a = (int)(o - p * ni);
    T v[12], q0, q1;
    dense_vals(inst, cam, points, a, p, v);
    chain_fwd(v, q0, q1);
    const T isd = obs_inv_sd[o];
    const T e0 = (q0 - obs_uv[2 * o]) * isd;
    const T e1 = (q1 - obs_uv[2 * o + 1]) * isd;
    T rho, drho;
    loss_eval<T, LOSS>((e0 * e0 + e1 * e1) / a2, rho, drho);
    acc += T(0.5) * a2 * rho;
  }
  const T total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

inline int threads_for(int ni) { return (ni + 31) / 32 * 32; }

#define OSFM_CHECK()                           \
  do {                                         \
    const cudaError_t e = cudaGetLastError(); \
    if (e != cudaSuccess) return (int)e;       \
  } while (0)

template <typename T, int LOSS>
int launch_assemble(const T* inst, const T* cam, const T* points,
                    const T* obs_uv, const T* obs_inv_sd,
                    const unsigned char* opt_inst, const unsigned char* opt_cam,
                    const unsigned char* opt_points, const T* point_prior,
                    const T* pp_inv, T lam1, int ni, int np, int chunk,
                    int n_chunks, T a2, T* out_pt, T* bmat, T* aux_part,
                    cudaStream_t s) {
  const int nt = threads_for(ni);
  const size_t smem = sizeof(T) * kAcc * nt;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        assemble_kernel<T, LOSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  assemble_kernel<T, LOSS><<<n_chunks, nt, smem, s>>>(
      inst, cam, points, obs_uv, obs_inv_sd, opt_inst, opt_cam, opt_points,
      point_prior, pp_inv, lam1, ni, np, chunk, a2, out_pt, bmat, aux_part);
  OSFM_CHECK();
  return 0;
}

template <typename T>
int schur_assembly(const T* inst, const T* cam, const T* points,
                   const T* obs_uv, const T* obs_inv_sd,
                   const unsigned char* opt_inst, const unsigned char* opt_cam,
                   const unsigned char* opt_points, const T* point_prior,
                   const T* pp_inv, double lam1, int ni, int np, int loss,
                   double loss_threshold, int chunk, int n_chunks, int n_split,
                   long long k_split, T* out_pt, T* bmat, T* aux_part,
                   T* aux_mid, T* aux, T* syrk_part, T* s_ii, void* stream) {
  if (ni < 1 || ni > kMaxThreads) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T a2 = T(loss_threshold) * T(loss_threshold);
  int err;
#define OSFM_ASSEMBLE(L)                                                      \
  err = launch_assemble<T, L>(inst, cam, points, obs_uv, obs_inv_sd,         \
                              opt_inst, opt_cam, opt_points, point_prior,    \
                              pp_inv, T(lam1), ni, np, chunk, n_chunks, a2,  \
                              out_pt, bmat, aux_part, s)
  switch (loss) {
    case 0: OSFM_ASSEMBLE(0); break;
    case 1: OSFM_ASSEMBLE(1); break;
    case 2: OSFM_ASSEMBLE(2); break;
    case 3: OSFM_ASSEMBLE(3); break;
    case 4: OSFM_ASSEMBLE(4); break;
    default: return -1;
  }
#undef OSFM_ASSEMBLE
  if (err) return err;
  const long long n_aux = (long long)kAuxRows * ni;
  const unsigned aux_blocks = (unsigned)((n_aux + 255) / 256);
  const int n_groups = (n_chunks + kChunkGroup - 1) / kChunkGroup;
  if (n_groups == 1) {
    sum_chunks_kernel<T><<<aux_blocks, 256, 0, s>>>(aux_part, n_chunks,
                                                    n_chunks, n_aux, aux);
  } else {
    sum_chunks_kernel<T><<<dim3(aux_blocks, n_groups), 256, 0, s>>>(
        aux_part, n_chunks, kChunkGroup, n_aux, aux_mid);
    OSFM_CHECK();
    sum_chunks_kernel<T><<<aux_blocks, 256, 0, s>>>(aux_mid, n_groups,
                                                    n_groups, n_aux, aux);
  }
  OSFM_CHECK();
  const int n = 6 * ni;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, n_split);
  if constexpr (std::is_same<T, double>::value) {
    const cudaError_t e = cudaFuncSetAttribute(
        syrk_dmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kDmmaSmem);
    if (e != cudaSuccess) return (int)e;
    syrk_dmma_kernel<<<grid, kDmmaThreads, kDmmaSmem, s>>>(
        bmat, 3LL * np, n, k_split, syrk_part);
  } else {
    syrk_kernel<T><<<grid, 256, 0, s>>>(bmat, 3LL * np, n, k_split, syrk_part);
  }
  OSFM_CHECK();
  const int red_tiles = (n + kRedTile - 1) / kRedTile;
  syrk_reduce_kernel<T><<<red_tiles * (red_tiles + 1) / 2,
                          kRedTile * kRedTile, 0, s>>>(
      syrk_part, n, n_split, s_ii);
  OSFM_CHECK();
  return 0;
}

template <typename T>
int back_substitute(const T* inst, const T* cam, const T* points,
                    const T* obs_uv, const T* obs_inv_sd, const T* out_pt,
                    const T* dx_i, const T* dx_cam, int ni, int np, int chunk,
                    int n_chunks, int loss, double loss_threshold, T* dx_p,
                    void* stream) {
  if (ni < 1 || ni > kMaxThreads) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T inv_a2 = T(1.0 / (loss_threshold * loss_threshold));
  const int nt = threads_for(ni);
  const size_t smem = sizeof(T) * (size_t)chunk * (6 * nt + kPtStage);
  if (smem > 48 * 1024) return -3;  // backsub_plan keeps it within 48 KB
#define OSFM_BACKSUB(L)                                                    \
  backsub_kernel<T, L><<<n_chunks, nt, smem, s>>>(                          \
      inst, cam, points, obs_uv, obs_inv_sd, out_pt, dx_i, dx_cam, ni, np,  \
      chunk, inv_a2, dx_p)
  switch (loss) {
    case 0: OSFM_BACKSUB(0); break;
    case 1: OSFM_BACKSUB(1); break;
    case 2: OSFM_BACKSUB(2); break;
    case 3: OSFM_BACKSUB(3); break;
    case 4: OSFM_BACKSUB(4); break;
    default: return -1;
  }
#undef OSFM_BACKSUB
  OSFM_CHECK();
  return 0;
}

template <typename T>
int cost_dense(const T* inst, const T* cam, const T* points, const T* obs_uv,
               const T* obs_inv_sd, int ni, long long n_slots, int loss,
               double loss_threshold, int n_blocks, T* partials, T* out,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T a2 = T(loss_threshold) * T(loss_threshold);
#define OSFM_COST_DENSE(L)                                                  \
  cost_dense_kernel<T, L><<<n_blocks, kCostBlock, 0, s>>>(                 \
      inst, cam, points, obs_uv, obs_inv_sd, ni, n_slots, a2, partials)
  switch (loss) {
    case 0: OSFM_COST_DENSE(0); break;
    case 1: OSFM_COST_DENSE(1); break;
    case 2: OSFM_COST_DENSE(2); break;
    case 3: OSFM_COST_DENSE(3); break;
    case 4: OSFM_COST_DENSE(4); break;
    default: return -1;
  }
#undef OSFM_COST_DENSE
  OSFM_CHECK();
  cost_final_kernel<T><<<1, kCostBlock, 0, s>>>(partials, n_blocks, out);
  OSFM_CHECK();
  return 0;
}

#undef OSFM_CHECK

}  // namespace

extern "C" {

#define OSFM_DENSE_API(SUFFIX, T)                                              \
  int ba_schur_assembly_##SUFFIX(                                              \
      const T* inst, const T* cam, const T* points, const T* obs_uv,          \
      const T* obs_inv_sd, const unsigned char* opt_inst,                     \
      const unsigned char* opt_cam, const unsigned char* opt_points,          \
      const T* point_prior, const T* pp_inv,                                  \
      double lam1, int ni, int np, int loss, double loss_threshold,           \
      int chunk, int n_chunks, int n_split, long long k_split, T* out_pt,     \
      T* bmat, T* aux_part, T* aux_mid, T* aux, T* syrk_part, T* s_ii,        \
      void* stream) {                                                          \
    return schur_assembly<T>(inst, cam, points, obs_uv, obs_inv_sd, opt_inst, \
                             opt_cam, opt_points, point_prior, pp_inv, lam1,  \
                             ni, np, loss, loss_threshold, chunk, n_chunks,   \
                             n_split, k_split, out_pt, bmat, aux_part,        \
                             aux_mid, aux, syrk_part, s_ii, stream);          \
  }                                                                            \
  int ba_back_substitute_##SUFFIX(                                             \
      const T* inst, const T* cam, const T* points, const T* obs_uv,          \
      const T* obs_inv_sd, const T* out_pt, const T* dx_i, const T* dx_cam,   \
      int ni, int np, int chunk, int n_chunks, int loss,                      \
      double loss_threshold, T* dx_p, void* stream) {                          \
    return back_substitute<T>(inst, cam, points, obs_uv, obs_inv_sd, out_pt,  \
                              dx_i, dx_cam, ni, np, chunk, n_chunks, loss,    \
                              loss_threshold, dx_p, stream);                   \
  }                                                                            \
  int ba_cost_dense_##SUFFIX(const T* inst, const T* cam, const T* points,    \
                             const T* obs_uv, const T* obs_inv_sd, int ni,    \
                             long long n_slots, int loss,                     \
                             double loss_threshold, int n_blocks,             \
                             T* partials, T* out, void* stream) {             \
    return cost_dense<T>(inst, cam, points, obs_uv, obs_inv_sd, ni, n_slots,  \
                         loss, loss_threshold, n_blocks, partials, out,       \
                         stream);                                              \
  }

OSFM_DENSE_API(f32, float)
OSFM_DENSE_API(f64, double)

#undef OSFM_DENSE_API

}  // extern "C"
