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
//     slot.  Each thread runs the chain of its slot for each point of the
//     chunk; the per-point 3x3 sums are a block reduction; the thread writes
//     its slot's column of B (bmat [3 NP, 6 NI]) and accumulates its slot's
//     81 direct and RHS sums in its own column of shared memory; the block's
//     sums go out as one partial per chunk (aux_part [chunks, 96, NI]), which
//     sum_chunks_kernel adds up in chunk order.
//  2. syrk_kernel: S_II = bmat^T bmat, only the 64 x 64 tiles on and below
//     the diagonal, split over K = 3 NP so that enough blocks fill the card;
//     syrk_reduce_kernel adds the splits in order and mirrors the upper
//     tiles.  The product takes FMAs (fma()) in the working type.
//
// What bounds them on the card.  At the 64 x 8,192 dense lane in f64 the
// assembly reads ~13 MB of observations and writes 75 MB of bmat that the
// product reads back; the product is 3.6 GFLOP (the lower half of a
// [384, 24,576] x [24,576, 384] product): operations bound it, ~0.05 ms at
// 67 TFLOP/s.  The per-point block reductions (two barriers per point) and
// the plain (no tensor core) tiled product keep this first version well above
// that bound; PERF.md has its times.  Keeping bmat out of device memory, as
// the TPU kernel does, needs the product fused into pass 1 and is later work.
//
// fused_back_substitute recomputes the chain instead of keeping the
// Jacobians: dx_p = Hinv (bp - sum_a Jp^T (J_pose dx_a + J_cam dx_cam)), one
// block per point, one thread per slot, a block reduction per point.
// fused_cost_dense is the cost over the dense grid with the indices implied
// by the slot number (no index arrays): a grid-stride loop, a fixed tree per
// block and a second single-block pass (as ba_resjac.cu's cost).  Both read
// ~24 B per slot in f64 and are memory- and latency-bound.
//
// Interface: plain C functions (ctypes), launched on the caller's stream; each
// returns the first non-zero cudaGetLastError() after its launches (or -1 for
// an unknown loss).

#include <cuda_runtime.h>

#include "ba_chain.cuh"

namespace {

constexpr int kMaxThreads = 256;  // one thread per instance slot, NI <= 256
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kAuxRows = 96;      // aux rows (the Pallas kernel's layout)
constexpr int kPt = 16;           // out_pt columns
constexpr int kAcc = 81;          // per-slot accumulators of assemble_kernel
constexpr int kTile = 64;         // syrk output tile
constexpr int kTileK = 16;        // syrk depth per shared-memory stage

// Index of (x, y), x <= y, in the row-major upper triangle of an n x n block.
__host__ __device__ constexpr int tri(int n, int x, int y) {
  return x * n - x * (x - 1) / 2 + (y - x);
}

// Block-wide sum of N values per thread; every thread gets the totals.
// Warp trees by shuffles, then the warp partials in warp order: the same
// inputs give the same bits on every run.  `sh` holds kMaxWarps * N values.
template <typename T, int N>
__device__ __forceinline__ void block_allreduce(T (&x)[N], T* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T v = x[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) sh[warp * N + i] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T v = sh[i];
    for (int w = 1; w < n_warps; ++w) v += sh[w * N + i];
    x[i] = v;
  }
  __syncthreads();
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
                    const T* __restrict__ opt_inst,
                    const T* __restrict__ opt_cam,
                    const T* __restrict__ opt_points,
                    const T* __restrict__ point_prior,
                    const T* __restrict__ pp_inv, T lam1, int ni, int np,
                    int chunk, T a2, T* __restrict__ out_pt,
                    T* __restrict__ bmat, T* __restrict__ aux_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [kAcc][blockDim.x]
  __shared__ T red_sh[kMaxWarps * 18];
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
  if (valid) opt_i = opt_inst[a];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[6 + k] = cam[k];
  const T opt_c[3] = {opt_cam[0], opt_cam[1], opt_cam[2]};

  const long long p_begin = (long long)blockIdx.x * chunk;
  const long long p_end =
      p_begin + chunk < (long long)np ? p_begin + chunk : (long long)np;
  for (long long p = p_begin; p < p_end; ++p) {
    const T optp = opt_points[p];
    T J0[12], J1[12];
    T r0 = T(0), r1 = T(0);
    if (valid) {
#pragma unroll
      for (int k = 0; k < 3; ++k) v[9 + k] = points[3 * p + k];
      T q0, q1;
      chain_fwd_jac(v, q0, q1, J0, J1);
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
    T s[18];
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
    block_allreduce<T, 18>(s, red_sh);

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
    T Vg[3][3], Ug[3][3], Cg[3][3];
#pragma unroll
    for (int y = 0; y < 3; ++y) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Vg[y][j] = s[9 + 3 * y + j];
    }
#pragma unroll
    for (int y = 0; y < 3; ++y) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        Ug[y][k] = Vg[y][0] * H[0][k] + Vg[y][1] * H[1][k] + Vg[y][2] * H[2][k];
      }
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
    }
    if (!valid) continue;

    // This slot's couplings Ga = Ji^T Jp and Schur factor B = Ga L.
    T Ga[6][3], B[6][3];
#pragma unroll
    for (int x = 0; x < 6; ++x) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Ga[x][j] = J0[x] * J0[9 + j] + J1[x] * J1[9 + j];
      B[x][0] = Ga[x][0] * l00 + Ga[x][1] * l10 + Ga[x][2] * l20;
      B[x][1] = Ga[x][1] * l11 + Ga[x][2] * l21;
      B[x][2] = Ga[x][2] * l22;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T* row = bmat + (3 * p + k) * ni6 + a;
#pragma unroll
      for (int x = 0; x < 6; ++x) row[x * ni] = B[x][k];
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
        ac[(45 + 3 * x + y) * nt] +=
            B[x][0] * Cg[y][0] + B[x][1] * Cg[y][1] + B[x][2] * Cg[y][2];
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
    for (int x = 0; x < 6; ++x) {
      const T direct = J0[x] * r0 + J1[x] * r1;
      const T gsch = Ga[x][0] * hib[0] + Ga[x][1] * hib[1] + Ga[x][2] * hib[2];
      ac[(63 + x) * nt] += direct - gsch;
    }
#pragma unroll
    for (int y = 0; y < 3; ++y) {
      ac[(69 + y) * nt] += J0[6 + y] * r0 + J1[6 + y] * r1;
    }
    if (a == 0) {  // the camera-family Schur terms, once per point
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        ac[(72 + y) * nt] +=
            Vg[y][0] * hib[0] + Vg[y][1] * hib[1] + Vg[y][2] * hib[2];
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

// out[i] = sum over c of part[c * n + i], in chunk order.
template <typename T>
__global__ void sum_chunks_kernel(const T* __restrict__ part, int n_chunks,
                                  long long n, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int c = 0; c < n_chunks; ++c) acc += part[(long long)c * n + i];
  out[i] = acc;
}

// part[split] = bmat[k-range]^T bmat[k-range] on the output tiles on and below
// the diagonal; bmat is [K, n] row-major.  256 threads, each 4 x 4 outputs.
template <typename T>
__global__ void __launch_bounds__(256)
    syrk_kernel(const T* __restrict__ bmat, long long K, int n,
                long long k_split, T* __restrict__ part) {
  int tr = 0;
  while ((tr + 1) * (tr + 2) / 2 <= (int)blockIdx.x) ++tr;
  const int tc = blockIdx.x - tr * (tr + 1) / 2;
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

// s_ii[i, j] = sum over splits of part at (i, j), read from the lower tile
// for an upper-tile (i, j): the result is exactly symmetric.
template <typename T>
__global__ void syrk_reduce_kernel(const T* __restrict__ part, int n,
                                   int n_split, T* __restrict__ s_ii) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nn = (long long)n * n;
  if (idx >= nn) return;
  int i = (int)(idx / n), j = (int)(idx % n);
  if (i / kTile < j / kTile) {
    const int t = i;
    i = j;
    j = t;
  }
  const long long src = (long long)i * n + j;
  T acc = T(0);
  for (int s = 0; s < n_split; ++s) acc += part[s * nn + src];
  s_ii[idx] = acc;
}

template <typename T, int LOSS>
__global__ void __launch_bounds__(kMaxThreads)
    backsub_kernel(const T* __restrict__ inst, const T* __restrict__ cam,
                   const T* __restrict__ points, const T* __restrict__ obs_uv,
                   const T* __restrict__ obs_inv_sd,
                   const T* __restrict__ out_pt, const T* __restrict__ dx_i,
                   const T* __restrict__ dx_cam, int ni, T a2,
                   T* __restrict__ dx_p) {
  __shared__ T red_sh[kMaxWarps * 3];
  const long long p = blockIdx.x;
  const int a = threadIdx.x;
  T u[3] = {T(0), T(0), T(0)};
  if (a < ni) {
    T v[12], J0[12], J1[12], q0, q1;
    dense_vals(inst, cam, points, a, p, v);
    chain_fwd_jac(v, q0, q1, J0, J1);
    const long long o = p * ni + a;
    const T isd = obs_inv_sd[o];
    const T e0 = (q0 - obs_uv[2 * o]) * isd;
    const T e1 = (q1 - obs_uv[2 * o + 1]) * isd;
    T rho, drho;
    loss_eval<T, LOSS>((e0 * e0 + e1 * e1) / a2, rho, drho);
    const T scale = isd * sqrt_weight(drho);
    // tmp = J_obs dx over the pose and camera directions.
    T d[9];
#pragma unroll
    for (int x = 0; x < 6; ++x) d[x] = dx_i[6 * a + x];
#pragma unroll
    for (int y = 0; y < 3; ++y) d[6 + y] = dx_cam[y];
    T tmp0 = T(0), tmp1 = T(0);
#pragma unroll
    for (int x = 0; x < 9; ++x) {
      tmp0 = tmp0 + J0[x] * scale * d[x];
      tmp1 = tmp1 + J1[x] * scale * d[x];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      u[j] = J0[9 + j] * scale * tmp0 + J1[9 + j] * scale * tmp1;
    }
  }
  block_allreduce<T, 3>(u, red_sh);
  if (threadIdx.x == 0) {
    const T* pt = out_pt + p * kPt;
    const T H[3][3] = {{pt[0], pt[1], pt[2]},
                       {pt[1], pt[3], pt[4]},
                       {pt[2], pt[4], pt[5]}};
    const T d0 = pt[6] - u[0], d1 = pt[7] - u[1], d2 = pt[8] - u[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dx_p[3 * p + j] = H[j][0] * d0 + H[j][1] * d1 + H[j][2] * d2;
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
                    const T* obs_uv, const T* obs_inv_sd, const T* opt_inst,
                    const T* opt_cam, const T* opt_points, const T* point_prior,
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
                   const T* obs_uv, const T* obs_inv_sd, const T* opt_inst,
                   const T* opt_cam, const T* opt_points, const T* point_prior,
                   const T* pp_inv, double lam1, int ni, int np, int loss,
                   double loss_threshold, int chunk, int n_chunks, int n_split,
                   long long k_split, T* out_pt, T* bmat, T* aux_part, T* aux,
                   T* syrk_part, T* s_ii, void* stream) {
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
  sum_chunks_kernel<T><<<(unsigned)((n_aux + 255) / 256), 256, 0, s>>>(
      aux_part, n_chunks, n_aux, aux);
  OSFM_CHECK();
  const int n = 6 * ni;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, n_split);
  syrk_kernel<T><<<grid, 256, 0, s>>>(bmat, 3LL * np, n, k_split, syrk_part);
  OSFM_CHECK();
  const long long nn = (long long)n * n;
  syrk_reduce_kernel<T><<<(unsigned)((nn + 255) / 256), 256, 0, s>>>(
      syrk_part, n, n_split, s_ii);
  OSFM_CHECK();
  return 0;
}

template <typename T>
int back_substitute(const T* inst, const T* cam, const T* points,
                    const T* obs_uv, const T* obs_inv_sd, const T* out_pt,
                    const T* dx_i, const T* dx_cam, int ni, int np, int loss,
                    double loss_threshold, T* dx_p, void* stream) {
  if (ni < 1 || ni > kMaxThreads) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T a2 = T(loss_threshold) * T(loss_threshold);
  const int nt = threads_for(ni);
#define OSFM_BACKSUB(L)                                                    \
  backsub_kernel<T, L><<<np, nt, 0, s>>>(inst, cam, points, obs_uv,       \
                                         obs_inv_sd, out_pt, dx_i, dx_cam, \
                                         ni, a2, dx_p)
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
      const T* obs_inv_sd, const T* opt_inst, const T* opt_cam,               \
      const T* opt_points, const T* point_prior, const T* pp_inv,             \
      double lam1, int ni, int np, int loss, double loss_threshold,           \
      int chunk, int n_chunks, int n_split, long long k_split, T* out_pt,     \
      T* bmat, T* aux_part, T* aux, T* syrk_part, T* s_ii, void* stream) {    \
    return schur_assembly<T>(inst, cam, points, obs_uv, obs_inv_sd, opt_inst, \
                             opt_cam, opt_points, point_prior, pp_inv, lam1,  \
                             ni, np, loss, loss_threshold, chunk, n_chunks,   \
                             n_split, k_split, out_pt, bmat, aux_part, aux,   \
                             syrk_part, s_ii, stream);                        \
  }                                                                            \
  int ba_back_substitute_##SUFFIX(                                             \
      const T* inst, const T* cam, const T* points, const T* obs_uv,          \
      const T* obs_inv_sd, const T* out_pt, const T* dx_i, const T* dx_cam,   \
      int ni, int np, int loss, double loss_threshold, T* dx_p,               \
      void* stream) {                                                          \
    return back_substitute<T>(inst, cam, points, obs_uv, obs_inv_sd, out_pt,  \
                              dx_i, dx_cam, ni, np, loss, loss_threshold,     \
                              dx_p, stream);                                   \
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
