"""Ablation variants of a simplified dense Schur assembly: CUDA kernel +
plain twin.

Replaces the Pallas kernel of `profile_kernel_variants.py`
(`make_variant(mode).run_once`), a profiler that times parts of the dense
assembly by leaving them out.  On the dense [NP, NI] instance-slot grid
(one camera [k1, k2, f], points broadcast along each row) each slot runs the
projection chain and its 12 derivatives J0, J1 (directions w0..2, t0..2,
k1, k2, f, x0..2); the outputs are

- out_obs [32, NP, NI]: rows 0-1 the residual (pred - uv) * inv_sd, rows
  2-13 J0, rows 14-25 J1, rows 26-31 zero;
- s_ii [6 NI, 6 NI] = sum over points and k in {0, 1, 2} of A_k^T G_k,
  A_k[p, x NI + a] = J0[x] J0[9 + k], G_k[p, x NI + a] = J1[x] J1[9 + k]
  (a full product, not a symmetric one).

`MODES`: `full` everything; `nopush` J0[j] = p0 (0.1 + j) and
J1[j] = p1 (0.1 + j) instead of derivatives; `nomatmul` s_ii zero; `noout`
out_obs rows 2-31 not written (uninitialised on the card, zero in the plain
twin; `rows_written` says which rows a mode writes); `fwdonly` the forward
chain only (rows 0-1, the rest zero, s_ii zero).  Float32, as the TPU
script runs it.

The CUDA source (`csrc/assembly_variants.cu`) says what bounds each mode and
how the product is split (`product_plan`: 128 x 128 register-tiled FP32
tiles, split over K to fill the card about twice).  The wrapper runs the
plain PyTorch version when its tensors lie on the CPU and launches the
kernel when they lie on a CUDA device; it never falls back from one to the
other.  `assembly_variant.launches` counts the calls that launched the
kernels (one call launches the slot pass and, for the modes with the
product, the split product and its fixed-order sum; `assembly_product`, the
product step alone on given operands, counts there too).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from opensfm_tpu_torch.ops.kernels import _build
from opensfm_tpu_torch.ops.kernels.ba_resjac import (
    _raise_on,
    chain_fwd,
    chain_fwd_jac,
)

SOURCE = "assembly_variants.cu"
MODES = ("full", "nopush", "nomatmul", "noout", "fwdonly")
OUT_ROWS = 32  # out_obs rows
SMS = 132  # streaming multiprocessors of an H100 SXM
PRODUCT_TILE = 128  # kPTile: the product's output tile
PRODUCT_TILE_K = 16  # kPTileK: k rows per stage
PRODUCT_BLOCKS_PER_SM = 2  # kPMinBlocks: the plan fills the card this often


def rows_written(mode: str) -> int:
    """The leading out_obs rows that `mode` writes (`noout` leaves rows
    2-31 as they were)."""
    return 2 if mode == "noout" else OUT_ROWS


def has_product(mode: str) -> bool:
    return mode not in ("nomatmul", "fwdonly")


def _vals(points, inst_t, cam_row):
    """The chain's 12 inputs on the [NP, NI] grid: [1, NI] pose rows, the
    camera's k1, k2, f and [NP, 1] point columns."""
    return (tuple(inst_t[k][None] for k in range(6))
            + tuple(cam_row.reshape(-1)[k] for k in range(3))
            + tuple(points[:, k][:, None] for k in range(3)))


def _chain_rows(mode: str, u, points, inst_t, cam_row):
    """(p0, p1, J0, J1) of every slot as [NP, NI] tensors: the prediction
    and the 12 derivatives of each coordinate, or `nopush`'s (and
    `fwdonly`'s) stand-ins p (0.1 + j)."""
    vals = _vals(points, inst_t, cam_row)
    if mode in ("fwdonly", "nopush"):
        p0, p1 = chain_fwd(vals)
        return (p0, p1, [p0 * (0.1 + j) for j in range(12)],
                [p1 * (0.1 + j) for j in range(12)])
    zero = torch.zeros_like(u)
    (p0, p1), J0, J1 = chain_fwd_jac(vals)
    # The constant columns as [NP, NI].
    return p0, p1, [j + zero for j in J0], [j + zero for j in J1]


def _operand(J, k: int) -> torch.Tensor:
    """The product operand's rows (p, k) of one coordinate's Jacobian:
    [NP, 6 NI], column x NI + a = J[x] J[9 + k]."""
    return torch.cat([J[x] * J[9 + k] for x in range(6)], dim=1)


def assembly_variant_plain(mode: str, u, v, isd, points, inst_t, cam_row
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `assembly_variant`: (out_obs, s_ii)."""
    _check_mode(mode)
    n_p, ni = u.shape
    p0, p1, J0, J1 = _chain_rows(mode, u, points, inst_t, cam_row)
    zero = torch.zeros_like(u)
    rows = [(p0 - u) * isd, (p1 - v) * isd]
    if mode in ("fwdonly", "noout"):
        rows += [zero] * (OUT_ROWS - 2)
    else:
        rows += J0 + J1 + [zero] * (OUT_ROWS - 26)
    out_obs = torch.stack(rows)
    s_ii = torch.zeros((6 * ni, 6 * ni), dtype=u.dtype, device=u.device)
    if has_product(mode):
        for k in range(3):
            s_ii = s_ii + _operand(J0, k).T @ _operand(J1, k)
    return out_obs, s_ii


def operands_plain(mode: str, u, v, isd, points, inst_t, cam_row
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The product's operands (A, G) [3 NP, 6 NI] of a mode with the
    product, as the slot pass lays them out (row 3 p + k, column x NI + a):
    s_ii = A^T G."""
    _check_mode(mode)
    if not has_product(mode):
        raise ValueError(f"mode {mode!r} has no product")
    n_p, ni = u.shape
    _, _, J0, J1 = _chain_rows(mode, u, points, inst_t, cam_row)
    return tuple(torch.stack([_operand(J, k) for k in range(3)], dim=1)
                 .reshape(3 * n_p, 6 * ni) for J in (J0, J1))


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.assembly_variant_f32
    fn.argtypes = ([_I] + [_P] * 6 + [_I, _I, _I] + [_P] * 3
                   + [_I, _LL, _P, _P, _P])
    fn.restype = _I
    fn = lib.assembly_product_f32
    fn.argtypes = [_P, _P, _LL, _I, _I, _I, _LL, _P, _P, _P]
    fn.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def operand_ld(ni: int) -> int:
    """Row stride of the product's operands and partials: 6 NI rounded up to
    a multiple of 4 floats, so that every row starts on 16 bytes."""
    return -(-6 * ni // 4) * 4


def product_plan(ni: int, n_p: int) -> Tuple[int, int]:
    """(splits, depth of a split) of the K = 3 NP product: enough splits
    that the 128 x 128 output tiles times the splits fill the SMs about
    PRODUCT_BLOCKS_PER_SM times (one wave: at 64 x 8,192, 9 tiles x 29
    splits = 261 blocks), each split a whole number of PRODUCT_TILE_K-deep
    stages and at least ~512 rows deep.  A function of the shapes alone, so
    the summation order is the same on every call."""
    tiles = -(-6 * ni // PRODUCT_TILE)
    k = max(3 * n_p, 1)
    n_split = max(1, min(PRODUCT_BLOCKS_PER_SM * SMS // (tiles * tiles),
                         k // 512))
    k_split = -(-(-(-k // n_split)) // PRODUCT_TILE_K) * PRODUCT_TILE_K
    return -(-k // k_split), k_split


def product_tiles(n: int):
    """[(tile row, tile column)] of the product's blocks in blockIdx.x
    order: the 128 x 128 tiles of the n x n output, row-major (the last row
    and column of tiles ragged when n is not a multiple of 128)."""
    t = -(-n // PRODUCT_TILE)
    return [(b // t, b % t) for b in range(t * t)]


def _check_cuda(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def assembly_product(op_a, op_g):
    """op_a^T op_g [n, n] of float32 operands [K, n] on a CUDA device: the
    ablation kernel's product step alone (split product and fixed-order
    sum, `product_plan`), for timing it beside a library product on the
    same operands.  n must be 6 NI for some NI (the plan's shapes) and a
    multiple of 4 (rows on 16 bytes)."""
    if op_a.device.type != "cuda":
        raise ValueError(f"the product step runs on CUDA, not {op_a.device}")
    _check_cuda(op_a, op_g)
    K, n = op_a.shape
    if op_g.shape != op_a.shape or n % 12 or K == 0 \
            or op_a.data_ptr() % 16 or op_g.data_ptr() % 16:
        raise ValueError("the product step takes two [K, 6 NI] operands, "
                         "NI even, 16-byte aligned")
    n_split, k_split = product_plan(n // 6, -(-K // 3))
    new = dict(dtype=torch.float32, device=op_a.device)
    part = torch.empty((n_split, n, n), **new)
    s_ii = torch.empty((n, n), **new)
    with torch.cuda.device(op_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().assembly_product_f32(
            op_a.data_ptr(), op_g.data_ptr(), K, n, n, n_split, k_split,
            part.data_ptr(), s_ii.data_ptr(), stream)
    _raise_on(err, "assembly_product")
    assembly_variant.launches += 1
    return s_ii


def assembly_variant(mode: str, u, v, isd, points, inst_t, cam_row
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out_obs [32, NP, NI], s_ii [6 NI, 6 NI]) of one ablation `mode` (see
    the module docstring) from u, v, isd [NP, NI], points [NP, 3], inst_t
    [8, NI] (rows 0-5 the poses) and cam_row [1, >= 3] (k1, k2, f first),
    all float32."""
    _check_mode(mode)
    if (u.dim() != 2 or v.shape != u.shape or isd.shape != u.shape
            or points.shape != (u.shape[0], 3) or inst_t.dim() != 2
            or inst_t.shape[0] < 6 or inst_t.shape[1] != u.shape[1]
            or cam_row.numel() < 3):
        raise ValueError("bad shapes for assembly_variant")
    if u.device.type == "cpu":
        return assembly_variant_plain(mode, u, v, isd, points, inst_t,
                                      cam_row)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    _check_cuda(u, v, isd, points, inst_t, cam_row)
    n_p, ni = u.shape
    new = dict(dtype=torch.float32, device=u.device)
    out_obs = torch.empty((OUT_ROWS, n_p, ni), **new)
    s_ii = torch.empty((6 * ni, 6 * ni), **new)
    n_split, k_split = product_plan(ni, n_p)
    ld = operand_ld(ni)
    if has_product(mode):
        op_a = torch.empty((3 * n_p, ld), **new)
        op_g = torch.empty((3 * n_p, ld), **new)
        part = torch.empty((n_split, 6 * ni, ld), **new)
        scratch = (op_a.data_ptr(), op_g.data_ptr(), part.data_ptr())
    else:
        scratch = (None, None, None)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().assembly_variant_f32(
            MODES.index(mode), u.data_ptr(), v.data_ptr(), isd.data_ptr(),
            points.data_ptr(), inst_t.data_ptr(), cam_row.data_ptr(), n_p, ni,
            ld, out_obs.data_ptr(), scratch[0], scratch[1], n_split, k_split,
            scratch[2], s_ii.data_ptr(), stream)
    _raise_on(err, "assembly_variant")
    assembly_variant.launches += 1
    return out_obs, s_ii


assembly_variant.launches = 0
