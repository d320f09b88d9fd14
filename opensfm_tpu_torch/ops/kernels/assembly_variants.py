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
how the product is split.  The wrapper runs the plain PyTorch version when
its tensors lie on the CPU and launches the kernel when they lie on a CUDA
device; it never falls back from one to the other.
`assembly_variant.launches` counts the calls that launched the kernels (one
call launches the slot pass and, for the modes with the product, the split
product and its fixed-order sum).
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
PRODUCT_TILE = 64  # kTile
PRODUCT_TILE_K = 16  # kTileK


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


def assembly_variant_plain(mode: str, u, v, isd, points, inst_t, cam_row
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `assembly_variant`: (out_obs, s_ii)."""
    _check_mode(mode)
    n_p, ni = u.shape
    vals = _vals(points, inst_t, cam_row)
    zero = torch.zeros_like(u)
    if mode in ("fwdonly", "nopush"):
        p0, p1 = chain_fwd(vals)
        J0 = [p0 * (0.1 + j) for j in range(12)]
        J1 = [p1 * (0.1 + j) for j in range(12)]
    else:
        (p0, p1), J0, J1 = chain_fwd_jac(vals)
        J0 = [j + zero for j in J0]  # the constant columns as [NP, NI]
        J1 = [j + zero for j in J1]
    rows = [(p0 - u) * isd, (p1 - v) * isd]
    if mode in ("fwdonly", "noout"):
        rows += [zero] * (OUT_ROWS - 2)
    else:
        rows += J0 + J1 + [zero] * (OUT_ROWS - 26)
    out_obs = torch.stack(rows)
    s_ii = torch.zeros((6 * ni, 6 * ni), dtype=u.dtype, device=u.device)
    if has_product(mode):
        for k in range(3):
            a = torch.cat([J0[x] * J0[9 + k] for x in range(6)], dim=1)
            g = torch.cat([J1[x] * J1[9 + k] for x in range(6)], dim=1)
            s_ii = s_ii + a.T @ g
    return out_obs, s_ii


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.assembly_variant_f32
    fn.argtypes = [_I] + [_P] * 6 + [_I, _I] + [_P] * 3 + [_I, _LL, _P, _P,
                                                           _P]
    fn.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def product_plan(ni: int, n_p: int) -> Tuple[int, int]:
    """(splits, depth of a split) of the K = 3 NP product: enough splits
    that the 64 x 64 output tiles times the splits give ~2 blocks on each
    SM, each split a whole number of 16-deep stages.  A function of the
    shapes alone, so the summation order is the same on every call."""
    tiles = -(-6 * ni // PRODUCT_TILE)
    k = max(3 * n_p, 1)
    n_split = max(1, min(2 * SMS // (tiles * tiles), k // 512))
    k_split = -(-(-(-k // n_split)) // PRODUCT_TILE_K) * PRODUCT_TILE_K
    return -(-k // k_split), k_split


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
    for t in (u, v, isd, points, inst_t, cam_row):
        if t.device != u.device:
            raise ValueError("all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    n_p, ni = u.shape
    new = dict(dtype=torch.float32, device=u.device)
    out_obs = torch.empty((OUT_ROWS, n_p, ni), **new)
    s_ii = torch.empty((6 * ni, 6 * ni), **new)
    n_split, k_split = product_plan(ni, n_p)
    if has_product(mode):
        op_a = torch.empty((3 * n_p, 6 * ni), **new)
        op_g = torch.empty((3 * n_p, 6 * ni), **new)
        part = torch.empty((n_split, 6 * ni, 6 * ni), **new)
        scratch = (op_a.data_ptr(), op_g.data_ptr(), part.data_ptr())
    else:
        scratch = (None, None, None)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().assembly_variant_f32(
            MODES.index(mode), u.data_ptr(), v.data_ptr(), isd.data_ptr(),
            points.data_ptr(), inst_t.data_ptr(), cam_row.data_ptr(), n_p, ni,
            out_obs.data_ptr(), scratch[0], scratch[1], n_split, k_split,
            scratch[2], s_ii.data_ptr(), stream)
    _raise_on(err, "assembly_variant")
    assembly_variant.launches += 1
    return out_obs, s_ii


assembly_variant.launches = 0
