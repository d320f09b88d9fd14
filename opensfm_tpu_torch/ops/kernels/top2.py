"""Exact top-2 nearest-descriptor search: CUDA kernel + plain twin.

Replaces the Pallas kernel `top2_sqdist_pallas` of
`opensfm_tpu/ops/pallas_kernels/top2.py` (bodies `_top2_kernel` and
`_top2_kernel_masked`): for each row of d1 the two nearest of the first
`n2` rows of d2 by squared L2, `sq1 + sq2 - 2 d1 . d2` in float32, with the
best column the lowest one attaining the minimum, the second distance the
minimum over every other allowed column (so a tie for the best gives
d2 == d1), and +inf, column 0 for rows with no allowed column.  An optional
[N, M] mask (bool or uint8, non-zero = allowed) restricts the candidates.

The CUDA source (`csrc/top2.cu`) splits the columns across blocks, keeps a
running top-2 in the product's epilogue, and merges the column slices with
a (distance, column) order, so its result does not depend on the split.
`kernel_route` picks its kernel: uint8 descriptors with D <= U8_MAX_D run
the product on the INT8 tensor cores (exact integers; one launch, or two
with the slice merge); float descriptors, mixed pairs and wider uint8 ones
run it on the FP32 pipes (four launches: two row-norm passes, the search
and the merge).  U8_MAX_D = 129 covers every OpenSfM feature type (SIFT
and HAHOG 128, 129 with the segment column; ORB 32; the reference's packed
AKAZE M-LDB 61, where the port's unpacked M-LDB bits are 486 wide and take
the FP32 route with M-SURF's 64 floats); up to it
every uint8 distance is an exact integer in float32.  Up to
U8_BITWISE_MAX_D = 258 (D * 255^2 < 2^24) the products stay exact and the
only rounding is that of the norms' float32 sum, which both kernels
perform as the twin does, so on uint8 the kernels, the plain twin and the
JAX package agree bitwise; wider uint8 descriptors round like float ones.

The wrapper runs the plain PyTorch version when its tensors lie on the CPU
and launches the kernel when they lie on a CUDA device; it never falls back
from one to the other.  `top2_sqdist.launches` counts the calls that
launched the kernel, and `top2_sqdist.launches_by_input` the same calls by
their descriptors: "uint8" (the INT8 route), "uint8_wide" (uint8 wider
than U8_MAX_D, the FP32 route) and "float" (the FP32 route);
`top2_sqdist.launches_masked` counts those of them that took a mask.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from opensfm_tpu_torch.ops.kernels import _build

SOURCE = "top2.cu"
TILE_N = 128  # query rows per block (kTileN)
TILE_M = 128  # database columns per tile (kTileM)
TARGET_BLOCKS = 528  # four blocks on each of the H100's 132 SMs
# The widest uint8 descriptors of the tensor-core kernel: 2 D * 255^2 < 2^24,
# so norms, dot products and their float32 sums stay exact integers.
U8_MAX_D = 129
# The widest uint8 descriptors on which either kernel is bitwise equal to
# the plain twin: D * 255^2 < 2^24, every product exact.
U8_BITWISE_MAX_D = 258


def top2_sqdist_plain(d1: torch.Tensor, d2: torch.Tensor, n2: int,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `top2_sqdist`: the dense distance matrix,
    then the Pallas kernel's per-row (min, lowest argmin, second min).
    Float32 throughout; on a CUDA device the matrix product must not run in
    TF32 (`torch.backends.cuda.matmul.allow_tf32`, off by default)."""
    a = d1.to(torch.float32)
    b = d2.to(torch.float32)
    n, m = a.shape[0], b.shape[0]
    dev = a.device
    if m == 0:
        return (torch.zeros((n, 1), dtype=torch.int32, device=dev),
                torch.full((n, 2), float("inf"), device=dev))
    sq1 = torch.sum(a * a, dim=1, keepdim=True)
    sq2 = torch.sum(b * b, dim=1)
    dist = sq1 + sq2[None, :] - 2.0 * (a @ b.T)
    col = torch.arange(m, device=dev)
    allowed = (col < n2)[None, :]
    if mask is not None:
        allowed = allowed & (mask != 0)
    dist = torch.where(allowed, dist, torch.full_like(dist, float("inf")))
    best = torch.min(dist, dim=1, keepdim=True).values
    i1 = torch.min(torch.where(dist == best, col[None, :], m), dim=1,
                   keepdim=True).values
    second = torch.min(
        torch.where(col[None, :] == i1, torch.full_like(dist, float("inf")),
                    dist), dim=1, keepdim=True).values
    return i1.to(torch.int32), torch.cat([best, second], dim=1)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    head = [_P, _P, _P, _I, _I, _I, _I, _I, _I]
    lib.top2_sqdist_f32.argtypes = head + [_P] * 8
    lib.top2_sqdist_u8.argtypes = head + [_P] * 6
    lib.top2_sqdist_f32.restype = lib.top2_sqdist_u8.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def split_columns(n: int, n2: int) -> Tuple[int, int]:
    """(splits, columns per split) of the kernel's grid: enough column
    slices that ceil(n / 128) row blocks times the slices reach about
    TARGET_BLOCKS, each slice a whole number of 128-column tiles."""
    tiles = max(1, -(-n2 // TILE_M))
    row_blocks = max(1, -(-n // TILE_N))
    splits = min(tiles, max(1, -(-TARGET_BLOCKS // row_blocks)))
    per = -(-tiles // splits)
    return -(-tiles // per), per * TILE_M


def kernel_route(d1: torch.Tensor, d2: torch.Tensor) -> str:
    """The kernel a pair of descriptor sets takes on the card: "u8" (INT8
    tensor cores) for uint8 sets of width 1..U8_MAX_D, else "f32" (both
    promoted to float32)."""
    if d1.dtype == torch.uint8 and d2.dtype == torch.uint8 \
            and 1 <= d1.shape[-1] <= U8_MAX_D:
        return "u8"
    return "f32"


def top2_sqdist(d1: torch.Tensor, d2: torch.Tensor, n2: int,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [N, 1] int32, dist [N, 2] float32): the nearest and second
    nearest squared distances from each row of d1 [N, D] to the first n2
    rows of d2 [M, D] (uint8 or float), and the nearest one's row.  `mask`
    [N, M] (bool or uint8) marks the allowed candidates."""
    if d1.device.type == "cpu":
        return top2_sqdist_plain(d1, d2, n2, mask)
    if d1.device.type != "cuda":
        raise ValueError(f"unsupported device {d1.device}")
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != d2.shape[1]:
        raise ValueError(f"bad descriptor shapes {tuple(d1.shape)}, "
                         f"{tuple(d2.shape)}")
    n, d = d1.shape
    m = d2.shape[0]
    if not 0 <= n2 <= m:
        raise ValueError(f"n2 = {n2} outside [0, {m}]")
    if d2.device != d1.device:
        raise ValueError("d1 and d2 must be on one CUDA device")
    for t in (d1, d2):
        if not (t.dtype.is_floating_point or t.dtype == torch.uint8):
            raise TypeError(f"descriptors must be uint8 or float, not "
                            f"{d1.dtype}, {d2.dtype}")
    route = kernel_route(d1, d2)
    uint8_in = d1.dtype == torch.uint8 and d2.dtype == torch.uint8
    if route == "f32":
        d1, d2 = d1.to(torch.float32), d2.to(torch.float32)
    d1, d2 = d1.contiguous(), d2.contiguous()
    mptr = None
    if mask is not None:
        if mask.shape != (n, m) or mask.device != d1.device:
            raise ValueError(f"mask must be [{n}, {m}] on {d1.device}")
        if mask.dtype == torch.bool:
            mask = mask.view(torch.uint8)
        if mask.dtype != torch.uint8:
            raise TypeError(f"mask must be bool or uint8, not {mask.dtype}")
        mask = mask.contiguous()
        mptr = mask.data_ptr()
    dev = d1.device
    idx = torch.empty((n, 1), dtype=torch.int32, device=dev)
    dist = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return idx, dist
    splits, per = split_columns(n, n2)
    part_d = torch.empty((2, splits, n), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, n), dtype=torch.int32, device=dev)
    scratch = [part_d[0].data_ptr(), part_i.data_ptr(), part_d[1].data_ptr()]
    if route == "f32":
        sq_a = torch.empty((n,), dtype=torch.float32, device=dev)
        sq_b = torch.empty((max(m, 1),), dtype=torch.float32, device=dev)
        scratch = [sq_a.data_ptr(), sq_b.data_ptr()] + scratch
    fn = getattr(_lib(), f"top2_sqdist_{route}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(d1.data_ptr(), d2.data_ptr(), mptr, n, m, d, int(n2), splits,
                 per, *scratch, dist.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"top2_sqdist kernel launch failed (cuda error "
                           f"{err})")
    top2_sqdist.launches += 1
    kind = ("uint8" if route == "u8" else "uint8_wide" if
            uint8_in else "float")
    top2_sqdist.launches_by_input[kind] += 1
    if mask is not None:
        top2_sqdist.launches_masked += 1
    return idx, dist


top2_sqdist.launches = 0
top2_sqdist.launches_by_input = {"uint8": 0, "uint8_wide": 0, "float": 0}
top2_sqdist.launches_masked = 0
