"""Exact top-2 descriptor matching on torch tensors.

Port of `opensfm_tpu.ops.matching`: squared L2 distances and the two nearest
candidates per row (`ops/kernels/top2.top2_sqdist`: the CUDA kernel on the
card, its plain twin on the CPU), the Lowe ratio test and the mutual check
on the device, and the WORDS candidate mask.  The reference pads the
descriptor sets to power-of-two buckets to share jit compiles and picks its
Pallas kernel above a size threshold on the TPU; the port searches the
unpadded sets, and the kernel takes any size, so every call on the card
goes through the kernel.  The matches are the same either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.ops.kernels.top2 import top2_sqdist


def _as_descriptors(d: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 descriptors stay uint8 (the kernel takes them as they are);
    anything else goes to float32, as the reference casts it.  A uint8 set
    matched against a float one is promoted by `top2_sqdist`."""
    d = np.asarray(d)
    dtype = np.uint8 if d.dtype == np.uint8 else np.float32
    return torch.as_tensor(np.ascontiguousarray(d, dtype=dtype), device=device)


def _one_way(d1: torch.Tensor, d2: torch.Tensor, ratio: float,
             mask: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best index [n1] int64, ratio-test pass [n1] bool) per row of d1."""
    n1, n2 = d1.shape[0], d2.shape[0]
    if mask is not None and tuple(mask.shape) != (n1, n2):
        raise ValueError(
            f"candidate mask shape {tuple(mask.shape)} != ({n1}, {n2})"
        )
    idx, dist = top2_sqdist(d1, d2, n2, mask)
    # Lowe ratio on distances (squared -> ratio on sqrt), in float32 like the
    # reference's numpy test.  Rows with fewer than two allowed candidates
    # are dropped (the reference's `len(match) == 2` check).
    good = torch.sqrt(torch.clamp_min(dist[:, 0], 0.0)) < ratio * torch.sqrt(
        torch.clamp_min(dist[:, 1], 1e-20)
    )
    good &= torch.isfinite(dist[:, 1])
    return idx[:, 0].long(), good


def match_brute_force_symmetric(
    d1: np.ndarray, d2: np.ndarray, ratio: float, symmetric: bool = True,
    mask12: Optional[torch.Tensor] = None,
    mask21: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Lowe-ratio matches (optionally mutual) between descriptor sets.

    Mirrors `opensfm_tpu.ops.matching.match_brute_force_symmetric`
    (matching.py:683-778 of OpenSfM) with exact top-2 search on `device`
    (`resolve_device`: cuda by default).  mask12 [N1, N2] / mask21 [N2, N1] (bool tensors on
    `device`) restrict the candidates per direction.  Returns [K, 2] int64
    index pairs."""
    if len(d1) < 2 or len(d2) < 2:
        return np.zeros((0, 2), dtype=np.int64)
    dev = resolve_device(device)
    f1 = _as_descriptors(d1, dev)
    f2 = _as_descriptors(d2, dev)

    best12, good12 = _one_way(f1, f2, ratio, mask12)
    rows = torch.nonzero(good12)[:, 0]
    js = best12[rows]
    if symmetric:
        if mask21 is None and mask12 is not None:
            mask21 = mask12.T
        best21, good21 = _one_way(f2, f1, ratio, mask21)
        mutual = good21[js] & (best21[js] == rows)
        rows, js = rows[mutual], js[mutual]
    return torch.stack([rows, js], dim=1).cpu().numpy().astype(np.int64)


def match_brute_force(
    d1: np.ndarray, d2: np.ndarray, ratio: float,
    mask12: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """One-way Lowe-ratio matching (matching.py:723-756 of OpenSfM)."""
    return match_brute_force_symmetric(
        d1, d2, ratio, symmetric=False, mask12=mask12, device=device
    )


def word_compatibility_mask(
    words1: np.ndarray, words2: np.ndarray, num_checks: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Candidate mask [N1, N2] for WORDS matching: (i, j) is allowed when
    feature j's best word is among feature i's first `num_checks` words
    (pyfeatures match_using_words semantics).  Built on `device` as a
    membership table [N1, vocabulary] read at every j's best word, on
    `device` (`resolve_device`: cuda by default)."""
    dev = resolve_device(device)
    w1 = torch.as_tensor(
        np.asarray(words1[:, : max(1, num_checks)], dtype=np.int64), device=dev
    )
    best2 = torch.as_tensor(np.asarray(words2[:, 0], dtype=np.int64),
                            device=dev)
    vocab = int(max(int(w1.max()) if w1.numel() else 0,
                    int(best2.max()) if best2.numel() else 0)) + 1
    member = torch.zeros((w1.shape[0], vocab), dtype=torch.bool, device=dev)
    member.scatter_(1, w1, True)
    return member[:, best2]
