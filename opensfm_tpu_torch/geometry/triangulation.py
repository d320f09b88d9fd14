"""Midpoint triangulation of bearings on torch tensors.

Port of `triangulate_bearings_midpoint` and its helpers from
`opensfm_tpu.geometry.triangulation` (triangulation.cc:138-178 of the
reference): mask-aware, with the reference's min-angle, angular reprojection
and min-depth validity checks.
"""

from __future__ import annotations

import math

import torch

from opensfm_tpu_torch.ops import linalg


def angle_between_vectors(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unsigned angle, 0 when |cos| >= 1 (triangulation.cc:67-74)."""
    c = torch.sum(u * v, dim=-1) / torch.sqrt(
        torch.sum(u * u, dim=-1) * torch.sum(v * v, dim=-1)
    )
    return torch.where(
        torch.abs(c) >= 1.0, torch.zeros_like(c),
        torch.arccos(torch.clamp(c, -1.0, 1.0)),
    )


def _pairwise_angle_ok(bearings, mask, min_angle: float):
    """True if ANY valid bearing pair subtends an angle in [min, pi-min]."""
    dots = bearings @ bearings.T  # unit bearings assumed
    ang = torch.where(
        torch.abs(dots) >= 1.0, torch.zeros_like(dots),
        torch.arccos(torch.clamp(dots, -1.0, 1.0)),
    )
    k = bearings.shape[0]
    eye = torch.eye(k, dtype=torch.bool, device=bearings.device)
    pair_mask = mask[:, None] & mask[None, :] & ~eye
    ok = (ang >= min_angle) & (ang <= math.pi - min_angle) & pair_mask
    return torch.any(ok)


def triangulate_bearings_midpoint(
    centers: torch.Tensor,  # [K, 3] camera origins (world)
    bearings: torch.Tensor,  # [K, 3] unit bearings (world)
    mask: torch.Tensor,  # [K] bool — valid rays
    thresholds: torch.Tensor,  # [K] per-ray angular reprojection threshold
    min_angle: float,
    min_depth: float = 1e-3,
):
    """Least-squares midpoint of K rays + validity: solves
    sum_i (I - b_i b_i^T) (X - o_i) = 0.  Returns (ok, X)."""
    maskf = mask.to(centers.dtype)[:, None]
    b = bearings * maskf
    eye = torch.eye(3, dtype=centers.dtype, device=centers.device)
    BBt = torch.einsum("ki,kj->kij", b, b)
    P = maskf[..., None] * eye - BBt  # [K,3,3]
    A = torch.sum(P, dim=0)
    rhs = torch.einsum("kij,kj->i", P, centers)
    X = linalg.solve3(A + 1e-12 * eye, rhs)

    angle_ok = _pairwise_angle_ok(bearings, mask, min_angle)
    rays = X[None, :] - centers
    ang_err = angle_between_vectors(rays, bearings)
    depth = torch.sum(rays * bearings, dim=-1)
    per_ray_ok = (ang_err <= thresholds) & (depth >= min_depth)
    ok = angle_ok & torch.all(per_ray_ok | ~mask)
    return ok, X
