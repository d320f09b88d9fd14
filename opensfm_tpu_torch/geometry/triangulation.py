"""Triangulation: midpoint and DLT solvers, point refinement, epipolar
angles, batched over leading dimensions on torch tensors.

Port of `opensfm_tpu.geometry.triangulation` (reference
geometry/triangulation.h, src/triangulation.cc:1-235).  Every function is
mask-aware (padded tracks keep static shapes) and takes any leading batch,
so the growth loop triangulates all its [N, T] padded tracks in one
computation; the validity checks (min ray angle, angular reprojection
threshold, min depth) are the reference's.
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
    """True if ANY valid bearing pair subtends an angle in [min, pi-min].
    bearings [..., K, 3] (unit), mask [..., K] -> [...]."""
    dots = bearings @ bearings.transpose(-1, -2)
    ang = torch.where(
        torch.abs(dots) >= 1.0, torch.zeros_like(dots),
        torch.arccos(torch.clamp(dots, -1.0, 1.0)),
    )
    k = bearings.shape[-2]
    eye = torch.eye(k, dtype=torch.bool, device=bearings.device)
    pair_mask = mask[..., :, None] & mask[..., None, :] & ~eye
    ok = (ang >= min_angle) & (ang <= math.pi - min_angle) & pair_mask
    return torch.any(ok.flatten(-2), dim=-1)


def triangulate_bearings_midpoint(
    centers: torch.Tensor,  # [..., K, 3] camera origins (world)
    bearings: torch.Tensor,  # [..., K, 3] unit bearings (world)
    mask: torch.Tensor,  # [..., K] bool — valid rays
    thresholds: torch.Tensor,  # [..., K] per-ray angular reprojection threshold
    min_angle: float,
    min_depth: float = 1e-3,
):
    """Least-squares midpoint of K rays + validity (triangulation.cc:138-178):
    solves sum_i (I - b_i b_i^T) (X - o_i) = 0.  Returns (ok [...],
    X [..., 3])."""
    maskf = mask.to(centers.dtype)[..., None]
    b = bearings * maskf
    eye = torch.eye(3, dtype=centers.dtype, device=centers.device)
    BBt = b[..., :, None] * b[..., None, :]
    P = maskf[..., None] * eye - BBt  # [..., K, 3, 3]
    A = torch.sum(P, dim=-3)
    rhs = torch.einsum("...kij,...kj->...i", P, centers)
    X = linalg.solve3(A + 1e-12 * eye, rhs)

    angle_ok = _pairwise_angle_ok(bearings, mask, min_angle)
    rays = X[..., None, :] - centers
    ang_err = angle_between_vectors(rays, bearings)
    depth = torch.sum(rays * bearings, dim=-1)
    per_ray_ok = (ang_err <= thresholds) & (depth >= min_depth)
    ok = angle_ok & torch.all(per_ray_ok | ~mask, dim=-1)
    return ok, X


def triangulate_two_bearings_midpoint(b1: torch.Tensor, b2: torch.Tensor,
                                      rotation: torch.Tensor,
                                      translation: torch.Tensor):
    """Closed-form two-ray midpoint (TriangulateTwoBearingsMidpointMany,
    triangulation.cc:180-194).  Camera 1 at the origin with bearings b1
    [..., N, 3]; camera 2 with world-to-camera [R|t] ([..., 3, 3], [..., 3];
    center -R^T t, bearings R^T b2).  Returns (ok [..., N], X [..., N, 3]):
    ok is False for near-parallel rays or a midpoint behind a camera."""
    o2 = -torch.einsum("...ji,...j->...i", rotation, translation)[..., None, :]
    b2w = b2 @ rotation  # R^T b2 for each row
    a11 = torch.sum(b1 * b1, dim=-1)
    a12 = -torch.sum(b1 * b2w, dim=-1)
    a22 = torch.sum(b2w * b2w, dim=-1)
    r1 = torch.sum(b1 * o2, dim=-1)
    r2 = -torch.sum(b2w * o2, dim=-1)
    det = a11 * a22 - a12 * a12
    safe_det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    l1 = (a22 * r1 - a12 * r2) / safe_det
    l2 = (-a12 * r1 + a11 * r2) / safe_det
    X = 0.5 * (b1 * l1[..., None] + (o2 + b2w * l2[..., None]))
    ok = (torch.abs(det) >= 1e-12) & (l1 > 0) & (l2 > 0)
    return ok, X


def triangulate_bearings_dlt(
    Rts: torch.Tensor,  # [..., K, 3, 4] world-to-camera matrices
    bearings: torch.Tensor,  # [..., K, 3] unit bearings (camera frames)
    mask: torch.Tensor,  # [..., K]
    threshold: float,
    min_angle: float,
    min_depth: float = 1e-3,
):
    """Homogeneous DLT over K views + validity (triangulation.cc:76-136).
    Returns (ok [...], X [..., 3])."""
    P1, P2, P3 = Rts[..., 0, :], Rts[..., 1, :], Rts[..., 2, :]
    x, y, z = bearings[..., 0:1], bearings[..., 1:2], bearings[..., 2:3]
    rows = torch.cat([x * P3 - z * P1, y * P3 - z * P2], dim=-2)  # [..., 2K, 4]
    rows_mask = torch.cat([mask, mask], dim=-1).to(rows.dtype)[..., None]
    A = rows * rows_mask
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    Xh = Vt[..., -1, :]
    w = Xh[..., 3]
    X = Xh[..., :3] / torch.where(torch.abs(w) < 1e-15,
                                  torch.full_like(w, 1e-15), w)[..., None]

    world_bearings = torch.einsum("...kji,...kj->...ki", Rts[..., :3], bearings)
    angle_ok = _pairwise_angle_ok(
        world_bearings / torch.linalg.vector_norm(world_bearings, dim=-1,
                                                  keepdim=True),
        mask, min_angle,
    )
    Xh1 = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    proj = torch.einsum("...kij,...j->...ki", Rts, Xh1)
    ang_err = angle_between_vectors(proj, bearings)
    depth = torch.sum(proj * bearings, dim=-1)
    per_ray_ok = (ang_err <= threshold) & (depth >= min_depth)
    ok = angle_ok & torch.all(per_ray_ok | ~mask, dim=-1)
    return ok, X


def point_refinement(
    centers: torch.Tensor,  # [..., K, 3]
    bearings: torch.Tensor,  # [..., K, 3] unit
    point: torch.Tensor,  # [..., 3]
    mask: torch.Tensor,  # [..., K]
    iterations: int = 10,
):
    """Gauss-Newton refinement of 3D points minimizing the bearing
    residuals r_i = normalize(X - o_i) - b_i (PointRefinement,
    triangulation.cc:222-234); a fixed iteration count, with LM damping so
    degenerate rays keep the steps finite."""
    maskf = mask.to(point.dtype)
    eye = torch.eye(3, dtype=point.dtype, device=point.device)
    X = point
    for _ in range(iterations):
        v = X[..., None, :] - centers  # [..., K, 3]
        norm = torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True), 1e-12)
        n = v / norm
        r = (n - bearings) * maskf[..., None]
        # d normalize(v) / dv = (I - n n^T) / |v|
        J = (eye - n[..., :, None] * n[..., None, :]) / norm[..., None]
        J = J * maskf[..., None, None]
        JtJ = torch.einsum("...kij,...kil->...jl", J, J)
        Jtr = torch.einsum("...kij,...ki->...j", J, r)
        X = X - linalg.solve3(JtJ + 1e-9 * eye, Jtr)
    return X


def epipolar_angle_two_bearings_many(
    bearings1: torch.Tensor,  # [N1, 3]
    bearings2: torch.Tensor,  # [N2, 3]
    rotation: torch.Tensor,  # [3, 3]
    translation: torch.Tensor,  # [3]
) -> torch.Tensor:
    """Symmetric epipolar angle matrix [N1, N2]
    (EpipolarAngleTwoBearingsMany, triangulation.cc:196-220).  [R|t] is
    world-to-cam2 relative to cam1 (y ~ R x + t); the epipole direction in
    cam1's frame is the second camera's center -R^T t."""
    epipole = -(rotation.T @ translation)
    t = epipole / torch.linalg.vector_norm(epipole)
    b2w = bearings2 @ rotation  # R^T applied to each row -> cam1 frame
    epi1 = torch.linalg.cross(t.expand_as(bearings1), bearings1, dim=-1)
    epi1 = epi1 / torch.linalg.vector_norm(epi1, dim=-1, keepdim=True)
    epi2 = torch.linalg.cross(t.expand_as(b2w), b2w, dim=-1)
    epi2 = epi2 / torch.linalg.vector_norm(epi2, dim=-1, keepdim=True)
    sym = (torch.abs(epi1 @ b2w.T) + torch.abs(bearings1 @ epi2.T)) / 2.0
    return math.pi / 2.0 - torch.arccos(torch.clamp(sym, -1.0, 1.0))
