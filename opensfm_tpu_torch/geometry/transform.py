"""Point-set registration: rotation (Kabsch) and similarity (Umeyama).

Port of `opensfm_tpu.geometry.transform` (reference geometry/transform.h,
`RotationBetweenPoints`, `SimilarityBetweenPoints`), used by the
relative-rotation and similarity RANSAC models and by the alignment.
Batched over leading dimensions.
"""

from __future__ import annotations

import torch

from opensfm_tpu_torch.ops import linalg


def _proper_rotation_from_svd(U, Vt):
    """Closest rotation U @ diag(1, 1, det) @ Vt with det = +1."""
    d = linalg.det3(U @ Vt)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (U * D[..., None, :]) @ Vt


def rotation_between_points(x: torch.Tensor, y: torch.Tensor, mask=None):
    """Rotation R minimizing sum ||R x_i - y_i||^2 (Kabsch).
    x, y: [..., N, 3]; mask [..., N].  Returns [..., 3, 3]."""
    if mask is not None:
        w = mask.to(x.dtype)[..., None]
        x = x * w
        y = y * w
    H = x.transpose(-1, -2) @ y  # sum x_i y_i^T
    U, _, Vt = torch.linalg.svd(H)
    # R = V diag(1, 1, det(V U^T)) U^T maps x -> y.
    return _proper_rotation_from_svd(Vt.transpose(-1, -2), U.transpose(-1, -2))


def similarity_between_points(x: torch.Tensor, y: torch.Tensor, mask=None):
    """Umeyama similarity (s, R, t) minimizing sum ||s R x_i + t - y_i||^2,
    as the 4x4 transform [..., 4, 4] mapping x into y (the similarity RANSAC
    model's `Eigen::Matrix4d`).  x, y: [..., N, 3]; mask [..., N]."""
    if mask is not None:
        w = mask.to(x.dtype)
    else:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    n = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1.0)[..., None]
    wx = w[..., None]

    mx = torch.sum(x * wx, dim=-2, keepdim=True) / n
    my = torch.sum(y * wx, dim=-2, keepdim=True) / n
    xc = (x - mx) * wx
    yc = (y - my) * wx
    var_x = torch.sum(xc * xc, dim=(-1, -2)) / n[..., 0, 0]
    H = (xc.transpose(-1, -2) @ yc) / n
    U, S, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = linalg.det3(V @ Ut)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (V * D[..., None, :]) @ Ut
    scale = torch.sum(S * D, dim=-1) / torch.clamp_min(var_x, 1e-18)
    t = my[..., 0, :] - scale[..., None] * torch.einsum(
        "...ij,...j->...i", R, mx[..., 0, :])

    T = torch.zeros(x.shape[:-2] + (4, 4), dtype=x.dtype, device=x.device)
    T[..., :3, :3] = scale[..., None, None] * R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T
