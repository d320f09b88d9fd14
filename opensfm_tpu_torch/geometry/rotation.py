"""Batched rotation math (angle-axis <-> matrix <-> quaternion) on torch
tensors.

Port of `opensfm_tpu.geometry.rotation`: every function broadcasts over
leading batch dimensions and keeps the guarded small-angle Taylor branches,
so forward-mode derivatives (`torch.func.jacfwd`) stay finite at the
identity.
"""

from __future__ import annotations

import torch

_EPS2 = 1e-14


def hat(r: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix of r[..., 3] -> [..., 3, 3]."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues_coeffs(theta2: torch.Tensor, derivs: bool = False):
    """(cos t, sin t / t, (1 - cos t) / t^2) with the small-angle series;
    with `derivs` also (sp, gp): d(sinc)/dr_i = r_i sp, d(ccos)/dr_i = r_i gp."""
    small = theta2 < _EPS2
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    ccos = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2
    )
    if not derivs:
        return cos_t, sinc, ccos
    sp = torch.where(small, -1.0 / 3.0 + theta2 / 30.0, (cos_t - sinc) / safe2)
    gp = torch.where(small, -1.0 / 12.0 + theta2 / 180.0,
                     (sinc - 2.0 * ccos) / safe2)
    return cos_t, sinc, ccos, sp, gp


def rotvec_to_matrix(r: torch.Tensor) -> torch.Tensor:
    """Angle-axis [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues):
    R = I + sinc(t) K + ((1 - cos t) / t^2) K^2 with K = hat(r)."""
    theta2 = torch.sum(r * r, dim=-1)
    _, a, b = rodrigues_coeffs(theta2)
    K = hat(r)
    rrT = r[..., :, None] * r[..., None, :]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    K2 = rrT - theta2[..., None, None] * eye
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def matrix_to_rotvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> angle-axis [..., 3], through the unit
    quaternion (stable over the whole range, angles near pi included)."""
    return quat_to_rotvec(matrix_to_quat(R))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z) with w >= 0, by the
    branch-free Shepperd method: the four candidates are formed and the
    best-conditioned one (largest 4 q_i^2) is kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                     dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    mags = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(mags, dim=-1)
    q = torch.take_along_dim(
        cands, best[..., None, None].expand(best.shape + (1, 4)), dim=-2
    )[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> angle-axis [..., 3], with a guarded
    norm so derivatives stay finite at the identity."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    n2 = torch.sum(v * v, dim=-1)
    small = n2 < 1e-18
    safe_n2 = torch.where(small, torch.ones_like(n2), n2)
    sin_half = torch.sqrt(safe_n2)
    half = torch.atan2(torch.where(small, torch.zeros_like(sin_half),
                                   sin_half), w)
    scale = torch.where(small, 2.0 + (2.0 * half) ** 2 / 12.0,
                        2.0 * half / sin_half)
    return v * scale[..., None]


def rotate(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotate points x[..., 3] by angle-axis r[..., 3] without forming R:
    x' = x cos t + (r x x) sinc t + r (r . x) (1 - cos t) / t^2."""
    theta2 = torch.sum(r * r, dim=-1, keepdim=True)
    cos_t, sinc, ccos = rodrigues_coeffs(theta2)
    r, x = torch.broadcast_tensors(r, x)
    rx = torch.linalg.cross(r, x, dim=-1)
    rdx = torch.sum(r * x, dim=-1, keepdim=True)
    return x * cos_t + rx * sinc + r * (rdx * ccos)


def rotate_jacobian(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d rotate(r, x) / d r as [..., 3 (output), 3 (r)], in closed form:
    column i is r_i V + sinc (e_i x x) + ccos (rdx e_i + x_i r) with
    V = -sinc x + sp (r x x) + gp rdx r (the chain of csrc/ba_resjac.cu)."""
    theta2 = torch.sum(r * r, dim=-1, keepdim=True)
    _, sinc, ccos, sp, gp = rodrigues_coeffs(theta2, derivs=True)
    r, x = torch.broadcast_tensors(r, x)
    rdx = torch.sum(r * x, dim=-1, keepdim=True)
    V = -sinc * x + sp * torch.linalg.cross(r, x, dim=-1) + gp * rdx * r
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return (
        V[..., :, None] * r[..., None, :]
        - sinc[..., None] * hat(x)
        + ccos[..., None] * (rdx[..., None] * eye
                             + r[..., :, None] * x[..., None, :])
    )
