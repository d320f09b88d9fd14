"""Batched rotation math (angle-axis <-> matrix) on torch tensors.

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
