"""Absolute pose solvers: P3P and N-point refinement, batched in torch.

Port of `opensfm_tpu.geometry.absolute_pose` (reference
geometry/absolute_pose.h: `AbsolutePoseThreePoints`:16, the
Ke-Roumeliotis algebraic P3P; `TranslationBetweenPoints`:125;
`AbsolutePoseNPoints`:145; `AbsolutePoseNPointsKnownRotation`:192).  The
P3P quartic is solved by the batched Durand-Kerner iteration
(`polynomial.real_roots`), as in the JAX package, and every step is
branch-free, so a whole [..., K] batch of samples is one computation.  The
Gauss-Newton polish uses the closed-form Jacobian of the rotation
(`rotation.rotate_jacobian`) where the JAX package differentiates forward.

Convention: bearings b (unit, camera frame), world points P, pose [R|t]
world-to-camera so that b ~ normalize(R P + t).
"""

from __future__ import annotations

import torch

from opensfm_tpu_torch.geometry import rotation as rot
from opensfm_tpu_torch.geometry.polynomial import real_roots
from opensfm_tpu_torch.ops import linalg


def _normalize(v):
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True), 1e-15)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _closest_rotation(M):
    U, _, Vt = torch.linalg.svd(M)
    d = linalg.det3(U @ Vt)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (U * D[..., None, :]) @ Vt


def p3p(bearings: torch.Tensor, points: torch.Tensor):
    """Algebraic P3P: up to 4 camera poses from 3 bearing <-> point pairs.

    bearings [..., 3, 3] unit camera-frame bearings, points [..., 3, 3]
    world points.  Returns (Rts [..., 4, 3, 4] world-to-camera,
    valid [..., 4]) (AbsolutePoseThreePoints, absolute_pose.h:16-122)."""
    b1, b2, b3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    p1, p2, p3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]

    k1 = _normalize(p1 - p2)
    k3 = _normalize(_cross(b1, b2))

    u1 = p1 - p3
    u2 = p2 - p3
    v1 = _cross(b1, b3)
    v2 = _cross(b2, b3)

    u1_k1 = _cross(u1, k1)
    sigma = torch.linalg.vector_norm(u1_k1, dim=-1)
    safe_sigma = torch.clamp_min(sigma, 1e-15)
    k3_second = u1_k1 / safe_sigma[..., None]

    k3_b3 = _dot(k3, b3)
    b1_b2 = torch.linalg.vector_norm(_cross(b1, b2), dim=-1)
    b1_dot_b2 = _dot(b1, b2)

    f11 = sigma * k3_b3
    f21 = sigma * b1_dot_b2 * k3_b3
    f22 = sigma * k3_b3 * b1_b2
    f13 = sigma * _dot(v1, k3)
    f23 = sigma * _dot(v2, k3)
    f24 = _dot(u2, k1) * k3_b3 * b1_b2
    f15 = -_dot(u1, k1) * k3_b3
    f25 = -_dot(u2, k1) * b1_dot_b2 * k3_b3

    g1 = f13 * f22
    g2 = f13 * f25 - f15 * f23
    g3 = f11 * f23 - f13 * f21
    g4 = -f13 * f24
    g5 = f11 * f22
    g6 = f11 * f25 - f15 * f21
    g7 = -f15 * f24

    alpha4 = g5 * g5 + g1 * g1 + g3 * g3
    alpha3 = 2.0 * (g5 * g6 + g1 * g2 + g3 * g4)
    alpha2 = g6 * g6 + 2.0 * g5 * g7 + g2 * g2 + g4 * g4 - g1 * g1 - g3 * g3
    alpha1 = 2.0 * (g6 * g7 - g1 * g2 - g3 * g4)
    alpha0 = g7 * g7 - g2 * g2 - g4 * g4

    coeffs = torch.stack([alpha4, alpha3, alpha2, alpha1, alpha0], dim=-1)
    cos_t1, is_real = real_roots(coeffs, iterations=80, imag_tol=1e-6)  # [..., 4]

    # Frames: c_bar has columns (k1, k3'', k1 x k3''); c_bbar has rows
    # (b1, k3, b1 x k3).
    c_bar = torch.stack([k1, k3_second, _cross(k1, k3_second)], dim=-1)
    c_bbar = torch.stack([b1, k3, _cross(b1, k3)], dim=-2)
    sign_k3b3 = torch.where(k3_b3 >= 0, 1.0, -1.0)

    def col(x):  # [...] -> [..., 1] to broadcast against the 4 roots
        return x[..., None]

    sin_t1 = col(sign_k3b3) * torch.sqrt(torch.clamp_min(
        1.0 - cos_t1 * cos_t1, 0.0))
    denom = col(g5) * cos_t1 * cos_t1 + col(g6) * cos_t1 + col(g7)
    denom = torch.where(torch.abs(denom) < 1e-18,
                        torch.full_like(denom, 1e-18), denom)
    t = sin_t1 / denom
    cos_t3 = t * (col(g1) * cos_t1 + col(g2))
    sin_t3 = t * (col(g3) * cos_t1 + col(g4))

    # The reference's RotationMatrixAroundAxis (absolute_pose.cc:3-18) is
    # the transpose of standard Rodrigues (clockwise rotation).
    one = torch.ones_like(cos_t1)
    zero = torch.zeros_like(cos_t1)
    c1 = torch.stack([
        torch.stack([one, zero, zero], dim=-1),
        torch.stack([zero, cos_t1, sin_t1], dim=-1),
        torch.stack([zero, -sin_t1, cos_t1], dim=-1),
    ], dim=-2)  # [..., 4, 3, 3]
    c2 = torch.stack([
        torch.stack([cos_t3, zero, -sin_t3], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([sin_t3, zero, cos_t3], dim=-1),
    ], dim=-2)

    rotation = _closest_rotation(
        c_bar[..., None, :, :] @ c1 @ c2 @ c_bbar[..., None, :, :])  # cam-to-world
    rb3 = torch.einsum("...ij,...j->...i", rotation, b3[..., None, :])
    translation = p3[..., None, :] - (
        (col(sigma) * sin_t1) / col(k3_b3))[..., None] * rb3
    R_wc = rotation.transpose(-1, -2)
    t_wc = -torch.einsum("...ij,...j->...i", R_wc, translation)
    Rts = torch.cat([R_wc, t_wc[..., None]], dim=-1)  # [..., 4, 3, 4]
    degenerate = (sigma < 1e-12) | (torch.abs(k3_b3) < 1e-12)
    valid = (is_real & ~col(degenerate)
             & torch.isfinite(Rts).flatten(-2).all(dim=-1))
    return Rts, valid


def translation_between_points(bearings: torch.Tensor, points: torch.Tensor,
                               R_cw: torch.Tensor, mask=None) -> torch.Tensor:
    """Optimal world-to-camera translation for a known world-to-camera
    rotation, minimizing Lu et al.'s object-space error
    (TranslationBetweenPoints, absolute_pose.h:125-142).  bearings, points
    [..., N, 3], R_cw [..., 3, 3]."""
    if mask is None:
        w = torch.ones(bearings.shape[:-1], dtype=bearings.dtype,
                       device=bearings.device)
    else:
        w = mask.to(bearings.dtype)
    n = torch.clamp_min(torch.sum(w, dim=-1), 1.0)
    F = torch.einsum("...ni,...nj->...nij", bearings, bearings) / torch.sum(
        bearings * bearings, dim=-1)[..., None, None]
    F = F * w[..., None, None]
    F1 = torch.sum(F, dim=-3) / n[..., None, None]
    eye = torch.eye(3, dtype=bearings.dtype, device=bearings.device)
    RP = points @ R_cw.transpose(-1, -2)
    F2 = torch.einsum("...nij,...nj->...i", F - w[..., None, None] * eye,
                      RP) / n[..., None]
    return linalg.solve3(eye - F1, F2)


def absolute_pose_known_rotation_n_points(
    bearings: torch.Tensor, points: torch.Tensor, R: torch.Tensor, mask=None
) -> torch.Tensor:
    """World-to-camera translation for a known rotation
    (AbsolutePoseNPointsKnownRotation, absolute_pose.h:192): minimize
    || [b]x (R P + t) ||^2, linear in t.  bearings, points [..., N, 3]."""
    RP = points @ R.transpose(-1, -2)
    Bx = rot.hat(bearings)  # [..., N, 3, 3]
    if mask is not None:
        Bx = Bx * mask[..., None, None].to(Bx.dtype)
    A = Bx.reshape(Bx.shape[:-3] + (-1, 3))
    rhs = -torch.einsum("...nij,...nj->...ni", Bx, RP).reshape(
        Bx.shape[:-3] + (-1,))
    AtA = A.transpose(-1, -2) @ A
    Atb = torch.einsum("...ki,...k->...i", A, rhs)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return linalg.solve3(AtA + 1e-12 * eye, Atb)


def absolute_pose_gn_refine(Rt: torch.Tensor, bearings: torch.Tensor,
                            points: torch.Tensor, mask=None,
                            iterations: int = 10) -> torch.Tensor:
    """Gauss-Newton on the bearing residual normalize(R P + t) - b, the
    non-minimal absolute-pose polish (AbsolutePoseNPoints semantics,
    absolute_pose.h:145).  Rt [..., 3, 4], bearings, points [..., N, 3];
    returns [..., 3, 4]."""
    params = torch.cat([rot.matrix_to_rotvec(Rt[..., :3, :3]),
                        Rt[..., :3, 3]], dim=-1)  # [..., 6]
    w = None if mask is None else mask.to(Rt.dtype)
    eye3 = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    eye6 = torch.eye(6, dtype=Rt.dtype, device=Rt.device)
    for _ in range(iterations):
        r = params[..., None, :3]
        v = rot.rotate(r, points) + params[..., None, 3:]
        norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        nrm = torch.clamp_min(norm, 1e-15)
        n = v / nrm
        res = n - bearings  # [..., N, 3]
        dn = (eye3 - n[..., :, None] * n[..., None, :]) / nrm[..., None]
        dn = torch.where((norm > 1e-15)[..., None], dn, eye3 / nrm[..., None])
        J = torch.cat([dn @ rot.rotate_jacobian(r, points), dn], dim=-1)
        if w is not None:
            res = res * w[..., None]
            J = J * w[..., None, None]
        J = J.reshape(J.shape[:-3] + (-1, 6))
        res = res.reshape(res.shape[:-2] + (-1,))
        JtJ = J.transpose(-1, -2) @ J
        Jtr = torch.einsum("...ki,...k->...i", J, res)
        step = linalg.solve_spd(JtJ + 1e-9 * eye6, Jtr)
        params = params - step
    R = rot.rotvec_to_matrix(params[..., :3])
    return torch.cat([R, params[..., 3:6, None]], dim=-1)


def absolute_pose_error(Rt: torch.Tensor, bearings: torch.Tensor,
                        points: torch.Tensor) -> torch.Tensor:
    """1 - b . normalize(R P + t), the AbsolutePose RANSAC error
    (absolute_pose_model.h:34-44).  Rt [..., M, 3, 4], bearings and points
    [..., 1, N, 3] (or [..., N, 3] against a single Rt [..., 3, 4]) ->
    [..., M, N].  The dot and the squared norm are expanded into two
    products over the rows, b . (R P + t) = [vec(R), t] . [vec(b P^T), b]
    and |R P + t|^2 = [vec(R^T R), 2 R^T t, |t|^2] . [vec(P P^T), P, 1],
    so no [M, N, 3] array is formed."""
    R, t = Rt[..., :3, :3], Rt[..., :3, 3]
    single = not (bearings.dim() >= 3 and bearings.shape[-3] == 1
                  and Rt.dim() == bearings.dim())
    if single:  # [..., 3, 4] against [..., N, 3]
        b, P = bearings, points
        R, t = R[..., None, :, :], t[..., None, :]
    else:  # [..., M, 3, 4] against [..., 1, N, 3]: drop the rows' M axis
        b, P = bearings[..., 0, :, :], points[..., 0, :, :]
    lhs = torch.cat([R.flatten(-2), t], dim=-1)  # [..., M, 12]
    rhs = torch.cat([(b[..., :, None] * P[..., None, :]).flatten(-2), b],
                    dim=-1)  # [..., N, 12]
    G = (R.transpose(-1, -2) @ R).flatten(-2)
    Rtt = torch.einsum("...ji,...j->...i", R, t)
    lhs2 = torch.cat([G, 2.0 * Rtt, torch.sum(t * t, dim=-1, keepdim=True)],
                     dim=-1)  # [..., M, 13]
    rhs2 = torch.cat([(P[..., :, None] * P[..., None, :]).flatten(-2), P,
                      torch.ones_like(P[..., :1])], dim=-1)  # [..., N, 13]
    dot = lhs @ rhs.transpose(-1, -2)  # [..., M, N]
    # 1 / max(|R P + t|, 1e-15), in place on the product.
    inv_norm = (lhs2 @ rhs2.transpose(-1, -2)).clamp_min_(1e-30).rsqrt_()
    err = dot.mul_(inv_norm).neg_().add_(1.0)
    return err[..., 0, :] if single else err
