"""Essential matrix estimation and relative pose, batched in torch.

Port of `opensfm_tpu.geometry.essential`: the least-squares N-point
essential matrix, Nistér's 5-point minimal solver (nullspace basis, the ten
cubic constraints over 20 monomials, Gauss-Jordan to a 10x10 action matrix,
its characteristic polynomial by Faddeev-LeVerrier, Durand-Kerner roots and
inverse-iteration eigenvectors), the epipolar geodesic error, and the
relative pose: decomposition of E, cheirality vote, the RelativePose
RANSAC error and the Gauss-Newton refinement (with a closed-form Jacobian
where the JAX package differentiates forward).  Every function takes a
leading batch of problems.  Convention: bearings x in camera 1, y in camera
2, y^T E x = 0, and [R|t] maps camera 1 to camera 2 (y ~ R x + t).

The nullspace basis comes from the SVD of the 5x9 epipolar system, which
differs between LAPACK builds and devices, so the ten candidates agree with
the reference's as a set (up to sign and order), not slot by slot.  A
singular Gauss-Jordan solve gives inf/NaN that the validity mask drops, as
in the reference; nothing raises.
"""

from __future__ import annotations

import numpy as np
import torch

from opensfm_tpu_torch.geometry import rotation as rot
from opensfm_tpu_torch.geometry.polynomial import real_roots
from opensfm_tpu_torch.geometry.triangulation import (
    triangulate_two_bearings_midpoint,
)
from opensfm_tpu_torch.ops import linalg


def _nullspace_rows(A: torch.Tensor, count: int) -> torch.Tensor:
    """The last `count` right singular vectors of A [..., N, 9] as rows."""
    full = A.shape[-2] < A.shape[-1]
    _, _, Vt = torch.linalg.svd(A, full_matrices=full)
    return Vt[..., Vt.shape[-2] - count:, :]


def essential_n_points(x: torch.Tensor, y: torch.Tensor,
                       mask=None) -> torch.Tensor:
    """Least-squares essential matrix from N>=8 bearing pairs.

    x, y: [..., N, 3] unit bearings.  Returns [..., 3, 3] projected onto the
    essential manifold (equal singular values), mirroring EssentialNPoints
    (essential.h:167)."""
    A = torch.einsum("...nj,...nk->...njk", y, x).reshape(x.shape[:-1] + (9,))
    if mask is not None:
        A = A * mask[..., None].to(A.dtype)
    E = _nullspace_rows(A, 1)[..., 0, :].reshape(x.shape[:-2] + (3, 3))
    # Project to the essential manifold: singular values (s, s, 0).
    U, S, Vt2 = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    D = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * D[..., None, :]) @ Vt2


# Monomial bases (exponent tuples over (x, y, z)); degree-3 ordering matches
# the reference's coefficient enum (essential.h:41-62).
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x y z 1
_DEG2 = [
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]  # xx xy yy xz yz zz x y z 1
_DEG3 = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1),
    (1, 1, 1), (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1),
    (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]  # xxx xxy xyy yyy xxz xyz yyz xzz yzz zzz xx xy yy xz yz zz x y z 1


def _product_table(basis_a, basis_b, basis_out) -> np.ndarray:
    """T[i, j, k] = 1 where monomial_a[i] * monomial_b[j] == monomial_out[k]."""
    index = {e: i for i, e in enumerate(basis_out)}
    T = np.zeros((len(basis_a), len(basis_b), len(basis_out)))
    for i, a in enumerate(basis_a):
        for j, b in enumerate(basis_b):
            T[i, j, index[tuple(p + q for p, q in zip(a, b))]] = 1.0
    return T


_O1_TABLE = _product_table(_DEG1, _DEG1, _DEG2)  # deg1 * deg1 -> deg2
_O2_TABLE = _product_table(_DEG2, _DEG1, _DEG3)  # deg2 * deg1 -> deg3


def _table(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, dtype=like.dtype, device=like.device)


def _o1(a, b):
    """Product of two degree-1 polynomials ([..., 4] -> [..., 10])."""
    return torch.einsum("...i,...j,ijk->...k", a, b, _table(_O1_TABLE, a))


def _o2(a, b):
    """deg-2 [..., 10] times deg-1 [..., 4] -> deg-3 [..., 20]."""
    return torch.einsum("...i,...j,ijk->...k", a, b, _table(_O2_TABLE, a))


def _charpoly(A: torch.Tensor) -> torch.Tensor:
    """Characteristic polynomial coefficients (monic, highest first) of
    square matrices [..., n, n] by the Faddeev-LeVerrier recursion."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    coeffs = [torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)]
    M = eye.expand(A.shape)
    for k in range(1, n + 1):
        AM = A @ M
        c = -torch.diagonal(AM, dim1=-2, dim2=-1).sum(-1) / k
        coeffs.append(c)
        M = AM + c[..., None, None] * eye
    return torch.stack(coeffs, dim=-1)  # [..., n+1]


def _inverse_iteration(A: torch.Tensor, lam: torch.Tensor, steps: int = 4):
    """Approximate eigenvectors of A [..., n, n] for (near-)eigenvalues
    lam [..., L] by shifted inverse iteration.  Returns (v [..., L, n],
    residual [..., L])."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    scale = 1.0 + torch.abs(lam)
    shifted = A[..., None, :, :] - ((lam + 1e-10 * scale)[..., None, None]
                                    * eye)
    v = torch.full(lam.shape + (n,), 1.0 / np.sqrt(n), dtype=A.dtype,
                   device=A.device)
    for _ in range(steps):
        w = linalg.solve_small(shifted, v)
        ok = torch.all(torch.isfinite(w), dim=-1, keepdim=True)
        w = torch.where(ok, w, v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1,
                                                         keepdim=True), 1e-30)
    Av = torch.einsum("...ij,...lj->...li", A, v)
    residual = torch.linalg.vector_norm(Av - lam[..., None] * v, dim=-1)
    return v, residual


def essential_five_points(x: torch.Tensor, y: torch.Tensor):
    """All essential matrices through 5 bearing pairs (Nistér's minimal case).

    x, y: [..., 5, 3] unit bearings with y^T E x = 0.  Returns
    (Es [..., 10, 3, 3] Frobenius-normalized, valid [..., 10] bool); invalid
    slots are complex or degenerate solutions (essential.h:100-164)."""
    dtype, dev = x.dtype, x.device
    batch = x.shape[:-2]
    # Step 1: nullspace basis of the epipolar system (essential.h:77-83).
    A = torch.einsum("...nj,...nk->...njk", y, x).reshape(batch + (5, 9))
    basis = _nullspace_rows(A, 4)  # [..., 4, 9]
    # E entries as degree-1 polynomials over [x, y, z, 1]: P[..., 3, 3, 4].
    P = basis.reshape(batch + (4, 3, 3)).permute(
        *range(len(batch)), -2, -1, -3)

    # Step 2: the ten cubic constraints: (EE^T - tr(EE^T)/2 I) E = 0 and
    # det(E) = 0.
    O1 = _table(_O1_TABLE, x)
    O2 = _table(_O2_TABLE, x)
    EEt = torch.einsum("...ijm,...kjn,mnp->...ikp", P, P, O1)
    trace = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    L = EEt - 0.5 * trace[..., None, None, :] * eye3[..., None]
    singular_rows = torch.einsum("...ikp,...klq,pqr->...ilr", L, P,
                                 O2).reshape(batch + (9, 20))
    det_row = (
        _o2(_o1(P[..., 0, 0, :], P[..., 1, 1, :])
            - _o1(P[..., 0, 1, :], P[..., 1, 0, :]), P[..., 2, 2, :])
        + _o2(_o1(P[..., 0, 2, :], P[..., 1, 0, :])
              - _o1(P[..., 0, 0, :], P[..., 1, 2, :]), P[..., 2, 1, :])
        + _o2(_o1(P[..., 0, 1, :], P[..., 1, 2, :])
              - _o1(P[..., 0, 2, :], P[..., 1, 1, :]), P[..., 2, 0, :])
    )
    M = torch.cat([singular_rows, det_row[..., None, :]], dim=-2)  # [.., 10, 20]

    # Step 3: Gauss-Jordan -> [I | B] (essential.h:97,107-110).
    B = linalg.solve_small(M[..., :10], M[..., 10:])
    gj_ok = torch.all(torch.isfinite(B).reshape(batch + (100,)), dim=-1)
    B = torch.where(gj_ok[..., None, None], B, torch.zeros_like(B))

    # Step 4: multiplication-by-x action matrix on the quotient basis
    # [xx xy yy xz yz zz x y z 1] (essential.h:115-126).
    At = torch.zeros(batch + (10, 10), dtype=dtype, device=dev)
    for row, src in enumerate((0, 1, 2, 4, 5, 7)):
        At[..., row, :] = -B[..., src, :]
    for row, col in ((6, 0), (7, 1), (8, 3), (9, 6)):
        At[..., row, col] = 1.0

    # Step 5: eigenvalues via charpoly + Durand-Kerner, balanced by the
    # largest entry so the root magnitudes stay O(1).
    s = torch.clamp_min(torch.amax(torch.abs(At), dim=(-2, -1)), 1e-12)
    coeffs = _charpoly(At / s[..., None, None])
    lam_scaled, is_real = real_roots(coeffs, iterations=80, imag_tol=1e-6)
    lams = lam_scaled * s[..., None]  # [..., 10]

    # Step 6: eigenvectors carry the solutions v = [.., x, y, z, 1]
    # (essential.h:129-136).
    vs, residuals = _inverse_iteration(At, lams)
    denom = vs[..., 9]
    safe = torch.abs(denom) > 1e-12 * torch.linalg.vector_norm(vs, dim=-1)
    d = torch.where(safe, denom, torch.ones_like(denom))
    sol = torch.stack([vs[..., 6] / d, vs[..., 7] / d, vs[..., 8] / d,
                       torch.ones_like(d)], dim=-1)  # [..., 10, 4]

    Evec = sol @ basis  # [..., 10, 9]
    norm = torch.linalg.vector_norm(Evec, dim=-1, keepdim=True)
    Es = (Evec / torch.clamp_min(norm, 1e-30)).reshape(batch + (10, 3, 3))

    valid = (
        is_real
        & gj_ok[..., None]
        & safe
        & (residuals < 1e-3 * (1.0 + torch.abs(lams)))
        & torch.isfinite(Es).reshape(batch + (10, 9)).all(dim=-1)
        & (norm[..., 0] > 1e-12)
    )
    return Es, valid


def epipolar_geodesic_error(E: torch.Tensor, x: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
    """asin(y . E x) per pair — EpipolarGeodesic (essential_model.h:22-28).
    E [..., 3, 3], x, y [..., N, 3] -> [..., N]."""
    Ex = torch.einsum("...ij,...nj->...ni", E, x)
    val = torch.sum(y * Ex, dim=-1)
    return torch.arcsin(torch.clamp(val, -1.0, 1.0))


def decompose_essential(E: torch.Tensor):
    """The four candidate (R, t) with |t| = 1 of E = [t]x R.
    Returns (Rs [..., 4, 3, 3], ts [..., 4, 3])."""
    U, _, Vt = torch.linalg.svd(E)
    # Proper rotations.
    U = U * linalg.det3(U)[..., None, None]
    Vt = Vt * linalg.det3(Vt)[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = torch.stack([Ra, Ra, Rb, Rb], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def relative_pose_from_essential(E: torch.Tensor, x: torch.Tensor,
                                 y: torch.Tensor, mask=None) -> torch.Tensor:
    """[R|t] of the decomposition of E that puts the most pairs in front of
    both cameras (RelativePoseFromEssential, relative_pose.h:13); ties go
    to the first candidate.  E [..., 3, 3], x, y [..., N, 3] bearing pairs
    (mask [..., N]) broadcasting against E's leading dimensions.  Returns
    [..., 3, 4]."""
    Rs, ts = decompose_essential(E)  # [..., 4, 3, 3], [..., 4, 3]
    ok, _ = triangulate_two_bearings_midpoint(
        x[..., None, :, :], y[..., None, :, :], Rs, ts)  # [..., 4, N]
    if mask is not None:
        ok = ok & mask[..., None, :]
    counts = torch.sum(ok.to(torch.int32), dim=-1)
    best = torch.argmax(counts, dim=-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0,
                                                                      :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    return torch.cat([R, t[..., None]], dim=-1)


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]x R with t normalized to unit length."""
    tn = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                             1e-15)
    return rot.hat(tn) @ R


def relative_pose_error(Rt: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """1 - mean bearing agreement after midpoint triangulation, the
    RelativePose RANSAC error (relative_pose_model.h:39-65); 1 where the
    triangulation fails.  Rt [..., 3, 4], x, y [..., N, 3] broadcasting
    against Rt's leading dimensions.  Returns [..., N]."""
    R = Rt[..., :3, :3]
    t = Rt[..., :3, 3]
    ok, X = triangulate_two_bearings_midpoint(x, y, R, t)
    px = X / torch.clamp_min(torch.linalg.vector_norm(X, dim=-1, keepdim=True),
                             1e-15)
    Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
    py = Xc2 / torch.clamp_min(torch.linalg.vector_norm(Xc2, dim=-1,
                                                        keepdim=True), 1e-15)
    err = 1.0 - 0.5 * (torch.sum(px * x, dim=-1) + torch.sum(py * y, dim=-1))
    return torch.where(ok, err, torch.ones_like(err))


def refine_relative_pose(Rt: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         mask=None, iterations: int = 10) -> torch.Tensor:
    """Gauss-Newton refinement of [R|t] on the epipolar geodesic residual
    asin(y . [t]x R x) (RelativePoseRefinement, relative_pose.h:155); the
    translation is renormalized to unit length each step (scale is not
    observable).  Rt [..., 3, 4], x, y [..., N, 3]."""
    params = torch.cat([
        rot.matrix_to_rotvec(Rt[..., :3, :3]),
        Rt[..., :3, 3] / torch.clamp_min(torch.linalg.vector_norm(
            Rt[..., :3, 3], dim=-1, keepdim=True), 1e-15),
    ], dim=-1)
    w = None if mask is None else mask.to(Rt.dtype)
    eye3 = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    eye6 = torch.eye(6, dtype=Rt.dtype, device=Rt.device)
    for _ in range(iterations):
        r, t = params[..., None, :3], params[..., 3:6]
        tnorm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        tn = t / torch.clamp_min(tnorm, 1e-15)
        Rx = rot.rotate(r, x)  # [..., N, 3] = R x
        s = torch.sum(y * torch.linalg.cross(tn[..., None, :].expand_as(Rx),
                                             Rx, dim=-1), dim=-1)
        res = torch.arcsin(torch.clamp(s, -1.0, 1.0))
        dasin = torch.where(torch.abs(s) < 1.0,
                            1.0 / torch.sqrt(torch.clamp_min(1.0 - s * s,
                                                             1e-300)),
                            torch.zeros_like(s))
        # s = tn . (Rx x y): ds/dtn = Rx x y, dtn/dt = (I - tn tn^T)/|t|;
        # s = (y x tn) . Rx: ds/dr = (y x tn)^T dRx/dr.
        dtn = (eye3 - tn[..., :, None] * tn[..., None, :]) / torch.clamp_min(
            tnorm, 1e-15)[..., None]
        ds_dt = torch.einsum("...nj,...ji->...ni",
                             torch.linalg.cross(Rx, y, dim=-1), dtn)
        a = torch.linalg.cross(y, tn[..., None, :].expand_as(y), dim=-1)
        ds_dr = torch.einsum("...nj,...nji->...ni", a,
                             rot.rotate_jacobian(r, x))
        J = torch.cat([ds_dr, ds_dt], dim=-1) * dasin[..., None]  # [..., N, 6]
        if w is not None:
            res = res * w
            J = J * w[..., None]
        JtJ = J.transpose(-1, -2) @ J
        Jtr = torch.einsum("...ni,...n->...i", J, res)
        new = params - linalg.solve_spd(JtJ + 1e-9 * eye6, Jtr)
        tn_new = new[..., 3:6] / torch.clamp_min(torch.linalg.vector_norm(
            new[..., 3:6], dim=-1, keepdim=True), 1e-15)
        params = torch.cat([new[..., :3], tn_new], dim=-1)
    R = rot.rotvec_to_matrix(params[..., :3])
    return torch.cat([R, params[..., 3:6, None]], dim=-1)
