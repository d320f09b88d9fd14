"""Essential matrix estimation, batched in torch.

Port of the part of `opensfm_tpu.geometry.essential` that RANSAC needs: the
least-squares N-point essential matrix, Nistér's 5-point minimal solver
(nullspace basis, the ten cubic constraints over 20 monomials, Gauss-Jordan
to a 10x10 action matrix, its characteristic polynomial by
Faddeev-LeVerrier, Durand-Kerner roots and inverse-iteration eigenvectors)
and the epipolar geodesic error.  Every function takes a leading batch of
problems.  Convention: bearings x in camera 1, y in camera 2, y^T E x = 0.

The nullspace basis comes from the SVD of the 5x9 epipolar system, which
differs between LAPACK builds and devices, so the ten candidates agree with
the reference's as a set (up to sign and order), not slot by slot.  A
singular Gauss-Jordan solve gives inf/NaN that the validity mask drops, as
in the reference; nothing raises.
"""

from __future__ import annotations

import numpy as np
import torch

from opensfm_tpu_torch.geometry.polynomial import real_roots
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
