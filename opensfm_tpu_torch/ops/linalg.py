"""Small dense linear algebra on torch tensors.

Port of `opensfm_tpu.ops.linalg` for what the bundle and matching paths
use: the SPD solve and inverse by Cholesky (the damped normal equations,
the covariances), the QR solve (the sharded bundle's reduced system, which
f32 roundoff can leave slightly indefinite), the small general solve by Gauss-Jordan (the 5-point
solver) and the closed-form 3x3 inverse, determinant and solve (per-point
Schur blocks, triangulation).
"""

from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A (batched).

    A: [..., N, N]; b: [..., N] or [..., N, K].  Like the reference's
    Cholesky solve, a matrix that is not positive definite gives NaN instead
    of raising, so the LM loop rejects the step (`torch.linalg.cholesky`
    would raise; `cholesky_ex` reports the failure without a host sync)."""
    vec = b.dim() == A.dim() - 1
    if vec:
        b = b[..., None]
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b, L)
    bad = (info != 0)[..., None, None]
    x = torch.where(bad, torch.full_like(x, float("nan")), x)
    return x[..., 0] if vec else x


def solve_qr(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b by QR (batched), for symmetric systems that roundoff
    may have left slightly indefinite (a Schur complement summed over
    shards in f32), where a Cholesky factor would give NaN.  A: [..., N, N];
    b: [..., N] or [..., N, K]."""
    vec = b.dim() == A.dim() - 1
    if vec:
        b = b[..., None]
    q, r = torch.linalg.qr(A)
    y = torch.einsum("...ji,...jk->...ik", q, b.to(A.dtype))
    x = torch.linalg.solve_triangular(r, y, upper=True)
    return x[..., 0] if vec else x


def inv_spd(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix by Cholesky
    (`solve_spd` against the identity; NaN where A is not positive
    definite)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return solve_spd(A, eye.expand(A.shape))


def solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve general small n x n systems A x = b (batched, any dtype).

    The reference's unrolled Gauss-Jordan elimination with partial pivoting,
    op for op: a singular system gives inf/NaN instead of raising (as
    `torch.linalg.solve` would), and callers keep their isfinite guards.
    A: [..., n, n]; b: [..., n] or [..., n, k]."""
    n = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    if vec:
        b = b[..., None]
    b = b.to(A.dtype)
    batch = torch.broadcast_shapes(A.shape[:-2], b.shape[:-2])
    M = torch.cat([A.expand(batch + A.shape[-2:]),
                   b.expand(batch + b.shape[-2:])], dim=-1)  # [..., n, n+k]
    rows = torch.arange(n, device=A.device)
    for i in range(n):
        # Partial pivot: strongest remaining row in column i.
        col = torch.abs(M[..., :, i])
        col = torch.where(rows >= i, col, torch.full_like(col, -float("inf")))
        p = torch.argmax(col, dim=-1)  # [...]
        perm = torch.where(rows == i, p[..., None],
                           torch.where(rows == p[..., None], i, rows))
        M = torch.take_along_dim(M, perm[..., :, None], dim=-2)
        # Normalize the pivot row, eliminate every other row (Gauss-Jordan:
        # the left block becomes the identity and the right block is x).
        row_i = M[..., i:i + 1, :] / M[..., i:i + 1, i:i + 1]
        factors = M[..., :, i:i + 1]
        elim = (rows != i)[:, None]
        M = torch.where(elim, M - factors * row_i, row_i)
    x = M[..., n:]
    return x[..., 0] if vec else x


def det3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of [..., 3, 3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of [..., 3, 3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    rows = [
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    return adjugate3(A) / det3(A)[..., None, None]


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve general 3x3 systems A x = b closed-form (batched).
    A: [..., 3, 3]; b: [..., 3]."""
    return torch.einsum("...ij,...j->...i", adjugate3(A), b) / det3(A)[..., None]
