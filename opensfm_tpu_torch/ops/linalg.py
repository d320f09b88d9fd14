"""Small dense linear algebra on torch tensors.

Port of `opensfm_tpu.ops.linalg` for what the bundle path uses: the SPD
solve by Cholesky (the damped normal equations) and the closed-form 3x3
inverse, determinant and solve (per-point Schur blocks, triangulation).
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
