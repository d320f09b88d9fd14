"""Batched LO-RANSAC engine + the essential and fundamental families.

Port of `opensfm_tpu.robust.ransac` (OpenSfM robust/robust_estimator.h,
scorer.h, instanciations.cc):

- K hypotheses are drawn up front and solved by a batched minimal solver
  (fixed shapes, no data-dependent early exit);
- all [K * M, N] residuals are scored at once with the MSAC truncated
  quadratic (minimize sum(min(e, thresh)^2));
- local optimization refits the winner on its inliers by the non-minimal
  solver, re-scores it and keeps it when it is better (two rounds).

The hypotheses are swept in chunks of CHUNK = 512 with the reference's
count, k = max(iterations, 64) (1,024 at 1,000 iterations), and the best
chunk wins.  The data are padded to a power-of-two bucket with the first
row repeated and masked out, as the reference pads them; sample indices
point into that padded array.  Chunk `ci` draws from a `torch.Generator`
seeded with `seed + ci * 7919` (the reference's key for that chunk); a
caller can inject its own [n_chunks * k_chunk, S] indices instead.  The
families of the reference other than these two (relative pose, relative
rotation, absolute pose with and without known rotation, similarity,
homography, line) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.geometry import essential as ess

CHUNK = 512  # hypotheses per sweep
LO_ROUNDS = 2  # local-optimization refits of the winner
_BIG = 1e30


@dataclass
class RansacResult:
    """Mirror of robust::ScoreInfo (scorer.h:7-19)."""

    model: Any = None
    inliers_indices: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    score: float = 0.0
    lo_model: Any = None

    @property
    def num_inliers(self) -> int:
        return len(self.inliers_indices)


def draw_samples(seed: int, chunk: int, n_pad: int, k: int, s: int,
                 mask: torch.Tensor) -> torch.Tensor:
    """[k, s] distinct indices of rows where `mask` is true, uniformly at
    random, from a generator on the mask's device seeded with
    seed + chunk * 7919: each hypothesis keeps the s largest of n_pad
    uniform keys (masked rows get -1)."""
    g = torch.Generator(device=mask.device)
    g.manual_seed(int(seed) + int(chunk) * 7919)
    keys = torch.rand((k, n_pad), generator=g, device=mask.device)
    keys = torch.where(mask[None, :], keys, torch.full_like(keys, -1.0))
    return torch.topk(keys, s, dim=1).indices


def _msac_score(errors, threshold, data_mask):
    """errors: [..., N] -> (cost[...], inliers[..., N]).  Lower cost wins."""
    e = torch.abs(errors)
    inl = (e <= threshold) & data_mask
    cost = torch.sum(
        torch.where(inl, e * e, torch.full_like(e, threshold * threshold))
        * data_mask.to(e.dtype),
        dim=-1,
    )
    return cost, inl


def make_ransac_core(
    minimal_fn: Callable,  # (d1[K,S,...], d2[K,S,...]) -> (models[K,M,...], valid[K,M])
    error_fn: Callable,  # (models[B,...], d1[N,...], d2[N,...]) -> [B, N]
    nonminimal_fn: Callable,  # (model, d1, d2, mask[N]) -> model
):
    """A batched LO-RANSAC core for one model family: (idx [K, S], d1, d2,
    threshold, mask [N]) -> (best model, its cost, its inliers [N])."""

    def core(idx, d1, d2, threshold, mask):
        models, valid = minimal_fn(d1[idx], d2[idx])
        flat_models = models.reshape((-1,) + models.shape[2:])
        flat_valid = valid.reshape(-1)

        errors = error_fn(flat_models, d1, d2)  # [K*M, N]
        cost, inliers = _msac_score(errors, threshold, mask[None, :])
        cost = torch.where(flat_valid, cost, torch.full_like(cost, _BIG))

        best = torch.argmin(cost)
        best_model = flat_models[best]
        best_cost = cost[best]
        best_inliers = inliers[best]

        for _ in range(LO_ROUNDS):
            refined = nonminimal_fn(best_model, d1, d2, best_inliers)
            e = error_fn(refined[None], d1, d2)[0]
            c, i = _msac_score(e, threshold, mask)
            better = (c < best_cost) & torch.all(torch.isfinite(refined))
            best_model = torch.where(better, refined, best_model)
            best_inliers = torch.where(better, i, best_inliers)
            best_cost = torch.where(better, c, best_cost)
        return best_model, best_cost, best_inliers

    return core


def _run(core, d1: np.ndarray, d2: np.ndarray, threshold: float,
         iterations: int, min_samples: int, seed: int,
         mask: Optional[np.ndarray] = None, device=None,
         samples: Optional[np.ndarray] = None) -> RansacResult:
    """Host wrapper: validate sizes, pad, run the core chunk by chunk on
    `device` and unpack the best chunk's result to numpy.  `samples`
    [n_chunks * k_chunk, S], when given, replaces the generator's draws."""
    dev = resolve_device(device)
    n = len(d1)
    if mask is None:
        mask = np.ones(n, dtype=bool)
    if int(mask.sum()) < min_samples:
        return RansacResult()
    n_pad = max(64, 1 << int(n - 1).bit_length())
    if n_pad > n:
        pad = n_pad - n
        d1 = np.concatenate([d1, np.repeat(d1[:1], pad, axis=0)])
        d2 = np.concatenate([d2, np.repeat(d2[:1], pad, axis=0)])
        mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
    k = int(max(iterations, 64))
    n_chunks = max(1, -(-k // CHUNK))
    k_chunk = min(k, CHUNK)
    if samples is not None and np.shape(samples) != (n_chunks * k_chunk,
                                                     min_samples):
        raise ValueError(f"samples must be [{n_chunks * k_chunk}, "
                         f"{min_samples}], not {np.shape(samples)}")
    d1t = torch.as_tensor(np.asarray(d1), device=dev)
    d2t = torch.as_tensor(np.asarray(d2), device=dev)
    maskt = torch.as_tensor(mask, device=dev)
    model = cost = inliers = None
    for ci in range(n_chunks):
        if samples is None:
            idx = draw_samples(seed, ci, n_pad, k_chunk, min_samples, maskt)
        else:
            idx = torch.as_tensor(
                np.asarray(samples[ci * k_chunk:(ci + 1) * k_chunk]),
                dtype=torch.int64, device=dev)
        m, c, inl = core(idx, d1t, d2t, float(threshold), maskt)
        if cost is None or float(c) < float(cost):
            model, cost, inliers = m, c, inl
    result = RansacResult(
        model=model.cpu().numpy(),
        inliers_indices=np.flatnonzero(inliers.cpu().numpy()[:n]),
        score=1.0 / (float(cost) + 1e-8),
    )
    result.lo_model = result.model
    return result


# ---------------------------------------------------------------------------
# Essential matrix: Nistér 5-point minimal solver, epipolar geodesic error
# ---------------------------------------------------------------------------

_ESSENTIAL_SAMPLES = 5  # each sample yields up to 10 candidate E


def _essential_error(E, x, y):
    return torch.abs(ess.epipolar_geodesic_error(E, x, y))


def _essential_nonminimal(E, x, y, mask):
    return ess.essential_n_points(x, y, mask=mask)


_essential_core = make_ransac_core(
    ess.essential_five_points, _essential_error, _essential_nonminimal
)


def ransac_essential(x1, x2, threshold: float, iterations: int = 1000,
                     seed: int = 42, mask=None, device=None,
                     samples=None) -> RansacResult:
    """Essential matrix RANSAC on bearing pairs; threshold is the epipolar
    geodesic angle in radians (RANSACEssential with EpipolarGeodesic,
    instanciations.cc:15-31)."""
    return _run(_essential_core, np.asarray(x1), np.asarray(x2),
                float(threshold), iterations, _ESSENTIAL_SAMPLES, seed, mask,
                device, samples)


# ---------------------------------------------------------------------------
# Fundamental matrix: normalized 8-point, Sampson distance
# ---------------------------------------------------------------------------


def _normalize(x, m):
    """Hartley normalization of [..., N, 2] points: homogeneous points in
    the normalized frame and the 3x3 transform."""
    if m is None:
        mean = torch.mean(x, dim=-2)
        std = torch.std(x, dim=-2, correction=0) + 1e-12
    else:
        w = m.to(x.dtype)[..., None]
        n = torch.clamp_min(torch.sum(w, dim=-2), 1.0)
        mean = torch.sum(x * w, dim=-2) / n
        std = torch.sqrt(torch.sum(w * (x - mean[..., None, :]) ** 2, dim=-2)
                         / n) + 1e-12
    zero = torch.zeros_like(mean[..., 0])
    one = torch.ones_like(zero)
    T = torch.stack([
        torch.stack([1.0 / std[..., 0], zero, -mean[..., 0] / std[..., 0]], -1),
        torch.stack([zero, 1.0 / std[..., 1], -mean[..., 1] / std[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)
    xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return xh @ T.transpose(-1, -2), T


def _fundamental_8pt(x1, x2, mask=None):
    """Normalized 8-point fundamental matrix from 2D point pairs
    [..., N, 2], rank 2, Frobenius-normalized."""
    x1h, T1 = _normalize(x1, mask)
    x2h, T2 = _normalize(x2, mask)
    A = torch.einsum("...nj,...nk->...njk", x2h, x1h).reshape(
        x1.shape[:-1] + (9,))
    if mask is not None:
        A = A * mask[..., None].to(A.dtype)
    F = ess._nullspace_rows(A, 1)[..., 0, :].reshape(x1.shape[:-2] + (3, 3))
    # Enforce rank 2.
    U, S, Vt2 = torch.linalg.svd(F)
    S = torch.stack([S[..., 0], S[..., 1], torch.zeros_like(S[..., 2])], -1)
    F = (U * S[..., None, :]) @ Vt2
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.linalg.matrix_norm(F)[..., None, None]
    return F / torch.where(norm < 1e-15, torch.ones_like(norm), norm)


def _fundamental_minimal(x1, x2):
    F = _fundamental_8pt(x1, x2)
    return F[..., None, :, :], torch.ones(F.shape[:-2] + (1,), dtype=torch.bool,
                                          device=F.device)


def _fundamental_error(F, x1, x2):
    """Sampson distance (first-order geometric error): F [B, 3, 3], points
    [N, 2] -> [B, N]."""
    x1h = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=1)
    x2h = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=1)
    Fx1 = torch.einsum("bij,nj->bni", F, x1h)
    Ftx2 = torch.einsum("nj,bjk->bnk", x2h, F)
    num = torch.sum(x2h * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return torch.sqrt(num / torch.clamp_min(den, 1e-15))


def _fundamental_nonminimal(F, x1, x2, mask):
    return _fundamental_8pt(x1, x2, mask=mask)


_fundamental_core = make_ransac_core(
    _fundamental_minimal, _fundamental_error, _fundamental_nonminimal
)


def ransac_fundamental(x1, x2, threshold: float, iterations: int = 1000,
                       seed: int = 42, mask=None, device=None,
                       samples=None) -> RansacResult:
    """Fundamental matrix RANSAC from 2D normalized image points; Sampson
    distance threshold (replaces cv2.findFundamentalMat in robust_match)."""
    return _run(_fundamental_core, np.asarray(x1), np.asarray(x2),
                float(threshold), iterations, 8, seed, mask, device, samples)
