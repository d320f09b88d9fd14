"""Batched LO-RANSAC engine and the model families of `match_features`
and the growth loop.

Port of `opensfm_tpu.robust.ransac` (OpenSfM robust/robust_estimator.h,
scorer.h, instanciations.cc):

- K hypotheses are drawn up front and solved by a batched minimal solver
  (fixed shapes, no data-dependent early exit);
- all [K * M, N] residuals are scored at once with the MSAC truncated
  quadratic (minimize sum(min(e, thresh)^2));
- local optimization refits the winner on its inliers by the non-minimal
  solver, re-scores it and keeps it when it is better (two rounds).

One engine (`make_batched_core`, `_run_batched`) runs every family on B
independent problems at once: each chunk of hypotheses is one batched
computation for all of them, so the launches of a call do not grow with B
(the reference's vmapped `ransac_absolute_pose_batched`); a single call is
B = 1.  The hypotheses are swept in chunks of CHUNK = 512 with the
reference's count, k = max(iterations, 64) (1,024 at 1,000 iterations),
and each problem keeps its best chunk.  Problems are padded to the largest
of them (the first row repeated, masked out; no power-of-two buckets) and
cut into groups only when one chunk's [group, K * M, N] residuals would
pass CAP_ELEMENTS.  Chunk `ci` draws from a CPU generator seeded with
seed + ci * 7919 (`draw_subsets`), so the card and the CPU draw the same
samples; a caller can inject its own row indices ([n_chunks * k_chunk, S]
for one problem, [B, n_chunks * k_chunk, S] for B).  The reference's
batched absolute pose shrinks its chunk with B to fit TPU memory
(ransac.py:362-374); the port keeps CHUNK, so a candidate's result does
not depend on the size of its round.  `make_ransac_core` builds a
one-problem core from per-problem callables, the reference's interface.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.geometry import absolute_pose as ap
from opensfm_tpu_torch.geometry import essential as ess
from opensfm_tpu_torch.geometry import transform as tf

CHUNK = 512  # hypotheses per sweep
LO_ROUNDS = 2  # local-optimization refits of the winner
CAP_ELEMENTS = 1 << 27  # residuals of one batched chunk ([group, K * M, N])
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


def _msac_cost(errors, threshold, mask):
    """MSAC: sum(min(|e|, thresh)^2) over the rows where `mask` holds;
    errors [..., N] -> [...].  Lower cost wins."""
    return errors.square().clamp_max_(threshold * threshold).mul_(
        mask.to(errors.dtype)).sum(dim=-1)


# ---------------------------------------------------------------------------
# The batched engine: B problems, one computation per chunk
# ---------------------------------------------------------------------------


def draw_subsets(seed: int, chunk: int, counts, k: int, s: int) -> np.ndarray:
    """[B, k, s] ranks: for each of B problems, k samples of s distinct
    ranks in [0, counts[b]), uniformly at random, from a CPU generator
    seeded with seed + chunk * 7919 (the same draws on any device).  Each
    sample takes rank j uniformly among the counts[b] - j ranks not taken
    yet."""
    g = torch.Generator()
    g.manual_seed(int(seed) + int(chunk) * 7919)
    counts = torch.as_tensor(np.asarray(counts, dtype=np.int64))[:, None]
    u = torch.rand((len(counts), k, s), generator=g, dtype=torch.float64)
    chosen = []
    for j in range(s):
        r = torch.floor(u[..., j] * (counts - j).to(torch.float64)).long()
        if chosen:
            for c in torch.sort(torch.stack(chosen, -1), dim=-1).values.unbind(-1):
                r = r + (r >= c).long()
        chosen.append(r)
    return torch.stack(chosen, -1).numpy()


def make_batched_core(minimal_fn: Callable, error_fn: Callable,
                      nonminimal_fn: Callable):
    """A batched LO-RANSAC core over G problems: (idx [G, K, S], d1 [G, N,
    ...], d2 [G, N, ...], threshold, mask [G, N]) -> (best models [G, ...],
    their costs [G], their inliers [G, N]).  `minimal_fn` maps samples
    [G, K, S, ...] to (models [G, K, M, ...], valid [G, K, M]); `error_fn`
    maps (models [G, B, ...], d1 [G, 1, N, ...], d2) to [G, B, N];
    `nonminimal_fn` refits (models [G, ...], d1, d2, mask [G, N])."""

    def core(idx, d1, d2, threshold, mask):
        G = d1.shape[0]
        rows = torch.arange(G, device=d1.device)
        models, valid = minimal_fn(d1[rows[:, None, None], idx],
                                   d2[rows[:, None, None], idx])
        flat = models.reshape((G, -1) + models.shape[3:])
        flat_valid = valid.reshape(G, -1)
        errors = error_fn(flat, d1[:, None], d2[:, None])  # [G, K*M, N]
        # The residuals are the sweep's largest array: only the winner's
        # row becomes an inlier mask.
        cost = _msac_cost(errors, threshold, mask[:, None, :])
        cost = torch.where(flat_valid, cost, torch.full_like(cost, _BIG))
        best = torch.argmin(cost, dim=1)
        best_model = flat[rows, best]
        best_cost = cost[rows, best]
        best_err = errors[rows, best]
        best_inliers = (torch.abs(best_err) <= threshold) & mask
        for _ in range(LO_ROUNDS):
            refined = nonminimal_fn(best_model, d1, d2, best_inliers)
            e = error_fn(refined[:, None], d1[:, None], d2[:, None])[:, 0]
            c = _msac_cost(e, threshold, mask)
            i = (torch.abs(e) <= threshold) & mask
            better = (c < best_cost) & torch.isfinite(refined).reshape(
                G, -1).all(dim=1)
            bm = better.reshape((G,) + (1,) * (refined.dim() - 1))
            best_model = torch.where(bm, refined, best_model)
            best_inliers = torch.where(better[:, None], i, best_inliers)
            best_cost = torch.where(better, c, best_cost)
        return best_model, best_cost, best_inliers

    return core


def make_ransac_core(minimal_fn: Callable, error_fn: Callable,
                     nonminimal_fn: Callable = None, min_samples: int = 2,
                     lo_rounds: int = LO_ROUNDS):
    """A one-problem LO-RANSAC core from per-problem callables (the
    reference's `make_ransac_core`): `minimal_fn(d1[S, ...], d2[S, ...])`
    -> (models [M, ...], valid [M]); `error_fn(model, d1[N, ...], d2[N,
    ...])` -> [N]; `nonminimal_fn(model, d1, d2, mask)` -> model (None: no
    local optimization).  They are batched over the hypotheses by
    `torch.func.vmap`, so they must be vmappable.

    core(idx [K, S] sample row indices, d1, d2, threshold, mask [N]) ->
    (best model, its MSAC cost, its inliers [N]).  The reference's core
    draws the K samples from a PRNG key; this one takes them, as every
    family of the engine takes injected draws."""
    vmap = torch.func.vmap

    def core(idx, d1, d2, threshold, mask):
        idx = torch.as_tensor(idx, dtype=torch.int64, device=d1.device)
        if idx.shape[-1] != min_samples:
            raise ValueError(f"samples of {min_samples} rows expected")
        models, valid = vmap(minimal_fn)(d1[idx], d2[idx])
        flat = models.reshape((-1,) + models.shape[2:])
        flat_valid = valid.reshape(-1)
        errors = vmap(lambda m: error_fn(m, d1, d2))(flat)  # [K * M, N]
        cost = _msac_cost(errors, threshold, mask[None, :])
        cost = torch.where(flat_valid, cost, torch.full_like(cost, _BIG))
        best = torch.argmin(cost)
        best_model, best_cost = flat[best], cost[best]
        best_inliers = (torch.abs(errors[best]) <= threshold) & mask
        if nonminimal_fn is not None:
            for _ in range(lo_rounds):
                refined = nonminimal_fn(best_model, d1, d2, best_inliers)
                e = error_fn(refined, d1, d2)
                c = _msac_cost(e, threshold, mask)
                better = bool(c < best_cost) and bool(
                    torch.isfinite(refined).all())
                if better:
                    best_model, best_cost = refined, c
                    best_inliers = (torch.abs(e) <= threshold) & mask
        return best_model, best_cost, best_inliers

    return core


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """`a` padded to n rows by repeating its first row."""
    if len(a) < n:
        a = np.concatenate([a, np.repeat(a[:1], n - len(a), axis=0)])
    return a


def _run_batched(core, d1s, d2s, threshold: float, iterations: int,
                 min_samples: int, models_per_sample: int, seed: int,
                 masks=None, device=None, samples=None):
    """Run `core` on B problems (d1s[b], d2s[b] of n_b rows): per chunk of
    k_chunk hypotheses one batched computation for all problems (for each
    group of problems, when CAP_ELEMENTS splits them), keeping each
    problem's best chunk.  `samples` [B, n_chunks * k_chunk, S] row indices
    replace the draws.  Returns a RansacResult per problem (empty where a
    problem has fewer valid rows than `min_samples`)."""
    dev = resolve_device(device)
    B = len(d1s)
    results = [RansacResult() for _ in range(B)]
    d1s = [np.asarray(d, dtype=np.float64) for d in d1s]
    d2s = [np.asarray(d, dtype=np.float64) for d in d2s]
    if masks is None:
        masks = [None] * B
    masks = [np.ones(len(d), dtype=bool) if m is None
             else np.asarray(m, dtype=bool) for d, m in zip(d1s, masks)]
    runnable = [b for b in range(B) if int(masks[b].sum()) >= min_samples]
    if not runnable:
        return results
    k = int(max(iterations, 64))
    k_chunk = min(k, CHUNK)
    n_chunks = max(1, -(-k // CHUNK))
    if samples is not None and np.shape(samples) != (
            B, n_chunks * k_chunk, min_samples):
        raise ValueError(f"samples must be [{B}, {n_chunks * k_chunk}, "
                         f"{min_samples}], not {np.shape(samples)}")
    # Draws: ranks among each problem's valid rows -> row indices.
    run_idx = {}
    for ci in range(n_chunks):
        if samples is not None:
            rows = np.asarray(samples)[runnable, ci * k_chunk:(ci + 1) * k_chunk]
        else:
            ranks = draw_subsets(seed, ci, [int(masks[b].sum()) for b in runnable],
                                 k_chunk, min_samples)
            rows = np.stack([np.flatnonzero(masks[b])[ranks[j]]
                             for j, b in enumerate(runnable)])
        run_idx[ci] = rows
    # Groups of problems of similar sizes, each padded to its largest (the
    # plain shapes: no power-of-two compile buckets).
    rows_of = {b: len(d1s[b]) for b in runnable}
    order = sorted(range(len(runnable)), key=lambda j: rows_of[runnable[j]])
    groups, cur = [], []
    for j in order:
        n = rows_of[runnable[j]]
        if cur and (len(cur) + 1) * k_chunk * models_per_sample * n \
                > CAP_ELEMENTS:
            groups.append(cur)
            cur = []
        cur.append(j)
    groups.append(cur)

    for group in groups:
        probs = [runnable[j] for j in group]
        n = max(rows_of[b] for b in probs)
        d1t = torch.as_tensor(np.stack([_pad_rows(d1s[b], n) for b in probs]),
                              device=dev)
        d2t = torch.as_tensor(np.stack([_pad_rows(d2s[b], n) for b in probs]),
                              device=dev)
        maskt = torch.as_tensor(np.stack([
            np.concatenate([masks[b], np.zeros(n - len(masks[b]), bool)])
            for b in probs]), device=dev)
        model = cost = inliers = None
        for ci in range(n_chunks):
            idx = torch.as_tensor(run_idx[ci][group], dtype=torch.int64,
                                  device=dev)
            m, c, inl = core(idx, d1t, d2t, float(threshold), maskt)
            if cost is None:
                model, cost, inliers = m, c, inl
            else:
                better = c < cost
                model = torch.where(
                    better.reshape((-1,) + (1,) * (m.dim() - 1)), m, model)
                inliers = torch.where(better[:, None], inl, inliers)
                cost = torch.where(better, c, cost)
        model, cost, inliers = (model.cpu().numpy(), cost.cpu().numpy(),
                                inliers.cpu().numpy())
        for row, b in enumerate(probs):
            res = RansacResult(
                model=model[row],
                inliers_indices=np.flatnonzero(inliers[row, :len(d1s[b])]),
                score=1.0 / (float(cost[row]) + 1e-8),
            )
            res.lo_model = res.model
            results[b] = res
    return results


def _run_one(core, d1, d2, threshold, iterations, min_samples,
             models_per_sample, seed, mask, device, samples) -> RansacResult:
    """One problem through the batched engine; `samples` [n_chunks *
    k_chunk, S] as in `_run`."""
    return _run_batched(
        core, [d1], [d2], threshold, iterations, min_samples,
        models_per_sample, seed, masks=[mask], device=device,
        samples=None if samples is None else np.asarray(samples)[None],
    )[0]


# ---------------------------------------------------------------------------
# Essential matrix: Nistér 5-point minimal solver, epipolar geodesic error
# ---------------------------------------------------------------------------

_ESSENTIAL_SAMPLES = 5  # each sample yields up to 10 candidate E


def _essential_error(E, x, y):
    """|asin(y . E x)| as vec(E) . vec(y x^T): E [..., M, 3, 3], x, y
    [..., 1, N, 3] -> [..., M, N] (EpipolarGeodesic, essential_model.h:
    22-28)."""
    yx = (y[..., 0, :, :, None] * x[..., 0, :, None, :]).flatten(-2)
    val = E.flatten(-2) @ yx.transpose(-1, -2)
    return torch.abs(torch.arcsin(val.clamp_(-1.0, 1.0)))


def _essential_nonminimal(E, x, y, mask):
    return ess.essential_n_points(x, y, mask=mask)


_essential_core = make_batched_core(ess.essential_five_points,
                                    _essential_error, _essential_nonminimal)


def ransac_essential(x1, x2, threshold: float, iterations: int = 1000,
                     seed: int = 42, mask=None, device=None,
                     samples=None) -> RansacResult:
    """Essential matrix RANSAC on bearing pairs; threshold is the epipolar
    geodesic angle in radians (RANSACEssential with EpipolarGeodesic,
    instanciations.cc:15-31)."""
    return _run_one(_essential_core, x1, x2, float(threshold), iterations,
                    _ESSENTIAL_SAMPLES, 10, seed, mask, device, samples)


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
    """Sampson distance (first-order geometric error): F [..., M, 3, 3],
    points [..., 1, N, 2] -> [..., M, N]."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Fx1 = x1h @ F.transpose(-1, -2)  # [..., M, N, 3]
    Ftx2 = x2h @ F
    num = torch.sum(x2h * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return torch.sqrt(num / torch.clamp_min(den, 1e-15))


def _fundamental_nonminimal(F, x1, x2, mask):
    return _fundamental_8pt(x1, x2, mask=mask)


_fundamental_core = make_batched_core(
    _fundamental_minimal, _fundamental_error, _fundamental_nonminimal
)


def ransac_fundamental(x1, x2, threshold: float, iterations: int = 1000,
                       seed: int = 42, mask=None, device=None,
                       samples=None) -> RansacResult:
    """Fundamental matrix RANSAC from 2D normalized image points; Sampson
    distance threshold (replaces cv2.findFundamentalMat in robust_match)."""
    return _run_one(_fundamental_core, x1, x2, float(threshold), iterations,
                    8, 1, seed, mask, device, samples)


# ---------------------------------------------------------------------------
# Relative pose [R|t] from bearing pairs: 5-point + cheirality
# ---------------------------------------------------------------------------


def _relpose_minimal(x, y):
    Es, valid = ess.essential_five_points(x, y)  # [..., 10, 3, 3]
    Rts = ess.relative_pose_from_essential(Es, x[..., None, :, :],
                                           y[..., None, :, :])
    return Rts, valid


def _relpose_nonminimal(Rt, x, y, mask):
    E = ess.essential_n_points(x, y, mask=mask)
    return ess.relative_pose_from_essential(E, x, y, mask=mask)


_relpose_core = make_batched_core(_relpose_minimal, ess.relative_pose_error,
                                  _relpose_nonminimal)


def ransac_relative_pose(x1, x2, threshold: float, iterations: int = 1000,
                         seed: int = 42, mask=None, device=None,
                         samples=None) -> RansacResult:
    """Relative pose [R|t] RANSAC from bearing pairs; the angular threshold
    is adapted to 1 - cos (RelativePose::ThresholdAdapter,
    relative_pose_model.h:17-19)."""
    return _run_one(_relpose_core, x1, x2, 1.0 - np.cos(threshold),
                    iterations, _ESSENTIAL_SAMPLES, 10, seed, mask, device,
                    samples)


# ---------------------------------------------------------------------------
# Relative rotation (Kabsch on 3 bearing pairs)
# ---------------------------------------------------------------------------


def _relrot_minimal(x, y):
    R = tf.rotation_between_points(x, y)
    return R[..., None, :, :], torch.ones(R.shape[:-2] + (1,),
                                          dtype=torch.bool, device=R.device)


def _relrot_error(R, x, y):
    """1 - y . (R x) as vec(R) . vec(y x^T): R [..., M, 3, 3], x, y
    [..., 1, N, 3] -> [..., M, N], with no [M, N, 3] array."""
    yx = (y[..., 0, :, :, None] * x[..., 0, :, None, :]).flatten(-2)  # [..., N, 9]
    return (R.flatten(-2) @ yx.transpose(-1, -2)).neg_().add_(1.0)


def _relrot_nonminimal(R, x, y, mask):
    return tf.rotation_between_points(x, y, mask=mask)


_relrot_core = make_batched_core(_relrot_minimal, _relrot_error,
                                 _relrot_nonminimal)


def ransac_relative_rotation(x1, x2, threshold: float, iterations: int = 1000,
                             seed: int = 42, mask=None, device=None,
                             samples=None) -> RansacResult:
    """Rotation-only relative pose RANSAC; angular threshold
    (relative_rotation_model.h)."""
    return _run_one(_relrot_core, x1, x2, 1.0 - np.cos(threshold), iterations,
                    3, 1, seed, mask, device, samples)


def ransac_relative_rotation_batched(x1_list, x2_list, threshold: float,
                                     iterations: int = 1000, seed: int = 42,
                                     device=None, samples=None):
    """`ransac_relative_rotation` for B bearing-pair sets in one batched
    computation per chunk; a list of RansacResult."""
    return _run_batched(_relrot_core, x1_list, x2_list,
                        1.0 - np.cos(threshold), iterations, 3, 1, seed,
                        device=device, samples=samples)


# ---------------------------------------------------------------------------
# Absolute pose (P3P + Gauss-Newton polish)
# ---------------------------------------------------------------------------


def _abspose_nonminimal(Rt, b, p, mask):
    return ap.absolute_pose_gn_refine(Rt, b, p, mask=mask, iterations=10)


_abspose_core = make_batched_core(ap.p3p, ap.absolute_pose_error,
                                  _abspose_nonminimal)


def ransac_absolute_pose(bearings, points, threshold: float,
                         iterations: int = 1000, seed: int = 42, mask=None,
                         device=None, samples=None) -> RansacResult:
    """P3P absolute pose RANSAC; angular threshold adapted to 1 - cos
    (absolute_pose_model.h:15-17)."""
    return _run_one(_abspose_core, bearings, points, 1.0 - np.cos(threshold),
                    iterations, 3, 4, seed, mask, device, samples)


def ransac_absolute_pose_batched(bearings_list, points_list, threshold: float,
                                 iterations: int = 1000, seed: int = 42,
                                 device=None, samples=None):
    """P3P absolute pose RANSAC for several independent candidates (the
    growth loop's resection round) in one batched computation per chunk:
    its launches do not grow with the number of candidates.  Returns a
    RansacResult per candidate (empty where a candidate has fewer than 3
    correspondences)."""
    return _run_batched(_abspose_core, bearings_list, points_list,
                        1.0 - np.cos(threshold), iterations, 3, 4, seed,
                        device=device, samples=samples)


# ---------------------------------------------------------------------------
# Absolute pose with a known rotation (a translation)
# ---------------------------------------------------------------------------


def _kr_eye(b):
    return torch.eye(3, dtype=b.dtype, device=b.device)


def _kr_minimal(b, p):
    t = ap.absolute_pose_known_rotation_n_points(b, p, _kr_eye(b))
    return t[..., None, :], torch.ones(t.shape[:-1] + (1,), dtype=torch.bool,
                                       device=t.device)


def _kr_error(t, b, p):
    pc = p + t[..., None, :]
    pc = pc / torch.clamp_min(torch.linalg.vector_norm(pc, dim=-1,
                                                       keepdim=True), 1e-15)
    return 1.0 - torch.sum(b * pc, dim=-1)


def _kr_nonminimal(t, b, p, mask):
    return ap.absolute_pose_known_rotation_n_points(b, p, _kr_eye(b),
                                                    mask=mask)


_abspose_kr_core = make_batched_core(_kr_minimal, _kr_error, _kr_nonminimal)


def ransac_absolute_pose_known_rotation(bearings, points, rotation,
                                        threshold: float,
                                        iterations: int = 1000,
                                        seed: int = 42, mask=None,
                                        device=None,
                                        samples=None) -> RansacResult:
    """Translation-only absolute pose RANSAC with a known rotation
    (absolute_pose_known_rotation_model.h): the points are rotated first,
    so the model is the world-to-camera translation t."""
    points_rot = np.asarray(points) @ np.asarray(rotation).T
    return _run_one(_abspose_kr_core, bearings, points_rot,
                    1.0 - np.cos(threshold), iterations, 2, 1, seed, mask,
                    device, samples)


# ---------------------------------------------------------------------------
# Similarity (Umeyama) between 3D point sets
# ---------------------------------------------------------------------------


def _similarity_minimal(x, y):
    T = tf.similarity_between_points(x, y)
    return T[..., None, :, :], torch.ones(T.shape[:-2] + (1,),
                                          dtype=torch.bool, device=T.device)


def _similarity_error(T, x, y):
    pred = x @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    return torch.linalg.vector_norm(pred - y, dim=-1)


def _similarity_nonminimal(T, x, y, mask):
    return tf.similarity_between_points(x, y, mask=mask)


_similarity_core = make_batched_core(_similarity_minimal, _similarity_error,
                                     _similarity_nonminimal)


def ransac_similarity(x1, x2, threshold: float, iterations: int = 1000,
                      seed: int = 42, mask=None, device=None,
                      samples=None) -> RansacResult:
    """Similarity RANSAC between 3D point sets; metric threshold
    (similarity_model.h).  The model is a 4x4 transform x2 = T x1."""
    return _run_one(_similarity_core, x1, x2, float(threshold), iterations,
                    3, 1, seed, mask, device, samples)


# ---------------------------------------------------------------------------
# Plane homography (DLT), forward transfer error
# ---------------------------------------------------------------------------


def _homography_dlt(x1, x2, mask=None):
    """DLT homography x2 ~ H x1 from 2D point rows [..., N, 2]."""
    ones = torch.ones_like(x1[..., :1])
    zeros = torch.zeros_like(torch.cat([x1, ones], dim=-1))
    X1 = torch.cat([x1, ones], dim=-1)  # [..., N, 3]
    u, v = x2[..., 0:1], x2[..., 1:2]
    rows1 = torch.cat([X1, zeros, -u * X1], dim=-1)
    rows2 = torch.cat([zeros, X1, -v * X1], dim=-1)
    A = torch.cat([rows1, rows2], dim=-2)  # [..., 2N, 9]
    if mask is not None:
        m = torch.cat([mask, mask], dim=-1).to(A.dtype)[..., None]
        A = A * m
    H = ess._nullspace_rows(A, 1)[..., 0, :].reshape(x1.shape[:-2] + (3, 3))
    h22 = H[..., 2, 2]
    h22 = torch.where(torch.abs(h22) < 1e-15, torch.full_like(h22, 1e-15), h22)
    return H / h22[..., None, None]


def _homography_minimal(x1, x2):
    H = _homography_dlt(x1, x2)
    return H[..., None, :, :], torch.ones(H.shape[:-2] + (1,),
                                          dtype=torch.bool, device=H.device)


def _homography_error(H, x1, x2):
    """Forward transfer error |H(x1) - x2| (cv2.findHomography semantics)."""
    p = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1) \
        @ H.transpose(-1, -2)
    w = p[..., 2:3]
    w = torch.where(torch.abs(w) < 1e-15, torch.full_like(w, 1e-15), w)
    return torch.linalg.vector_norm(p[..., :2] / w - x2, dim=-1)


def _homography_nonminimal(H, x1, x2, mask):
    return _homography_dlt(x1, x2, mask=mask)


_homography_core = make_batched_core(_homography_minimal, _homography_error,
                                     _homography_nonminimal)


def ransac_homography(x1, x2, threshold: float, iterations: int = 1000,
                      seed: int = 42, mask=None, device=None,
                      samples=None) -> RansacResult:
    """Plane homography RANSAC from 2D points; transfer-distance threshold
    (replaces cv2.findHomography in the plane-based two-view path)."""
    return _run_one(_homography_core, x1, x2, float(threshold), iterations,
                    4, 1, seed, mask, device, samples)


# ---------------------------------------------------------------------------
# 2D line y = a x + b, point-line distance
# ---------------------------------------------------------------------------


def _line_minimal(p, _):
    """The line through two points [..., 2, 2]: models [..., 1, 2] (a, b)
    and valid [..., 1] (not vertical)."""
    x1, y1 = p[..., 0, 0], p[..., 0, 1]
    x2, y2 = p[..., 1, 0], p[..., 1, 1]
    dx = x2 - x1
    a = (y2 - y1) / torch.where(torch.abs(dx) < 1e-15,
                                torch.full_like(dx, 1e-15), dx)
    b = y1 - a * x1
    return torch.stack([a, b], dim=-1)[..., None, :], \
        (torch.abs(dx) > 1e-15)[..., None]


def _line_error(ab, p, _):
    """Distance of points p [..., 1, N, 2] to lines ab [..., B, 2]:
    [..., B, N]."""
    a, b = ab[..., 0:1], ab[..., 1:2]
    x, y = p[..., 0, :, 0], p[..., 0, :, 1]
    x = x[..., None, :]
    y = y[..., None, :]
    return torch.abs(a * x - y + b) / torch.sqrt(a * a + 1.0)


def _line_nonminimal(ab, p, _, mask):
    """Weighted least-squares y = a x + b over the rows of `mask`."""
    w = mask.to(p.dtype)
    n = torch.clamp_min(torch.sum(w, dim=-1), 1.0)
    mx = torch.sum(w * p[..., 0], dim=-1) / n
    my = torch.sum(w * p[..., 1], dim=-1) / n
    cov = torch.sum(w * (p[..., 0] - mx[..., None])
                    * (p[..., 1] - my[..., None]), dim=-1)
    var = torch.clamp_min(
        torch.sum(w * (p[..., 0] - mx[..., None]) ** 2, dim=-1), 1e-15)
    a = cov / var
    return torch.stack([a, my - a * mx], dim=-1)


_line_core = make_batched_core(_line_minimal, _line_error, _line_nonminimal)


def ransac_line(points, threshold: float, iterations: int = 1000,
                seed: int = 42, mask=None, device=None,
                samples=None) -> RansacResult:
    """2D line RANSAC (line_model.h): model (a, b) of y = a x + b, the
    point-line distance against `threshold`."""
    points = np.asarray(points, dtype=np.float64)
    return _run_one(_line_core, points, points, float(threshold),
                    iterations, 2, 1, seed, mask, device, samples)
