"""Plain PatchMatch depthmaps: the reference the dense cells are judged by.

Written from OpenSfM's dense stage (opensfm/dense.py: neighbours by the
angles of common tracks, the depth range from point percentiles, greys
scaled by INTER_AREA) and its PatchMatch estimator (dense/src/depthmap.cc:
random planes, then red/black half-iterations of propagation from the four
axis neighbours and six random refinements; a plane's score is its best
normalised cross-correlation over the neighbours; the JAX package's draws
from numpy's generator seeded 42).  Plain torch, no program code: it takes
the benchmark's rendered pixels, poses and tracks and works out everything
else again.

`dtype` sets the precision of the values (greys, planes, depths, scores);
pixel positions in a neighbour are always taken in float32.  float32 is
the configuration's; bfloat16 is the control.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

N_RANDOM = 6
MIN_PATCH_VARIANCE = 1e-5
SEED = 42
CHUNK_BYTES = 4 << 30  # device bytes one chunk of neighbours may take


def grey(rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 -> grey uint8 with OpenCV's 15-bit weights, rounded."""
    x = rgb.astype(np.int64)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2]
             + 16384) >> 15).astype(np.uint8)


def area_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] INTER_AREA weights: each output averages the source
    interval [d s, (d + 1) s), s = src / dst, partial pixels weighted by
    their coverage (the weights rounded to float32, as OpenCV keeps
    them)."""
    s = src / dst
    w = np.zeros((dst, src))
    for d in range(dst):
        a, b = d * s, d * s + s
        cell = min(s, src - a)
        lo, hi = int(np.ceil(a)), min(int(np.floor(b)), src - 1)
        lo = min(lo, hi)
        if lo - a > 1e-3:
            w[d, lo - 1] = np.float32((lo - a) / cell)
        w[d, lo:hi] = np.float32(1.0 / cell)
        if b - hi > 1e-3:
            w[d, hi] = np.float32(min(min(b - hi, 1.0), cell) / cell)
    return w


def scaled_grey(rgb: np.ndarray, width: int, device) -> torch.Tensor:
    """The grey of `rgb` in [0, 1], float32, scaled to `width` columns."""
    g = torch.as_tensor(grey(rgb).astype(np.float32) / np.float32(255.0),
                        device=device)
    h, w = g.shape
    height = max(int(round(h * width / w)), 1)
    if (w, h) == (width, height):
        return g
    wy = torch.as_tensor(area_matrix(h, height), device=device)
    wx = torch.as_tensor(area_matrix(w, width), device=device)
    return (wy @ g.double() @ wx.T).float()


def angles(points: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Angle at each point between the rays to c1 and c2."""
    a, b = c1 - points, c2 - points
    la, lb = np.sum(a * a, 1), np.sum(b * b, 1)
    ok = (la > 0) & (lb > 0)
    cos = np.clip(np.sum(a * b, 1) / np.sqrt(np.where(ok, la * lb, 1.0)),
                  -1.0, 1.0)
    return np.where(ok, np.arccos(cos), 0.0)


def neighbours(shot: int, names: Sequence[str], centres: np.ndarray,
               points: np.ndarray, obs_point: np.ndarray,
               obs_view: np.ndarray, k: int) -> List[int]:
    """The shot and its `k` best neighbours: views sharing more than 20
    tracks seen between 3 and 30 degrees apart, ranked by that count; a
    tie keeps the order in which the pair first appears among the tracks
    (tracks in order, each track's views sorted by name)."""
    order = np.argsort(obs_point, kind="stable")
    starts = np.searchsorted(obs_point[order], np.arange(len(points) + 1))
    first: Dict[int, tuple] = {}
    common: Dict[int, List[int]] = {}
    for j in np.unique(obs_point[obs_view == shot]):
        views = sorted(obs_view[order[starts[j]:starts[j + 1]]].tolist(),
                       key=lambda v: names[v])
        p = views.index(shot)
        for q, o in enumerate(views):
            if o == shot:
                continue
            key = (j, min(p, q), max(p, q))
            if o not in first:
                first[o] = key
            common.setdefault(o, []).append(j)
    scored = []
    for o in sorted(first, key=first.get):
        theta = angles(points[common[o]], centres[shot], centres[o])
        score = float(np.sum((np.pi / 60 < theta) & (theta < np.pi / 6)))
        if score > 20:
            scored.append((o, score))
    scored.sort(key=lambda x: x[1], reverse=True)
    return [shot] + [o for o, _ in scored[:k]]


def depth_range(points: np.ndarray, R: np.ndarray,
                centre: np.ndarray) -> Tuple[float, float]:
    """0.9 x the 10th and 1.1 x the 90th percentile of the points' depths
    in front of the camera."""
    d = (points - centre) @ R[2]
    d = d[d > 0]
    if len(d) == 0:
        return 1.0, 40.0
    return float(np.percentile(d, 10) * 0.9), float(np.percentile(d, 90) * 1.1)


def _nz(x):
    return torch.where(torch.abs(x) > 1e-9, x, 1e-9)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


class Shot:
    """The device arrays of one reference view and its neighbours."""

    def __init__(self, ref_grey, nb_greys, focal, R_ref, t_ref, nb_R, nb_t,
                 nb_focal, min_depth, max_depth, patch_size, dtype, device):
        self.dtype, self.device = dtype, device
        H, W = ref_grey.shape
        self.H, self.W = H, W
        size = max(W, H)
        ys, xs = np.mgrid[0:H, 0:W]
        # Each pixel's unit bearing (f64), scaled to z = 1.
        q = torch.as_tensor(np.stack([(xs - (W - 1) / 2.0) / size / focal,
                                      (ys - (H - 1) / 2.0) / size / focal,
                                      np.ones((H, W))], -1), device=device)
        b = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        rays = (b / b[..., 2:3]).cpu().numpy()
        self.rays_host = rays
        hp = patch_size // 2
        dy, dx = np.mgrid[-hp:hp + 1, -hp:hp + 1]
        oy = torch.as_tensor(np.clip(ys[None] + dy.reshape(-1, 1, 1), 0,
                                     H - 1), device=device)
        ox = torch.as_tensor(np.clip(xs[None] + dx.reshape(-1, 1, 1), 0,
                                     W - 1), device=device)
        ref = ref_grey.to(device=device, dtype=dtype)
        self.rays = torch.as_tensor(rays, dtype=dtype, device=device)
        self.patch = ref[oy, ox].reshape(len(dy.reshape(-1)), -1)  # [P2, HW]
        self.mean = torch.mean(self.patch, 0)
        self.var = torch.mean(self.patch ** 2, 0) - self.mean ** 2
        self.rays_off = self.rays[oy, ox].reshape(self.patch.shape[0], -1, 3)
        self.nb = torch.stack([g.to(device=device, dtype=dtype)
                               for g in nb_greys])
        self.R = torch.as_tensor(np.stack([Rn @ R_ref.T for Rn in nb_R]),
                                 dtype=dtype, device=device)
        self.t = torch.as_tensor(
            np.stack([tn - Rn @ R_ref.T @ t_ref for Rn, tn in zip(nb_R, nb_t)]),
            dtype=dtype, device=device)
        self.f = torch.as_tensor(np.asarray(nb_focal), dtype=dtype,
                                 device=device)
        self.min_depth, self.max_depth = float(min_depth), float(max_depth)

    def score(self, nu, pix):
        """(score, neighbour, depth) of planes nu [M, 3] at pixels `pix`."""
        P2 = self.patch.shape[0]
        rays = self.rays_off[:, pix]
        ref_patch, ref_mean, ref_var = (self.patch[:, pix], self.mean[pix],
                                        self.var[pix])
        z = 1.0 / _nz(_dot(rays, nu))  # [P2, M]
        X = [rays[..., c] * z for c in range(3)]
        N, nbH, nbW = self.nb.shape
        size = float(max(nbH, nbW))
        per = 14 * 4 * P2 * len(pix)
        chunk = max(1, min(N, CHUNK_BYTES // per))
        best = arg = None
        for c0 in range(0, N, chunk):
            c1 = min(N, c0 + chunk)
            R = self.R[c0:c1, :, :, None, None]
            t = self.t[c0:c1, :, None, None]
            f = self.f[c0:c1, None, None]
            Xn = [R[:, i, 0] * X[0] + R[:, i, 1] * X[1] + R[:, i, 2] * X[2]
                  + t[:, i] for i in range(3)]
            zc = _nz(Xn[2])
            px = (f * Xn[0] / zc).float() * size + (nbW - 1) / 2.0
            py = (f * Xn[1] / zc).float() * size + (nbH - 1) / 2.0
            x0 = torch.clamp(torch.floor(px), 0, nbW - 2)
            y0 = torch.clamp(torch.floor(py), 0, nbH - 2)
            fx = torch.clamp(px - x0, 0.0, 1.0).to(self.dtype)
            fy = torch.clamp(py - y0, 0.0, 1.0).to(self.dtype)
            idx = (y0 * nbW + x0).long().reshape(c1 - c0, -1)
            g = self.nb[c0:c1].reshape(c1 - c0, -1)

            def at(o):
                return torch.gather(g, 1, idx + o).reshape(fx.shape)

            warped = (at(0) * (1 - fy) * (1 - fx) + at(1) * (1 - fy) * fx
                      + at(nbW) * fy * (1 - fx) + at(nbW + 1) * fy * fx)
            inside = ((px >= 0) & (px < nbW - 1) & (py >= 0)
                      & (py < nbH - 1) & (Xn[2] > 0))
            valid = torch.all(inside, dim=1)
            wmean = torch.mean(warped, dim=1)
            wvar = torch.mean(warped ** 2, dim=1) - wmean ** 2
            cov = torch.mean(warped * ref_patch, dim=1) - wmean * ref_mean
            ncc = cov / torch.sqrt(torch.clamp(ref_var * wvar,
                                               min=MIN_PATCH_VARIANCE ** 2))
            s, n = torch.max(torch.where(valid, ncc, -1.0), dim=0)
            n = n.to(torch.int32) + c0
            if best is None:
                best, arg = s, n
            else:
                better = s > best
                best = torch.where(better, s, best)
                arg = torch.where(better, n, arg)
        depth = z[P2 // 2]
        off = (depth <= self.min_depth) | (depth >= self.max_depth)
        return torch.where(off, -1.0, best), arg, depth


def patch_match(shot: Shot, iterations: int):
    """(depth, plane nu, score, neighbour index) as numpy, before the
    correlation threshold."""
    H, W, dev, dt = shot.H, shot.W, shot.device, shot.dtype
    rng = np.random.default_rng(SEED)
    depth0 = np.exp(rng.uniform(np.log(shot.min_depth), np.log(shot.max_depth),
                                size=(H, W))).astype(np.float32)
    normal0 = np.stack([rng.uniform(-1, 1, size=(H, W)),
                        rng.uniform(-1, 1, size=(H, W)),
                        -np.ones((H, W))], axis=-1).astype(np.float32)
    X0 = shot.rays_host * depth0[..., None]
    ndotX = np.einsum("hwc,hwc->hw", normal0, X0)
    nu0 = normal0 / np.where(np.abs(ndotX) > 1e-9, ndotX, 1e-9)[..., None]
    nu = torch.as_tensor(nu0, dtype=torch.float32, device=dev).to(dt)
    nu = nu.reshape(-1, 3)
    every = torch.arange(H * W, device=dev)
    score, nghbr, depth = shot.score(nu, every)
    state = [nu, depth, score, nghbr]
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    for _ in range(iterations):
        for parity in (0, 1):
            noise_d = ((0.02 * (0.3 ** np.arange(N_RANDOM)))[:, None, None]
                       * rng.standard_normal((N_RANDOM, H, W)))
            noise_n = ((0.5 * (0.8 ** np.arange(N_RANDOM)))[:, None, None, None]
                       * rng.standard_normal((N_RANDOM, 2, H, W)))
            nd = torch.as_tensor(noise_d, dtype=torch.float32,
                                 device=dev).to(dt).reshape(N_RANDOM, -1)
            nn = torch.as_tensor(noise_n, dtype=torch.float32,
                                 device=dev).to(dt).reshape(N_RANDOM, 2, -1)
            pix = torch.nonzero((((ys + xs) % 2) == parity).reshape(-1))[:, 0]
            cur = [a[pix] for a in state]

            def consider(cand):
                s, n, d = shot.score(cand, pix)
                ok = s > cur[2]
                cur[0] = torch.where(ok[:, None], cand, cur[0])
                cur[1] = torch.where(ok, d, cur[1])
                cur[2] = torch.where(ok, s, cur[2])
                cur[3] = torch.where(ok, n, cur[3])

            for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
                full = state[0].clone()
                full[pix] = cur[0]
                rolled = torch.roll(full.reshape(H, W, 3), shift, dims=axis)
                consider(rolled.reshape(-1, 3)[pix])
            rays = shot.rays.reshape(-1, 3)[pix]
            for k in range(N_RANDOM):
                d_new = cur[1] * torch.exp(nd[k, pix])
                nz = _nz(cur[0][:, 2])
                nx = -cur[0][:, 0] / nz + nn[k, 0, pix]
                ny = -cur[0][:, 1] / nz + nn[k, 1, pix]
                n_vec = torch.stack([nx, ny, -torch.ones_like(nx)], dim=-1)
                X = rays * d_new[:, None]
                consider(n_vec / _nz(_dot(n_vec, X))[:, None])
            for a, part in zip(state, cur):
                a[pix] = part
    nu, depth, score, nghbr = state
    bad = shot.var < MIN_PATCH_VARIANCE
    depth = torch.where(bad, 0.0, depth)
    score = torch.where(bad, -1.0, score)
    out = [x.reshape(H, W, *x.shape[1:]) for x in (depth, nu, score, nghbr)]
    return [x.float().cpu().numpy() if x.is_floating_point()
            else x.cpu().numpy() for x in out]


def depthmap(rgbs: Dict[int, np.ndarray], shot: int, nbrs: List[int],
             focal: float, R: np.ndarray, t: np.ndarray, centres: np.ndarray,
             points: np.ndarray, settings: Dict, dtype, device):
    """The raw depthmap OpenSfM saves for view `shot` with neighbours
    `nbrs` (the shot first): depth (zero under the correlation
    threshold), plane, score and neighbour index."""
    width = int(settings["depthmap_resolution"])
    g = {v: scaled_grey(rgbs[v], width, device) for v in nbrs}
    lo, hi = depth_range(points, R[shot], centres[shot])
    sh = Shot(g[shot], [g[v] for v in nbrs[1:]], focal, R[shot], t[shot],
              [R[v] for v in nbrs[1:]], [t[v] for v in nbrs[1:]],
              [focal] * (len(nbrs) - 1), lo, hi,
              int(settings["depthmap_patch_size"]), dtype, device)
    depth, nu, score, nghbr = patch_match(
        sh, int(settings["depthmap_patchmatch_iterations"]))
    depth = depth * (score > settings["depthmap_min_correlation_score"])
    return depth, nu, score, nghbr


def disagreement(a, b, rtol: float) -> float:
    """Share of the pixels at which two raw depthmaps (depth, plane,
    score, best neighbour's name) differ: depth or plane by more than
    `rtol` of b's, score by more than `rtol`, or another neighbour.  A
    value that is not finite differs."""
    da, pa, sa, na = (np.asarray(x) for x in a)
    db, pb, sb, nb = (np.asarray(x) for x in b)
    same = np.abs(da - db) <= rtol * np.abs(db)
    same &= (np.max(np.abs(pa - pb), -1)
             <= rtol * np.max(np.abs(pb), -1))
    same &= np.abs(sa - sb) <= rtol
    same &= na == nb
    return float(1.0 - np.mean(same))
