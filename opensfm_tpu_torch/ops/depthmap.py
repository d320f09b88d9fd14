"""PatchMatch multi-view stereo as batched checkerboard propagation.

Copy of `opensfm_tpu.ops.depthmap` as batched torch on a device (the
reference's PatchMatch estimator, dense/src/depthmap.cc:
RandomInitialization:241, PatchMatchForwardPass/BackwardPass:288-309,
PatchMatchUpdatePixel:310-380, the plane-induced homography of
depthmap.h:25).  The sequential raster passes are red/black checkerboard
half-iterations: every pixel of one parity takes its four axis neighbours'
planes (the other parity), then six random refinements, all pixels at
once.

Planes are the reference's 3-vector nu with 1/z(q) = nu . r(q), where
r(q) = (x_n/f, y_n/f, 1) is pixel q's homogeneous ray in the reference
camera: copying nu between pixels is slanted-plane propagation, and the
plane-induced warp is z evaluated at each patch offset.

The arrays are float32, as the JAX package declares them.  A candidate's
score is taken over the neighbours in chunks (`neighbour_chunk`), so the
[chunk, P^2, pixels] temporaries of one chunk bound the peak memory.  The
launches of a half-iteration grow with its chunk count, ceil(neighbours /
chunk), and with nothing else: at 640 x 480 one chunk holds up to 10
neighbours; a larger depthmap, with fewer neighbours a chunk, takes more
chunks.  A half-iteration scores its parity's pixels only, the only ones
it may change.
The random draws come from a numpy Generator on the host, in the JAX
package's order and shapes, and are copied to the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device

# Device bytes the temporaries of one chunk of neighbours may take.
CHUNK_BUDGET_BYTES = 4 << 30
# float32 arrays of [P^2, H, W] alive per neighbour while one is scored
# (measured on the card: one shot's peak grows by 12.7 a neighbour).
_TEMPORARIES_PER_NEIGHBOUR = 14
N_RANDOM = 6  # random refinements per half-iteration
MIN_PATCH_VARIANCE = 1e-5  # the JAX package's; depthmap_min_patch_sd is unread


def neighbour_chunk(patch_points: int, height: int, width: int,
                    n_neighbours: int) -> int:
    """Neighbours scored together so that one chunk's temporaries stay
    within CHUNK_BUDGET_BYTES."""
    per = _TEMPORARIES_PER_NEIGHBOUR * 4 * patch_points * height * width
    return max(1, min(n_neighbours, CHUNK_BUDGET_BYTES // per))


def _patch_offsets(patch_size: int) -> np.ndarray:
    hp = patch_size // 2
    dys, dxs = np.mgrid[-hp : hp + 1, -hp : hp + 1]
    return np.stack([dys.ravel(), dxs.ravel()], axis=1)  # [P*P, 2]


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) > 1e-9, x, 1e-9)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of the products along the last axis (3): elementwise, so that
    its launches do not depend on the size (a batched cuBLAS product
    splits its grid by the batch count)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _score_candidate(nu, rays_off, ref_patch, ref_mean, ref_var,
                     nb_gray, R_rel, t_rel, nb_f, min_depth, max_depth,
                     min_patch_variance, chunk: Optional[int] = None):
    """Best NCC over the neighbours for the plane field nu [..., 3] (the
    pixels in any layout: [H, W] or a list [K]): (score, nghbr int32,
    depth), each of nu's pixel shape; the first neighbour wins a tie, as
    argmax does."""
    shape = nu.shape[:-1]
    P2 = ref_patch.shape[0]
    nu = nu.reshape(-1, 3)
    rays_off = rays_off.reshape(P2, -1, 3)
    ref_patch = ref_patch.reshape(P2, -1)
    ref_mean, ref_var = ref_mean.reshape(-1), ref_var.reshape(-1)
    N, nbH, nbW = nb_gray.shape
    inv_z = _dot3(rays_off, nu)  # [P2, M]
    z = 1.0 / _nonzero(inv_z)
    X = [rays_off[..., c] * z for c in range(3)]  # ref-camera patch points
    size = float(max(nbH, nbW))
    chunk = chunk or neighbour_chunk(P2, len(nu), 1, N)
    grays = nb_gray.reshape(N, -1)
    score = nghbr = None
    for c0 in range(0, N, chunk):
        c1 = min(N, c0 + chunk)
        R = R_rel[c0:c1, :, :, None, None]  # [n, 3, 3, 1, 1]
        t = t_rel[c0:c1, :, None, None]
        f = nb_f[c0:c1, None, None]
        Xn = [R[:, i, 0] * X[0] + R[:, i, 1] * X[1] + R[:, i, 2] * X[2]
              + t[:, i] for i in range(3)]  # [n, P2, M] each
        zc = _nonzero(Xn[2])
        px = f * Xn[0] / zc * size + (nbW - 1) / 2.0
        py = f * Xn[1] / zc * size + (nbH - 1) / 2.0
        x0 = torch.clamp(torch.floor(px), 0, nbW - 2)
        y0 = torch.clamp(torch.floor(py), 0, nbH - 2)
        fx = torch.clamp(px - x0, 0.0, 1.0)
        fy = torch.clamp(py - y0, 0.0, 1.0)
        idx = (y0 * nbW + x0).long().reshape(c1 - c0, -1)
        g = grays[c0:c1]

        def at(offset):
            return torch.gather(g, 1, idx + offset).reshape(fx.shape)

        warped = (at(0) * (1 - fy) * (1 - fx) + at(1) * (1 - fy) * fx
                  + at(nbW) * fy * (1 - fx) + at(nbW + 1) * fy * fx)
        inside = ((px >= 0) & (px < nbW - 1) & (py >= 0) & (py < nbH - 1)
                  & (Xn[2] > 0))
        valid = torch.all(inside, dim=1)  # the whole patch visible
        wmean = torch.mean(warped, dim=1)
        wvar = torch.mean(warped ** 2, dim=1) - wmean ** 2
        cov = torch.mean(warped * ref_patch, dim=1) - wmean * ref_mean
        ncc = cov / torch.sqrt(
            torch.clamp(ref_var * wvar, min=min_patch_variance ** 2))
        s, n = torch.max(torch.where(valid, ncc, -1.0), dim=0)
        n = n.to(torch.int32) + c0
        if score is None:
            score, nghbr = s, n
        else:  # a later chunk wins only where strictly better
            better = s > score
            score = torch.where(better, s, score)
            nghbr = torch.where(better, n, nghbr)
    depth = z[P2 // 2]  # the patch centre
    bad_depth = (depth <= min_depth) | (depth >= max_depth)
    score = torch.where(bad_depth, -1.0, score)
    return score.reshape(shape), nghbr.reshape(shape), depth.reshape(shape)


def _pm_half_iteration(state, parity, noise_d, noise_n, rays, rays_off,
                       ref_patch, ref_mean, ref_var, nb_gray, R_rel, t_rel,
                       nb_f, min_depth, max_depth, min_patch_variance):
    """One red/black half-step: the 4 axis neighbours' planes, then random
    refinements with shrinking ranges (PatchMatchUpdatePixel:310-380).
    Only the pixels of `parity` can change, so candidates are made and
    scored at those pixels alone (the JAX package scores every pixel and
    masks).  `jnp.roll` wraps around the image, so propagation reaches
    across the opposite border; the port rolls as well."""
    nu, depth, score, nghbr = state
    H, W = depth.shape
    P2 = ref_patch.shape[0]
    dev = depth.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    idx = torch.nonzero((((ys + xs) % 2) == parity).reshape(-1))[:, 0]
    at = lambda a: a.reshape(-1, *a.shape[2:])[idx]  # noqa: E731
    sub = (rays_off.reshape(P2, H * W, 3)[:, idx],
           ref_patch.reshape(P2, H * W)[:, idx], at(ref_mean), at(ref_var))
    rays_k = at(rays)

    def consider(nu_c, cur):
        s_c, n_c, d_c = _score_candidate(
            nu_c, *sub, nb_gray, R_rel, t_rel, nb_f, min_depth, max_depth,
            min_patch_variance,
        )
        ok = s_c > cur[2]
        return (torch.where(ok[:, None], nu_c, cur[0]),
                torch.where(ok, d_c, cur[1]), torch.where(ok, s_c, cur[2]),
                torch.where(ok, n_c, cur[3]))

    def scatter(full, part):  # the parity's pixels of `full` set to `part`
        flat = full.reshape(-1, *full.shape[2:]).clone()
        flat[idx] = part
        return flat.reshape(full.shape)

    cur = tuple(at(a) for a in state)
    for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        # The other parity's planes (and, across an odd border, this
        # parity's current ones).
        rolled = torch.roll(scatter(nu, cur[0]), shift, dims=axis)
        cur = consider(at(rolled), cur)
    for k in range(noise_d.shape[0]):
        d_new = cur[1] * torch.exp(at(noise_d[k]))
        nz = _nonzero(cur[0][:, 2])
        nx = -cur[0][:, 0] / nz + at(noise_n[k, 0])
        ny = -cur[0][:, 1] / nz + at(noise_n[k, 1])
        n_vec = torch.stack([nx, ny, -torch.ones_like(nx)], dim=-1)
        # nu of the perturbed (depth, normal): X = d r(q), nu = n / (n . X).
        X = rays_k * d_new[:, None]
        ndotX = _dot3(n_vec, X)
        cur = consider(n_vec / _nonzero(ndotX)[:, None], cur)
    return tuple(scatter(full, part) for full, part in zip(state, cur))


def random_init(rng: np.random.Generator, ref_rays: np.ndarray,
                min_depth: float, max_depth: float) -> np.ndarray:
    """The initial planes nu [H, W, 3] (RandomInitialization:241-260),
    from `rng`'s first draws, in the JAX package's order and arithmetic."""
    H, W = ref_rays.shape[:2]
    depth0 = np.exp(
        rng.uniform(np.log(min_depth), np.log(max_depth), size=(H, W))
    ).astype(np.float32)
    normal0 = np.stack(
        [
            rng.uniform(-1, 1, size=(H, W)),
            rng.uniform(-1, 1, size=(H, W)),
            -np.ones((H, W)),
        ],
        axis=-1,
    ).astype(np.float32)
    X0 = np.asarray(ref_rays) * depth0[..., None]
    ndotX = np.einsum("hwc,hwc->hw", normal0, X0)
    return normal0 / np.where(np.abs(ndotX) > 1e-9, ndotX, 1e-9)[..., None]


def random_refinements(rng: np.random.Generator, H: int,
                       W: int) -> Tuple[np.ndarray, np.ndarray]:
    """One half-iteration's draws (noise_d [6, H, W], noise_n [6, 2, H,
    W]) from `rng`, in the JAX package's order and scales."""
    noise_d = (
        (0.02 * (0.3 ** np.arange(N_RANDOM)))[:, None, None]
        * rng.standard_normal((N_RANDOM, H, W))
    )
    noise_n = (
        (0.5 * (0.8 ** np.arange(N_RANDOM)))[:, None, None, None]
        * rng.standard_normal((N_RANDOM, 2, H, W))
    )
    return noise_d, noise_n


def prepare(ref_gray, ref_rays, R_ref, t_ref, neighbor_grays, neighbor_Rs,
            neighbor_ts, neighbor_focals, patch_size: int, dev):
    """The device arrays of one shot: (rays, rays_off, ref_patch, ref_mean,
    ref_var, nb_gray, R_rel, t_rel, nb_f), float32."""
    H, W = ref_gray.shape
    f32 = torch.float32
    rays = torch.as_tensor(np.asarray(ref_rays), dtype=f32, device=dev)
    ref = torch.as_tensor(np.asarray(ref_gray), dtype=f32, device=dev)
    offsets = _patch_offsets(patch_size)
    ys, xs = np.mgrid[0:H, 0:W]
    oy = torch.as_tensor(np.clip(ys[None] + offsets[:, 0, None, None], 0,
                                 H - 1), device=dev)
    ox = torch.as_tensor(np.clip(xs[None] + offsets[:, 1, None, None], 0,
                                 W - 1), device=dev)
    ref_patch = ref[oy, ox]  # [P2, H, W]
    ref_mean = torch.mean(ref_patch, dim=0)
    ref_var = torch.mean(ref_patch ** 2, dim=0) - ref_mean ** 2
    rays_off = rays[oy, ox]  # [P2, H, W, 3]
    nb_gray = torch.as_tensor(np.stack(neighbor_grays), dtype=f32,
                              device=dev)
    R_rel = torch.as_tensor(
        np.stack([Rn @ R_ref.T for Rn in neighbor_Rs]), dtype=f32,
        device=dev)
    t_rel = torch.as_tensor(
        np.stack([tn - Rn @ R_ref.T @ t_ref
                  for Rn, tn in zip(neighbor_Rs, neighbor_ts)]),
        dtype=f32, device=dev)
    nb_f = torch.as_tensor(np.asarray(neighbor_focals), dtype=f32,
                           device=dev)
    return rays, (rays_off, ref_patch, ref_mean, ref_var, nb_gray, R_rel,
                  t_rel, nb_f)


def patch_match_depthmap(
    ref_gray: np.ndarray,
    ref_rays: np.ndarray,  # [H, W, 3] homogeneous rays (z = 1), cam frame
    R_ref: np.ndarray,  # [3,3] world->cam
    t_ref: np.ndarray,  # [3]
    neighbor_grays: List[np.ndarray],
    neighbor_Rs: List[np.ndarray],
    neighbor_ts: List[np.ndarray],
    neighbor_focals: List[float],
    min_depth: float,
    max_depth: float,
    iterations: int = 3,
    patch_size: int = 7,
    min_patch_variance: float = MIN_PATCH_VARIANCE,
    seed: int = 42,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (depth[H,W], plane nu [H,W,3], score[H,W], nghbr[H,W]),
    computed on `device` (CUDA unless told otherwise).  Every neighbour
    camera is perspective with a centred principal point and focal
    `neighbor_focals[i]` (units of its max(H, W)), and every neighbour grey
    has the same size, as in the JAX package."""
    dev = resolve_device(device)
    H, W = ref_gray.shape
    rng = np.random.default_rng(seed)
    rays, arrays = prepare(ref_gray, ref_rays, R_ref, t_ref, neighbor_grays,
                           neighbor_Rs, neighbor_ts, neighbor_focals,
                           patch_size, dev)
    statics = (float(min_depth), float(max_depth), float(min_patch_variance))

    nu = torch.as_tensor(random_init(rng, ref_rays, min_depth, max_depth),
                         dtype=torch.float32, device=dev)
    score, nghbr, depth = _score_candidate(nu, *arrays, *statics)

    state = (nu, depth, score, nghbr)
    for _it in range(iterations):
        for parity in (0, 1):
            noise_d, noise_n = random_refinements(rng, H, W)
            state = _pm_half_iteration(
                state, parity,
                torch.as_tensor(noise_d, dtype=torch.float32, device=dev),
                torch.as_tensor(noise_n, dtype=torch.float32, device=dev),
                rays, *arrays, *statics,
            )

    nu, depth, score, nghbr = state
    # Low-variance reference patches are unreliable (ComputeIgnoreMask:262).
    bad = arrays[3] < min_patch_variance
    depth = torch.where(bad, 0.0, depth)
    score = torch.where(bad, -1.0, score)
    return (
        depth.cpu().numpy(), nu.cpu().numpy(), score.cpu().numpy(),
        nghbr.cpu().numpy(),
    )
