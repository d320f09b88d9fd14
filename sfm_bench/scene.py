"""The benchmark's own generators: every input of a run is made here from
its seed, so the yardstick stays fixed whatever the program becomes.

`orbit_scene`: views on a circle around textured boxes on a textured
ground inside four textured walls, rendered by ray casting on a device (a
rewrite of the repository's `synthetic_images` renderer), and the sparse
map such views give: points where a view's pixels hit a surface, tracks
over the views that see them unoccluded.

Nothing here imports the program; `pngio` writes the images.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# -- rotations (numpy, f64) --------------------------------------------------


def rotvec_to_matrix(r: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation matrices [..., 3, 3] of angle-axis rows [..., 3]."""
    r = np.asarray(r, dtype=np.float64)
    theta = np.linalg.norm(r, axis=-1)[..., None, None]
    safe = np.where(theta > 1e-12, theta, 1.0)
    k = r / safe[..., 0]
    K = np.zeros(r.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    return np.where(theta > 1e-12, R, eye)


def matrix_to_rotvec(R: np.ndarray) -> np.ndarray:
    """Angle-axis row of a rotation matrix (angles below pi - 1e-6)."""
    R = np.asarray(R, dtype=np.float64)
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = math.acos(cos)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-12:
        return w / 2
    return w * theta / (2 * math.sin(theta))


def look_at(centre, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World-to-camera rotation (x right, y down, z forward) of a camera
    at `centre` looking at `target`, its x axis horizontal."""
    z = np.asarray(target, np.float64) - centre
    z /= np.linalg.norm(z)
    x = np.cross(z, up)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


# -- the orbit scene's renderer ----------------------------------------------

BOXES = np.array([[-1.5, 1.5, -1.0, 1.0, 0.0, 2.0],
                  [1.2, 2.4, 0.8, 2.2, 0.0, 1.0]])
GROUND_EXTENT = 14.0  # m: the ground spans [-E, E]^2
WALL_HEIGHT, WALL_THICKNESS = 5.0, 0.2
TEXTURE_CYCLES = (0.5, 1.0, 2.0, 4.0, 8.0)  # per metre, one octave each
TEXTURE_GRID = 64  # noise cells per octave (the texture wraps)


def scene_boxes(walls: float) -> np.ndarray:
    """BOXES and four walls whose inner faces stand `walls` m out."""
    d, t = float(walls), WALL_THICKNESS
    ring = [[d, d + t, -d - t, d + t], [-d - t, -d, -d - t, d + t],
            [-d, d, d, d + t], [-d, d, -d - t, -d]]
    return np.concatenate([BOXES, [r + [0.0, WALL_HEIGHT] for r in ring]])


def cast(c: torch.Tensor, d: torch.Tensor, boxes: np.ndarray
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First hit of rays c + t d (f64, [..., 3] each): (t, surface), t
    inf for the sky; surface 0 is the ground, 1 + 3 b + axis the face of
    box b across `axis`."""
    dev = d.device
    inf = torch.full(d.shape[:-1], float("inf"), dtype=torch.float64,
                     device=dev)
    t_best = torch.where(d[..., 2] < -1e-12, -c[..., 2] / d[..., 2], inf)
    p = c + t_best[..., None] * d
    outside = ((p[..., 0].abs() > GROUND_EXTENT)
               | (p[..., 1].abs() > GROUND_EXTENT))
    t_best = torch.where(outside, inf, t_best)
    surface = torch.zeros(d.shape[:-1], dtype=torch.long, device=dev)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    for b, box in enumerate(boxes):
        lo = torch.as_tensor(box[0::2], dtype=torch.float64, device=dev)
        hi = torch.as_tensor(box[1::2], dtype=torch.float64, device=dev)
        t0, t1 = (lo - c) * inv, (hi - c) * inv
        t_near, axis = torch.minimum(t0, t1).max(dim=-1)
        t_far = torch.maximum(t0, t1).min(dim=-1).values
        hit = (t_near <= t_far) & (t_near > 0) & (t_near < t_best)
        t_best = torch.where(hit, t_near, t_best)
        surface = torch.where(hit, 1 + 3 * b + axis, surface)
    return t_best, surface


def _texture(grids: torch.Tensor, surface: torch.Tensor, u: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """Sum over octaves of bilinear value noise at (u, v) metres."""
    n = TEXTURE_GRID
    out = torch.zeros_like(u)
    for o, cycles in enumerate(TEXTURE_CYCLES):
        gu, gv = u * cycles, v * cycles
        iu, iv = torch.floor(gu), torch.floor(gv)
        fu, fv = gu - iu, gv - iv
        iu, iv = iu.long() % n, iv.long() % n
        g = grids[:, o].reshape(-1)
        base = surface * n * n

        def at(a, b):
            return g[base + (a % n) * n + (b % n)]

        out = out + ((1 - fu) * (1 - fv) * at(iu, iv)
                     + fu * (1 - fv) * at(iu + 1, iv)
                     + (1 - fu) * fv * at(iu, iv + 1)
                     + fu * fv * at(iu + 1, iv + 1)) / cycles ** 0.35
    return out


def render_view(R: np.ndarray, centre: np.ndarray, width: int, height: int,
                focal: float, walls: float, grids: torch.Tensor,
                supersample: int) -> torch.Tensor:
    """[height, width, 3] uint8 RGB (on `grids`' device) of the scene from a
    pinhole camera (R world-to-camera, centre, focal in units of the
    larger side), `supersample`^2 rays a pixel."""
    dev = grids.device
    ss = supersample
    size = max(width, height)
    js, is_ = torch.meshgrid(
        (torch.arange(height * ss, device=dev, dtype=torch.float64) + 0.5)
        / ss,
        (torch.arange(width * ss, device=dev, dtype=torch.float64) + 0.5)
        / ss, indexing="ij")
    xn = (is_ - width / 2.0) / size / focal
    yn = (js - height / 2.0) / size / focal
    d = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1) @ torch.as_tensor(
        R, dtype=torch.float64, device=dev)
    c = torch.as_tensor(centre, dtype=torch.float64, device=dev)
    boxes = scene_boxes(walls)
    t, surface = cast(c, d, boxes)
    sky = torch.isinf(t)
    p = c + torch.where(sky, torch.zeros_like(t), t)[..., None] * d
    axis = torch.where(surface == 0, torch.full_like(surface, 2),
                       (surface - 1) % 3)
    u = torch.where(axis == 0, p[..., 1], p[..., 0])
    v = torch.where(axis == 2, p[..., 1], p[..., 2])
    tex = _texture(grids, surface, u.float(), v.float())
    box_shades = ([0.75, 0.55, 0.9], [0.7, 0.5, 0.85])
    box_tints = ([0.8, 0.45, 0.35], [0.35, 0.5, 0.75])
    shades = [1.0] + [x for b in range(len(boxes)) for x in box_shades[b % 2]]
    tints = [[0.55, 0.5, 0.4]] + [box_tints[b % 2] for b in range(len(boxes))
                                  for _ in range(3)]
    shade = torch.tensor(shades, device=dev)[surface]
    tint = torch.tensor(tints, device=dev)[surface]
    value = ((0.5 + 0.45 * torch.tanh(2.5 * tex))[..., None]
             * shade[..., None] * tint * 1.6)
    value = torch.where(sky[..., None],
                        torch.tensor([0.7, 0.8, 0.95], device=dev), value)
    rgb = value.clamp(0, 1).reshape(height, ss, width, ss, 3).mean(dim=(1, 3))
    return (rgb * 255 + 0.5).to(torch.uint8)


# -- the orbit scene ----------------------------------------------------------


def orbit_poses(n_views: int, radius: float, height: float,
                target) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(rotation vector, translation) of `n_views` cameras evenly on a
    circle, each looking at `target`."""
    out = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        c = np.array([radius * np.cos(a), radius * np.sin(a), height])
        R = look_at(c, target)
        out.append((matrix_to_rotvec(R), -R @ c))
    return out


def track_lengths(rng: np.random.Generator, n: int, mean: float,
                  lo: int, hi: int) -> np.ndarray:
    """`n` track lengths in [lo, hi] of mean `mean`: lo plus a binomial
    draw over the rest of the range."""
    return lo + rng.binomial(hi - lo, (mean - lo) / (hi - lo), n)


def orbit_scene(p: Dict, seed: int, device) -> Dict:
    """The views, the points and the tracks of an orbit capture of size
    `p` (the configuration's sizes), from `seed`.  Returns the shots'
    poses, the camera, the points [P, 3], the observations (point, view,
    x, y in normalized units, point-major: a point's views in its track's
    order) and the texture grids the renderer needs."""
    rng = np.random.default_rng(seed)
    n = p["views"]
    W, H = p["undistorted_image_size"]
    focal = p["focal"]
    poses = orbit_poses(n, p["orbit_radius"], p["orbit_height"],
                        p["target"])
    Rs = rotvec_to_matrix(np.array([r for r, _ in poses]))
    ts = np.array([t for _, t in poses])
    centres = -np.einsum("nji,nj->ni", Rs, ts)
    boxes = scene_boxes(p["walls"])
    grids = torch.as_tensor(
        rng.uniform(-1.0, 1.0, (1 + 3 * len(boxes), len(TEXTURE_CYCLES),
                                TEXTURE_GRID, TEXTURE_GRID)),
        dtype=torch.float32, device=device)

    # Candidate points: a pixel of a random view cast onto the scene.
    n_points = p["points"]
    m = 2 * n_points
    src = rng.integers(0, n, m)
    size = max(W, H)
    px = rng.uniform(0, W, m)
    py = rng.uniform(0, H, m)
    dcam = np.stack([(px - W / 2) / size / focal, (py - H / 2) / size / focal,
                     np.ones(m)], 1)
    dirs = np.einsum("mji,mj->mi", Rs[src], dcam)
    c = torch.as_tensor(centres[src], device=device)
    t, _ = cast(c, torch.as_tensor(dirs, device=device), boxes)
    t = t.cpu().numpy()
    keep = np.isfinite(t)
    X = centres[src] + t[:, None] * dirs
    X, src = X[keep], src[keep]

    # Which views see each candidate, unoccluded and in the frame.
    Xt = torch.as_tensor(X, device=device)
    seen = np.zeros((len(X), n), bool)
    uv = np.zeros((len(X), n, 2))
    for v in range(n):
        Xc = X @ Rs[v].T + ts[v]
        z = Xc[:, 2]
        xy = Xc[:, :2] / np.where(z > 1e-9, z, 1.0)[:, None] * focal
        inside = ((z > 1e-9) & (np.abs(xy[:, 0]) < W / 2 / size)
                  & (np.abs(xy[:, 1]) < H / 2 / size))
        ray = Xt - torch.as_tensor(centres[v], device=device)
        dist = torch.linalg.norm(ray, dim=1)
        th, _ = cast(torch.as_tensor(centres[v], device=device).expand_as(ray),
                     ray / dist[:, None], boxes)
        visible = (th > dist - 1e-3 * dist).cpu().numpy()
        seen[:, v] = inside & visible
        uv[:, v] = xy

    # Tracks: the source view, then the nearest seeing views round the
    # orbit, up to a drawn length.
    lengths = track_lengths(rng, len(X), p["mean_track"], p["min_track"],
                            p["max_track"])
    offsets = np.array(list(dict.fromkeys(
        [0] + [(s * k) % n for k in range(1, n // 2 + 1) for s in (1, -1)])))
    obs_point, obs_view = [], []
    kept = 0
    for j in range(len(X)):
        if kept == n_points:
            break
        order = (src[j] + offsets) % n
        views = order[seen[j, order]][:lengths[j]]
        if len(views) < p["min_track"] or views[0] != src[j]:
            continue
        obs_point.extend([kept] * len(views))
        obs_view.extend(views.tolist())
        X[kept] = X[j]
        uv[kept] = uv[j]
        kept += 1
    if kept < n_points:
        raise RuntimeError(f"only {kept} of {n_points} points are seen twice")
    obs_point = np.asarray(obs_point)
    obs_view = np.asarray(obs_view)
    return dict(
        poses=poses, R=Rs, t=ts, centres=centres, focal=focal, width=W,
        height=H, points=X[:n_points].copy(), obs_point=obs_point,
        obs_view=obs_view, obs_xy=uv[obs_point, obs_view], grids=grids,
        walls=p["walls"])
