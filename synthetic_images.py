"""Rendered image datasets for the port's chain from images.

`write_image_dataset` renders views on a circle looking inward at a
non-planar textured scene (two boxes on a ground plane, each face with its
own multi-octave value-noise texture and shade; optionally ringed by four
textured walls) with torch on a device,
from a seed, and writes them as PNGs with an eXIf chunk (Make, Model,
FocalLengthIn35mmFilm, a capture time and GPS with noise) by its own PNG
and EXIF writers, so neither OpenCV nor PIL is needed.  It returns the true
camera centres; `grade_reconstruction` holds a
reconstruction's camera centres against them after a similarity fit.  Views
may be rendered through any camera model (`cameras.bearing`) and as rig
instances of several cameras, with the overrides that give each camera
key its model.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import yaml

GPS_ORIGIN = (52.519, 13.401, 30.0)
MAKE, MODEL = "Synthetic", "Renderer 1"
FOCAL_35MM = 28  # mm: focal ratio 28 / 36 of the larger image side
# Boxes [x0, x1, y0, y1, z0, z1] on the ground plane z = 0.
BOXES = np.array([[-1.5, 1.5, -1.0, 1.0, 0.0, 2.0],
                  [1.2, 2.4, 0.8, 2.2, 0.0, 1.0]])
GROUND_EXTENT = 14.0  # m: the ground plane spans [-E, E]^2, sky beyond
WALL_HEIGHT, WALL_THICKNESS = 5.0, 0.2  # m, of the optional walls
TEXTURE_CYCLES = (0.5, 1.0, 2.0, 4.0, 8.0)  # per metre, one octave each
TEXTURE_GRID = 64  # noise grid cells per octave (the texture wraps)
SUPERSAMPLE = 2  # rays per pixel along each axis
GPS_NOISE = 0.5  # m, standard deviation of the EXIF positions


def view_poses(n_views: int, step_deg: Optional[float] = None,
               radius: float = 8.0, height: float = 3.0,
               target=(0.0, 0.0, 0.6)) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(R world-to-camera, centre) of `n_views` cameras on a circle,
    `step_deg` apart (evenly around the whole circle by default), each
    looking at `target` (x right, y down, z forward)."""
    step = 2 * np.pi / n_views if step_deg is None else np.radians(step_deg)
    out = []
    for i in range(n_views):
        a = step * i
        c = np.array([radius * np.cos(a), radius * np.sin(a), height])
        z = np.asarray(target) - c
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        out.append((np.stack([x, np.cross(z, x), z]), c))
    return out


# Camera models of the renders, normalized units (`cameras.PARAMS` order),
# focal FOCAL_35MM / 36 as the EXIF says, every distortion term away from
# zero.
CAMERA_MODELS = {
    "brown": ("brown", (-0.05, 0.01, 0.001, 0.001, -0.0005, FOCAL_35MM / 36.0,
                        1.0, 0.005, -0.003)),
    "fisheye_opencv": ("fisheye_opencv", (-0.02, 0.003, 0.0005, -0.0001,
                                          FOCAL_35MM / 36.0, 1.0, -0.004,
                                          0.002)),
}
# A stereo rig: a brown camera on the left and a fisheye_opencv camera on
# the right, 0.4 m apart, both facing the view direction.
RIG = [("left", CAMERA_MODELS["brown"], -0.2),
       ("right", CAMERA_MODELS["fisheye_opencv"], 0.2)]


def _noise_grids(seed: int, n_surfaces: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.0, 1.0, (n_surfaces, len(TEXTURE_CYCLES),
                                TEXTURE_GRID, TEXTURE_GRID))
    return torch.as_tensor(g, dtype=torch.float32, device=device)


def _texture(grids: torch.Tensor, surface: torch.Tensor, u: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """Sum over octaves of bilinear value noise at (u, v) metres."""
    n = TEXTURE_GRID
    out = torch.zeros_like(u)
    for o, cycles in enumerate(TEXTURE_CYCLES):
        gu, gv = u * cycles, v * cycles
        iu, iv = torch.floor(gu), torch.floor(gv)
        fu, fv = gu - iu, gv - iv
        iu = iu.long() % n
        iv = iv.long() % n
        g = grids[:, o].reshape(-1)
        base = surface * n * n

        def at(a, b):
            return g[base + (a % n) * n + (b % n)]

        val = ((1 - fu) * (1 - fv) * at(iu, iv) + fu * (1 - fv) * at(iu + 1, iv)
               + (1 - fu) * fv * at(iu, iv + 1) + fu * fv * at(iu + 1, iv + 1))
        out = out + val / cycles ** 0.35
    return out


def scene_boxes(walls: Optional[float] = None) -> np.ndarray:
    """BOXES, and with `walls` four WALL_HEIGHT walls (thin boxes) whose
    inner faces stand `walls` metres from the origin along x and y."""
    if walls is None:
        return BOXES
    d, t = float(walls), WALL_THICKNESS
    ring = [[d, d + t, -d - t, d + t], [-d - t, -d, -d - t, d + t],
            [-d, d, d, d + t], [-d, d, -d - t, -d]]
    return np.concatenate([BOXES, [r + [0.0, WALL_HEIGHT] for r in ring]])


def render_view(R: np.ndarray, centre: np.ndarray, width: int, height: int,
                seed: int = 0, device="cpu",
                walls: Optional[float] = None,
                camera: Optional[Tuple[str, Tuple[float, ...]]] = None
                ) -> np.ndarray:
    """[height, width, 3] uint8 RGB of the scene (`scene_boxes(walls)`)
    from camera (R, centre), ray-cast on `device` with SUPERSAMPLE^2 rays
    per pixel: pinhole rays of focal FOCAL_35MM / 36, or with `camera`
    (projection type, parameters in `cameras.PARAMS` order, normalized
    units) each ray is that model's bearing of its normalized image
    coordinates (`cameras.bearing(..., xp=torch)`)."""
    dev = torch.device(device)
    ss = SUPERSAMPLE
    size = max(width, height)
    focal = FOCAL_35MM / 36.0
    js, is_ = torch.meshgrid(
        (torch.arange(height * ss, device=dev, dtype=torch.float64) + 0.5) / ss,
        (torch.arange(width * ss, device=dev, dtype=torch.float64) + 0.5) / ss,
        indexing="ij")
    if camera is None:
        xn = (is_ - width / 2.0) / size / focal
        yn = (js - height / 2.0) / size / focal
        d_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    else:
        from opensfm_tpu_torch.geometry import cameras

        uv = torch.stack([(is_ - width / 2.0) / size,
                          (js - height / 2.0) / size], dim=-1)
        params = torch.as_tensor(camera[1], dtype=torch.float64, device=dev)
        d_cam = cameras.bearing(camera[0], uv, params, xp=torch)
    Rt = torch.as_tensor(R, dtype=torch.float64, device=dev)
    d = d_cam @ Rt  # world directions (R^T d_cam), not normalized
    c = torch.as_tensor(centre, dtype=torch.float64, device=dev)
    inf = torch.full(d.shape[:-1], float("inf"), dtype=torch.float64,
                     device=dev)

    # Ground plane.
    t_best = torch.where(d[..., 2] < -1e-12, -c[2] / d[..., 2], inf)
    p = c + t_best[..., None] * d
    outside = (p[..., 0].abs() > GROUND_EXTENT) | (p[..., 1].abs() > GROUND_EXTENT)
    t_best = torch.where(outside, inf, t_best)
    surface = torch.zeros(d.shape[:-1], dtype=torch.long, device=dev)
    # Boxes (slab test): surface 1 + 3 * box + axis of the entry face.
    boxes = scene_boxes(walls)
    for b, box in enumerate(boxes):
        lo = torch.as_tensor(box[0::2], dtype=torch.float64, device=dev)
        hi = torch.as_tensor(box[1::2], dtype=torch.float64, device=dev)
        inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        t0, t1 = (lo - c) * inv, (hi - c) * inv
        tmin, tmax = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t_near, axis = tmin.max(dim=-1)
        t_far = tmax.min(dim=-1).values
        hit = (t_near <= t_far) & (t_near > 0) & (t_near < t_best)
        t_best = torch.where(hit, t_near, t_best)
        surface = torch.where(hit, 1 + 3 * b + axis, surface)
    sky = torch.isinf(t_best)
    p = c + torch.where(sky, torch.zeros_like(t_best), t_best)[..., None] * d

    # Texture coordinates on each surface: the two axes along its face.
    axis = torch.where(surface == 0, torch.full_like(surface, 2),
                       (surface - 1) % 3)
    u = torch.where(axis == 0, p[..., 1], p[..., 0])
    v = torch.where(axis == 2, p[..., 1], p[..., 2])
    grids = _noise_grids(seed, 1 + 3 * len(boxes), dev)
    tex = _texture(grids, surface, u.float(), v.float())
    # The ground, then each box's three face axes; boxes alternate between
    # two shade sets and two tints (the walls continue the pattern).
    box_shades = ([0.75, 0.55, 0.9], [0.7, 0.5, 0.85])
    box_tints = ([0.8, 0.45, 0.35], [0.35, 0.5, 0.75])
    shades = [1.0] + [x for b in range(len(boxes)) for x in box_shades[b % 2]]
    tints = [[0.55, 0.5, 0.4]] + [box_tints[b % 2] for b in range(len(boxes))
                                  for _ in range(3)]
    shade = torch.tensor(shades, device=dev)[surface]
    tint = torch.tensor(tints, device=dev)[surface]
    value = (0.5 + 0.45 * torch.tanh(2.5 * tex))[..., None] \
        * shade[..., None] * tint * 1.6
    value = torch.where(sky[..., None],
                        torch.tensor([0.7, 0.8, 0.95], device=dev), value)
    rgb = value.clamp(0, 1).reshape(height, ss, width, ss, 3).mean(dim=(1, 3))
    return (rgb * 255 + 0.5).to(torch.uint8).cpu().numpy()


def _tiff_ifd(entries, offset: int) -> Tuple[bytes, bytes]:
    """(IFD bytes, its out-of-line data) of `entries` [(tag, type, count,
    payload bytes)], little-endian, the IFD placed at `offset`."""
    n = len(entries)
    data_at = offset + 2 + 12 * n + 4
    ifd, extra = struct.pack("<H", n), b""
    for tag, typ, count, payload in sorted(entries):
        if len(payload) <= 4:
            ifd += struct.pack("<HHL", tag, typ, count) + payload.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHLL", tag, typ, count, data_at + len(extra))
            extra += payload + b"\0" * (len(payload) % 2)
    return ifd + struct.pack("<L", 0), extra


def _ascii(tag, text):
    b = text.encode() + b"\0"
    return (tag, 2, len(b), b)


def _rationals(tag, values, den=10000):
    nums = [(int(round(v * den)), den) for v in values]
    return (tag, 5, len(nums), b"".join(struct.pack("<LL", *r) for r in nums))


def _dms(deg: float) -> List[float]:
    deg = abs(deg)
    d = int(deg)
    m = int((deg - d) * 60)
    return [d, m, (deg - d - m / 60.0) * 3600.0]


def exif_tiff(lat: float, lon: float, alt: float, capture: str,
              model: str = MODEL) -> bytes:
    """A little-endian TIFF EXIF block: Make, Model, the Exif IFD
    (FocalLengthIn35mmFilm, DateTimeOriginal) and the GPS IFD."""
    exif_entries = [(0xA405, 3, 1, struct.pack("<H", FOCAL_35MM)),
                    _ascii(0x9003, capture)]
    gps_entries = [
        (0x0000, 1, 4, b"\x02\x02\x00\x00"),
        _ascii(0x0001, "N" if lat >= 0 else "S"), _rationals(0x0002, _dms(lat)),
        _ascii(0x0003, "E" if lon >= 0 else "W"), _rationals(0x0004, _dms(lon)),
        (0x0005, 1, 1, b"\x00"), _rationals(0x0006, [max(alt, 0.0)], 1000),
        _rationals(0x000B, [5.0], 10),
    ]
    ifd0 = [_ascii(0x010F, MAKE), _ascii(0x0110, model),
            (0x8769, 4, 1, b""), (0x8825, 4, 1, b"")]
    # Lay out: header, IFD0 (+ data), Exif IFD (+ data), GPS IFD (+ data).
    ifd0_len = 2 + 12 * len(ifd0) + 4
    _, data0 = _tiff_ifd([e for e in ifd0 if e[3]], 8)
    exif_at = 8 + ifd0_len + len(data0)
    exif_ifd, exif_data = _tiff_ifd(exif_entries, exif_at)
    gps_at = exif_at + len(exif_ifd) + len(exif_data)
    gps_ifd, gps_data = _tiff_ifd(gps_entries, gps_at)
    ifd0 = [e if e[3] else (e[0], 4, 1, struct.pack(
        "<L", exif_at if e[0] == 0x8769 else gps_at)) for e in ifd0]
    ifd0_bytes, data0 = _tiff_ifd(ifd0, 8)
    return (b"II*\0" + struct.pack("<L", 8) + ifd0_bytes + data0 + exif_ifd
            + exif_data + gps_ifd + gps_data)


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray, exif: Optional[bytes] = None) -> None:
    """An 8-bit RGB PNG, rows Sub-filtered, with an optional eXIf chunk."""
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3).astype(np.int16)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]
    raw = np.concatenate([np.ones((h, 1), np.uint8),
                          (sub & 255).astype(np.uint8)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + (_png_chunk(b"eXIf", exif) if exif else b"")
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def camera_key(model: str, width: int, height: int) -> str:
    """The camera id `extract_metadata` gives a render's EXIF (Make, Model,
    size, perspective, FOCAL_35MM / 36): the key of its camera model
    override."""
    from opensfm_tpu_torch import exif

    return exif.camera_id_(MAKE, model, width, height, "perspective",
                           FOCAL_35MM / 36.0)


def write_image_dataset(path: str, n_views: int = 16, width: int = 2048,
                        height: int = 1536, seed: int = 0, device="cpu",
                        step_deg: Optional[float] = None,
                        config: Optional[Dict[str, Any]] = None,
                        walls: Optional[float] = None,
                        camera: Optional[Tuple[str, Tuple[float, ...]]] = None,
                        rig: Optional[List[Tuple[str, Tuple[str, Tuple[float, ...]],
                                                 float]]] = None
                        ) -> Dict[str, Any]:
    """Render `n_views` views (`view_poses`) of `scene_boxes(walls)` into
    `path`/images as PNGs with EXIF (GPS with GPS_NOISE metres of noise)
    and write `config.yaml` (`config` over the defaults).  Returns
    {"centres": {image: true centre}}.

    `camera` (projection type, parameters) renders through that model and
    writes `camera_models_overrides.json`, which gives the EXIF's camera
    its true model.  `rig` [(name, camera, offset in metres along the view's
    x axis)] renders each view as a rig instance of one image per rig
    camera, `view_<i>_<name>.png` with EXIF Model `<MODEL> <name>` (one
    camera key per rig camera, each overridden with its model); the truth
    then also holds {"rig_cameras": {name: (rotation, translation)}}, the
    instance-to-camera poses of a frame at the view's pose, and
    `rig_patterns` {name: regex} for `create_rig pattern`."""
    from opensfm_tpu_torch import geo, io
    from opensfm_tpu_torch.geometry.cameras import Camera

    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(config or {}), f)
    ref = geo.TopocentricConverter(*GPS_ORIGIN)
    rng = np.random.default_rng(seed + 1)
    truth: Dict[str, Any] = {"centres": {}}
    members = ([(None, camera, 0.0)] if rig is None else rig)
    overrides = {}
    for name, model_cam, _ in members:
        if model_cam is None:
            continue
        model = MODEL if name is None else f"{MODEL} {name}"
        override = Camera(model_cam[0], model_cam[1])
        override.id = camera_key(model, width, height)
        override.width, override.height = width, height
        overrides[override.id] = override
    if rig is not None:
        truth["rig_cameras"] = {name: (np.zeros(3), np.array([-off, 0.0, 0.0]))
                                for name, _, off in rig}
        truth["rig_patterns"] = {name: f"_{name}" for name, _, _ in rig}
    for i, (R, c) in enumerate(view_poses(n_views, step_deg)):
        gps_c = c + rng.normal(0, GPS_NOISE, 3)
        for name, model_cam, off in members:
            image = (f"view_{i:03d}.png" if name is None
                     else f"view_{i:03d}_{name}.png")
            centre = c + off * R[0]
            rgb = render_view(R, centre, width, height, seed=seed,
                              device=device, walls=walls, camera=model_cam)
            lat, lon, alt = ref.to_lla(*(gps_c + off * R[0]))
            write_png(os.path.join(path, "images", image), rgb,
                      exif_tiff(lat, lon, alt, f"2024:05:01 12:{i // 60:02d}:"
                                               f"{i % 60:02d}",
                                model=MODEL if name is None
                                else f"{MODEL} {name}"))
            truth["centres"][image] = centre
    if overrides:
        with open(os.path.join(path, "camera_models_overrides.json"),
                  "w") as f:
            io.json_dump(io.cameras_to_json(overrides), f)
    return truth


def write_true_reconstruction(path: str, n_views: int, width: int,
                              height: int, step_deg: Optional[float] = None,
                              camera: Optional[Tuple[str, Tuple[float, ...]]]
                              = None, n_points: int = 400, seed: int = 0
                              ) -> None:
    """Write `reconstruction.json` and `tracks.csv` for the views
    `write_image_dataset(path, n_views, width, height, step_deg=step_deg,
    camera=camera)` rendered: every view at its true pose with its true
    camera (`camera`, or the pinhole of focal FOCAL_35MM / 36), and
    `n_points` points on the ground and the boxes' tops, each observed
    where it projects into a view (occlusion is not checked), so that no
    matching needs to run."""
    from opensfm_tpu_torch import pymap, types
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.geometry.cameras import Camera
    from opensfm_tpu_torch.geometry.pose import Pose

    ptype, params = camera or ("perspective", (0.0, 0.0, FOCAL_35MM / 36.0))
    cam = Camera(ptype, params)
    cam.id = camera_key(MODEL, width, height)
    cam.width, cam.height = width, height
    rec = types.Reconstruction()
    rec.add_camera(cam)
    rng = np.random.default_rng(seed)
    n_top = n_points // 4
    pts = np.column_stack([rng.uniform(-3.0, 3.0, (n_points - n_top, 2)),
                           np.zeros(n_points - n_top)])
    top = BOXES[rng.integers(0, len(BOXES), n_top)]
    pts = np.concatenate([pts, np.column_stack([
        rng.uniform(top[:, 0], top[:, 1]), rng.uniform(top[:, 2], top[:, 3]),
        top[:, 5]])])
    tracks = pymap.TracksManager()
    for i, (R, c) in enumerate(view_poses(n_views, step_deg)):
        image = f"view_{i:03d}.png"
        pose = Pose()
        pose.set_rotation_matrix(R)
        pose.set_origin(c)
        shot = rec.create_shot(image, cam.id, pose)
        uv = shot.project_many(pts)
        in_front = (pts - c) @ R[2] > 0
        half = np.array([width, height]) / 2.0 / max(width, height)
        seen = in_front & np.all(np.abs(uv) < half, axis=1)
        for j in np.flatnonzero(seen):
            tracks.add_observation(image, str(j), pymap.Observation(
                uv[j, 0], uv[j, 1], 0.004, 128, 128, 128, int(j)))
    for j, p in enumerate(pts):
        rec.create_point(str(j), p)
    data = DataSet(path)
    data.save_reconstruction([rec])
    data.save_tracks_manager(tracks)


def grade_reconstruction(reconstructions, truth: Dict[str, Any],
                         tracks_manager=None) -> Dict[str, Any]:
    """The largest reconstruction's shots, the number of reconstructions,
    its camera-centre RMS after the similarity (Umeyama) that best maps
    them onto the true centres (metres), that similarity (x_true = scale *
    rotation @ x + translation), and, with
    `tracks_manager`, its
    reprojection RMS in pixels of the larger image side over the track
    observations within 0.006 (normalized units, as
    `synthetic_bundle.grade_reconstruction`) of their projection."""
    import synthetic_bundle as sb

    rec = max(reconstructions, key=lambda r: len(r.shots))
    ids = sorted(rec.shots)
    est = np.array([rec.shots[s].pose.get_origin() for s in ids])
    true = np.array([truth["centres"][s] for s in ids])
    me, mt = est.mean(0), true.mean(0)
    e, t = est - me, true - mt
    U, S, Vt = np.linalg.svd(t.T @ e / len(ids))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    Rf = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / np.mean(np.sum(e * e, axis=1))
    d = scale * e @ Rf.T - t
    out = {"shots": len(ids), "reconstructions": len(reconstructions),
           "points": len(rec.points),
           "centre_rms": float(np.sqrt(np.mean(np.sum(d * d, axis=1)))),
           "scale": float(scale), "rotation": Rf.tolist(),
           "translation": (mt - scale * Rf @ me).tolist()}
    if tracks_manager is not None:
        cam = next(iter(rec.cameras.values()))
        size = max(cam.width, cam.height)
        out["reprojection_rms_px"] = sb.reprojection_rms(
            rec, tracks_manager, max_error=0.006) * size
    return out


def scene_distance(points: np.ndarray,
                   walls: Optional[float] = None) -> np.ndarray:
    """Distance (m) of each of `points` [K, 3] to the nearest surface of
    the rendered scene: the ground square [-GROUND_EXTENT, GROUND_EXTENT]^2
    at z = 0 and the faces of `scene_boxes(walls)`, computed analytically
    (a point inside a box is as far from it as from its nearest face)."""
    p = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    out = np.sqrt(np.sum(np.maximum(np.abs(p[:, :2]) - GROUND_EXTENT, 0.0)
                         ** 2, axis=1) + p[:, 2] ** 2)
    for box in scene_boxes(walls):
        lo, hi = box[0::2], box[1::2]
        outside = np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0.0),
                                 axis=1)
        inside = np.min(np.minimum(p - lo, hi - p), axis=1)
        out = np.minimum(out, np.where(inside > 0, inside, outside))
    return out


def grade_point_cloud(points: np.ndarray, grade: Dict[str, Any],
                      walls: Optional[float] = None) -> Dict[str, Any]:
    """A dense point cloud in the reconstruction's frame, mapped to the
    truth's by `grade_reconstruction`'s similarity: its point count and
    the median and 90th-percentile distance (m) to the nearest scene
    surface (`scene_distance`)."""
    p = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if not len(p):
        return {"points": 0, "median_m": None, "p90_m": None}
    mapped = (grade["scale"] * p @ np.asarray(grade["rotation"]).T
              + np.asarray(grade["translation"]))
    d = scene_distance(mapped, walls)
    return {"points": int(len(p)), "median_m": float(np.median(d)),
            "p90_m": float(np.quantile(d, 0.9))}


def rig_reading(rig_cameras) -> Tuple[float, float]:
    """(baseline m, relative rotation rad) between the rig cameras "left"
    and "right" of RIG."""
    a, b = (rig_cameras[n].pose for n in ("left", "right"))
    rel = b.compose(a.inverse())
    return (float(np.linalg.norm(rel.get_origin())),
            float(np.linalg.norm(rel.rotation)))
