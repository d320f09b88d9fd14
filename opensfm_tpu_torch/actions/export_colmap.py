"""Export the reconstruction to the COLMAP text model format (cameras.txt,
images.txt, points3D.txt).

Port of `opensfm_tpu.actions.export_colmap` (reference
`opensfm/actions/export_colmap.py`); host text, the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.features import denormalized_image_coordinates


def _colmap_camera(camera):
    """(model_name, params) per COLMAP conventions."""
    w, h = camera.width, camera.height
    size = max(w, h)
    f = camera.focal * size if hasattr(camera, "focal") else size
    cx, cy = w / 2.0, h / 2.0
    pt = camera.projection_type
    if pt == "perspective":
        return "RADIAL", [f, cx, cy, camera.k1, camera.k2]
    if pt == "simple_radial":
        return "SIMPLE_RADIAL", [f, cx, cy, camera.k1]
    if pt == "brown":
        return "FULL_OPENCV", [
            camera.focal * size, camera.focal * camera.aspect_ratio * size,
            cx + camera.cx * size, cy + camera.cy * size,
            camera.k1, camera.k2, camera.p1, camera.p2, camera.k3, 0.0, 0.0, 0.0,
        ]
    if pt == "fisheye":
        return "RADIAL_FISHEYE", [f, cx, cy, camera.k1, camera.k2]
    return "SIMPLE_PINHOLE", [f, cx, cy]


def _quaternion(R: np.ndarray) -> list:
    """Rotation matrix -> quaternion (w, x, y, z), COLMAP's convention."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return [s / 4, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s]
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = [0.0] * 4
    q[0] = (R[k, j] - R[j, k]) / s
    q[i + 1] = s / 4
    q[j + 1] = (R[j, i] + R[i, j]) / s
    q[k + 1] = (R[k, i] + R[i, k]) / s
    return q


def run_dataset(data, binary: bool = False, device=None) -> None:
    """Write the first reconstruction to `colmap_export/` (host text;
    `device` is resolved as every entry point resolves it)."""
    resolve_device(device)
    export_path = os.path.join(data.data_path, "colmap_export")
    os.makedirs(export_path, exist_ok=True)
    reconstructions = data.load_reconstruction()
    if not reconstructions:
        return
    rec = reconstructions[0]

    camera_ids = {cid: i + 1 for i, cid in enumerate(rec.cameras)}
    with open(os.path.join(export_path, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cid, camera in rec.cameras.items():
            model, params = _colmap_camera(camera)
            f.write(
                f"{camera_ids[cid]} {model} {camera.width} {camera.height} "
                + " ".join(f"{p:.12g}" for p in params) + "\n"
            )

    point_ids = {pid: i + 1 for i, pid in enumerate(rec.points)}
    image_ids = {sid: i + 1 for i, sid in enumerate(rec.shots)}

    with open(os.path.join(export_path, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                "CAMERA_ID, NAME then POINTS2D[]\n")
        for sid, shot in rec.shots.items():
            q = _quaternion(shot.pose.get_rotation_matrix())
            t = shot.pose.translation
            f.write(
                f"{image_ids[sid]} "
                + " ".join(f"{v:.12g}" for v in q)
                + " " + " ".join(f"{v:.12g}" for v in t)
                + f" {camera_ids[shot.camera.id]} {sid}\n"
            )
            obs_entries = []
            for lm_id, obs in shot.get_landmark_observations().items():
                px = denormalized_image_coordinates(
                    obs.point[None], shot.camera.width, shot.camera.height
                )[0]
                obs_entries.append(
                    f"{px[0]:.6f} {px[1]:.6f} {point_ids.get(lm_id, -1)}"
                )
            f.write(" ".join(obs_entries) + "\n")

    with open(os.path.join(export_path, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid, point in rec.points.items():
            c = point.coordinates
            col = point.color
            track_entries = []
            for sid in point.get_observations():
                if sid in image_ids:
                    track_entries.append(f"{image_ids[sid]} -1")
            f.write(
                f"{point_ids[pid]} {c[0]:.12g} {c[1]:.12g} {c[2]:.12g} "
                f"{int(col[0])} {int(col[1])} {int(col[2])} 0.0 "
                + " ".join(track_entries) + "\n"
            )
