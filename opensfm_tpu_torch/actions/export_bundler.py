"""Export to the Bundler format (bundle.rd.out and list.txt).

Port of `opensfm_tpu.actions.export_bundler` (reference
`opensfm/actions/export_bundler.py`); host text, the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.features import denormalized_image_coordinates


def run_dataset(data, list_path=None, bundle_path=None, undistorted=False,
                device=None) -> None:
    """Write every reconstruction to `bundler/` (host text; `device` is
    resolved as every entry point resolves it)."""
    resolve_device(device)
    bundle_dir = bundle_path or os.path.join(data.data_path, "bundler")
    list_dir = list_path or bundle_dir
    os.makedirs(bundle_dir, exist_ok=True)
    os.makedirs(list_dir, exist_ok=True)

    reconstructions = data.load_reconstruction()
    tracks_manager = data.load_tracks_manager() if data.tracks_exists() else None

    for i, rec in enumerate(reconstructions):
        shot_ids = list(rec.shots)
        shot_index = {sid: j for j, sid in enumerate(shot_ids)}
        lines = ["# Bundle file v0.3"]
        points = rec.points
        lines.append(f"{len(shot_ids)} {len(points)}")

        for sid in shot_ids:
            shot = rec.shots[sid]
            cam = shot.camera
            size = max(cam.width, cam.height)
            focal = (cam.focal if hasattr(cam, "focal") else 1.0) * size
            k1 = getattr(cam, "k1", 0.0)
            k2 = getattr(cam, "k2", 0.0)
            lines.append(f"{focal:.10g} {k1:.10g} {k2:.10g}")
            R = shot.pose.get_rotation_matrix()
            t = shot.pose.translation
            # Bundler convention: y up, z backwards.
            flip = np.diag([1.0, -1.0, -1.0])
            Rb = flip @ R
            tb = flip @ t
            for row in Rb:
                lines.append(" ".join(f"{v:.10g}" for v in row))
            lines.append(" ".join(f"{v:.10g}" for v in tb))

        for pid, point in points.items():
            c = point.coordinates
            col = point.color
            lines.append(" ".join(f"{v:.10g}" for v in c))
            lines.append(f"{int(col[0])} {int(col[1])} {int(col[2])}")
            view_entries = []
            if tracks_manager is not None:
                for sid, obs in tracks_manager.get_track_observations(pid).items():
                    if sid in shot_index:
                        cam = rec.shots[sid].camera
                        px = denormalized_image_coordinates(
                            obs.point[None], cam.width, cam.height
                        )[0]
                        # Bundler 2D coords: origin at image center, y up.
                        x = px[0] - cam.width / 2.0
                        y = cam.height / 2.0 - px[1]
                        view_entries.append(
                            f"{shot_index[sid]} {obs.id} {x:.4f} {y:.4f}"
                        )
            lines.append(f"{len(view_entries)} " + " ".join(view_entries))

        suffix = "" if i == 0 else f"_{i}"
        with open(os.path.join(bundle_dir, f"bundle{suffix}.rd.out"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(list_dir, f"list{suffix}.txt"), "w") as f:
            f.write("\n".join(shot_ids) + "\n")
