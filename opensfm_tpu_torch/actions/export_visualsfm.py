"""Export to the VisualSfM NVM format.

Port of `opensfm_tpu.actions.export_visualsfm` (reference
`opensfm/actions/export_visualsfm.py`): host text, the same bytes, with
every shot's quaternion from the port's rotation module, in one float64
batch on `device`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.features import denormalized_image_coordinates
from opensfm_tpu_torch.geometry.rotation import matrix_to_quat


def run_dataset(data, points: bool = True, image_list=None,
                device=None) -> None:
    """Write the first reconstruction as `reconstruction.nvm`."""
    dev = resolve_device(device)
    reconstructions = data.load_reconstruction()
    tracks_manager = data.load_tracks_manager() if data.tracks_exists() else None
    if not reconstructions:
        return
    rec = reconstructions[0]
    lines = ["NVM_V3", ""]
    shot_ids = list(rec.shots)
    shot_index = {sid: i for i, sid in enumerate(shot_ids)}
    lines.append(str(len(shot_ids)))
    rotations = np.array([rec.shots[sid].pose.get_rotation_matrix()
                          for sid in shot_ids], dtype=np.float64)
    quats = matrix_to_quat(torch.as_tensor(rotations.reshape(-1, 3, 3),
                                           device=dev)).cpu().numpy()
    for sid, q in zip(shot_ids, quats):
        shot = rec.shots[sid]
        cam = shot.camera
        size = max(cam.width, cam.height)
        focal = (cam.focal if hasattr(cam, "focal") else 1.0) * size
        o = shot.pose.get_origin()
        k1 = -getattr(cam, "k1", 0.0)
        lines.append(
            f"{sid}\t{focal:.10g} "
            + " ".join(f"{v:.10g}" for v in q)
            + " " + " ".join(f"{v:.10g}" for v in o)
            + f" {k1:.10g} 0"
        )
    if points and tracks_manager is not None:
        lines.append("")
        lines.append(str(len(rec.points)))
        for pid, point in rec.points.items():
            c = point.coordinates
            col = point.color
            entries = []
            for sid, obs in tracks_manager.get_track_observations(pid).items():
                if sid in shot_index:
                    cam = rec.shots[sid].camera
                    px = denormalized_image_coordinates(
                        obs.point[None], cam.width, cam.height
                    )[0]
                    x = px[0] - cam.width / 2.0
                    y = px[1] - cam.height / 2.0
                    entries.append(f"{shot_index[sid]} {obs.id} {x:.4f} {y:.4f}")
            lines.append(
                " ".join(f"{v:.10g}" for v in c)
                + f" {int(col[0])} {int(col[1])} {int(col[2])} "
                + f"{len(entries)} " + " ".join(entries)
            )
    with open(os.path.join(data.data_path, "reconstruction.nvm"), "w") as f:
        f.write("\n".join(lines) + "\n")
