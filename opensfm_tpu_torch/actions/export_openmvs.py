"""Export the undistorted reconstruction to the OpenMVS binary scene.

Port of `opensfm_tpu.actions.export_openmvs` (reference
actions/export_openmvs.py:10-81 and dense/openmvs_exporter.h): each
perspective camera one platform (full-pixel K), each undistorted shot a
platform pose and an image, each tracked point a vertex with its views;
the `.mvs` stream is `io_openmvs`'s, byte-equal to the JAX package's.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.io_openmvs import OpenMVSExporter

logger = logging.getLogger(__name__)


def run_dataset(data, image_list=None, device=None) -> None:
    """Write `undistorted/openmvs/scene.mvs` from the undistorted dataset
    (host code; `device` is resolved as every entry point resolves it)."""
    resolve_device(device)
    udata = data.undistorted_dataset()
    reconstructions = udata.load_undistorted_reconstruction()
    tracks_manager = udata.load_undistorted_tracks_manager()

    export_only = None
    if image_list:
        export_only = {}
        with open(image_list) as f:
            for image in f:
                export_only[image.strip()] = True

    if reconstructions:
        export(reconstructions[0], tracks_manager, udata, export_only)


def export(reconstruction, tracks_manager, udata, export_only) -> None:
    exporter = OpenMVSExporter()
    for camera in reconstruction.cameras.values():
        if camera.projection_type == "perspective":
            w, h = camera.width, camera.height
            K = np.array(
                [
                    [camera.focal * max(w, h), 0, (w - 1.0) / 2.0],
                    [0, camera.focal * max(w, h), (h - 1.0) / 2.0],
                    [0, 0, 1],
                ]
            )
            exporter.add_camera(str(camera.id), K, w, h)

    for shot in reconstruction.shots.values():
        if export_only is not None and shot.id not in export_only:
            continue
        if shot.camera.projection_type == "perspective":
            image_path = udata._undistorted_image_file(shot.id)
            mask_path = udata._fp("masks", shot.id + ".png")
            if not os.path.isfile(mask_path):
                mask_path = ""
            exporter.add_shot(
                str(os.path.abspath(image_path)),
                str(os.path.abspath(mask_path)) if mask_path else "",
                str(shot.id),
                str(shot.camera.id),
                shot.pose.get_rotation_matrix(),
                shot.pose.get_origin(),
            )

    for point in reconstruction.points.values():
        observations = tracks_manager.get_track_observations(point.id)
        if export_only is not None:
            shots = [k for k in observations if k in export_only]
        else:
            shots = list(observations)
        if shots:
            exporter.add_point(np.asarray(point.coordinates, np.float64), shots)

    out_dir = os.path.join(udata.data_path, "openmvs")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "scene.mvs")
    exporter.export(out)
    logger.info(
        "Wrote %s (%d platforms, %d images, %d vertices)",
        out, len(exporter.platforms), len(exporter.images),
        len(exporter.vertices),
    )
