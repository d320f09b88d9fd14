"""Export to the PMVS format: visualize/ JPEGs, txt/ projection matrices,
models/ and the options file.

Port of `opensfm_tpu.actions.export_pmvs` (reference
`opensfm/actions/export_pmvs.py`): the JPEGs are written by the port's own
codec (`io.imwrite`), which writes cv2.imwrite's bytes at its defaults.
"""

from __future__ import annotations

import logging
import os

from opensfm_tpu_torch import io, resolve_device

logger = logging.getLogger(__name__)


def run_dataset(data, points=False, image_list=None, output=None,
                device=None) -> None:
    """Write the first reconstruction's perspective shots to `pmvs/` (host
    code; `device` is resolved as every entry point resolves it)."""
    resolve_device(device)
    base = output or os.path.join(data.data_path, "pmvs")
    os.makedirs(os.path.join(base, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(base, "txt"), exist_ok=True)
    os.makedirs(os.path.join(base, "models"), exist_ok=True)

    reconstructions = data.load_reconstruction()
    if not reconstructions:
        return
    rec = reconstructions[0]

    index = 0
    for shot_id, shot in rec.shots.items():
        cam = shot.camera
        if cam.projection_type not in ("perspective", "brown", "radial",
                                       "simple_radial"):
            continue
        try:
            image = data.load_image(shot_id)
        except IOError:
            continue
        # P = K [R|t] in pixel conventions.
        P = cam.get_K_in_pixel_coordinates() @ shot.pose.get_Rt()
        io.imwrite(os.path.join(base, "visualize", "%08d.jpg" % index), image)
        with open(os.path.join(base, "txt", "%08d.txt" % index), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
        index += 1

    with open(os.path.join(base, "pmvs_options.txt"), "w") as f:
        f.write("level 1\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n")
        f.write("CPU 8\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n")
        f.write("timages -1 0 %d\noimages 0\n" % index)
    logger.info("Exported %d images to PMVS at %s", index, base)
