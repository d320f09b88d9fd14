"""Extract EXIF metadata and build camera models
(reference `opensfm/actions/extract_metadata.py:15-76`)."""

from __future__ import annotations

import logging
import os

from opensfm_tpu_torch import exif as exif_mod
from opensfm_tpu_torch import sensors

logger = logging.getLogger(__name__)


def run_dataset(data) -> None:
    """Extract each image's metadata from its EXIF tags into exif/ (EXIF
    overrides applied), and write camera_models.json (camera model
    overrides applied).  Host work only: the EXIF parser is the port's."""
    # Per-dataset sensor-width overrides ({"make model": width_mm}), merged
    # over the built-in table.
    data_path = getattr(data, "data_path", None)
    if data_path:
        sensors.load_extra_sensor_data(
            os.path.join(str(data_path), "sensor_data.json")
        )

    exif_overrides = (
        data.load_exif_overrides() if data.exif_overrides_exists() else {}
    )

    camera_models = {}
    for image in data.images():
        if data.exif_exists(image):
            logger.info("Loading existing EXIF for %s", image)
            d = data.load_exif(image)
        else:
            logger.info("Extracting EXIF for %s", image)
            d = data.extract_exif(image)
            if image in exif_overrides:
                d.update(exif_overrides[image])
            data.save_exif(image, d)

        if d["camera"] not in camera_models:
            camera = exif_mod.camera_from_exif_metadata(d, data)
            camera_models[d["camera"]] = camera

    # Apply camera model overrides ("all" overrides every camera).
    if data.camera_models_overrides_exists():
        overrides = data.load_camera_models_overrides()
        if "all" in overrides:
            for key in camera_models:
                camera_models[key] = overrides["all"].copy()
                camera_models[key].id = key
        else:
            for key, value in overrides.items():
                camera_models[key] = value

    data.save_camera_models(camera_models)
