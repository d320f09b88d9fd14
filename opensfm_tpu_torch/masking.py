"""Feature masking from binary masks and segmentations.

Port of `opensfm_tpu.masking` (reference `opensfm/masking.py`:
load_features_mask:54, mask_from_segmentation:14).
"""

from __future__ import annotations

import logging

import numpy as np

from opensfm_tpu_torch.geometry.cameras import denormalized_image_coordinates

logger = logging.getLogger(__name__)


def mask_from_segmentation(segmentation: np.ndarray, ignore_values) -> np.ndarray:
    """Binary mask that is 0 on the ignored segmentation values."""
    mask = np.ones(segmentation.shape, dtype=np.uint8)
    for value in ignore_values:
        mask &= (segmentation != value).astype(np.uint8)
    return mask


def load_features_mask(data, image: str, points: np.ndarray) -> np.ndarray:
    """Per-feature boolean mask from the image's mask file (masking.py:54)."""
    if points is None or len(points) == 0:
        return np.array([], dtype=bool)
    mask_image = data.load_mask(image)
    if mask_image is None:
        return np.ones(len(points), dtype=bool)
    exif = data.load_exif(image) if data.exif_exists(image) else {}
    width = exif.get("width") or mask_image.shape[1]
    height = exif.get("height") or mask_image.shape[0]
    px = denormalized_image_coordinates(
        np.asarray(points)[:, :2], mask_image.shape[1], mask_image.shape[0]
    )
    xs = np.clip(px[:, 0].round().astype(int), 0, mask_image.shape[1] - 1)
    ys = np.clip(px[:, 1].round().astype(int), 0, mask_image.shape[0] - 1)
    return mask_image[ys, xs] > 0
