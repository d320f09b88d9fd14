"""EXIF-orientation coordinate conversions.

Port of `opensfm_tpu.upright` (reference `opensfm/upright.py:8-70`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Homogeneous 2D transforms from normalized opensfm coords to upright
# unit-square coords, per EXIF orientation tag.
_R = {
    1: np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float),
    3: np.array([[-1, 0, 1], [0, -1, 1], [0, 0, 1]], dtype=float),
    6: np.array([[0, -1, 1], [1, 0, 0], [0, 0, 1]], dtype=float),
    8: np.array([[0, 1, 0], [-1, 0, 1], [0, 0, 1]], dtype=float),
}


def opensfm_to_upright(
    coords: np.ndarray, width: int, height: int, orientation: int,
    new_width: Optional[int] = None, new_height: Optional[int] = None,
) -> np.ndarray:
    """Normalized opensfm coords -> upright pixel coords
    (upright.py:8-70).

    >>> sfm = np.array([[-0.5, -0.375], [-0.5, 0.375],
    ...                 [0.5, -0.375], [0.5, 0.375]])
    >>> opensfm_to_upright(sfm, 320, 240, 1).tolist()
    [[0.0, 0.0], [0.0, 240.0], [320.0, 0.0], [320.0, 240.0]]
    """
    coords = np.asarray(coords, dtype=float)
    size = max(width, height)
    # Normalized -> unit square of the original image.
    h = np.column_stack(
        [
            coords[:, 0] * size / width + 0.5,
            coords[:, 1] * size / height + 0.5,
            np.ones(len(coords)),
        ]
    )
    R = _R.get(orientation, _R[1])
    upright = h @ R.T
    if orientation in (6, 8):
        out_w, out_h = height, width
    else:
        out_w, out_h = width, height
    out_w = new_width or out_w
    out_h = new_height or out_h
    return np.column_stack([upright[:, 0] * out_w, upright[:, 1] * out_h])
