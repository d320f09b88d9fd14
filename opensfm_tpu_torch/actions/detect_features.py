"""Detect features for all images (reference actions/detect_features.py)."""

from __future__ import annotations

from typing import Any, Dict

from opensfm_tpu_torch import features_processing


def run_dataset(data, device=None) -> Dict[str, Any]:
    """Detect, describe, mask and save every image's features on `device`
    (CUDA unless told otherwise); return the per-image report."""
    return features_processing.run_features_processing(
        data, data.images(), force=False, device=device)
