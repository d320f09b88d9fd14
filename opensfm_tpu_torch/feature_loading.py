"""Cached feature loading: masked views, descriptor indices, words.

Port of `opensfm_tpu.feature_loading` (OpenSfM feature_loading.py:21-214:
FeatureLoader with lru caches; the singleton is in feature_loader.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from opensfm_tpu_torch.features import FeaturesData

# Weight of the segmentation-label column appended to descriptors when
# `matching_use_segmentation` is on: cross-class candidate distances grow by
# (MULT * label_delta)^2, so the exact top-2 matcher never ranks them first.
# Mirrors reference feature_loading.py:16-18 (value determined there
# experimentally for HAHOG uchar descriptors).
SEGMENTATION_IN_DESCRIPTOR_MULT = 35


class FeatureLoader:
    """lru-cached accessors over per-image feature files."""

    def clear_cache(self) -> None:
        self._load_all_data_unmasked.cache_clear()
        self._load_all_data_masked.cache_clear()

    def load_mask(self, data, image: str) -> Optional[np.ndarray]:
        features_data = self._load_all_data_unmasked(data, image)
        if features_data is None:
            return None
        return data.load_features_mask(image, features_data.points[:, :2])

    def load_points_colors_segmentations_instances(self, data, image: str):
        """(points, colors, segmentation, instances) of an image's masked
        features, the last two None without semantic data; None without
        features."""
        features_data = self._load_all_data_masked(data, image)
        if features_data is None:
            return None
        semantic = features_data.semantic
        return (
            features_data.points,
            features_data.colors,
            semantic.segmentation if semantic else None,
            semantic.instances if semantic else None,
        )

    def load_all_data(
        self, data, image: str, masked: bool,
        segmentation_in_descriptor: bool = False,
    ) -> Optional[FeaturesData]:
        if masked:
            features_data = self._load_all_data_masked(data, image)
        else:
            features_data = self._load_all_data_unmasked(data, image)
        if features_data is None or not segmentation_in_descriptor:
            return features_data
        return self._add_segmentation_in_descriptor(data, features_data)

    def _add_segmentation_in_descriptor(
        self, data, features: FeaturesData
    ) -> FeaturesData:
        """Append the weighted segmentation-label column to the descriptors
        (reference feature_loading.py:123-155): semantic classes become
        part of the descriptor metric, so the exact top-2 matmul matcher
        suppresses cross-class matches without any masking pass."""
        if (
            not data.config["hahog_normalize_to_uchar"]
            or data.config["feature_type"] != "HAHOG"
        ):
            raise RuntimeError(
                "Semantic segmentation in descriptor only supported for "
                "HAHOG UCHAR descriptors"
            )
        segmentation = (
            features.semantic.segmentation if features.semantic else None
        )
        if segmentation is None or features.descriptors is None:
            return features
        desc_augmented = np.concatenate(
            (
                features.descriptors.astype(np.float32),
                np.asarray(segmentation, dtype=np.float32)[:, None]
                * SEGMENTATION_IN_DESCRIPTOR_MULT,
            ),
            axis=1,
        )
        return FeaturesData(
            features.points, desc_augmented, features.colors,
            features.semantic,
        )

    def load_bearings(
        self, data, image: str, masked: bool, camera
    ) -> Optional[np.ndarray]:
        """Unit bearings of the (masked) features (feature_loading.py:88)."""
        features_data = self.load_all_data(data, image, masked)
        if features_data is None:
            return None
        return camera.bearings_many(features_data.points[:, :2])

    def load_features_index(
        self, data, image: str, masked: bool,
        segmentation_in_descriptor: bool = False,
    ) -> Optional[Tuple[FeaturesData, np.ndarray]]:
        """(features, descriptor matrix) — the exact-NN 'index'
        (feature_loading.py:176; :111 for the segmentation flag)."""
        features_data = self.load_all_data(
            data, image, masked,
            segmentation_in_descriptor=segmentation_in_descriptor,
        )
        if features_data is None or features_data.descriptors is None:
            return None
        desc = features_data.descriptors
        # Keep uchar-quantized descriptors uint8: the device matcher
        # upcasts after upload (4x less host->device traffic).  (The
        # segmentation-augmented column is already float32 and can exceed
        # uint8 range, so augmented descriptors stay float.)
        dtype = np.uint8 if desc.dtype == np.uint8 else np.float32
        return features_data, np.ascontiguousarray(desc, dtype=dtype)

    def load_words(self, data, image: str, masked: bool) -> Optional[np.ndarray]:
        if not data.words_exist(image):
            return None
        words = data.load_words(image)
        if masked:
            mask = self.load_mask(data, image)
            if mask is not None:
                words = words[mask]
        return words

    @lru_cache(maxsize=200)
    def _load_all_data_unmasked(self, data, image: str) -> Optional[FeaturesData]:
        return data.load_features(image)

    @lru_cache(maxsize=200)
    def _load_all_data_masked(self, data, image: str) -> Optional[FeaturesData]:
        features_data = self._load_all_data_unmasked(data, image)
        if features_data is None:
            return None
        mask = data.load_features_mask(image, features_data.points[:, :2])
        if mask is not None and len(mask) == len(features_data.points):
            if not mask.all():
                return features_data.mask(mask)
        return features_data
