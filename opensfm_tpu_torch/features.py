"""Feature data containers and their versioned npz format.

Mirrors the reference `opensfm/features.py`: `FeaturesData` and its
versioned npz save/load (features.py:50-278).  Detection comes with a later
slice of the port.
"""

from __future__ import annotations

from typing import Any, BinaryIO, Dict, List, Optional, Union

import numpy as np


class SemanticData:
    """Per-feature segmentation/instance labels (features.py:17-47)."""

    def __init__(
        self,
        segmentation: np.ndarray,
        instances: Optional[np.ndarray],
        labels: List[str],
    ) -> None:
        self.segmentation = segmentation
        self.instances = instances
        self.labels = labels

    def __len__(self) -> int:
        return len(self.segmentation)

    def has_instances(self) -> bool:
        return self.instances is not None

    def mask(self, mask: np.ndarray) -> "SemanticData":
        return SemanticData(
            self.segmentation[mask],
            self.instances[mask] if self.instances is not None else None,
            self.labels,
        )


class FeaturesData:
    """Detected features: points[N,>=3] (x, y, scale[, angle]) in normalized
    coordinates, descriptors, colors, optional semantics/depths."""

    FEATURES_VERSION = 3
    FEATURES_HEADER = "OPENSFM_FEATURES_VERSION"

    def __init__(
        self,
        points: np.ndarray,
        descriptors: Optional[np.ndarray],
        colors: np.ndarray,
        semantic: Optional[SemanticData] = None,
        depths: Optional[np.ndarray] = None,
    ) -> None:
        self.points = points
        self.descriptors = descriptors
        self.colors = colors
        self.semantic = semantic
        self.depths = depths

    def __len__(self) -> int:
        return len(self.points)

    def get_segmentation(self) -> Optional[np.ndarray]:
        return self.semantic.segmentation if self.semantic else None

    def has_instances(self) -> bool:
        return bool(self.semantic) and self.semantic.instances is not None

    def mask(self, mask: np.ndarray) -> "FeaturesData":
        return FeaturesData(
            self.points[mask],
            self.descriptors[mask] if self.descriptors is not None else None,
            self.colors[mask] if len(self.colors) else self.colors,
            self.semantic.mask(mask) if self.semantic else None,
            self.depths[mask] if self.depths is not None else None,
        )

    def save(self, fileobject: Union[str, BinaryIO], config: Dict[str, Any]) -> None:
        feature_type = str(config.get("feature_type", "HAHOG")).upper()
        if (
            (feature_type == "AKAZE"
             and config.get("akaze_descriptor") in ["MLDB_UPRIGHT", "MLDB"])
            or (feature_type == "HAHOG" and config.get("hahog_normalize_to_uchar"))
            or (feature_type == "ORB")
        ):
            feature_data_type = np.uint8
        else:
            feature_data_type = np.float32
        if self.descriptors is None:
            raise RuntimeError("No descriptors found, cannot save features data.")
        semantic = self.semantic
        kwargs: Dict[str, Any] = dict(
            points=self.points.astype(np.float32),
            descriptors=self.descriptors.astype(feature_data_type),
            colors=self.colors,
        )
        if semantic:
            kwargs.update(
                segmentations=semantic.segmentation.astype(np.uint8),
                instances=(
                    semantic.instances.astype(np.int16)
                    if semantic.instances is not None
                    else []
                ),
                segmentation_labels=np.array(semantic.labels).astype(str),
            )
        else:
            kwargs.update(segmentations=[], instances=[], segmentation_labels=[])
        kwargs[self.FEATURES_HEADER] = self.FEATURES_VERSION
        np.savez_compressed(fileobject, **kwargs)

    @classmethod
    def from_file(
        cls, fileobject: Union[str, BinaryIO], config: Dict[str, Any]
    ) -> "FeaturesData":
        s = np.load(fileobject, allow_pickle=False)
        version = int(s[cls.FEATURES_HEADER]) if cls.FEATURES_HEADER in s else 0
        feature_type = str(config.get("feature_type", "HAHOG")).upper()
        descriptors = s["descriptors"] if "descriptors" in s else None
        # OpenSfM upcasts uchar descriptors to f32 here for FLANN
        # (features.py from_file); the exact matcher uploads uint8 and
        # upcasts on the device instead, so the quantized dtype is kept.
        points = s["points"].astype(np.float64)
        colors = s["colors"] if "colors" in s else np.zeros((len(points), 3))

        semantic = None
        if version >= 2 and "segmentations" in s and len(s["segmentations"]):
            instances = (
                s["instances"] if "instances" in s and len(s["instances"]) else None
            )
            labels = (
                list(s["segmentation_labels"])
                if "segmentation_labels" in s
                else []
            )
            semantic = SemanticData(s["segmentations"], instances, labels)
        return cls(points, descriptors, colors, semantic)
