"""Abstract dataset interface — the inter-stage contract.

Mirrors reference `opensfm/dataset_base.py:12-243` (DataSetBase ABC with
load/save methods for images, masks, EXIF, features, matches, tracks,
reconstructions, reference, rigs, GCPs, reports).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from opensfm_tpu_torch import pymap, types
from opensfm_tpu_torch.features import FeaturesData


class DataSetBase(ABC):
    """Base for dataset classes providing all pipeline IO."""

    io_handler = None
    config: Dict[str, Any] = {}

    @abstractmethod
    def images(self) -> List[str]: ...

    @abstractmethod
    def load_image(self, image: str) -> np.ndarray: ...

    def load_mask(self, image: str) -> Optional[np.ndarray]:
        return None

    def load_features_mask(self, image: str, points: np.ndarray) -> np.ndarray:
        return np.ones(len(points), dtype=bool)

    def load_instances(self, image: str) -> Optional[np.ndarray]:
        return None

    def load_segmentation(self, image: str) -> Optional[np.ndarray]:
        return None

    def segmentation_labels(self) -> List[Any]:
        return []

    @abstractmethod
    def load_exif(self, image: str) -> Dict[str, Any]: ...

    def exif_exists(self, image: str) -> bool:
        try:
            self.load_exif(image)
            return True
        except (IOError, KeyError):
            return False

    @abstractmethod
    def load_camera_models(self) -> Dict[str, Any]: ...

    def load_camera_models_overrides(self) -> Dict[str, Any]:
        return {}

    def load_exif_overrides(self) -> Dict[str, Any]:
        return {}

    # -- features -----------------------------------------------------------
    def features_exist(self, image: str) -> bool:
        return False

    def load_features(self, image: str) -> Optional[FeaturesData]:
        return None

    def save_features(self, image: str, features_data: FeaturesData) -> None:
        raise NotImplementedError

    def words_exist(self, image: str) -> bool:
        return False

    def load_words(self, image: str) -> np.ndarray:
        raise NotImplementedError

    def save_words(self, image: str, words: np.ndarray) -> None:
        raise NotImplementedError

    # -- matches ------------------------------------------------------------
    def matches_exists(self, image: str) -> bool:
        return False

    def load_matches(self, image: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def save_matches(self, image: str, matches: Dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    # -- tracks -------------------------------------------------------------
    def load_tracks_manager(
        self, filename: Optional[str] = None
    ) -> pymap.TracksManager:
        raise NotImplementedError

    def save_tracks_manager(
        self, tracks_manager: pymap.TracksManager, filename: Optional[str] = None
    ) -> None:
        raise NotImplementedError

    # -- reconstruction -----------------------------------------------------
    def load_reconstruction(
        self, filename: Optional[str] = None
    ) -> List[types.Reconstruction]:
        raise NotImplementedError

    def save_reconstruction(
        self,
        reconstruction: List[types.Reconstruction],
        filename: Optional[str] = None,
        minify: bool = False,
    ) -> None:
        raise NotImplementedError

    # -- reference ----------------------------------------------------------
    @abstractmethod
    def load_reference(self): ...

    @abstractmethod
    def init_reference(self, images: Optional[List[str]] = None) -> None: ...

    def reference_exists(self) -> bool:
        try:
            self.load_reference()
            return True
        except (IOError, NotImplementedError):
            return False

    # -- rigs ---------------------------------------------------------------
    def load_rig_cameras(self) -> Dict[str, pymap.RigCamera]:
        return {}

    def save_rig_cameras(self, rig_cameras: Dict[str, pymap.RigCamera]) -> None:
        raise NotImplementedError

    def load_rig_assignments(self) -> List[List[Tuple[str, str]]]:
        return []

    def save_rig_assignments(self, assignments) -> None:
        raise NotImplementedError

    # -- GCPs ---------------------------------------------------------------
    def load_ground_control_points(self) -> List[Any]:
        return []

    # -- reports / logs -----------------------------------------------------
    def save_report(self, report_str: str, path: str) -> None:
        pass

    def load_report(self, path: str) -> str:
        return ""

    def append_to_profile_log(self, content: str) -> None:
        pass
