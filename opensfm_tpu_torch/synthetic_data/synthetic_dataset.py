"""In-memory fake DataSet for hermetic end-to-end tests.

Port of `opensfm_tpu.synthetic_data.synthetic_dataset` (reference
`opensfm/synthetic_data/synthetic_dataset.py:51`): the pipeline runs with no
disk and no images.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from opensfm_tpu_torch import config as config_mod
from opensfm_tpu_torch import pymap, types
from opensfm_tpu_torch.dataset_base import DataSetBase
from opensfm_tpu_torch.features import FeaturesData


class SyntheticDataSet(DataSetBase):
    """DataSet whose contents live in memory."""

    def __init__(
        self,
        reconstruction: types.Reconstruction,
        exifs: Dict[str, Any],
        features: Optional[Dict[str, FeaturesData]] = None,
        tracks_manager: Optional[pymap.TracksManager] = None,
        gcps: Optional[Dict[str, Any]] = None,
        rig_cameras: Optional[Dict[str, pymap.RigCamera]] = None,
        rig_assignments: Optional[List[List[Tuple[str, str]]]] = None,
    ) -> None:
        self.reconstruction = reconstruction
        self.exifs = exifs
        self.features = features or {}
        self.tracks_manager = tracks_manager
        self.gcps = gcps or {}
        self.rig_cameras_data = rig_cameras or {}
        self.rig_assignments_data = rig_assignments or []
        self.config = config_mod.default_config()
        self.reference = reconstruction.reference
        self.matches: Dict[str, Dict[str, np.ndarray]] = {}
        self.saved_reconstructions: Dict[str, List[types.Reconstruction]] = {}

    # -- images -------------------------------------------------------------
    def images(self) -> List[str]:
        return sorted(self.reconstruction.shots.keys())

    def load_image(self, image: str) -> np.ndarray:
        raise IOError("SyntheticDataSet has no image files")

    # -- exif ---------------------------------------------------------------
    def load_exif(self, image: str) -> Dict[str, Any]:
        return self.exifs[image]

    def load_camera_models(self):
        return {
            cam_id: cam.copy()
            for cam_id, cam in self.reconstruction.cameras.items()
        }

    # -- features -----------------------------------------------------------
    def features_exist(self, image: str) -> bool:
        return image in self.features

    def load_features(self, image: str) -> Optional[FeaturesData]:
        return self.features.get(image)

    def save_features(self, image: str, features_data: FeaturesData) -> None:
        self.features[image] = features_data

    # -- matches ------------------------------------------------------------
    def matches_exists(self, image: str) -> bool:
        return image in self.matches

    def load_matches(self, image: str) -> Dict[str, np.ndarray]:
        if image not in self.matches:
            raise IOError(f"No matches for {image}")
        return self.matches[image]

    def save_matches(self, image: str, matches: Dict[str, np.ndarray]) -> None:
        self.matches[image] = matches

    # -- tracks -------------------------------------------------------------
    def load_tracks_manager(self, filename=None) -> pymap.TracksManager:
        if self.tracks_manager is None:
            raise IOError("No tracks manager")
        return self.tracks_manager

    def save_tracks_manager(self, tracks_manager, filename=None) -> None:
        self.tracks_manager = tracks_manager

    # -- reconstruction -----------------------------------------------------
    def load_reconstruction(self, filename=None):
        return self.saved_reconstructions.get(filename or "reconstruction.json", [])

    def save_reconstruction(self, reconstruction, filename=None, minify=False):
        self.saved_reconstructions[filename or "reconstruction.json"] = reconstruction

    # -- reference ----------------------------------------------------------
    def load_reference(self):
        return self.reference

    def init_reference(self, images=None) -> None:
        pass

    # -- rigs ---------------------------------------------------------------
    # Derived from the ground-truth reconstruction when not passed
    # explicitly, exactly like the reference
    # (synthetic_dataset.py:98-108): without this the rig e2e scene runs
    # as mono — no shared instances, no rig-camera locking — and misses
    # the reference's strict rig bounds.
    def load_rig_cameras(self):
        if self.rig_cameras_data:
            return dict(self.rig_cameras_data)
        return dict(self.reconstruction.rig_cameras)

    def load_rig_assignments(self):
        if self.rig_assignments_data:
            return list(self.rig_assignments_data)
        return [
            [(shot_id, rig_camera.id)
             for shot_id, rig_camera in instance.rig_cameras.items()]
            for instance in self.reconstruction.rig_instances.values()
        ]

    # -- GCPs ---------------------------------------------------------------
    def load_ground_control_points(self):
        return list(self.gcps.values())
