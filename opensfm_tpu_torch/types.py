"""Reconstruction: the user-facing scene container.

Mirrors the reference `opensfm/types.py:15-370` (a thin shell over the map
with dict-like `cameras` / `shots` / `points` / `rig_cameras` /
`rig_instances` / `biases` views and a topocentric `reference`).  Here the
views are the map's own dicts, which already behave like the reference's
pybind view classes.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

import numpy as np

from opensfm_tpu_torch import pymap
from opensfm_tpu_torch.geo import TopocentricConverter
from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose, Similarity


class Reconstruction:
    """The reconstructed scene: cameras, (rig) shots, points, reference."""

    def __init__(self) -> None:
        self.map = pymap.Map()

    # -- dict-like views ----------------------------------------------------
    @property
    def cameras(self) -> Dict[str, Camera]:
        return self.map.cameras

    @cameras.setter
    def cameras(self, value: Dict[str, Camera]) -> None:
        for cam in value.values():
            self.map.create_camera(cam)

    @property
    def biases(self) -> Dict[str, Similarity]:
        return self.map.biases

    @biases.setter
    def biases(self, value: Dict[str, Similarity]) -> None:
        for cam_id, bias in value.items():
            self.map.set_bias(cam_id, bias)

    def set_bias(self, cam_id: str, bias: Similarity) -> None:
        self.map.set_bias(cam_id, bias)

    @property
    def rig_cameras(self) -> Dict[str, pymap.RigCamera]:
        return self.map.rig_cameras

    @rig_cameras.setter
    def rig_cameras(self, values: Dict[str, pymap.RigCamera]) -> None:
        for rig_camera in values.values():
            self.map.create_rig_camera(rig_camera)

    @property
    def rig_instances(self) -> Dict[str, pymap.RigInstance]:
        return self.map.rig_instances

    @rig_instances.setter
    def rig_instances(self, values: Dict[str, pymap.RigInstance]) -> None:
        for rig_instance in values.values():
            self.add_rig_instance(rig_instance)

    def remove_rig_instance(self, rig_instance_id: str) -> None:
        self.map.remove_rig_instance(rig_instance_id)

    @property
    def shots(self) -> Dict[str, pymap.Shot]:
        return self.map.shots

    @shots.setter
    def shots(self, value: Dict[str, pymap.Shot]) -> None:
        for shot in value.values():
            self.add_shot(shot)

    @property
    def pano_shots(self) -> Dict[str, pymap.Shot]:
        return self.map.pano_shots

    @pano_shots.setter
    def pano_shots(self, value: Dict[str, pymap.Shot]) -> None:
        for shot in value.values():
            self.add_pano_shot(shot)

    @property
    def points(self) -> Dict[str, pymap.Landmark]:
        return self.map.landmarks

    @points.setter
    def points(self, value: Dict[str, pymap.Landmark]) -> None:
        self.map.clear_observations_and_landmarks()
        for point in value.values():
            self.add_point(point)

    def remove_point(self, point_id: str) -> None:
        self.map.remove_landmark(point_id)

    @property
    def reference(self) -> TopocentricConverter:
        return self.map.get_reference()

    @reference.setter
    def reference(self, value: TopocentricConverter) -> None:
        self.map.set_reference(value.lat, value.lon, value.alt)

    # -- cameras ------------------------------------------------------------
    def add_camera(self, camera: Camera) -> Camera:
        return self.map.create_camera(camera)

    def get_camera(self, cam_id: str) -> Camera:
        return self.map.get_camera(cam_id)

    # -- rigs ---------------------------------------------------------------
    def add_rig_camera(self, rig_camera: pymap.RigCamera) -> pymap.RigCamera:
        return self.map.create_rig_camera(rig_camera)

    def add_rig_instance(self, rig_instance: pymap.RigInstance) -> pymap.RigInstance:
        """Insert the instance (shots must be added separately via create_shot)."""
        return self.map.update_rig_instance(rig_instance)

    # -- shots --------------------------------------------------------------
    def create_shot(
        self,
        shot_id: str,
        camera_id: str,
        pose: Optional[Pose] = None,
        rig_camera_id: Optional[str] = None,
        rig_instance_id: Optional[str] = None,
    ) -> pymap.Shot:
        return self.map.create_shot(
            shot_id, camera_id, rig_camera_id, rig_instance_id, pose
        )

    def add_shot(self, shot: pymap.Shot) -> pymap.Shot:
        """Copy a shot (and its camera/rig context) into this reconstruction."""
        if shot.camera.id not in self.cameras:
            self.add_camera(shot.camera)
        rig_camera_id = None
        rig_instance_id = None
        if shot.is_in_rig():
            if shot.rig_camera.id not in self.rig_cameras:
                self.add_rig_camera(shot.rig_camera)
            if shot.rig_instance.id not in self.rig_instances:
                ri = pymap.RigInstance(shot.rig_instance.id)
                ri.pose = shot.rig_instance.pose
                self.map.rig_instances[ri.id] = ri
            rig_camera_id = shot.rig_camera.id
            rig_instance_id = shot.rig_instance.id
        new_shot = self.map.create_shot(
            shot.id, shot.camera.id, rig_camera_id, rig_instance_id, shot.pose
        )
        if shot.is_in_rig():
            # Keep the instance pose authoritative, not the per-shot one.
            self.map.rig_instances[rig_instance_id].pose = shot.rig_instance.pose
        new_shot.metadata.set(shot.metadata)
        new_shot.scale = shot.scale
        new_shot.merge_cc = shot.merge_cc
        return new_shot

    def get_shot(self, shot_id: str) -> pymap.Shot:
        return self.map.get_shot(shot_id)

    def remove_shot(self, shot_id: str) -> None:
        self.map.remove_shot(shot_id)

    # -- pano shots ---------------------------------------------------------
    def create_pano_shot(self, shot_id, camera_id, pose=None) -> pymap.Shot:
        return self.map.create_pano_shot(shot_id, camera_id, pose)

    def add_pano_shot(self, shot: pymap.Shot) -> pymap.Shot:
        if shot.camera.id not in self.cameras:
            self.add_camera(shot.camera)
        new_shot = self.map.create_pano_shot(shot.id, shot.camera.id, shot.pose)
        new_shot.metadata.set(shot.metadata)
        return new_shot

    def get_pano_shot(self, shot_id: str) -> pymap.Shot:
        return self.map.get_pano_shot(shot_id)

    def remove_pano_shot(self, shot_id: str) -> None:
        self.map.remove_pano_shot(shot_id)

    # -- points -------------------------------------------------------------
    def create_point(self, point_id: str, coordinates=None) -> pymap.Landmark:
        return self.map.create_landmark(
            point_id, coordinates if coordinates is not None else np.zeros(3)
        )

    def add_point(self, point: pymap.Landmark) -> pymap.Landmark:
        new_point = self.map.create_landmark(point.id, point.coordinates)
        new_point.color = np.array(point.color)
        return new_point

    def get_point(self, point_id: str) -> pymap.Landmark:
        return self.map.landmarks[point_id]

    def add_observation(
        self, shot_id: str, lm_id: str, observation: pymap.Observation
    ) -> None:
        self.map.add_observation(shot_id, lm_id, observation)

    def remove_observation(self, shot_id: str, lm_id: str) -> None:
        self.map.remove_observation(shot_id, lm_id)

    # -- misc ---------------------------------------------------------------
    def add_correspondences_from_tracks_manager(
        self, tracks_manager: pymap.TracksManager
    ) -> None:
        """Attach observations for every (shot, reconstructed track) pair."""
        for track_id in tracks_manager.get_track_ids():
            if track_id not in self.points:
                continue
            for shot_id, obs in tracks_manager.get_track_observations(track_id).items():
                if shot_id in self.shots:
                    self.add_observation(shot_id, track_id, obs)

    def __deepcopy__(self, memo) -> "Reconstruction":
        rec = Reconstruction()
        for cam in self.cameras.values():
            rec.add_camera(cam)
        for cam_id, bias in self.biases.items():
            rec.set_bias(cam_id, copy.deepcopy(bias))
        for rig_camera in self.rig_cameras.values():
            if rig_camera.id not in rec.rig_cameras:
                rec.add_rig_camera(pymap.RigCamera(rig_camera.pose.copy(), rig_camera.id))
        for shot in self.shots.values():
            rec.add_shot(shot)
        for instance_id, instance in self.rig_instances.items():
            if instance_id in rec.rig_instances:
                rec.rig_instances[instance_id].pose = instance.pose
        for point in self.points.values():
            rec.add_point(point)
        for shot in self.shots.values():
            for lm_id, obs in shot.get_landmark_observations().items():
                if lm_id in rec.points:
                    rec.add_observation(shot.id, lm_id, obs.copy())
        rec.map._reference = self.map._reference
        return rec

    def __repr__(self) -> str:
        return (
            "<Reconstruction"
            f" cameras={len(self.cameras)}"
            f" shots={len(self.shots)}"
            f" points={len(self.points)}"
            f" rig_cameras={len(self.rig_cameras)}"
            f" rig_instances={len(self.rig_instances)}"
            ">"
        )


PANOSHOT_RIG_PREFIX = "panoshot_"
