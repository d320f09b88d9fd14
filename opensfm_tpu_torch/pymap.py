"""In-memory SfM map: cameras, shots, rigs, landmarks, observations, tracks.

Pure-Python equivalent of the reference's C++ `pymap` module
(reference: opensfm/src/map/map.h:20-212, shot.h:50-182, landmark.h:9-51,
observation.h:20-52, rig.h:1-90, tracks_manager.h:10-60).  The user-facing
API (dict-like views, `shot.pose`, `landmark.get_observations()`, rig
composition `pose(shot) = pose(rig_camera) ∘ pose(rig_instance)`) matches the
reference so orchestration code reads identically.

This host-side object graph is the *mutable* representation used by the
dynamic growth loop; the bundle adjuster and batched geometry kernels
consume flat columnar snapshots extracted by `opensfm_tpu_torch.ba.problem`
(poses[N,6], points[M,3], obs CSR indices) and write results back through
this API.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose, Similarity


class OptionalValue:
    """Mirror of foundation::OptionalValue (has_value / value semantics)."""

    __slots__ = ("_value",)

    def __init__(self, value=None) -> None:
        self._value = value

    @property
    def has_value(self) -> bool:
        return self._value is not None

    @property
    def value(self):
        if self._value is None:
            raise ValueError("OptionalValue is empty")
        return self._value

    @value.setter
    def value(self, v) -> None:
        self._value = v

    def reset(self) -> None:
        self._value = None


class Depth:
    """Depth prior attached to an observation (observation.h:10-18)."""

    __slots__ = ("value", "is_radial", "std_deviation")

    def __init__(self, value: float, is_radial: bool, std_deviation: float) -> None:
        self.value = float(value)
        self.is_radial = bool(is_radial)
        self.std_deviation = float(std_deviation)


NO_SEMANTIC_VALUE = -1


class Observation:
    """A 2D feature observation: point, scale, color, ids (observation.h:20-52)."""

    __slots__ = (
        "point", "scale", "color", "id", "segmentation", "instance", "depth_prior",
    )

    def __init__(
        self,
        x: float,
        y: float,
        s: float,
        r: int,
        g: int,
        b: int,
        feature: int,
        segmentation: int = NO_SEMANTIC_VALUE,
        instance: int = NO_SEMANTIC_VALUE,
        depth_prior: Optional[Depth] = None,
    ) -> None:
        self.point = np.array([x, y], dtype=np.float64)
        self.scale = float(s)
        self.color = np.array([r, g, b], dtype=np.int64)
        self.id = int(feature)  # feature_id
        self.segmentation = int(segmentation)
        self.instance = int(instance)
        self.depth_prior = depth_prior

    def copy(self) -> "Observation":
        return Observation(
            self.point[0], self.point[1], self.scale,
            self.color[0], self.color[1], self.color[2],
            self.id, self.segmentation, self.instance, self.depth_prior,
        )

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, Observation)
            and np.array_equal(self.point, o.point)
            and self.scale == o.scale
            and np.array_equal(self.color, o.color)
            and self.id == o.id
            and self.segmentation == o.segmentation
            and self.instance == o.instance
        )

    def __repr__(self) -> str:
        return f"Observation({self.point.tolist()}, scale={self.scale}, id={self.id})"


class ShotMeasurements:
    """Optional per-shot sensor metadata (shot.h:26-47)."""

    __slots__ = (
        "capture_time", "gps_position", "gps_accuracy", "compass_accuracy",
        "compass_angle", "opk_accuracy", "opk_angles", "gravity_down",
        "orientation", "sequence_key", "attributes",
    )

    def __init__(self) -> None:
        self.capture_time = OptionalValue()
        self.gps_position = OptionalValue()
        self.gps_accuracy = OptionalValue()
        self.compass_accuracy = OptionalValue()
        self.compass_angle = OptionalValue()
        self.opk_accuracy = OptionalValue()
        self.opk_angles = OptionalValue()
        self.gravity_down = OptionalValue()
        self.orientation = OptionalValue()
        self.sequence_key = OptionalValue()
        self.attributes: Dict[str, str] = {}

    def set(self, other: "ShotMeasurements") -> None:
        for slot in self.__slots__:
            if slot == "attributes":
                self.attributes = dict(other.attributes)
            else:
                src = getattr(other, slot)
                dst = getattr(self, slot)
                dst._value = src._value


class ShotMesh:
    """Per-shot 2.5D viewer mesh (shot.h:16-24)."""

    __slots__ = ("vertices", "faces")

    def __init__(self) -> None:
        self.vertices = None
        self.faces = None


class RigCamera:
    """A camera slot in a rig: fixed pose relative to the instance (rig.h)."""

    __slots__ = ("pose", "id")

    def __init__(self, pose: Optional[Pose] = None, rig_camera_id: str = "") -> None:
        self.pose = pose if pose is not None else Pose()
        self.id = rig_camera_id


class RigInstance:
    """A posed instantiation of a rig; owns the poses of its shots (rig.h)."""

    def __init__(self, instance_id: str) -> None:
        self.id = instance_id
        self._pose = Pose()
        self.shots: Dict[str, "Shot"] = {}

    @property
    def pose(self) -> Pose:
        return self._pose

    @pose.setter
    def pose(self, p: Pose) -> None:
        self._pose = p.copy()

    @property
    def rig_cameras(self) -> Dict[str, RigCamera]:
        return {sid: shot.rig_camera for sid, shot in self.shots.items()}

    @property
    def camera_ids(self) -> Dict[str, str]:
        """shot_id -> rig_camera_id (pybind `rig_camera_ids`)."""
        return {sid: shot.rig_camera.id for sid, shot in self.shots.items()}

    @property
    def rig_camera_ids(self) -> Dict[str, str]:
        return self.camera_ids

    def keys(self):
        return self.shots.keys()

    def update_instance_pose_with_shot(self, shot_id: str, shot_pose: Pose) -> None:
        """Set instance pose from one shot's world pose:
        pose(instance) = pose(rig_camera)^-1 ∘ pose(shot)."""
        shot = self.shots[shot_id]
        self._pose = shot.rig_camera.pose.inverse().compose(shot_pose)


def _is_single_shot_rig(shot: "Shot") -> bool:
    return (
        shot.rig_instance is not None
        and len(shot.rig_instance.shots) == 1
        and np.allclose(shot.rig_camera.pose.rotation, 0.0)
        and np.allclose(shot.rig_camera.pose.translation, 0.0)
    )


class Shot:
    """A captured image: camera + pose (via rig) + metadata (shot.h:50-182)."""

    def __init__(self, shot_id: str, camera: Camera, pose: Optional[Pose] = None):
        self.id = shot_id
        self.camera = camera
        self.metadata = ShotMeasurements()
        self.mesh = ShotMesh()
        self.scale = 1.0
        self.merge_cc = 0
        self.covariance = None
        # Rig links; standalone shots get an implicit single-shot rig so that
        # pose(shot) = pose(rig_camera=identity) ∘ pose(instance).
        self.rig_camera: RigCamera = RigCamera(Pose(), shot_id)
        self.rig_instance: RigInstance = RigInstance(shot_id)
        self.rig_instance.shots[shot_id] = self
        if pose is not None:
            self.rig_instance.pose = pose
        # landmark_id -> Observation
        self._observations: Dict[str, Observation] = {}

    # -- pose (composed through the rig) ------------------------------------
    @property
    def pose(self) -> Pose:
        return self.rig_camera.pose.compose(self.rig_instance.pose)

    @pose.setter
    def pose(self, p: Pose) -> None:
        if not _is_single_shot_rig(self):
            raise RuntimeError(
                "Can't set the pose of a Shot belonging to a RigInstance"
            )
        self.rig_instance.pose = p

    def set_rig(self, rig_instance: RigInstance, rig_camera: RigCamera) -> None:
        self.rig_instance.shots.pop(self.id, None)
        self.rig_instance = rig_instance
        self.rig_camera = rig_camera
        rig_instance.shots[self.id] = self

    def is_in_rig(self) -> bool:
        return not _is_single_shot_rig(self)

    # -- projection helpers ---------------------------------------------------
    def project(self, point) -> np.ndarray:
        """World point -> normalized image coordinates."""
        return self.camera.project(self.pose.transform(point))

    def project_many(self, points) -> np.ndarray:
        return self.camera.project_many(self.pose.transform_many(points))

    def bearing(self, point) -> np.ndarray:
        """Normalized image coordinates -> world-frame unit bearing."""
        b = self.camera.bearing(point)
        return b @ self.pose.get_rotation_matrix()  # R^T b

    def bearing_many(self, points) -> np.ndarray:
        b = self.camera.bearings_many(points)
        return b @ self.pose.get_rotation_matrix()

    # -- observations ---------------------------------------------------------
    def get_observation(self, landmark_id: str) -> Optional[Observation]:
        return self._observations.get(landmark_id)

    def get_landmark_observations(self) -> Dict[str, Observation]:
        return self._observations

    def __repr__(self) -> str:
        return f"Shot({self.id!r}, camera={self.camera.id!r})"


class Landmark:
    """A reconstructed 3D point with its observing shots (landmark.h:9-51)."""

    __slots__ = ("id", "coordinates", "color", "_observations", "reprojection_errors")

    def __init__(self, lm_id: str, coordinates=None) -> None:
        self.id = lm_id
        self.coordinates = (
            np.zeros(3) if coordinates is None
            else np.asarray(coordinates, dtype=np.float64).reshape(3).copy()
        )
        self.color = np.array([0, 0, 0], dtype=np.int64)
        self._observations: Dict[str, int] = {}  # shot_id -> feature_id
        self.reprojection_errors: Dict[str, np.ndarray] = {}

    def get_observations(self) -> Dict[str, int]:
        return self._observations

    def number_of_observations(self) -> int:
        return len(self._observations)

    def __repr__(self) -> str:
        return f"Landmark({self.id!r}, {self.coordinates.tolist()})"


class Map:
    """The central SfM map container (map.h:20-212)."""

    def __init__(self) -> None:
        self.cameras: Dict[str, Camera] = {}
        self.biases: Dict[str, Similarity] = {}
        self.shots: Dict[str, Shot] = {}
        self.pano_shots: Dict[str, Shot] = {}
        self.landmarks: Dict[str, Landmark] = {}
        self.rig_cameras: Dict[str, RigCamera] = {}
        self.rig_instances: Dict[str, RigInstance] = {}
        self._reference = None  # TopocentricConverter

    # -- reference ----------------------------------------------------------
    def get_reference(self):
        from opensfm_tpu_torch.geo import TopocentricConverter

        if self._reference is None:
            return TopocentricConverter(0.0, 0.0, 0.0)
        return self._reference

    def set_reference(self, lat: float, lon: float, alt: float) -> None:
        from opensfm_tpu_torch.geo import TopocentricConverter

        self._reference = TopocentricConverter(lat, lon, alt)

    # -- cameras ------------------------------------------------------------
    def create_camera(self, camera: Camera) -> Camera:
        cam = camera.copy()
        self.cameras[cam.id] = cam
        # Every camera starts with an identity GPS bias (map.h SetBias).
        self.biases.setdefault(cam.id, Similarity())
        return cam

    def get_camera(self, cam_id: str) -> Camera:
        return self.cameras[cam_id]

    def set_bias(self, cam_id: str, bias: Similarity) -> None:
        self.biases[cam_id] = bias

    # -- rigs ---------------------------------------------------------------
    def create_rig_camera(self, rig_camera: RigCamera) -> RigCamera:
        rc = RigCamera(rig_camera.pose.copy(), rig_camera.id)
        self.rig_cameras[rc.id] = rc
        return rc

    def create_rig_instance(self, instance_id: str) -> RigInstance:
        ri = RigInstance(instance_id)
        self.rig_instances[instance_id] = ri
        return ri

    def update_rig_instance(self, rig_instance: RigInstance) -> RigInstance:
        existing = self.rig_instances.get(rig_instance.id)
        if existing is None:
            self.rig_instances[rig_instance.id] = rig_instance
            return rig_instance
        existing.pose = rig_instance.pose
        return existing

    def remove_rig_instance(self, instance_id: str) -> None:
        instance = self.rig_instances.pop(instance_id, None)
        if instance:
            for shot_id in list(instance.shots):
                self.remove_shot(shot_id)

    # -- shots --------------------------------------------------------------
    def create_shot(
        self,
        shot_id: str,
        camera_id: str,
        rig_camera_id: Optional[str] = None,
        rig_instance_id: Optional[str] = None,
        pose: Optional[Pose] = None,
    ) -> Shot:
        if shot_id in self.shots:
            raise RuntimeError(f"Shot {shot_id} already exists")
        camera = self.cameras[camera_id]
        shot = Shot(shot_id, camera, pose)
        if rig_camera_id is not None and rig_instance_id is not None:
            rig_camera = self.rig_cameras[rig_camera_id]
            instance = self.rig_instances.setdefault(
                rig_instance_id, RigInstance(rig_instance_id)
            )
            shot.set_rig(instance, rig_camera)
            if pose is not None:
                instance.update_instance_pose_with_shot(shot_id, pose)
        else:
            # Implicit single-shot rig registered under the shot id.
            self.rig_cameras.setdefault(shot.rig_camera.id, shot.rig_camera)
            self.rig_instances[shot.rig_instance.id] = shot.rig_instance
        self.shots[shot_id] = shot
        return shot

    def get_shot(self, shot_id: str) -> Shot:
        return self.shots[shot_id]

    def remove_shot(self, shot_id: str) -> None:
        shot = self.shots.pop(shot_id, None)
        if shot is None:
            return
        for lm_id in list(shot._observations):
            lm = self.landmarks.get(lm_id)
            if lm:
                lm._observations.pop(shot_id, None)
        shot._observations.clear()
        instance = shot.rig_instance
        instance.shots.pop(shot_id, None)
        if not instance.shots:
            self.rig_instances.pop(instance.id, None)

    # -- pano shots ----------------------------------------------------------
    def create_pano_shot(self, shot_id: str, camera_id: str, pose=None) -> Shot:
        shot = Shot(shot_id, self.cameras[camera_id], pose)
        self.pano_shots[shot_id] = shot
        return shot

    def get_pano_shot(self, shot_id: str) -> Shot:
        return self.pano_shots[shot_id]

    def remove_pano_shot(self, shot_id: str) -> None:
        self.pano_shots.pop(shot_id, None)

    # -- landmarks ------------------------------------------------------------
    def create_landmark(self, lm_id: str, coordinates) -> Landmark:
        lm = Landmark(lm_id, coordinates)
        self.landmarks[lm_id] = lm
        return lm

    def remove_landmark(self, lm_id: str) -> None:
        lm = self.landmarks.pop(lm_id, None)
        if lm is None:
            return
        for shot_id in list(lm._observations):
            shot = self.shots.get(shot_id)
            if shot:
                shot._observations.pop(lm_id, None)

    def clear_observations_and_landmarks(self) -> None:
        for shot in self.shots.values():
            shot._observations.clear()
        self.landmarks.clear()

    # -- observations ---------------------------------------------------------
    def add_observation(self, shot_id: str, lm_id: str, observation: Observation):
        shot = self.shots[shot_id]
        lm = self.landmarks[lm_id]
        shot._observations[lm_id] = observation
        lm._observations[shot_id] = observation.id

    def remove_observation(self, shot_id: str, lm_id: str) -> None:
        shot = self.shots.get(shot_id)
        lm = self.landmarks.get(lm_id)
        if shot:
            shot._observations.pop(lm_id, None)
        if lm:
            lm._observations.pop(shot_id, None)

    def compute_reprojection_errors(self, tracks_manager, scaled: bool) -> None:
        for lm in self.landmarks.values():
            lm.reprojection_errors = {}
            for shot_id in lm.get_observations():
                shot = self.shots[shot_id]
                obs = shot.get_observation(lm.id)
                if obs is None:
                    continue
                proj = shot.project(lm.coordinates)
                err = proj - obs.point
                if scaled:
                    err = err / max(obs.scale, 1e-12)
                lm.reprojection_errors[shot_id] = err

    def to_tracks_manager(self) -> "TracksManager":
        tm = TracksManager()
        for shot in self.shots.values():
            for lm_id, obs in shot._observations.items():
                tm.add_observation(shot.id, lm_id, obs)
        return tm

    def __repr__(self) -> str:
        return (
            f"Map(cameras={len(self.cameras)}, shots={len(self.shots)}, "
            f"landmarks={len(self.landmarks)})"
        )


# ---------------------------------------------------------------------------
# TracksManager
# ---------------------------------------------------------------------------

TRACKS_HEADER = "OPENSFM_TRACKS_VERSION"
TRACKS_VERSION = 2


class TracksManager:
    """Bidirectional shot<->track observation store (tracks_manager.h:10-60).

    Text serialization is byte-compatible with the reference's tracks.csv
    (v0/v1/v2 readers, v2 writer — map/src/tracks_manager.cc:30-127,419-448).
    """

    def __init__(self) -> None:
        self._tracks_per_shot: Dict[str, Dict[str, Observation]] = {}
        self._shots_per_track: Dict[str, Dict[str, Observation]] = {}

    # -- edits ---------------------------------------------------------------
    def add_observation(self, shot_id: str, track_id: str, obs: Observation):
        self._tracks_per_shot.setdefault(shot_id, {})[track_id] = obs
        self._shots_per_track.setdefault(track_id, {})[shot_id] = obs

    def remove_observation(self, shot_id: str, track_id: str) -> None:
        self._tracks_per_shot.get(shot_id, {}).pop(track_id, None)
        track = self._shots_per_track.get(track_id)
        if track is not None:
            track.pop(shot_id, None)
            if not track:
                del self._shots_per_track[track_id]

    # -- queries -------------------------------------------------------------
    def get_observation(self, shot_id: str, track_id: str) -> Observation:
        return self._tracks_per_shot[shot_id][track_id]

    def num_shots(self) -> int:
        return len(self._tracks_per_shot)

    def num_tracks(self) -> int:
        return len(self._shots_per_track)

    def get_shot_ids(self) -> List[str]:
        return list(self._tracks_per_shot.keys())

    def get_track_ids(self) -> List[str]:
        return list(self._shots_per_track.keys())

    def get_shot_observations(self, shot_id: str) -> Dict[str, Observation]:
        return self._tracks_per_shot.get(shot_id, {})

    def get_track_observations(self, track_id: str) -> Dict[str, Observation]:
        return self._shots_per_track.get(track_id, {})

    def has_shot_observations(self, shot_id: str) -> bool:
        return shot_id in self._tracks_per_shot

    def construct_sub_tracks_manager(
        self, track_ids: Iterable[str], shot_ids: Iterable[str]
    ) -> "TracksManager":
        shot_set = set(shot_ids)
        sub = TracksManager()
        for track_id in track_ids:
            for shot_id, obs in self._shots_per_track.get(track_id, {}).items():
                if shot_id in shot_set:
                    sub.add_observation(shot_id, track_id, obs)
        return sub

    def get_all_common_observations(
        self, shot1: str, shot2: str
    ) -> List[Tuple[str, Observation, Observation]]:
        obs1 = self._tracks_per_shot.get(shot1, {})
        obs2 = self._tracks_per_shot.get(shot2, {})
        if len(obs1) > len(obs2):
            return [
                (t, obs1[t], o2) for t, o2 in obs2.items() if t in obs1
            ]
        return [(t, o1, obs2[t]) for t, o1 in obs1.items() if t in obs2]

    def get_all_pairs_connectivity(
        self,
        shots: Optional[Iterable[str]] = None,
        tracks: Optional[Iterable[str]] = None,
    ) -> Dict[Tuple[str, str], int]:
        """Number of common tracks for every shot pair that shares any."""
        shot_filter = set(shots) if shots else None
        track_ids = tracks if tracks else self._shots_per_track.keys()
        connectivity: Dict[Tuple[str, str], int] = {}
        for track_id in track_ids:
            observing = [
                s
                for s in self._shots_per_track.get(track_id, {})
                if shot_filter is None or s in shot_filter
            ]
            observing.sort()
            for i in range(len(observing)):
                for j in range(i + 1, len(observing)):
                    key = (observing[i], observing[j])
                    connectivity[key] = connectivity.get(key, 0) + 1
        return connectivity

    # -- serialization -------------------------------------------------------
    def as_string(self) -> str:
        lines = [f"{TRACKS_HEADER}_v{TRACKS_VERSION}"]
        for shot_id, tracks in self._tracks_per_shot.items():
            for track_id, o in tracks.items():
                lines.append(
                    f"{shot_id}\t{track_id}\t{o.id}\t{o.point[0]:g}\t{o.point[1]:g}"
                    f"\t{o.scale:g}\t{o.color[0]}\t{o.color[1]}\t{o.color[2]}"
                    f"\t{o.segmentation}\t{o.instance}"
                )
        return "\n".join(lines) + "\n"

    @staticmethod
    def instanciate_from_string(s: str) -> "TracksManager":
        lines = s.splitlines()
        version = 0
        start = 0
        if lines and lines[0].startswith(TRACKS_HEADER):
            version = int(lines[0].rsplit("_v", 1)[1])
            start = 1
        tm = TracksManager()
        for line in lines[start:]:
            if not line.strip():
                continue
            e = line.split("\t")
            if version == 0:
                shot, track, fid, x, y, r, g, b = e
                obs = Observation(float(x), float(y), 0.0, int(r), int(g), int(b), int(fid))
            elif version == 1:
                shot, track, fid, x, y, s_, r, g, b = e
                obs = Observation(float(x), float(y), float(s_), int(r), int(g), int(b), int(fid))
            else:
                shot, track, fid, x, y, s_, r, g, b, seg, inst = e
                obs = Observation(
                    float(x), float(y), float(s_), int(r), int(g), int(b),
                    int(fid), int(seg), int(inst),
                )
            tm.add_observation(shot, track, obs)
        return tm

    def write_to_file(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write(self.as_string())

    @staticmethod
    def instanciate_from_file(filename: str) -> "TracksManager":
        with open(filename) as f:
            return TracksManager.instanciate_from_string(f.read())
