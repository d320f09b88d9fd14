"""Synthetic scenes: street/cube ground truth + noisy input synthesis.

Port of `opensfm_tpu.synthetic_data.synthetic_scene` (reference
`opensfm/synthetic_data/synthetic_scene.py`: SyntheticCubeScene:88,
SyntheticStreetScene:148, SyntheticInputData:426-480, compare:482-530).
Scenes and inputs take `rng` (a `np.random.RandomState`; None draws from
NumPy's global legacy state) and hand it to every draw of
`synthetic_generator`, in the JAX package's order.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from opensfm_tpu_torch import geo, pymap, types
from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose
from opensfm_tpu_torch.reconstruction_helpers import exif_to_metadata
from opensfm_tpu_torch.synthetic_data import synthetic_generator as sg
from opensfm_tpu_torch.synthetic_data import synthetic_metrics as sm


def get_scene_generator(type_: str, length: float) -> Callable[[float], np.ndarray]:
    """Path generator (synthetic_scene.py:35-55): 'circle' is an ellipse of
    axis sizes (length, length), 'line' a transposed line of that length."""
    if type_ == "circle":
        return functools.partial(sg.ellipse_generator, length, length)
    if type_ == "ellipse":
        return functools.partial(sg.ellipse_generator, length, length / 2)
    if type_ == "line":
        return functools.partial(sg.line_generator, length, 0.0, 0.0, True)
    raise ValueError(f"Unknown scene generator type {type_}")


def get_camera(type_: str, id_: str, focal: float, k1: float, k2: float) -> Camera:
    if type_ == "perspective":
        camera = Camera.create_perspective(focal, k1, k2)
    elif type_ == "fisheye":
        camera = Camera.create_fisheye(focal, k1, k2)
    elif type_ == "spherical":
        camera = Camera.create_spherical()
    else:
        raise ValueError(type_)
    camera.id = id_
    camera.height = 1600
    camera.width = 2000
    return camera


def camera_pose(position, lookat, up) -> Pose:
    """World-to-camera pose looking at a target (synthetic_scene.py:57-85)."""
    ez = np.asarray(lookat, dtype=np.float64) - np.asarray(position, dtype=np.float64)
    ez /= np.linalg.norm(ez)
    ex = np.cross(ez, np.asarray(up, dtype=np.float64))
    ex /= np.linalg.norm(ex)
    ey = np.cross(ez, ex)
    pose = Pose()
    pose.set_rotation_matrix(np.stack([ex, ey, ez]))
    pose.set_origin(position)
    return pose


class SyntheticScene:
    def get_reconstruction(self) -> types.Reconstruction:
        raise NotImplementedError


class SyntheticCubeScene(SyntheticScene):
    """Cameras on a sphere looking at points in a cube
    (synthetic_scene.py:88-145)."""

    def __init__(self, num_cameras: int, num_points: int, noise: float,
                 rng=None) -> None:
        rand = sg._random(rng)
        self.reconstruction = types.Reconstruction()
        for i in range(num_cameras):
            camera = Camera.create_perspective(0.9, -0.1, 0.01)
            camera.id = "camera%04d" % i
            camera.height = 600
            camera.width = 800
            self.reconstruction.add_camera(camera)

        r = 2.0
        for i in range(num_cameras):
            phi = rand.rand() * math.pi
            theta = rand.rand() * 2.0 * math.pi
            position = np.array(
                [
                    r * np.sin(theta) * np.cos(phi),
                    r * np.sin(theta) * np.sin(phi),
                    r * np.cos(theta),
                ]
            )
            alpha = rand.rand()
            pose = camera_pose(position, [0.0, 0, 0], [alpha * 0.2, alpha * 0.2, 1.0])
            self.reconstruction.create_shot("shot%04d" % i, "camera%04d" % i, pose)

        points = rand.rand(num_points, 3) - [0.5, 0.5, 0.5]
        for i, p in enumerate(points):
            pt = self.reconstruction.create_point("point" + str(i), p)
            pt.color = np.array([100, 100, 20])

    def get_reconstruction(self) -> types.Reconstruction:
        import copy

        return copy.deepcopy(self.reconstruction)


class _Sequence:
    """One camera (or rig) sequence along the path."""

    def __init__(self, cameras, rig_cameras, instances, positions, rotations):
        self.cameras = cameras  # List[Camera] per rig slot
        self.rig_cameras = rig_cameras  # List[RigCamera]
        self.instances = instances  # List[List[(shot_id, rig_camera_id, camera_id)]]
        self.positions = positions
        self.rotations = rotations


class SyntheticStreetScene(SyntheticScene):
    """Virtual street extruded along a parametric path with cameras on it
    (synthetic_scene.py:148-424)."""

    def __init__(self, generator, reference=None, rng=None) -> None:
        self.generator = generator
        self.rng = rng
        self.reference = reference
        self.wall_points: Optional[np.ndarray] = None
        self.floor_points: Optional[np.ndarray] = None
        self.sequences: List[_Sequence] = []
        self.width = 0.0

    def _num_shots(self) -> int:
        return sum(
            len(inst) for seq in self.sequences for inst in seq.instances
        )

    def add_street(self, points_count, height, width) -> "SyntheticStreetScene":
        self.wall_points, self.floor_points = sg.generate_street(
            sg.samples_generator_random_count(int(points_count // 3),
                                              rng=self.rng),
            self.generator, height, width, rng=self.rng,
        )
        self.width = width
        return self

    def perturb_walls(self, sigmas) -> "SyntheticStreetScene":
        sg.perturb_points(self.wall_points, sigmas, rng=self.rng)
        return self

    def perturb_floor(self, sigmas) -> "SyntheticStreetScene":
        sg.perturb_points(self.floor_points, sigmas, rng=self.rng)
        return self

    def add_camera_sequence(
        self, camera, length, height, interval, position_noise, rotation_noise,
        positions_shift=None, end=None,
    ) -> "SyntheticStreetScene":
        default_noise_interval = 0.25 * interval
        actual_end = length if end is None else end
        positions, rotations = sg.generate_cameras(
            sg.samples_generator_interval(
                length, actual_end, interval, default_noise_interval,
                rng=self.rng,
            ),
            self.generator, height,
        )
        sg.perturb_points(positions, position_noise, rng=self.rng)
        sg.perturb_rotations(rotations, rotation_noise, rng=self.rng)
        if positions_shift:
            positions += np.array(positions_shift)

        shift = self._num_shots()
        rig_camera = pymap.RigCamera(Pose(), camera.id)
        instances = []
        for i in range(len(positions)):
            shot_id = f"Shot {shift + i:04d}"
            instances.append([(shot_id, camera.id, camera.id)])
        self.sequences.append(
            _Sequence([camera], [rig_camera], instances, positions, rotations)
        )
        return self

    def add_rig_camera_sequence(
        self, cameras, relative_positions, relative_rotations, length, height,
        interval, position_noise, rotation_noise, end=None,
    ) -> "SyntheticStreetScene":
        default_noise_interval = 0.25 * interval
        actual_end = length if end is None else end
        instances_positions, instances_rotations = sg.generate_cameras(
            sg.samples_generator_interval(
                length, actual_end, interval, default_noise_interval,
                rng=self.rng,
            ),
            self.generator, height,
        )
        sg.perturb_points(instances_positions, position_noise, rng=self.rng)
        sg.perturb_rotations(instances_rotations, rotation_noise,
                             rng=self.rng)

        shift = self._num_shots()
        n_slots = len(relative_positions)
        rig_cameras = []
        for i, (rc_p, rc_r) in enumerate(zip(relative_positions, relative_rotations)):
            pose = Pose(rc_r)
            pose.set_origin(rc_p)
            rig_cameras.append(pymap.RigCamera(pose, f"RigCamera {i}"))

        instances = []
        for i in range(len(instances_positions)):
            instance = []
            for j in range(n_slots):
                shot_id = f"Shot {shift + i * n_slots + j:04d}"
                instance.append((shot_id, rig_cameras[j].id, cameras[j].id))
            instances.append(instance)
        self.sequences.append(
            _Sequence(
                list(cameras), rig_cameras, instances,
                instances_positions, instances_rotations,
            )
        )
        return self

    def get_reconstruction(self) -> types.Reconstruction:
        floor_color = [120, 90, 10]
        wall_color = [10, 90, 130]
        reconstruction = types.Reconstruction()
        if self.reference is not None:
            reconstruction.reference = self.reference
        sg.add_points_to_reconstruction(self.floor_points, floor_color, reconstruction)
        sg.add_points_to_reconstruction(self.wall_points, wall_color, reconstruction)

        instance_counter = 0
        for seq in self.sequences:
            for camera in seq.cameras:
                if camera.id not in reconstruction.cameras:
                    reconstruction.add_camera(camera)
            for rig_camera in seq.rig_cameras:
                if rig_camera.id not in reconstruction.rig_cameras:
                    reconstruction.add_rig_camera(rig_camera)
            for instance, position, rotation in zip(
                seq.instances, seq.positions, seq.rotations
            ):
                instance_id = str(instance_counter)
                instance_counter += 1
                reconstruction.add_rig_instance(pymap.RigInstance(instance_id))
                for shot_id, rig_camera_id, camera_id in instance:
                    reconstruction.create_shot(
                        shot_id, camera_id,
                        rig_camera_id=rig_camera_id, rig_instance_id=instance_id,
                    )
                pose = Pose()
                pose.set_rotation_matrix(rotation)
                pose.set_origin(position)
                reconstruction.rig_instances[instance_id].pose = pose
        return reconstruction

    def get_rig_assignments(self) -> List[List[Tuple[str, str]]]:
        """Rig assignments for multi-camera sequences (dataset contract)."""
        assignments = []
        for seq in self.sequences:
            if len(seq.rig_cameras) < 2:
                continue
            for instance in seq.instances:
                assignments.append(
                    [(shot_id, rig_camera_id) for shot_id, rig_camera_id, _ in instance]
                )
        return assignments

    def get_rig_cameras(self) -> Dict[str, pymap.RigCamera]:
        out = {}
        for seq in self.sequences:
            if len(seq.rig_cameras) < 2:
                continue
            for rc in seq.rig_cameras:
                out[rc.id] = rc
        return out


class SyntheticInputData:
    """Re-synthesized noisy inputs (EXIF, projections, GCPs) from a
    ground-truth reconstruction (synthetic_scene.py:426-480)."""

    def __init__(
        self,
        reconstruction: types.Reconstruction,
        reference: geo.TopocentricConverter,
        projection_max_depth: float,
        projection_noise: float,
        gps_noise: Union[Dict[str, float], float],
        imu_noise: float,
        gcp_noise: Tuple[float, float],
        causal_gps_noise: bool = False,
        gcps_count: Optional[int] = None,
        gcps_shift: Optional[np.ndarray] = None,
        rng=None,
    ) -> None:
        self.reconstruction = reconstruction
        self.exifs = sg.generate_exifs(
            reconstruction, reference, gps_noise, imu_noise,
            causal_gps_noise=causal_gps_noise, rng=rng,
        )
        for shot in self.reconstruction.shots.values():
            shot.metadata = exif_to_metadata(
                self.exifs[shot.id], False, self.reconstruction.reference
            )
        (self.features, self.tracks_manager, self.gcps) = sg.generate_track_data(
            reconstruction, projection_max_depth, projection_noise, gcp_noise,
            gcps_count, gcps_shift, rng=rng,
        )


def compare(
    reference: types.Reconstruction,
    gcps: Dict[str, Any],
    reconstruction: types.Reconstruction,
    device=None,
) -> Dict[str, float]:
    """Compare a reconstruction against ground truth
    (synthetic_scene.py:482-530); the GCPs are triangulated on `device`
    (CUDA unless told otherwise)."""
    georef = reference.reference
    completeness = sm.completeness_errors(reference, reconstruction)

    geo_referenced = sm.change_geo_reference(
        reconstruction, georef.lat, georef.lon, georef.alt
    )
    absolute_position = sm.position_errors(reference, geo_referenced)
    absolute_rotation = sm.rotation_errors(reference, geo_referenced)
    absolute_points = sm.points_errors(reference, geo_referenced)
    absolute_gps = sm.gps_errors(geo_referenced)
    absolute_gcp = sm.gcp_errors(geo_referenced, gcps, device=device)

    aligned = sm.aligned_to_reference(reference, geo_referenced)
    aligned_position = sm.position_errors(reference, aligned)
    aligned_rotation = sm.rotation_errors(reference, aligned)
    aligned_points = sm.points_errors(reference, aligned)
    aligned_gps = sm.gps_errors(aligned)

    return {
        "ratio_cameras": completeness[0],
        "ratio_points": completeness[1],
        "absolute_position_rmse": sm.rmse(absolute_position),
        "absolute_position_mad": sm.mad(absolute_position),
        "absolute_rotation_rmse": sm.rmse(absolute_rotation),
        "absolute_rotation_median": float(np.median(absolute_rotation)),
        "absolute_points_rmse": sm.rmse(absolute_points),
        "absolute_points_mad": sm.mad(absolute_points),
        "absolute_gps_rmse": sm.rmse(absolute_gps),
        "absolute_gps_mad": sm.mad(absolute_gps),
        "absolute_gcp_rmse_horizontal": (
            sm.rmse(absolute_gcp[:, :2]) if absolute_gcp.ndim > 1 else 0.0
        ),
        "absolute_gcp_rmse_vertical": (
            sm.rmse(absolute_gcp[:, 2]) if absolute_gcp.ndim > 1 else 0.0
        ),
        "aligned_position_rmse": sm.rmse(aligned_position),
        "aligned_position_mad": sm.mad(aligned_position),
        "aligned_rotation_rmse": sm.rmse(aligned_rotation),
        "aligned_rotation_median": float(np.median(aligned_rotation)),
        "aligned_gps_rmse": sm.rmse(aligned_gps),
        "aligned_gps_mad": sm.mad(aligned_gps),
        "aligned_points_rmse": sm.rmse(aligned_points),
        "aligned_points_mad": sm.mad(aligned_points),
    }
