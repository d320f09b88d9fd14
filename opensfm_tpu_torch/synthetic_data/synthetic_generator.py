"""Procedural generators: street geometry, camera paths, noisy inputs.

Port of `opensfm_tpu.synthetic_data.synthetic_generator` (reference
`opensfm/synthetic_data/synthetic_generator.py`: generate_street:102,
generate_cameras:110, generate_exifs:163, generate_track_data:364-460 with
the GCP synthesis and its shift).

Every function that draws random numbers takes `rng`, a
`np.random.RandomState`; `rng=None` draws from NumPy's global legacy state.
The draws are the JAX package's calls, in its order and with its shapes, so
one seed gives one scene in both packages.
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from opensfm_tpu_torch import features as oft
from opensfm_tpu_torch import pymap, types
from opensfm_tpu_torch.geo import TopocentricConverter
from opensfm_tpu_torch.geometry.angles import opk_from_rotation
from opensfm_tpu_torch.geometry.pose import (_matrix_to_rotvec_np,
                                             _rotvec_to_matrix_np)
from opensfm_tpu_torch.io import (GroundControlPoint,
                                  GroundControlPointObservation)

logger = logging.getLogger(__name__)


def _random(rng: Optional[np.random.RandomState]):
    """The generator to draw from: `rng`, or NumPy's global legacy state."""
    return np.random if rng is None else rng


def derivative(func: Callable[[float], np.ndarray], x: float) -> np.ndarray:
    eps = 1e-10
    d = (func(x + eps) - func(x)) / eps
    return d / np.linalg.norm(d)


def samples_generator_random_count(count: int, rng=None) -> np.ndarray:
    return _random(rng).rand(count)


def samples_generator_interval(
    length: float, end: float, interval: float, interval_noise: float,
    rng=None,
) -> np.ndarray:
    samples = np.linspace(0, end / length, num=int(end / interval))
    samples += _random(rng).normal(
        0.0, float(interval_noise) / float(length), samples.shape)
    return samples


def generate_samples_and_local_frame(samples, shape):
    points, tangents = [], []
    for i in samples:
        points.append(shape(i))
        ex = derivative(shape, i)
        ez = np.array([ex[1], -ex[0]])
        tangents.append(np.array([ez, ex]))
    return np.array(points), np.array(tangents)


def generate_samples_shifted(samples, shape, shift):
    plane_points = []
    for i in samples:
        point = shape(i)
        tangent = derivative(shape, i)
        tangent = np.array([-tangent[1], tangent[0]])
        plane_points.append(point + tangent * (shift / 2))
    return np.array(plane_points)


def generate_z_plane(samples, shape, thickness, rng=None):
    plane_points = []
    for i in samples:
        point = shape(i)
        tangent = derivative(shape, i)
        tangent = np.array([-tangent[1], tangent[0]])
        plane_points.append(
            point + tangent * ((_random(rng).rand() - 0.5) * thickness))
    plane_points = np.array(plane_points)
    return np.insert(plane_points, 2, values=0, axis=1)


def generate_xy_planes(samples, shape, z_size, y_size, rng=None):
    xy1 = generate_samples_shifted(samples, shape, y_size)
    xy2 = generate_samples_shifted(samples, shape, -y_size)
    xy1 = np.insert(xy1, 2, values=_random(rng).rand(xy1.shape[0]) * z_size,
                    axis=1)
    xy2 = np.insert(xy2, 2, values=_random(rng).rand(xy2.shape[0]) * z_size,
                    axis=1)
    return np.concatenate((xy1, xy2), axis=0)


def generate_street(samples, shape, height, width, rng=None):
    """Walls + floor point clouds along a parametric path."""
    walls = generate_xy_planes(samples, shape, height, width, rng=rng)
    floor = generate_z_plane(samples, shape, width, rng=rng)
    return walls, floor


def generate_cameras(samples, shape, height):
    """Positions and local frames along the path."""
    positions, rotations = generate_samples_and_local_frame(samples, shape)
    positions = np.insert(positions, 2, values=height, axis=1)
    rotations = np.insert(rotations, 2, values=0, axis=2)
    rotations = np.insert(rotations, 1, values=np.array([0, 0, -1]), axis=1)
    return positions, rotations


def line_generator(length, center_x, center_y, transpose, point):
    x = point * length
    if transpose:
        return np.array([center_y, x + center_x]).T
    return np.array([x + center_x, center_y]).T


def ellipse_generator(x_size, y_size, point):
    y = np.sin(point * 2 * np.pi) * y_size / 2
    x = np.cos(point * 2 * np.pi) * x_size / 2
    return np.array([x, y]).T


def perturb_points(points: np.ndarray, sigmas: List[float], rng=None) -> None:
    eps = 1e-10
    gaussian = np.array([max(s, eps) for s in sigmas])
    for point in points:
        point += _random(rng).normal(0.0, gaussian, point.shape)


def perturb_rotations(rotations: np.ndarray, angle_sigma: float,
                      rng=None) -> None:
    for i in range(len(rotations)):
        rodrigues = _matrix_to_rotvec_np(rotations[i])
        angle = np.linalg.norm(rodrigues)
        if angle < 1e-12:
            continue
        angle_perturbed = angle + _random(rng).normal(0.0, angle_sigma)
        rodrigues *= float(angle_perturbed) / float(angle)
        rotations[i] = _rotvec_to_matrix_np(rodrigues)


# ---------------------------------------------------------------------------
# Reconstruction assembly
# ---------------------------------------------------------------------------


def add_points_to_reconstruction(
    points: np.ndarray, color, reconstruction: types.Reconstruction
):
    shift = len(reconstruction.points)
    for i in range(points.shape[0]):
        point = reconstruction.create_point(str(shift + i), points[i, :])
        point.color = np.asarray(color, dtype=np.int64)


# ---------------------------------------------------------------------------
# Noisy input synthesis
# ---------------------------------------------------------------------------


def generate_exifs(
    reconstruction: types.Reconstruction,
    reference: TopocentricConverter,
    gps_noise: Union[Dict[str, float], float],
    imu_noise: float,
    causal_gps_noise: bool = False,
    rng=None,
) -> Dict[str, Any]:
    """Fake EXIF metadata with noisy GPS + OPK from the ground truth
    (synthetic_generator.py:163-265)."""
    from opensfm_tpu_torch.reconstruction import shot_lla_and_compass

    def _gps_dop(shot) -> float:
        if isinstance(gps_noise, dict):
            return gps_noise[shot.camera.id]
        if isinstance(gps_noise, float):
            return gps_noise
        return 15.0

    exifs: Dict[str, Any] = {}
    per_sequence = defaultdict(list)
    for shot_name in sorted(reconstruction.shots.keys()):
        shot = reconstruction.shots[shot_name]
        exif: Dict[str, Any] = {
            "width": shot.camera.width,
            "height": shot.camera.height,
            "camera": str(shot.camera.id),
            "make": str(shot.camera.id),
            "skey": (
                shot.metadata.sequence_key.value
                if shot.metadata.sequence_key.has_value
                else None
            ),
        }
        per_sequence[exif["skey"]].append(shot_name)
        if shot.camera.projection_type in ["perspective", "fisheye"]:
            exif["focal_ratio"] = shot.camera.focal
        exifs[shot_name] = exif

    speed_ms = 10.0
    previous_pose = None
    previous_time = 0.0
    for rig_instance in sorted(
        reconstruction.rig_instances.values(), key=lambda x: x.id
    ):
        pose = rig_instance.pose.get_origin()
        if previous_pose is not None:
            previous_time += np.linalg.norm(pose - previous_pose) / speed_ms
        previous_pose = pose
        for shot_id in rig_instance.shots:
            exifs[shot_id]["capture_time"] = previous_time

    for sequence_images in per_sequence.values():
        for shot_name in sequence_images:
            shot = reconstruction.shots[shot_name]
            exif = exifs[shot_name]
            origin = shot.pose.get_origin()
            dop = _gps_dop(shot)
            origin = np.array([origin], dtype=np.float64)
            perturb_points(origin, [dop, dop, 0], rng=rng)
            origin = origin[0]
            _, _, _, comp = shot_lla_and_compass(shot, reference)
            lat, lon, alt = reference.to_lla(*origin)
            exif["gps"] = {
                "latitude": lat, "longitude": lon, "altitude": alt, "dop": dop,
            }
            omega, phi, kappa = opk_from_rotation(
                shot.pose.get_rotation_matrix())
            opk_noise = _random(rng).normal(
                0.0, np.full(3, max(imu_noise, 1e-10)), 3)
            exif["opk"] = {
                "omega": math.degrees(omega) + opk_noise[0],
                "phi": math.degrees(phi) + opk_noise[1],
                "kappa": math.degrees(kappa) + opk_noise[2],
            }
            exif["compass"] = {"angle": comp}
    return exifs


def _is_in_front(point, center, z_axis) -> bool:
    return (point - center) @ z_axis > 0


def _is_inside_camera(projection, camera) -> bool:
    w, h = float(camera.width), float(camera.height)
    w2, h2 = 2.0 * w, 2.0 * h
    if w > h:
        return ((-0.5 < projection[0] < 0.5)
                and (-h / w2 < projection[1] < h / w2))
    return ((-0.5 < projection[1] < 0.5)
            and (-w / h2 < projection[0] < w / h2))


def generate_track_data(
    reconstruction: types.Reconstruction,
    maximum_depth: float,
    projection_noise: float,
    gcp_noise: Tuple[float, float],
    gcps_count: Optional[int],
    gcp_shift: Optional[np.ndarray],
    rng=None,
) -> Tuple[Dict[str, oft.FeaturesData], pymap.TracksManager,
           Dict[str, GroundControlPoint]]:
    """Noisy projections assembled straight into a TracksManager (no
    matching: the reconstruction stages alone are under test,
    synthetic_generator.py:364-460)."""
    from scipy import spatial

    rand = _random(rng)
    tracks_manager = pymap.TracksManager()
    desc_size, non_zeroes = 128, 5
    points_ids = list(reconstruction.points)
    points_coordinates = [p.coordinates for p in reconstruction.points.values()]
    points_colors = [p.color for p in reconstruction.points.values()]

    track_descriptors = []
    for _ in points_coordinates:
        descriptor = np.zeros(desc_size)
        for _ in range(non_zeroes):
            descriptor[rand.randint(0, desc_size)] = rand.random() * 255
        track_descriptors.append(descriptor.round().astype(np.float32))

    points_tree = spatial.cKDTree(points_coordinates)
    features: Dict[str, oft.FeaturesData] = {}
    default_scale = 0.004

    for shot_index, shot in reconstruction.shots.items():
        neighbors = sorted(
            points_tree.query_ball_point(shot.pose.get_origin(), maximum_depth)
        )
        if not neighbors:
            features[shot_index] = oft.FeaturesData(
                np.zeros((0, 3)), np.zeros((0, desc_size)), np.zeros((0, 3)),
                None,
            )
            continue
        projections = shot.project_many(
            np.array([points_coordinates[c] for c in neighbors])
        )
        center = shot.pose.get_origin()
        z_axis = shot.pose.get_rotation_matrix()[2]
        is_panorama = shot.camera.projection_type in (
            "spherical", "equirectangular")
        perturbation = float(projection_noise) / float(
            max(shot.camera.width, shot.camera.height)
        )
        perturbations = rand.normal(
            0.0, np.array([max(perturbation, 1e-12)] * 2),
            (len(projections), 2)
        )

        projections_inside, descriptors_inside, colors_inside = [], [], []
        for i, (p_id, projection) in enumerate(zip(neighbors, projections)):
            if not _is_inside_camera(projection, shot.camera):
                continue
            point = points_coordinates[p_id]
            if not is_panorama and not _is_in_front(point, center, z_axis):
                continue
            projection = projection + perturbations[i]
            color = points_colors[p_id]
            projections_inside.append(
                [projection[0], projection[1], default_scale])
            descriptors_inside.append(track_descriptors[p_id])
            colors_inside.append(color)
            obs = pymap.Observation(
                projection[0], projection[1], default_scale,
                int(color[0]), int(color[1]), int(color[2]),
                len(projections_inside) - 1,
            )
            tracks_manager.add_observation(
                str(shot_index), str(points_ids[p_id]), obs)
        features[shot_index] = oft.FeaturesData(
            np.array(projections_inside),
            np.array(descriptors_inside),
            np.array(colors_inside),
            None,
        )

    gcps: Dict[str, GroundControlPoint] = {}
    if gcps_count is not None and gcp_shift is not None:
        all_track_ids = list(tracks_manager.get_track_ids())
        gcps_ids = [
            all_track_ids[i]
            for i in rand.randint(len(all_track_ids) - 1, size=gcps_count)
        ]
        sigmas_gcp = rand.normal(
            0.0,
            np.array([gcp_noise[0], gcp_noise[0], gcp_noise[1]]),
            (len(gcps_ids), 3),
        )
        for i, gcp_id in enumerate(gcps_ids):
            point = reconstruction.points[gcp_id]
            gcp = GroundControlPoint()
            gcp.id = f"gcp-{gcp_id}"
            enu = point.coordinates + np.asarray(gcp_shift) + sigmas_gcp[i]
            lat, lon, alt = reconstruction.reference.to_lla(*enu)
            gcp.lla = {"latitude": lat, "longitude": lon, "altitude": alt}
            gcp.has_altitude = True
            for shot_id, obs in tracks_manager.get_track_observations(
                    gcp_id).items():
                gcp.observations.append(
                    GroundControlPointObservation(shot_id, obs.point)
                )
            gcps[gcp.id] = gcp
    return features, tracks_manager, gcps
