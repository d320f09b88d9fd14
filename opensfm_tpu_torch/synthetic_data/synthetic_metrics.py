"""Reconstruction comparison metrics (ATE-style aligned errors).

Port of `opensfm_tpu.synthetic_data.synthetic_metrics` (reference
`opensfm/synthetic_data/synthetic_metrics.py:12-165`).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import align as oalign
from opensfm_tpu_torch import geo, multiview
from opensfm_tpu_torch.geometry import transform as tf_mod
from opensfm_tpu_torch.geometry.pose import _matrix_to_rotvec_np


def points_errors(reference, candidate) -> np.ndarray:
    common = set(reference.points) & set(candidate.points)
    return np.array(
        [
            reference.points[p].coordinates - candidate.points[p].coordinates
            for p in common
        ]
    )


def completeness_errors(reference, candidate) -> Tuple[float, float]:
    return (
        float(len(candidate.shots)) / float(len(reference.shots)),
        float(len(candidate.points)) / float(len(reference.points)),
    )


def gps_errors(candidate) -> np.ndarray:
    errors = []
    for shot in candidate.shots.values():
        if not shot.metadata.gps_position.has_value:
            continue
        bias = candidate.biases[shot.camera.id]
        pose1 = bias.transform(shot.metadata.gps_position.value)
        pose2 = shot.pose.get_origin()
        errors.append(pose1 - pose2)
    return np.array(errors)


def gcp_errors(candidate, gcps: Dict[str, object], device=None) -> np.ndarray:
    errors = []
    for gcp in gcps.values():
        if not gcp.lla:
            continue
        triangulated = multiview.triangulate_gcp(gcp, candidate.shots,
                                                 device=device)
        if triangulated is None:
            continue
        gcp_enu = candidate.reference.to_topocentric(*gcp.lla_vec)
        errors.append(triangulated - np.asarray(gcp_enu))
    return np.array(errors)


def position_errors(reference, candidate) -> np.ndarray:
    common = set(reference.shots) & set(candidate.shots)
    return np.array(
        [
            reference.shots[s].pose.get_origin() - candidate.shots[s].pose.get_origin()
            for s in common
        ]
    )


def rotation_errors(reference, candidate) -> np.ndarray:
    common = set(reference.shots) & set(candidate.shots)
    errors = []
    for s in common:
        R1 = reference.shots[s].pose.get_rotation_matrix()
        R2 = candidate.shots[s].pose.get_rotation_matrix()
        errors.append(np.linalg.norm(_matrix_to_rotvec_np(R1.T @ R2)))
    return np.array(errors)


def find_alignment(points0: List, points1: List) -> Tuple[float, np.ndarray, np.ndarray]:
    """(s, A, b) with points1 = s A points0 + b (Umeyama, in f64 on the
    host)."""
    v0 = np.array([p for p in points0 if p is not None], dtype=np.float64)
    v1 = np.array([p for p in points1 if p is not None], dtype=np.float64)
    T = tf_mod.similarity_between_points(
        torch.from_numpy(v0), torch.from_numpy(v1)).numpy()
    s = np.linalg.det(T[:3, :3]) ** (1.0 / 3.0)
    return s, T[:3, :3] / s, T[:3, 3]


def aligned_to_reference(reference, reconstruction):
    """Similarity-align a reconstruction to the reference (ATE-style)."""
    coords1, coords2 = [], []
    for point1 in reconstruction.points.values():
        point2 = reference.points.get(point1.id)
        if point2 is not None:
            coords1.append(point1.coordinates)
            coords2.append(point2.coordinates)
    if not coords1:
        for shot1 in reconstruction.shots.values():
            shot2 = reference.shots.get(shot1.id)
            if shot2 is not None:
                coords1.append(shot1.pose.get_origin())
                coords2.append(shot2.pose.get_origin())
    s, A, b = find_alignment(coords1, coords2)
    aligned = copy.deepcopy(reconstruction)
    oalign.apply_similarity(aligned, s, A, b)
    return aligned


def change_geo_reference(reconstruction, latitude, longitude, altitude):
    """Re-root the topocentric reference (small-extent approximation)."""
    t_old_new = reconstruction.reference.to_topocentric(latitude, longitude, altitude)
    b = -np.array(t_old_new)
    aligned = copy.deepcopy(reconstruction)
    aligned.reference = geo.TopocentricConverter(latitude, longitude, altitude)
    oalign.apply_similarity(aligned, 1.0, np.eye(3), b)
    for shot in aligned.shots.values():
        if shot.metadata.gps_position.has_value:
            shot.metadata.gps_position.value = (
                np.asarray(shot.metadata.gps_position.value) + b
            )
    return aligned


def rmse(errors: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.asarray(errors) ** 2)))


def mad(errors: np.ndarray) -> float:
    errors = np.asarray(errors)
    return float(np.median(np.absolute(errors - np.median(errors))))
