"""GPS/GCP alignment constraints for the bundle.

Port of the part of `opensfm_tpu.align` that `ba.problem.bundle` needs with
`align_method: auto` (align.py:119-182 of the reference): the 3D-3D
correspondences from GPS and GCP data, and the test that decides whether
they lie on a single line (then the bundle adds up-vector prior rows).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import types
from opensfm_tpu_torch.geometry import triangulation as tri

logger = logging.getLogger(__name__)


def triangulate_gcp(
    point,
    shots: Dict[str, Any],
    reproj_threshold: float = 0.02,
    min_ray_angle_degrees: float = 1.0,
    min_depth: float = 0.001,
) -> Optional[np.ndarray]:
    """Triangulate a GCP from its image observations, or None when fewer
    than two shots see it or the rays fail validation.  The defaults are the
    reference's strict alignment thresholds (multiview.py:556-589)."""
    os_, bs = [], []
    for obs in point.observations:
        shot = shots.get(obs.shot_id)
        if shot is None:
            continue
        bearing = shot.camera.bearing(obs.projection)
        pose = shot.pose
        bs.append(pose.get_rotation_matrix().T @ bearing)
        os_.append(pose.get_origin())
    if len(bs) < 2:
        return None
    k = len(bs)
    ok, X = tri.triangulate_bearings_midpoint(
        torch.as_tensor(np.asarray(os_), dtype=torch.float64),
        torch.as_tensor(np.asarray(bs), dtype=torch.float64),
        torch.ones(k, dtype=torch.bool),
        torch.full((k,), reproj_threshold, dtype=torch.float64),
        min_angle=math.radians(min_ray_angle_degrees), min_depth=min_depth,
    )
    return X.numpy() if bool(ok) else None


def triangulate_all_gcp(
    reconstruction: types.Reconstruction, gcp: List[Any]
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Triangulated and measured GCP coordinates."""
    triangulated, measured = [], []
    for point in gcp:
        X = triangulate_gcp(point, reconstruction.shots)
        if X is not None and point.lla:
            triangulated.append(X)
            measured.append(
                np.asarray(reconstruction.reference.to_topocentric(*point.lla_vec))
            )
    return triangulated, measured


def alignment_constraints(
    config: Dict[str, Any],
    reconstruction: types.Reconstruction,
    gcp: List[Any],
    use_gps: bool,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """3D-3D correspondences from GCP and GPS (align.py:119-144)."""
    X, Xp = [], []
    if gcp and config["bundle_use_gcp"]:
        triangulated, measured = triangulate_all_gcp(reconstruction, gcp)
        X.extend(triangulated)
        Xp.extend(measured)
    if use_gps and config["bundle_use_gps"]:
        for rig_instance in reconstruction.rig_instances.values():
            gpses = [
                np.asarray(shot.metadata.gps_position.value, dtype=np.float64)
                for shot in rig_instance.shots.values()
                if shot.metadata.gps_position.has_value
            ]
            if gpses:
                X.append(rig_instance.pose.get_origin())
                Xp.append(np.average(gpses, axis=0))
    return X, Xp


def detect_alignment_constraints(
    config: Dict[str, Any],
    reconstruction: types.Reconstruction,
    gcp: List[Any],
    use_gps: bool,
) -> str:
    """'naive' unless constraints are on a single line (align.py:147-182)."""
    X, _ = alignment_constraints(config, reconstruction, gcp, use_gps)
    if len(X) < 3:
        return "orientation_prior"
    X = np.array(X)
    X = X - np.average(X, axis=0)
    evalues = np.sort(np.linalg.eigvalsh(X.T @ X))
    ratio_1st_2nd = math.fabs(evalues[2] / max(evalues[1], 1e-30))
    epsilon_abs = 1e-10
    epsilon_ratio = 5e3
    is_line = np.sum(evalues < epsilon_abs) > 1 or ratio_1st_2nd > epsilon_ratio
    if is_line:
        logger.warning(
            "Shots and/or GCPs are aligned on a single-line. Using %s prior",
            config["align_orientation_prior"],
        )
        return "orientation_prior"
    return "naive"
