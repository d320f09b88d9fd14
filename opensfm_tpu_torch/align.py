"""Align a reconstruction to GPS and GCP data.

Port of `opensfm_tpu.align`, which mirrors the reference
`opensfm/align.py:18-455`: similarity alignment to GPS+GCP constraints,
degenerate single-line detection (eigenvalue test), orientation-prior
alignment for linear captures, and per-camera GPS bias compensation.  The
GCP triangulation and the Umeyama fits run on `device` (CUDA unless told
otherwise), as the JAX package runs them on its default device.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import multiview, resolve_device, types
from opensfm_tpu_torch.geometry import transform as tf_mod
from opensfm_tpu_torch.geometry.pose import Pose, Similarity

logger = logging.getLogger(__name__)


def align_reconstruction(
    reconstruction: types.Reconstruction,
    gcp: List[Any],
    config: Dict[str, Any],
    use_gps: bool = True,
    bias_override: bool = False,
    device=None,
) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """Align a reconstruction with GPS and GCP data (align.py:18-39)."""
    has_scaled_rigs = any(
        len(ri.shots) > 1 for ri in reconstruction.rig_instances.values()
    )
    use_scale = not has_scaled_rigs
    if bias_override and config["bundle_compensate_gps_bias"]:
        return set_gps_bias(reconstruction, config, gcp, use_scale,
                            device=device)
    # When GPS bias compensation is on, GPS and GCP live in frames that
    # differ by the (yet unestimated) bias; mixing both in one rigid
    # similarity tilts the model whenever the GCPs are unevenly spread.
    # Align on GPS alone during iteration — the GCP/GPS offset is resolved
    # by set_gps_bias at the final bias_override stage.  (The reference
    # mixes both (align.py:18-39) and is fragile to clustered GCPs.)
    align_gcp = gcp
    if config.get("bundle_compensate_gps_bias", False) and use_gps and any(
        shot.metadata.gps_position.has_value
        for shot in reconstruction.shots.values()
    ):
        align_gcp = []
    res = compute_reconstruction_similarity(
        reconstruction, align_gcp, config, use_gps, use_scale, device=device
    )
    if res:
        s, A, b = res
        apply_similarity(reconstruction, s, A, b)
    return res


def _similarity(X: np.ndarray, Xp: np.ndarray, device) -> np.ndarray:
    """The Umeyama similarity [4, 4] mapping X onto Xp, on `device`."""
    dev = resolve_device(device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    return tf_mod.similarity_between_points(f64(X), f64(Xp)).cpu().numpy()


def apply_similarity_pose(pose: Pose, s: float, A: np.ndarray, b: np.ndarray) -> None:
    """Apply y = s A x + b to an object with world-to-cam pose (align.py:41-51)."""
    R = pose.get_rotation_matrix()
    t = np.array(pose.translation)
    Rp = R @ A.T
    tp = -Rp @ b + s * t
    pose.set_rotation_matrix(Rp)
    pose.translation = tp


def apply_similarity(
    reconstruction: types.Reconstruction, s: float, A: np.ndarray, b: np.ndarray
) -> None:
    """Apply a similarity (y = s A x + b) to a reconstruction (align.py:54-74)."""
    for point in reconstruction.points.values():
        point.coordinates = s * (A @ point.coordinates) + b
    for rig_instance in reconstruction.rig_instances.values():
        pose = rig_instance.pose
        apply_similarity_pose(pose, s, A, b)
        rig_instance.pose = pose
    for rig_camera in reconstruction.rig_cameras.values():
        # Scale rig camera lever-arms only.
        pose = rig_camera.pose
        apply_similarity_pose(pose, s, np.eye(3), np.zeros(3))
        rig_camera.pose = pose


def compute_reconstruction_similarity(
    reconstruction: types.Reconstruction,
    gcp: List[Any],
    config: Dict[str, Any],
    use_gps: bool,
    use_scale: bool,
    device=None,
) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """(s, A, b) aligning the reconstruction to GPS/GCP (align.py:77-116)."""
    align_method = config["align_method"]
    if align_method == "auto":
        align_method = detect_alignment_constraints(
            config, reconstruction, gcp, use_gps, device=device
        )
    res = None
    if align_method == "orientation_prior":
        res = compute_orientation_prior_similarity(
            reconstruction, config, gcp, use_gps, use_scale, device=device
        )
    elif align_method == "naive":
        res = compute_naive_similarity(config, reconstruction, gcp, use_gps,
                                       use_scale, device=device)
    if not res:
        return None
    s, A, b = res
    if s == 0 or np.isnan(A).any() or np.isnan(b).any():
        logger.warning(
            "Computation of alignment similarity (%s) is degenerate.", align_method
        )
        return None
    return res


def alignment_constraints(
    config: Dict[str, Any],
    reconstruction: types.Reconstruction,
    gcp: List[Any],
    use_gps: bool,
    device=None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """3D-3D correspondences from GCP and GPS (align.py:119-144)."""
    X, Xp = [], []
    if gcp and config["bundle_use_gcp"]:
        triangulated, measured = triangulate_all_gcp(reconstruction, gcp,
                                                     device=device)
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


def triangulate_all_gcp(
    reconstruction: types.Reconstruction, gcp: List[Any], device=None
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Triangulated and measured GCP coordinates (align.py GCP helper)."""
    triangulated, measured = [], []
    for point in gcp:
        X = multiview.triangulate_gcp(point, reconstruction.shots,
                                      device=device)
        if X is not None and point.lla:
            triangulated.append(X)
            measured.append(
                np.asarray(reconstruction.reference.to_topocentric(*point.lla_vec))
            )
    return triangulated, measured


def detect_alignment_constraints(
    config: Dict[str, Any],
    reconstruction: types.Reconstruction,
    gcp: List[Any],
    use_gps: bool,
    device=None,
) -> str:
    """'naive' unless constraints are on a single line (align.py:147-182)."""
    X, _ = alignment_constraints(config, reconstruction, gcp, use_gps,
                                 device=device)
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


def compute_naive_similarity(
    config: Dict[str, Any],
    reconstruction: types.Reconstruction,
    gcp: List[Any],
    use_gps: bool,
    use_scale: bool,
    device=None,
) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """Direct 3D-3D Umeyama alignment (align.py:185-227)."""
    X, Xp = alignment_constraints(config, reconstruction, gcp, use_gps,
                                  device=device)
    if len(X) == 0:
        return None

    same_values = np.linalg.norm(np.std(Xp, axis=0)) < 1e-10
    single_value = len(X) == 1
    if single_value:
        logger.warning("Only 1 constraint. Using translation-only alignment.")
    if same_values:
        logger.warning(
            "GPS/GCP data seems to have identical values. "
            "Using translation-only alignment."
        )
    if same_values or single_value:
        t = np.array(Xp[0]) - np.array(X[0])
        return 1.0, np.identity(3), t

    if len(X) == 2:
        logger.warning("Only 2 constraints. Will be up to some unknown rotation.")
        X.append(X[1])
        Xp.append(Xp[1])

    X = np.array(X)
    Xp = np.array(Xp)
    T = _similarity(X, Xp, device)
    A, b = T[:3, :3], T[:3, 3]
    s = np.linalg.det(A) ** (1.0 / 3)
    A = A / s
    if not use_scale:
        b = b + (s - 1.0) * (A @ np.average(X, axis=0))
        s = 1.0
    return s, A, b


def compute_orientation_prior_similarity(
    reconstruction: types.Reconstruction,
    config: Dict[str, Any],
    gcp: List[Any],
    use_gps: bool,
    use_scale: bool,
    device=None,
) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """Alignment assuming a camera orientation prior — for single-line
    captures (align.py:230-303)."""
    p = estimate_ground_plane(reconstruction, config)
    if p is None:
        return None
    Rplane = multiview.plane_horizontalling_rotation(p)
    if Rplane is None:
        return None

    X, Xp = alignment_constraints(config, reconstruction, gcp, use_gps,
                                  device=device)
    X = np.array(X)
    Xp = np.array(Xp)
    if len(X) < 1:
        return 1.0, Rplane, np.zeros(3)

    X = (Rplane @ X.T).T

    two_shots = len(X) == 2
    single_shot = len(X) < 2
    same_shots = X.std(axis=0).max() < 1e-8 or Xp.std(axis=0).max() < 0.01
    if single_shot or same_shots:
        s = 1.0
        A = Rplane
        b = Xp.mean(axis=0) - X.mean(axis=0)
        max_scale = 1000.0
        current_scale = np.linalg.norm(b)
        if two_shots and current_scale > max_scale:
            b = max_scale * b / current_scale
            s = max_scale / current_scale
    else:
        # 2D similarity in the horizontalized plane.
        res = _affine_2d_from_points(X[:, :2], Xp[:, :2], use_scale)
        if res is None:
            return None
        M2, t2 = res
        s = np.sqrt(max(np.linalg.det(M2), 1e-30))
        A = np.eye(3)
        A[:2, :2] = M2 / s
        A = A @ Rplane
        b = np.array([t2[0], t2[1], Xp[:, 2].mean() - s * X[:, 2].mean()])
    return s, A, b


def _affine_2d_from_points(
    x: np.ndarray, y: np.ndarray, use_scale: bool
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """2D similarity y = M x + t (rotation+uniform scale, no shear)."""
    if len(x) < 2:
        return None
    mx, my = x.mean(axis=0), y.mean(axis=0)
    xc, yc = x - mx, y - my
    # Complex-number formulation of 2D similarity.
    zx = xc[:, 0] + 1j * xc[:, 1]
    zy = yc[:, 0] + 1j * yc[:, 1]
    denom = np.sum(np.abs(zx) ** 2)
    if denom < 1e-18:
        return None
    a = np.sum(zy * np.conj(zx)) / denom
    if not use_scale:
        if np.abs(a) < 1e-18:
            return None
        a = a / np.abs(a)
    M = np.array([[a.real, -a.imag], [a.imag, a.real]])
    t = my - M @ mx
    return M, t


def estimate_ground_plane(
    reconstruction: types.Reconstruction, config: Dict[str, Any]
) -> Optional[np.ndarray]:
    """Ground plane from camera heights + orientation prior (align.py:363-404)."""
    orientation_type = config["align_orientation_prior"]
    onplane, verticals, ground_points = [], [], []
    for shot in reconstruction.shots.values():
        ground_points.append(shot.pose.get_origin())
        if not shot.metadata.orientation.has_value:
            continue
        R = shot.pose.get_rotation_matrix()
        x, y, z = get_horizontal_and_vertical_directions(
            R, shot.metadata.orientation.value
        )
        if orientation_type == "no_roll":
            onplane.append(x)
            verticals.append(-y)
        elif orientation_type == "horizontal":
            onplane.append(x)
            onplane.append(z)
            verticals.append(-y)
        elif orientation_type == "vertical":
            onplane.append(x)
            onplane.append(y)
            verticals.append(-z)

    ground_points = np.array(ground_points)
    ground_points -= ground_points.mean(axis=0)
    try:
        return multiview.fit_plane(
            ground_points, np.array(onplane), np.array(verticals)
        )
    except (ValueError, np.linalg.LinAlgError):
        return None


def get_horizontal_and_vertical_directions(
    R: np.ndarray, orientation: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Image XYZ direction vectors given EXIF orientation (align.py:407-446).

    See http://sylvana.net/jpegcrop/exif_orientation.html
    """
    if orientation == 1:
        return R[0, :], R[1, :], R[2, :]
    if orientation == 2:
        return -R[0, :], R[1, :], -R[2, :]
    if orientation == 3:
        return -R[0, :], -R[1, :], R[2, :]
    if orientation == 4:
        return R[0, :], -R[1, :], R[2, :]
    if orientation == 5:
        return R[1, :], R[0, :], -R[2, :]
    if orientation == 6:
        return -R[1, :], R[0, :], R[2, :]
    if orientation == 7:
        return -R[1, :], -R[0, :], -R[2, :]
    if orientation == 8:
        return R[1, :], -R[0, :], R[2, :]
    logger.error("unknown orientation %d. Using 1 instead", orientation)
    return R[0, :], R[1, :], R[2, :]


def set_gps_bias(
    reconstruction: types.Reconstruction,
    config: Dict[str, Any],
    gcp: List[Any],
    use_scale: bool,
    device=None,
) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """Compensate GPS with a per-camera similarity bias (align.py:306-360).

    Aligns with GCP-only constraints, then computes per-camera similarities
    mapping GPS positions onto the GCP-aligned reconstruction.
    """
    result = compute_reconstruction_similarity(
        reconstruction, gcp, config, use_gps=False, use_scale=use_scale,
        device=device,
    )
    if not result:
        logger.warning("Cannot align on GCPs only for bias computation")
        return None
    s, A, b = result
    apply_similarity(reconstruction, s, A, b)

    # Per-camera correspondences origin <-> GPS.
    per_camera: Dict[str, Tuple[List[np.ndarray], List[np.ndarray]]] = {}
    for shot in reconstruction.shots.values():
        if not shot.metadata.gps_position.has_value:
            continue
        cam_id = shot.camera.id
        per_camera.setdefault(cam_id, ([], []))
        per_camera[cam_id][0].append(
            np.asarray(shot.metadata.gps_position.value, dtype=np.float64)
        )
        per_camera[cam_id][1].append(shot.pose.get_origin())

    for cam_id, (gps, origins) in per_camera.items():
        if len(gps) < 3:
            bias = Similarity()
        else:
            T = _similarity(np.array(gps), np.array(origins), device)
            sb, Ab, bb = multiview.decompose_similarity_transform(T)
            bias = Similarity(Ab, bb, sb)
        reconstruction.set_bias(cam_id, bias)
    return result
