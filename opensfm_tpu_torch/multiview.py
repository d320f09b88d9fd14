"""Multi-view geometry wrappers over the batched robust estimators.

Port of `opensfm_tpu.multiview`, which mirrors the reference
`opensfm/multiview.py` API (fit_plane:133,
plane_horizontalling_rotation:178, fit_similarity_transform:214,
motion_from_plane_homography:366 — Faugeras-Lustman 1988,
absolute_pose_ransac:468, relative_pose_ransac:494,
relative_pose_ransac_rotation_only:520, relative_pose_optimize_nonlinear:541,
triangulate_gcp:556) on top of `opensfm_tpu_torch.robust`.

Convention: all relative/absolute poses are world-to-camera [R|t] with
x_cam = R x_world + t.  Every function that reaches torch takes `device`
(CUDA unless told otherwise); the plane, homography-decomposition and
similarity-decomposition helpers are NumPy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device, robust
from opensfm_tpu_torch.geometry import essential as ess
from opensfm_tpu_torch.geometry import triangulation as tri
from opensfm_tpu_torch.geometry.pose import _rotvec_to_matrix_np


def homogeneous(x: np.ndarray) -> np.ndarray:
    """Add a column of ones."""
    s = x.shape[:-1] + (1,)
    return np.hstack((x, np.ones(s)))


def homogeneous_vec(x: np.ndarray) -> np.ndarray:
    """Add a column of zeros."""
    s = x.shape[:-1] + (1,)
    return np.hstack((x, np.zeros(s)))


def euclidean(x: np.ndarray) -> np.ndarray:
    """Divide by the last column and drop it."""
    return x[..., :-1] / x[..., -1:]


# ---------------------------------------------------------------------------
# Planes
# ---------------------------------------------------------------------------


def fit_plane(points, vectors=None, verticals=None) -> np.ndarray:
    """Estimate a plane p s.t. points and vectors lie on it (multiview.py:133).

    >>> x = [[0,0,0], [1,0,0], [0,1,0]]
    >>> p = fit_plane(x, None, None)
    >>> np.allclose(p, [0,0,1,0]) or np.allclose(p, [0,0,-1,0])
    True
    """
    points = np.asarray(points, dtype=np.float64)
    s = 1.0 / max(1e-8, points.std())
    x = homogeneous(s * points)
    if vectors is not None and len(vectors) > 0:
        v = homogeneous_vec(s * np.asarray(vectors, dtype=np.float64))
        A = np.vstack((x, v))
    else:
        A = x
    evalues, evectors = np.linalg.eigh(A.T @ A)
    p = evectors[:, 0]
    if np.allclose(p[:3], [0, 0, 0]):
        return np.array([0.0, 0.0, 1.0, 0.0])
    if verticals is not None and len(verticals) > 0:
        d = sum(p[:3] @ vertical for vertical in verticals)
        p *= np.sign(d) if d != 0 else 1.0
    return p


def plane_horizontalling_rotation(p: np.ndarray) -> Optional[np.ndarray]:
    """Rotation bringing plane normal p to +z (multiview.py:178)."""
    v0 = np.asarray(p[:3], dtype=np.float64)
    v1 = np.array([0.0, 0.0, 1.0])
    n0 = np.linalg.norm(v0)
    if n0 < 1e-15:
        return np.eye(3)
    v0 = v0 / n0
    axis = np.cross(v0, v1)
    angle = math.atan2(np.linalg.norm(axis), v0 @ v1)
    na = np.linalg.norm(axis)
    if na > 0:
        return _rotvec_to_matrix_np(axis / na * angle)
    elif angle < 1.0:
        return np.eye(3)
    elif angle > 3.0:
        return np.diag([1.0, -1.0, -1.0])
    return None


# ---------------------------------------------------------------------------
# Similarity
# ---------------------------------------------------------------------------


def fit_similarity_transform(
    p1: np.ndarray, p2: np.ndarray, max_iterations: int = 1000,
    threshold: float = 1, device=None, samples=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """RANSAC similarity p2 = T p1; returns (T[4,4], inlier indices)."""
    result = robust.ransac_similarity(
        np.asarray(p1), np.asarray(p2), threshold, max_iterations,
        device=device, samples=samples,
    )
    if result.model is None:
        return np.zeros((4, 4)), np.zeros(0, dtype=np.int64)
    return np.asarray(result.model), result.inliers_indices


def decompose_similarity_transform(T: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """T -> (scale, rotation, translation)."""
    m = T.shape[0]
    A, b = T[: m - 1, : m - 1], T[: m - 1, m - 1]
    s = np.linalg.det(A) ** (1.0 / (m - 1))
    return s, A / s, b


# ---------------------------------------------------------------------------
# Robust pose wrappers (pyrobust entry point equivalents)
# ---------------------------------------------------------------------------


def absolute_pose_ransac(
    bs, Xs, threshold: float, iterations: int, probability: float = 0.999,
    device=None, samples=None,
) -> np.ndarray:
    """P3P RANSAC -> [R|t] world-to-camera (multiview.py:468)."""
    result = robust.ransac_absolute_pose(bs, Xs, threshold, iterations,
                                         device=device, samples=samples)
    if result.model is None:
        return np.hstack([np.eye(3), np.zeros((3, 1))])
    return np.asarray(result.model)


def absolute_pose_ransac_batched(
    bs_list, Xs_list, threshold: float, iterations: int,
    probability: float = 0.999, device=None, samples=None,
):
    """P3P RANSAC for B independent candidate problems in one batched
    computation per chunk (growth-loop resection batching).  Returns a list
    of ([R|t], inlier_indices) aligned with the inputs."""
    results = robust.ransac_absolute_pose_batched(
        bs_list, Xs_list, threshold, iterations, device=device,
        samples=samples,
    )
    out = []
    for res in results:
        if res.model is None:
            out.append((np.hstack([np.eye(3), np.zeros((3, 1))]),
                        np.zeros(0, dtype=np.int64)))
        else:
            out.append((np.asarray(res.model), res.inliers_indices))
    return out


def absolute_pose_known_rotation_ransac(
    bs, Xs, threshold: float, iterations: int, probability: float = 0.999,
    device=None, samples=None,
) -> np.ndarray:
    """Translation-only RANSAC with identity rotation -> [I|t]."""
    result = robust.ransac_absolute_pose_known_rotation(
        bs, Xs, np.eye(3), threshold, iterations, device=device,
        samples=samples,
    )
    t = result.model if result.model is not None else np.zeros(3)
    return np.hstack([np.eye(3), np.asarray(t)[:, None]])


def relative_pose_ransac(
    b1, b2, threshold: float, iterations: int, probability: float = 0.999,
    device=None, samples=None,
) -> np.ndarray:
    """Essential-based relative pose RANSAC -> [R|t] (multiview.py:494)."""
    result = robust.ransac_relative_pose(b1, b2, threshold, iterations,
                                         device=device, samples=samples)
    if result.model is None:
        return np.hstack([np.eye(3), np.array([[0.0], [0.0], [1.0]])])
    return np.asarray(result.model)


def relative_pose_ransac_rotation_only(
    b1, b2, threshold: float, iterations: int, probability: float = 0.999,
    device=None, samples=None,
) -> np.ndarray:
    """Rotation-only RANSAC -> R with R b1 ~ b2 (multiview.py:520)."""
    result = robust.ransac_relative_rotation(b1, b2, threshold, iterations,
                                             device=device, samples=samples)
    if result.model is None:
        return np.eye(3)
    return np.asarray(result.model)


def relative_pose_ransac_rotation_only_batched(
    b1_list, b2_list, threshold: float, iterations: int,
    probability: float = 0.999, device=None, samples=None,
) -> List[np.ndarray]:
    """`relative_pose_ransac_rotation_only` for B pairs in one batched
    computation per chunk (compute_image_pairs)."""
    results = robust.ransac_relative_rotation_batched(
        b1_list, b2_list, threshold, iterations, device=device,
        samples=samples,
    )
    return [np.eye(3) if r.model is None else np.asarray(r.model)
            for r in results]


def _f64(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=resolve_device(device))


def relative_pose_optimize_nonlinear(
    b1, b2, t: np.ndarray, R: np.ndarray, iterations: int, device=None,
) -> np.ndarray:
    """GN refinement of [R|t] on the epipolar residual (multiview.py:541)."""
    Rt0 = np.hstack([np.asarray(R), np.asarray(t)[:, None]])
    Rt = ess.refine_relative_pose(
        _f64(Rt0, device), _f64(b1, device), _f64(b2, device),
        iterations=min(int(iterations), 50),
    )
    return Rt.cpu().numpy()


def relative_pose_inliers(Rt: np.ndarray, b1, b2, threshold: float,
                          device=None) -> np.ndarray:
    """Indices of pairs consistent with [R|t] (the RelativePose error)."""
    err = ess.relative_pose_error(
        _f64(Rt, device), _f64(b1, device), _f64(b2, device)
    ).cpu().numpy()
    return np.flatnonzero(err < 1.0 - np.cos(threshold))


# ---------------------------------------------------------------------------
# Homography motions (plane-based two-view bootstrap)
# ---------------------------------------------------------------------------


def homography_ransac(
    x1: np.ndarray, x2: np.ndarray, threshold: float, iterations: int = 1000,
    device=None, samples=None,
):
    """RANSAC plane homography from 2D points; returns (H, inlier indices).

    Replaces cv2.findHomography for the plane-based two-view path."""
    result = robust.ransac_homography(x1, x2, threshold, iterations,
                                      device=device, samples=samples)
    if result.model is None:
        return None, np.zeros(0, dtype=np.int64)
    return np.asarray(result.model), result.inliers_indices


def nullspace(A: np.ndarray) -> Tuple[float, np.ndarray]:
    """Smallest singular value and the corresponding right singular vector."""
    _, s, vh = np.linalg.svd(np.asarray(A, dtype=np.float64))
    return float(s[-1]), vh[-1]


def focal_from_homography(H: np.ndarray) -> float:
    """Focal length of a rotation-only homography H = K R K^-1.

    Solves W = H W H^T for W = diag(a, a, b) in the least-squares sense
    (the 6 upper-triangle entries give 6 linear equations in (a, b)), then
    f = sqrt(a/b).  Mirrors the reference's `focal_from_homography`
    (multiview.py:260-283).
    """
    H = np.asarray(H, dtype=np.float64)
    H = H / np.cbrt(np.linalg.det(H))
    rows = []
    for i in range(3):
        for j in range(i, 3):
            coef_a = H[i, 0] * H[j, 0] + H[i, 1] * H[j, 1]
            coef_b = H[i, 2] * H[j, 2]
            if i == j and i < 2:
                coef_a -= 1.0
            elif i == j:
                coef_b -= 1.0
            rows.append([coef_a, coef_b])
    _, (a, b) = nullspace(np.array(rows))
    return float(np.sqrt(abs(a / b)))


def project_to_rotation_matrix(A: np.ndarray) -> Optional[np.ndarray]:
    """Closest rotation matrix to A (Procrustes; multiview.py:299-307)."""
    try:
        u, _, vt = np.linalg.svd(np.asarray(A, dtype=np.float64))
    except np.linalg.LinAlgError:
        return None
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = u @ np.diag([1.0, 1.0, -1.0]) @ vt
    return R


def R_from_homography(
    H: np.ndarray, f1: float, f2: float
) -> Optional[np.ndarray]:
    """Rotation between two views related by a rotation-only homography
    (multiview.py:288-296)."""
    K1 = np.diag([f1, f1, 1.0])
    K2_inv = np.diag([1.0 / f2, 1.0 / f2, 1.0])
    return project_to_rotation_matrix(K2_inv @ np.asarray(H) @ K1)


def motion_from_plane_homography(
    H: np.ndarray,
) -> Optional[List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]]:
    """Camera motions (R, t, n, d) from a plane-induced homography
    following [Faugeras and Lustman 1988] (multiview.py:366)."""
    try:
        u, l_, vh = np.linalg.svd(H)
    except (ValueError, np.linalg.LinAlgError):
        return None
    d1, d2, d3 = l_
    s = np.linalg.det(u) * np.linalg.det(vh)
    if d1 / d2 < 1.0001 or d2 / d3 < 1.0001:
        return None  # degenerate: pure rotation or ambiguous

    abs_x1 = np.sqrt((d1**2 - d2**2) / (d1**2 - d3**2))
    abs_x3 = np.sqrt((d2**2 - d3**2) / (d1**2 - d3**2))
    solutions = []
    for x1, x3 in [
        (abs_x1, abs_x3), (abs_x1, -abs_x3), (-abs_x1, abs_x3), (-abs_x1, -abs_x3),
    ]:
        sin_term = x1 * x3 / d2
        sin_theta = (d1 - d3) * sin_term
        sin_phi = (d1 + d3) * sin_term
        d1_x3_2 = d1 * x3**2
        d3_x1_2 = d3 * x1**2
        cos_theta = (d3_x1_2 + d1_x3_2) / d2
        cos_phi = (d3_x1_2 - d1_x3_2) / d2
        Rp_p = np.array(
            [[cos_theta, 0, -sin_theta], [0, 1, 0], [sin_theta, 0, cos_theta]]
        )
        Rp_n = np.array([[cos_phi, 0, sin_phi], [0, -1, 0], [sin_phi, 0, -cos_phi]])
        np_ = np.array([x1, 0, x3])
        tp_p = (d1 - d3) * np.array([x1, 0, -x3])
        tp_n = (d1 + d3) * np_
        R_p = s * u @ Rp_p @ vh
        R_n = s * u @ Rp_n @ vh
        t_p = u @ tp_p
        t_n = u @ tp_n
        n = -vh.T @ np_
        d = s * d2
        solutions.append((R_p, t_p, n, d))
        solutions.append((R_n, t_n, n, -d))
    return solutions


# ---------------------------------------------------------------------------
# GCP triangulation
# ---------------------------------------------------------------------------


def triangulate_gcp(
    point,
    shots: Dict[str, Any],
    reproj_threshold: float = 0.02,
    min_ray_angle_degrees: float = 1.0,
    min_depth: float = 0.001,
    device=None,
):
    """Triangulate a GCP from its observations with strict validation
    (multiview.py:556-589), or None when fewer than two shots see it or the
    rays fail validation.

    Defaults mirror the reference: 0.02 rad angular reprojection threshold
    and 1 degree minimum ray angle — much stricter than the BA-side
    TriangulateGCP (ba_helpers.cc:313: 1.0 rad / 0.1 deg).  Alignment relies
    on the strictness: with poor poses the triangulations fail validation
    and GCPs drop out of the similarity fit instead of skewing it."""
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
    dev = resolve_device(device)
    k = len(bs)
    ok, X = tri.triangulate_bearings_midpoint(
        _f64(os_, dev), _f64(bs, dev), torch.ones(k, dtype=torch.bool,
                                                  device=dev),
        torch.full((k,), reproj_threshold, dtype=torch.float64, device=dev),
        min_angle=math.radians(min_ray_angle_degrees), min_depth=min_depth,
    )
    return X.cpu().numpy() if bool(ok) else None
