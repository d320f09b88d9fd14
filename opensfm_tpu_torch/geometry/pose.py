"""Host-side Pose / Similarity shells (NumPy, float64).

These mirror the user-facing API of the reference's `pygeometry.Pose` and
`pygeometry.Similarity` (reference: opensfm/src/geometry/pose.h:1-212,
similarity.h) so orchestration code reads identically.  Convention, as in the
reference: a Pose stores the **world-to-camera** transform
``x_cam = R @ x_world + t`` with ``rotation`` the angle-axis of R.

The batched/differentiable device-side equivalents live in
`opensfm_tpu_torch.geometry.rotation` (JAX); these shells are pure NumPy because
they serve the inherently dynamic growth/IO paths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rotvec_to_matrix_np(r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, dtype=np.float64)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        K = _hat_np(r)
        return np.eye(3) + K + 0.5 * (K @ K)
    k = r / theta
    K = _hat_np(k)
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _matrix_to_rotvec_np(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, dtype=np.float64)
    # Quaternion extraction (Shepperd), then quat -> angle-axis.
    tr = np.trace(R)
    cands = np.array(
        [
            1.0 + tr,
            1.0 + R[0, 0] - R[1, 1] - R[2, 2],
            1.0 - R[0, 0] + R[1, 1] - R[2, 2],
            1.0 - R[0, 0] - R[1, 1] + R[2, 2],
        ]
    )
    i = int(np.argmax(cands))
    if i == 0:
        q = np.array(
            [1.0 + tr, R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        )
    elif i == 1:
        q = np.array(
            [R[2, 1] - R[1, 2], cands[1], R[0, 1] + R[1, 0], R[0, 2] + R[2, 0]]
        )
    elif i == 2:
        q = np.array(
            [R[0, 2] - R[2, 0], R[0, 1] + R[1, 0], cands[2], R[1, 2] + R[2, 1]]
        )
    else:
        q = np.array(
            [R[1, 0] - R[0, 1], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], cands[3]]
        )
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    w, v = q[0], q[1:]
    sin_half = np.linalg.norm(v)
    if sin_half < 1e-12:
        return 2.0 * v
    half = np.arctan2(sin_half, w)
    return v * (2.0 * half / sin_half)


def _hat_np(r: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]]
    )


class Pose:
    """World-to-camera rigid transform, stored as (angle-axis, translation)."""

    __slots__ = ("_r", "_t")

    def __init__(self, rotation=(0.0, 0.0, 0.0), translation=(0.0, 0.0, 0.0)) -> None:
        self._r = np.asarray(rotation, dtype=np.float64).reshape(3).copy()
        self._t = np.asarray(translation, dtype=np.float64).reshape(3).copy()

    # -- attributes ---------------------------------------------------------
    @property
    def rotation(self) -> np.ndarray:
        return self._r

    @rotation.setter
    def rotation(self, value) -> None:
        self._r = np.asarray(value, dtype=np.float64).reshape(3).copy()

    @property
    def translation(self) -> np.ndarray:
        return self._t

    @translation.setter
    def translation(self, value) -> None:
        self._t = np.asarray(value, dtype=np.float64).reshape(3).copy()

    # -- matrix views -------------------------------------------------------
    def get_rotation_matrix(self) -> np.ndarray:
        return _rotvec_to_matrix_np(self._r)

    def set_rotation_matrix(self, R) -> None:
        self._r = _matrix_to_rotvec_np(np.asarray(R))

    def get_R_world_to_cam(self) -> np.ndarray:
        return self.get_rotation_matrix()

    def get_R_cam_to_world(self) -> np.ndarray:
        return self.get_rotation_matrix().T

    def get_Rt(self) -> np.ndarray:
        """3x4 [R|t] world-to-camera matrix (pose.h GetRt)."""
        Rt = np.empty((3, 4))
        Rt[:, :3] = self.get_rotation_matrix()
        Rt[:, 3] = self._t
        return Rt

    def get_world_to_cam(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.get_rotation_matrix()
        T[:3, 3] = self._t
        return T

    def get_cam_to_world(self) -> np.ndarray:
        T = np.eye(4)
        R = self.get_rotation_matrix()
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ self._t
        return T

    # -- origin -------------------------------------------------------------
    def get_origin(self) -> np.ndarray:
        """Camera center in world coordinates: -R^T t."""
        return -self.get_rotation_matrix().T @ self._t

    def set_origin(self, origin) -> None:
        self._t = -self.get_rotation_matrix() @ np.asarray(origin, dtype=np.float64)

    # -- transforms ---------------------------------------------------------
    def transform(self, point) -> np.ndarray:
        """World -> camera."""
        point = np.asarray(point, dtype=np.float64)
        return point @ self.get_rotation_matrix().T + self._t

    def transform_many(self, points) -> np.ndarray:
        return self.transform(points)

    def transform_inverse(self, point) -> np.ndarray:
        """Camera -> world."""
        point = np.asarray(point, dtype=np.float64)
        return (point - self._t) @ self.get_rotation_matrix()

    def transform_inverse_many(self, points) -> np.ndarray:
        return self.transform_inverse(points)

    # -- composition --------------------------------------------------------
    def compose(self, base: "Pose") -> "Pose":
        """self ∘ base: apply `base` first, then `self` (pose.h:146-158)."""
        R_self = self.get_rotation_matrix()
        R = R_self @ base.get_rotation_matrix()
        t = R_self @ base.translation + self._t
        p = Pose()
        p.set_rotation_matrix(R)
        p.translation = t
        return p

    def relative_to(self, base: "Pose") -> "Pose":
        """self expressed relative to `base`: self ∘ base^{-1}."""
        return self.compose(base.inverse())

    def inverse(self) -> "Pose":
        R = self.get_rotation_matrix()
        p = Pose()
        p.set_rotation_matrix(R.T)
        p.translation = -(R.T @ self._t)
        return p

    def copy(self) -> "Pose":
        return Pose(self._r, self._t)

    def __repr__(self) -> str:
        return f"Pose(r={self._r.tolist()}, t={self._t.tolist()})"

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, Pose)
            and np.allclose(self._r, o._r)
            and np.allclose(self._t, o._t)
        )


class Similarity:
    """Similarity transform x' = s * R @ x + t (similarity.h)."""

    __slots__ = ("_pose", "_scale")

    def __init__(self, rotation=(0.0, 0.0, 0.0), translation=(0.0, 0.0, 0.0), scale=1.0):
        rotation = np.asarray(rotation, dtype=np.float64)
        if rotation.shape == (3, 3):
            self._pose = Pose()
            self._pose.set_rotation_matrix(rotation)
            self._pose.translation = translation
        else:
            self._pose = Pose(rotation, translation)
        self._scale = float(scale)

    @property
    def rotation(self) -> np.ndarray:
        return self._pose.rotation

    @rotation.setter
    def rotation(self, value) -> None:
        self._pose.rotation = value

    @property
    def translation(self) -> np.ndarray:
        return self._pose.translation

    @translation.setter
    def translation(self, value) -> None:
        self._pose.translation = value

    @property
    def scale(self) -> float:
        return self._scale

    @scale.setter
    def scale(self, value: float) -> None:
        self._scale = float(value)

    def get_rotation_matrix(self) -> np.ndarray:
        return self._pose.get_rotation_matrix()

    def transform(self, point) -> np.ndarray:
        point = np.asarray(point, dtype=np.float64)
        return self._scale * (point @ self.get_rotation_matrix().T) + self.translation

    def transform_many(self, points) -> np.ndarray:
        return self.transform(points)

    def inverse(self) -> "Similarity":
        R = self.get_rotation_matrix()
        inv_t = -(R.T @ self.translation) / self._scale
        out = Similarity(scale=1.0 / self._scale)
        out._pose.set_rotation_matrix(R.T)
        out._pose.translation = inv_t
        return out

    def compose(self, other: "Similarity") -> "Similarity":
        """self ∘ other: apply `other` first, then `self`."""
        R_self = self.get_rotation_matrix()
        R = R_self @ other.get_rotation_matrix()
        t = self._scale * (R_self @ other.translation) + self.translation
        out = Similarity(scale=self._scale * other._scale)
        out._pose.set_rotation_matrix(R)
        out._pose.translation = t
        return out

    def __repr__(self) -> str:
        return (
            f"Similarity(r={self.rotation.tolist()}, "
            f"t={self.translation.tolist()}, s={self._scale})"
        )
