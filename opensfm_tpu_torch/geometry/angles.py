"""Angle conventions: pan/tilt/roll and omega/phi/kappa <-> rotation.

Port of `opensfm_tpu.geometry.angles` (OpenSfM geometry.py conventions:
camera frame x right, y down, z forward; world ENU).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from opensfm_tpu_torch.geometry.pose import _rotvec_to_matrix_np


def rotation_from_angle_axis(angle_axis) -> np.ndarray:
    return _rotvec_to_matrix_np(np.asarray(angle_axis, dtype=np.float64))


def rotation_from_ptr(pan: float, tilt: float, roll: float) -> np.ndarray:
    """World-to-camera rotation from pan, tilt, roll."""
    R1 = rotation_from_angle_axis([0.0, 0.0, roll])
    R2 = rotation_from_angle_axis([tilt + np.pi / 2, 0.0, 0.0])
    R3 = rotation_from_angle_axis([0.0, 0.0, pan])
    return R1 @ R2 @ R3


def pan_from_rotation(R: np.ndarray) -> float:
    Rt_ez = R.T @ [0, 0, 1]
    return float(np.arctan2(Rt_ez[0], Rt_ez[1]))


def tilt_from_rotation(R: np.ndarray) -> float:
    Rt_ez = R.T @ [0, 0, 1]
    return float(np.arctan2(-Rt_ez[2], np.linalg.norm(Rt_ez[:2])))


def roll_from_rotation(R: np.ndarray) -> float:
    Rt_ex = R.T @ [1, 0, 0]
    Rt_ez = R.T @ [0, 0, 1]
    a = np.cross(Rt_ez, [0, 0, 1])
    a /= np.linalg.norm(a)
    b = np.cross(Rt_ex, a)
    return float(np.arcsin(Rt_ez @ b))


def ptr_from_rotation(R: np.ndarray) -> Tuple[float, float, float]:
    return pan_from_rotation(R), tilt_from_rotation(R), roll_from_rotation(R)


_RC = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])


def rotation_from_opk(omega: float, phi: float, kappa: float) -> np.ndarray:
    """World-to-camera rotation from photogrammetry omega/phi/kappa (rad)."""
    Rw = rotation_from_angle_axis([-omega, 0.0, 0.0])
    Rp = rotation_from_angle_axis([0.0, -phi, 0.0])
    Rk = rotation_from_angle_axis([0.0, 0.0, -kappa])
    return _RC @ Rk @ Rp @ Rw


def opk_from_rotation(R: np.ndarray) -> Tuple[float, float, float]:
    """Omega, phi, kappa (rad) from world-to-camera rotation."""
    M = R.T @ _RC
    omega = float(np.arctan2(-M[1, 2], M[2, 2]))
    phi = float(np.arcsin(np.clip(M[0, 2], -1.0, 1.0)))
    kappa = float(np.arctan2(-M[0, 1], M[0, 0]))
    return omega, phi, kappa
