"""Geometry: cameras, poses and rotations (numpy host shells, torch math)."""

from opensfm_tpu_torch.geometry.pose import Pose, Similarity  # noqa: F401
from opensfm_tpu_torch.geometry.cameras import Camera  # noqa: F401
