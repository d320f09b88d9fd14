"""Batched robust estimation (RANSAC) on torch tensors.

Port of `opensfm_tpu.robust`: K hypotheses are drawn up front, solved by a
batched minimal solver, all residuals are scored at once, and local
optimization refits the winner on its inliers.  The essential and
fundamental families serve `match_features`; the relative pose, relative
rotation, absolute pose (single, batched, known rotation), similarity and
homography families serve the growth loop.
"""

from opensfm_tpu_torch.robust.ransac import (  # noqa: F401
    RansacResult,
    ransac_absolute_pose,
    ransac_absolute_pose_batched,
    ransac_absolute_pose_known_rotation,
    ransac_essential,
    ransac_fundamental,
    ransac_homography,
    ransac_relative_pose,
    ransac_relative_rotation,
    ransac_relative_rotation_batched,
    ransac_similarity,
)
