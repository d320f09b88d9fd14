"""Batched robust estimation (RANSAC) on torch tensors.

Port of `opensfm_tpu.robust`: K hypotheses are drawn up front, solved by a
batched minimal solver, all residuals are scored at once, and local
optimization refits the winner on its inliers.  This slice ports the
essential and fundamental families, which `match_features` uses.
"""

from opensfm_tpu_torch.robust.ransac import (  # noqa: F401
    RansacResult,
    ransac_essential,
    ransac_fundamental,
)
