"""Compute dense depthmaps (reference actions/compute_depthmaps.py)."""

from __future__ import annotations

from typing import Any, Dict

from opensfm_tpu_torch import dense
from opensfm_tpu_torch.dataset import UndistortedDataSet


def run_dataset(data, subfolder: str = "undistorted",
                interactive: bool = False, device=None) -> Dict[str, Any]:
    """Raw, clean and pruned depthmaps of the undistorted shots under
    `subfolder` on `device` (CUDA unless told otherwise), merged into
    `depthmaps/merged.ply`; returns `dense.compute_depthmaps`' report."""
    udata_path = data.data_path + "/" + subfolder
    udata = UndistortedDataSet(data, udata_path)
    data.config["interactive"] = interactive
    tracks_manager = udata.load_undistorted_tracks_manager()
    return dense.compute_depthmaps(udata, tracks_manager, device=device)
