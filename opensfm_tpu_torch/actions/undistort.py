"""Undistort images + reconstruction (reference actions/undistort.py)."""

from __future__ import annotations

from timeit import default_timer as timer
from typing import Any, Dict

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch import undistort as undistort_mod
from opensfm_tpu_torch.dataset import UndistortedDataSet


def run_dataset(data, reconstruction=None, reconstruction_index=0,
                tracks=None, output="undistorted", skip_images=False,
                device=None) -> Dict[str, Any]:
    """Write the undistorted reconstruction, tracks and images of
    `data`'s reconstruction `reconstruction_index` under `output`, the
    images remapped on `device` (CUDA unless told otherwise); return the
    report (shots, subshots, the images' load / remap / save seconds)."""
    dev = resolve_device(device)
    start = timer()
    undistorted_data_path = data.data_path + "/" + output
    udata = UndistortedDataSet(data, undistorted_data_path)
    reconstructions = data.load_reconstruction(reconstruction)
    if data.tracks_exists(tracks):
        tracks_manager = data.load_tracks_manager(tracks)
    else:
        tracks_manager = None
    report: Dict[str, Any] = {"device": str(dev)}
    if reconstructions:
        r = reconstructions[reconstruction_index]
        shots = undistort_mod.undistort_reconstruction_with_images(
            tracks_manager, r, data, udata, skip_images, device=dev,
            report=report,
        )
        report.update(shots=len(shots),
                      subshots=sum(len(s) for s in shots.values()))
    report["wall_s"] = timer() - start
    return report
