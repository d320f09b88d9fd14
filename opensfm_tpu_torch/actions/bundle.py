"""Bundle-adjust a reconstruction (reference actions/bundle.py:9-32)."""

from __future__ import annotations

from typing import Any, Dict, List

from opensfm_tpu_torch.ba import problem as ba_problem


def run_dataset(data, input=None, output=None, device=None) -> List[Dict[str, Any]]:
    """Bundle every reconstruction of `input` (default reconstruction.json)
    on `device` (CUDA unless told otherwise) and save them to `output`.
    Returns the per-reconstruction bundle reports."""
    reconstructions = data.load_reconstruction(input)
    camera_priors = data.load_camera_models()
    rig_camera_priors = data.load_rig_cameras()
    tracks_manager = data.load_tracks_manager()
    gcp = data.load_ground_control_points()
    reports = []
    for reconstruction in reconstructions:
        # JSON reconstructions carry no observations; re-attach them from the
        # tracks manager so the bundle has projection residuals.
        reconstruction.add_correspondences_from_tracks_manager(tracks_manager)
        reports.append(ba_problem.bundle(
            reconstruction, camera_priors, rig_camera_priors, gcp,
            data.config, device=device,
        ))
    data.save_reconstruction(reconstructions, output)
    return reports
