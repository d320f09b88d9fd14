"""Extend a reconstruction with the remaining images
(reference actions/extend_reconstruction.py:8-34)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from opensfm_tpu_torch import io, reconstruction, resolve_device


def run_dataset(data, input: Optional[str] = None,
                output: Optional[str] = None,
                device=None) -> Optional[Dict[str, Any]]:
    """Grow the first reconstruction of `input` with the images of the
    tracks it lacks, on `device` (CUDA unless told otherwise), save it as
    `output` and the report; return the report."""
    device = resolve_device(device)
    tracks_manager = data.load_tracks_manager()
    prior_recs = data.load_reconstruction(input)
    gcp = data.load_ground_control_points()
    if not prior_recs:
        return None
    rec = prior_recs[0]
    images = set(tracks_manager.get_shot_ids()) - set(rec.shots)
    rec, report = reconstruction.grow_reconstruction(
        data, tracks_manager, rec, images, gcp, device=device)
    report["device"] = str(device)
    data.save_reconstruction([rec], output)
    data.save_report(io.json_dumps(report), "reconstruction.json")
    return report
