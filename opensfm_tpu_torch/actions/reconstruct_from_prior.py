"""Reconstruct starting from a prior model
(reference actions/reconstruct_from_prior.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from opensfm_tpu_torch import io, reconstruction


def run_dataset(data, input: str = "reconstruction.json",
                output: str = "reconstruction.prior.json",
                device=None) -> Optional[Dict[str, Any]]:
    """Retriangulate and bundle the first reconstruction of `input` on
    `device` (CUDA unless told otherwise), save it as `output` and the
    report as `reports/reconstruction.json`; return the report."""
    tracks_manager = data.load_tracks_manager()
    rec_prior = data.load_reconstruction(input)
    if not rec_prior:
        return None
    report, rec = reconstruction.reconstruct_from_prior(
        data, tracks_manager, rec_prior[0], device=device)
    data.save_reconstruction([rec], output)
    data.save_report(io.json_dumps(report), "reconstruction.json")
    return report
