"""Incremental reconstruction (reference actions/reconstruct.py:6-25)."""

from __future__ import annotations

from typing import Any, Dict

from opensfm_tpu_torch import io, reconstruction


def run_dataset(data, algorithm: str = "incremental",
                device=None) -> Dict[str, Any]:
    """Reconstruct `data` from its tracks on `device` (CUDA unless told
    otherwise), save `reconstruction.json` and `reports/reconstruction.json`
    and return the report.  `algorithm` is "incremental" (growth from the
    best pair, partials merged) or "triangulation" (poses from the
    metadata, retriangulated and bundled)."""
    tracks_manager = data.load_tracks_manager()
    if algorithm == "incremental":
        report, reconstructions = reconstruction.incremental_reconstruction(
            data, tracks_manager, device=device
        )
    elif algorithm == "triangulation":
        report, reconstructions = reconstruction.triangulation_reconstruction(
            data, tracks_manager, device=device
        )
    else:
        raise RuntimeError(f"Unsupported algorithm for reconstruction {algorithm}")
    data.save_reconstruction(reconstructions)
    data.save_report(io.json_dumps(report), "reconstruction.json")
    return report
