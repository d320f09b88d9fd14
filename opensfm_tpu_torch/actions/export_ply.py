"""Export the reconstruction to PLY (reference actions/export_ply.py; port
of `opensfm_tpu.actions.export_ply`)."""

from __future__ import annotations

from opensfm_tpu_torch import resolve_device


def run_dataset(data, no_cameras: bool = False, no_points: bool = False,
                depthmaps: bool = False, point_num_views: bool = False,
                device=None) -> None:
    """Write the first reconstruction as `reconstruction.ply` (host text;
    `device` is resolved as every entry point resolves it)."""
    resolve_device(device)
    reconstructions = data.load_reconstruction()
    tracks_manager = data.load_tracks_manager() if data.tracks_exists() else None
    if reconstructions:
        data.save_ply(
            reconstructions[0], tracks_manager, "reconstruction.ply",
            no_cameras, no_points, point_num_views,
        )
