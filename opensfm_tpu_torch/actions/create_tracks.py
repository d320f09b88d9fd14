"""Link pairwise matches into tracks (reference actions/create_tracks.py:8-62).

The linking and the `tracks.csv` codec are host work (the native C++ core
when it builds, else Python); the report says which path ran for each.
"""

from __future__ import annotations

from timeit import default_timer as timer

from opensfm_tpu_torch import io, native, resolve_device, tracking


def run_dataset(data, device=None) -> None:
    """Link the matches of `data` into `tracks.csv` and write
    `reports/tracks.json`.  `device` is resolved as every entry point
    resolves it (CUDA unless told otherwise, raising when CUDA is absent),
    though no step of this stage runs on it."""
    dev = resolve_device(device)
    start = timer()
    features, colors, segmentations, instances, depths = tracking.load_features(
        data, data.images()
    )
    features_end = timer()
    matches = tracking.load_matches(data, data.images())
    matches_end = timer()
    paths = {}
    tracks_manager = tracking.create_tracks_manager(
        features, colors, segmentations, instances, matches,
        data.config["min_track_length"], depths,
        data.config["depth_is_radial"],
        data.config["depth_std_deviation_m_default"],
        report=paths,
    )
    tracks_end = timer()
    data.save_tracks_manager(tracks_manager)
    paths["codec"] = "native" if native.available() else "python"

    report = {
        "wall_times": {
            "load_features": features_end - start,
            "load_matches": matches_end - features_end,
            "compute_tracks": tracks_end - matches_end,
            "save_tracks": timer() - tracks_end,
        },
        "num_images": tracks_manager.num_shots(),
        "num_tracks": tracks_manager.num_tracks(),
        "paths": paths,
        "device": str(dev),
    }
    data.save_report(io.json_dumps(report), "tracks.json")
