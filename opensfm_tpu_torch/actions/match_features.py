"""Match features between image pairs (OpenSfM actions/match_features.py:9-34;
port of `opensfm_tpu.actions.match_features`)."""

from __future__ import annotations

from timeit import default_timer as timer
from typing import Any, Dict, Tuple

from opensfm_tpu_torch import io, matching, resolve_device


def run_dataset(data, device=None) -> Dict[Tuple[str, str], Any]:
    """Match every candidate pair of the dataset's images on `device` (CUDA
    unless told otherwise), save `matches/*.pkl.gz` and
    `reports/matches.json`, and return the robust matches per pair."""
    device = resolve_device(device)
    images = data.images()
    start = timer()
    pairs_matches, preport = matching.match_images(data, {}, images, images,
                                                   device=device)
    matching.save_matches(data, images, pairs_matches)
    matching.clear_cache()
    end = timer()
    write_report(data, preport, list(pairs_matches.keys()), end - start)
    return pairs_matches


def write_report(data, preport, pairs, wall_time: float) -> None:
    report = {
        "wall_time": wall_time,
        "num_pairs": len(pairs),
        "pairs": [list(p) for p in pairs],
    }
    report.update(preport)
    data.save_report(io.json_dumps(report), "matches.json")
