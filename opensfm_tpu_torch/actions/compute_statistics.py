"""Compute statistics + figures (reference actions/compute_statistics.py;
port of `opensfm_tpu.actions.compute_statistics`)."""

from __future__ import annotations

import logging
import os
from timeit import default_timer as timer
from typing import Any, Dict

from opensfm_tpu_torch import io, resolve_device, stats

logger = logging.getLogger(__name__)


def run_dataset(data, diagram_max_points: int = -1,
                device=None) -> Dict[str, Any]:
    """Write `stats/stats.json` and the figures (`stats.save_*`, drawn on
    `device`, CUDA unless told otherwise); return the seconds of the
    statistics and of each figure.  Unlike the JAX package, a failing
    figure raises: the figures are the port's own code."""
    dev = resolve_device(device)
    start = timer()
    reconstructions = data.load_reconstruction()
    tracks_manager = data.load_tracks_manager()
    output_path = os.path.join(data.data_path, "stats")
    os.makedirs(output_path, exist_ok=True)

    stats_dict = stats.compute_all_statistics(data, tracks_manager,
                                              reconstructions, device=dev)
    with open(os.path.join(output_path, "stats.json"), "w") as f:
        io.json_dump(stats_dict, f)
    report: Dict[str, Any] = {"device": str(dev), "stats_s": timer() - start,
                              "figures_s": {}}

    t0 = timer()
    stats.save_residual_histogram(stats_dict, output_path, device=dev)
    report["figures_s"]["residual_histogram"] = timer() - t0
    for name, save in (("matchgraph", stats.save_matchgraph),
                       ("topview", stats.save_topview),
                       ("heatmap", stats.save_heatmap),
                       ("residual_grids", stats.save_residual_grids)):
        t0 = timer()
        save(data, tracks_manager, reconstructions, output_path, device=dev)
        report["figures_s"][name] = timer() - t0
    report["wall_s"] = timer() - start
    logger.info("Statistics written to %s", output_path)
    return report
