"""Export a PDF report (reference actions/export_report.py; port of
`opensfm_tpu.actions.export_report`)."""

from __future__ import annotations

from timeit import default_timer as timer
from typing import Any, Dict

from opensfm_tpu_torch import report, resolve_device


def run_dataset(data, device=None) -> Dict[str, Any]:
    """Write `stats/report.pdf`, computing the statistics and figures on
    `device` (CUDA unless told otherwise) where `stats/stats.json` is
    absent; return its seconds."""
    dev = resolve_device(device)
    start = timer()
    report.generate_report(data, device=dev)
    return {"device": str(dev), "wall_s": timer() - start}
