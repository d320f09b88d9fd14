"""Logging setup + memory report (reference opensfm/log.py:7-28)."""

from __future__ import annotations

import logging

from opensfm_tpu_torch.context import current_memory_usage


def setup() -> None:
    logging.basicConfig(
        format="%(asctime)s %(levelname)s: %(message)s", level=logging.INFO
    )


def memory_usage() -> float:
    """Current memory usage in MB."""
    return current_memory_usage() / 1024.0
