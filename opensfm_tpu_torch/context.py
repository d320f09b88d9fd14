"""Host-side parallelism + memory utilities.

Mirrors reference `opensfm/context.py:47-136` (parallel_map, memory
probing, process throttling).  The heavy math is batched on the device;
parallel_map only covers host-side IO orchestration.
"""

from __future__ import annotations

import logging
import os
import resource
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")
R = TypeVar("R")


def parallel_map(func: Callable[[T], R], args: Iterable[T], num_proc: int,
                 max_batch_size: int = 1) -> List[R]:
    """Thread-pool map (context.py:47-67).  Threads (not processes): the
    inner loops either release the GIL (device dispatch, IO) or are
    numpy-vectorized."""
    args = list(args)
    num_proc = max(1, min(num_proc, len(args) or 1))
    if num_proc == 1:
        return [func(arg) for arg in args]
    with ThreadPoolExecutor(max_workers=num_proc) as executor:
        return list(executor.map(func, args))


def memory_available() -> Optional[int]:
    """Available memory in MB (context.py:92-123)."""
    try:
        with open("/proc/meminfo") as f:
            lines = f.read().splitlines()
        info = dict(
            (line.split(":")[0], line.split(":")[1].strip())
            for line in lines
        )
        value = info.get("MemAvailable")
        if value is None:
            return None
        return int(value.split()[0]) // 1024
    except (IOError, ValueError):
        return None


def current_memory_usage() -> int:
    """Resident memory of this process in KB (context.py:101-127)."""
    usage = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform == "darwin":
        return usage // 1024
    return usage


def processes_that_fit_in_memory(desired: int, per_process: int) -> int:
    """Clamp process count by available memory (context.py:129-136)."""
    available = memory_available()
    if available is not None:
        fittable = max(1, int(available / per_process))
        return min(desired, fittable)
    return desired


# ---------------------------------------------------------------------------
# Device-dispatch accounting (SURVEY §7.3 "sequentiality of incremental
# SfM"): each entry is one device solve or program started at a hot call
# site (`ba.lm.bundle_adjust` records one per solve).  Host-side and cheap
# numpy work is not counted.
# ---------------------------------------------------------------------------

DISPATCH_COUNTS: dict = {}


def record_dispatch(tag: str, n: int = 1) -> None:
    DISPATCH_COUNTS[tag] = DISPATCH_COUNTS.get(tag, 0) + n


def reset_dispatch_counts() -> None:
    DISPATCH_COUNTS.clear()


def dispatch_counts() -> dict:
    return dict(DISPATCH_COUNTS)
