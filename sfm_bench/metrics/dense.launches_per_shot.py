"""Kernel launches a raw depthmap (copies and fills not counted), from a
traced window."""

import re

COPIES = re.compile(r"^(Memcpy|Memset)")


def read(run):
    shots = [it for it in run.items if it.get("kind") == "depthmap"]
    if run.trace is None or not run.trace.kernels or not shots:
        return None
    kernels = sum(n for k, (n, _) in run.trace.kernels.items()
                  if not COPIES.search(k))
    return kernels / len(shots)
