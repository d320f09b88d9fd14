"""opensfm_tpu_torch — the PyTorch/CUDA port of opensfm_tpu.

A second package beside the JAX reference `opensfm_tpu`: the same on-disk
formats and the same bundle-adjustment math, with plain tensor code in
PyTorch and the reference's Pallas kernels rewritten by hand for NVIDIA
Hopper (`csrc/`).  The package imports neither `jax` nor `opensfm_tpu`.

Entry points run on the GPU unless the caller asks for the CPU:
`resolve_device(None)` is `cuda` and raises when CUDA is absent.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless told otherwise.

    Raises RuntimeError when CUDA is asked for (explicitly or by default) and
    is not available; nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
