"""The PyTorch port stands alone: importing it pulls in neither JAX nor the
JAX package, and its entry points refuse to run without CUDA unless asked
for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import opensfm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    opensfm_tpu_torch.__path__, "opensfm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import synthetic_bundle, chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "opensfm_tpu"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_port_imports_neither_jax_nor_reference():
    # A fresh interpreter: this test process already imported JAX.
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")


def test_default_device_needs_cuda():
    _no_cuda()
    from opensfm_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_bundle_adjust_without_device_raises():
    _no_cuda()
    import synthetic_bundle as sb
    from opensfm_tpu_torch.ba import lm

    problem = sb.make_problem(8, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.bundle_adjust(problem, max_iterations=1)
    res = lm.bundle_adjust(problem, max_iterations=1, device="cpu")
    assert np.isfinite(res.final_cost)


def test_cli_without_device_raises(tmp_path):
    _no_cuda()
    import synthetic_bundle as sb

    sb.write_dataset(str(tmp_path), sb.make_problem(8, 64))
    before = (tmp_path / "reconstruction.json").read_bytes()
    proc = subprocess.run(
        [sys.executable, "-m", "opensfm_tpu_torch", "bundle", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert (tmp_path / "reconstruction.json").read_bytes() == before
    proc = subprocess.run(
        [sys.executable, "-m", "opensfm_tpu_torch", "bundle", str(tmp_path),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "reconstruction.json").read_bytes() != before
