"""A run imports neither JAX nor the JAX package, reads none of the old
benchmark files, and refuses to run without a CUDA device."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest
import torch

from sfm_bench.tests.tiny import REPO, TINY

_RUN_BOTH = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from sfm_bench import run as harness
from sfm_bench import control, costs, pngio, scene, trace  # noqa: F401
bench = harness.manifest()
tiny = json.loads({tiny!r})
for m in bench["per_layer"]:
    harness.load_module("metrics", m["name"])
for cell, t in tiny.items():
    spec = harness.cell_spec(bench, cell)
    spec["config"]["sizes"].update(t["sizes"])
    spec["config"]["settings"].update(t["settings"])
    spec["params"].update(t["params"])
    res = harness.run_cell(spec, bench, 7, 0.5, False, torch.device("cpu"))
    assert res["correct"], res
print("FORBIDDEN", harness.forbidden_modules())
print("MODULES", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_imports_no_jax():
    import json

    code = _RUN_BOTH.format(repo=REPO, tiny=json.dumps(TINY))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    forbidden = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("FORBIDDEN")][0]
    assert forbidden == "FORBIDDEN []"
    modules = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("MODULES")][0]
    assert "'opensfm_tpu_torch'" in modules  # the port ran


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    from sfm_bench import run as harness

    monkeypatch.setitem(sys.modules, "opensfm_tpu_torch_like", sys)
    assert "opensfm_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "opensfm_tpu.dense", sys)
    assert "opensfm_tpu" in harness.forbidden_modules()


# An import of the old benchmarks, the smoke script, the old generators or
# JAX, or a string naming one of the old record files.
OLD = re.compile(
    r"^\s*(import|from)\s+(bench|bench_e2e|bench_scaling|bench_scale_xl"
    r"|profile_ba|chip_smoke|synthetic_bundle|synthetic_images|jax|jaxlib"
    r"|flax|opensfm_tpu)\b(?!_torch)"
    r"|[\"'][^\"'\n]*(BENCH_r|MULTICHIP_|BASELINE\.json"
    r"|bench(_e2e|_scaling|_scale_xl)?\.py)", re.M)


def test_sources_name_no_old_benchmark_file():
    bench_dir = os.path.join(REPO, "sfm_bench")
    for root, dirs, files in os.walk(bench_dir):
        if os.path.basename(root) == "tests":
            continue  # the tests name them to check them
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert not OLD.search(text), (name, OLD.search(text))


def test_no_card_no_run(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sfm_bench import run as harness

    rc = harness.main(["--workload", "submodel80.depthmaps", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 1 CUDA device" in out.err
