"""A later change adds a configuration, a cell and a per-layer metric as new
files and new BENCHMARK.json entries alone: in a copy of the benchmark,
with no file of it edited, the harness finds and runs them by name."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

from sfm_bench.tests.tiny import REPO, TINY

_RUN = """
import json, sys
sys.path[:0] = [{tmp!r}, {repo!r}]
import torch
torch.set_num_threads(2)
from sfm_bench import run as harness
assert harness.HERE == __import__("pathlib").Path({tmp!r}) / "sfm_bench"
bench = harness.manifest()
spec = harness.cell_spec(bench, "orbit-small.depthmaps")
out = {{}}
for traced in (False, True):
    res = harness.run_cell(spec, bench, 3, 0.5, traced, torch.device("cpu"))
    out[str(traced)] = res
print(json.dumps(out))
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_files_alone_add_a_cell(tmp_path):
    tmp = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "sfm_bench"),
                    os.path.join(tmp, "sfm_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(os.path.join(tmp, "sfm_bench"))
    bench_dir = os.path.join(tmp, "sfm_bench")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # A configuration: the submodel's, smaller.
    with open(os.path.join(bench_dir, "configs",
                           "opensfm-submodel-80.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "orbit-small"
    t = TINY["submodel80.depthmaps"]
    cfg["sizes"].update(t["sizes"])
    cfg["settings"].update(t["settings"])
    with open(os.path.join(bench_dir, "configs", "orbit-small.json"),
              "w") as f:
        json.dump(cfg, f)
    # A cell on the existing driver.
    with open(os.path.join(bench_dir, "workloads",
                           "submodel80.depthmaps.json")) as f:
        work = json.load(f)
    work.update(config="orbit-small", traffic="small_orbit")
    work["params"].update(t["params"])
    with open(os.path.join(bench_dir, "workloads",
                           "orbit-small.depthmaps.json"), "w") as f:
        json.dump(work, f)
    # A per-layer metric: a reader of its own.
    with open(os.path.join(bench_dir, "metrics", "dense.shots_read.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    return float(len(run.items)) if run.items else None\n")
    bench["configs"].append(dict(copy.deepcopy(bench["configs"][0]),
                                 name="orbit-small",
                                 file="sfm_bench/configs/orbit-small.json"))
    bench["workloads"].append(dict(name="orbit-small.depthmaps",
                                   config="orbit-small",
                                   traffic="small_orbit", chips=1,
                                   why="a small orbit"))
    for m in bench["end_to_end"]:
        if m["name"] == "depthmaps_per_s":
            m["workloads"].append("orbit-small.depthmaps")
    bench["per_layer"].append(dict(
        name="dense.shots_read", unit="depthmaps", better="higher",
        source="program_counter", layer="Dense", moves="depthmaps_per_s",
        workloads=["orbit-small.depthmaps"]))
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    proc = subprocess.run(
        [sys.executable, "-c", _RUN.format(tmp=tmp, repo=REPO)], cwd=tmp,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["False"]["correct"] and out["True"]["correct"]
    assert set(out["False"]["metrics"]) == {"depthmaps_per_s", "setup_s"}
    assert out["True"]["metrics"]["dense.shots_read"]["value"] >= 1
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
