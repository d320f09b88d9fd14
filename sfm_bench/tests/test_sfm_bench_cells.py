"""Each cell's driver runs the port at a tiny size on the CPU and comes out
correct; with the timed path broken underneath, the same run comes out
not correct; and the control (the reference in the precision below the
configuration's) fails the cell's comparison."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from sfm_bench.tests.tiny import TINY, tiny_spec
from sfm_bench import control
from sfm_bench import run as harness

CELLS = sorted(TINY)
CPU = torch.device("cpu")


def _run(bench, cell, seed=5, seconds=0.5, traced=False):
    return harness.run_cell(tiny_spec(bench, cell), bench, seed, seconds,
                            traced, CPU)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(bench, cell):
    res = _run(bench, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = {m["name"] for m in harness.metrics_of(bench, cell,
                                                   "end_to_end")}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_no_device_metric_off_the_cpu(bench, cell):
    """Off the card the profiler sees no device work: the device metrics
    stay silent (never 0), the program's own spans and counters read."""
    res = _run(bench, cell, traced=True)
    assert res["correct"]
    for name in res["metrics"]:
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert entry["source"] != "device_trace", name


def _dense_unchanged(monkeypatch):
    from opensfm_tpu_torch.ops import depthmap

    monkeypatch.setattr(depthmap, "_pm_half_iteration",
                        lambda state, *a, **k: state)


def _dense_half(monkeypatch):
    from opensfm_tpu_torch.ops import depthmap

    score = depthmap._score_candidate

    def half(nu, rays_off, ref_patch, ref_mean, ref_var, nb_gray, R_rel,
             t_rel, nb_f, *rest, **kw):
        n = max(1, nb_gray.shape[0] // 2)
        return score(nu, rays_off, ref_patch, ref_mean, ref_var, nb_gray[:n],
                     R_rel[:n], t_rel[:n], nb_f[:n], *rest, **kw)

    monkeypatch.setattr(depthmap, "_score_candidate", half)


def _dense_altered(monkeypatch):
    from opensfm_tpu_torch.dataset import UndistortedDataSet

    save = UndistortedDataSet.save_raw_depthmap

    def altered(self, image, depth, *rest):
        save(self, image, np.asarray(depth) * np.float32(1.001), *rest)

    monkeypatch.setattr(UndistortedDataSet, "save_raw_depthmap", altered)


def _dense_never_saved(monkeypatch):
    from opensfm_tpu_torch import dense

    monkeypatch.setattr(dense, "compute_depthmap", lambda *a, **k: None)


FAULTS = {
    ("submodel80.depthmaps", "state_unchanged"): _dense_unchanged,
    ("submodel80.depthmaps", "half_the_batch"): _dense_half,
    ("submodel80.depthmaps", "answer_altered"): _dense_altered,
    ("submodel80.depthmaps", "answer_never_saved"): _dense_never_saved,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_is_not_correct(bench, monkeypatch, cell, fault):
    FAULTS[cell, fault](monkeypatch)
    res = _run(bench, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    spec = tiny_spec(bench, cell)
    driver = harness.load_module("traffic", spec["driver"])
    checks = driver.control(spec, 5, CPU)
    assert any(not c["value"] <= c["limit"] for c in checks), checks


def test_control_command_runs_the_drivers_control(monkeypatch, capsys):
    """`python3 -m sfm_bench.control` finds the cell's control by the
    driver's name and prints its checks a seed."""
    calls = []

    def fake(spec, seed, device):
        calls.append((spec["name"], seed))
        return [{"name": "x", "value": 1.0, "limit": 0.5}]

    load = harness.load_module

    def load_module(kind, name):
        mod = load(kind, name)
        monkeypatch.setattr(mod, "control", fake)
        return mod

    monkeypatch.setattr(harness, "load_module", load_module)
    assert control.main(["--workload", CELLS[0], "--seeds", "3,4"]) == 0
    assert calls == [(CELLS[0], 3), (CELLS[0], 4)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["seed"] for ln in lines] == [3, 4]
