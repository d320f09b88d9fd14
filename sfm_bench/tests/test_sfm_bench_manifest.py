"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
leads to the files the harness finds by that name."""

from __future__ import annotations

import json
import os
import re

import pytest

from sfm_bench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
BENCH_DIR = os.path.join(REPO, "sfm_bench")


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level(bench):
    assert set(bench) == TOP
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(REPO, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check(bench):
    """2 + 14 runs a cell, each allowed run_seconds + 60 s, 180 s of
    compiling a cell and 1,200 s spare, with the full 24 cells."""
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180
             + 1200)
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_keys(bench, kind):
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }[kind]
    entries = bench[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                            "higher")
            assert e["source"] in (SOURCES_E2E if kind == "end_to_end"
                                   else SOURCES)
        else:
            assert _line(e["why"])
        if kind == "configs":
            assert _line(e["source"]) and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
        if kind == "workloads":
            assert e["chips"] in (1, 4)
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        if kind == "per_layer":
            assert _line(e["layer"])


def test_bounds(bench):
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]


def test_every_cell_reports_enough(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        e2e = {m["name"] for m in bench["end_to_end"]
               if c in m.get("workloads", cells)}
        assert "setup_s" in e2e and len(e2e) >= 2, c
        assert any(c in m.get("workloads", cells)
                   for m in bench["per_layer"]), c


def test_moves_is_reported_where_the_metric_is(bench):
    """A per-layer metric moves an end-to-end metric that every cell
    reporting it reports too."""
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s", m["name"]
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]


def test_one_layer_name_a_layer(bench):
    """Metrics of one layer give it letter for letter, and PERF.md's list
    of layers names each."""
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    for m in bench["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_configs_files_and_cuts(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"] == f"sfm_bench/configs/{c['name']}.json"
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg["sizes"] or k in cfg["settings"]
                   for k in c["reduced"])
        assert sorted(cfg.get("cuts", {})) == sorted(c["reduced"])
        assert cfg["assumed"] and cfg["precision"] in ("float32", "float64")


def test_cells_find_their_files(bench):
    pairs = set()
    for w in bench["workloads"]:
        pair = (w["config"], w["traffic"])
        assert pair not in pairs
        pairs.add(pair)
        with open(os.path.join(BENCH_DIR, "workloads",
                               w["name"] + ".json")) as f:
            spec = json.load(f)
        assert spec["config"] == w["config"]
        assert spec["traffic"] == w["traffic"]
        assert os.path.isfile(os.path.join(BENCH_DIR, "traffic",
                                           spec["driver"] + ".py"))
        assert spec["limits"]
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_file_names_are_names():
    for root, dirs, files in os.walk(BENCH_DIR):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in dirs + files:
            rel = os.path.relpath(os.path.join(root, name), REPO)
            assert PATH.match(rel), rel
