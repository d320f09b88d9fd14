"""Run one benchmark cell once and print its result as the last line.

    python3 -m sfm_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json.  Everything about
it is found by name: `workloads/<cell>.json` (its configuration, traffic
driver, parameters and limits), `configs/<config>.json` (the
configuration's sizes and settings), `traffic/<driver>.py` (the
generator and the calls into the program) and, in a traced run,
`metrics/<metric>.py` for each per-layer metric the cell reports.  A run
sets up (inputs from the seed, warm-up), measures a window of at least
`--seconds`, frees the program's state, then judges what the window
produced against the plain reference (`reference/`).  It needs a CUDA
device and never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is measured from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "opensfm_tpu")
WINDOW = "sfm_bench.window"


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark, loaded by its path (names
    may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"sfm_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = CHECKOUT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell_spec(bench: Dict[str, Any], name: str, root: Path = HERE
              ) -> Dict[str, Any]:
    """The cell's manifest entry with its workload file and its
    configuration file."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = dict(entry)
    spec.update(load_json(root / "workloads" / f"{name}.json"))
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    spec["config"] = load_json(root.parent / cfg["file"])
    return spec


def metrics_of(bench: Dict[str, Any], cell: str, kind: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` entries that `cell` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """What a per-layer metric's reader sees of one run."""

    cell: str
    items: List[Dict[str, Any]]
    window_s: float
    facts: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Any] = None  # trace.Summary of a traced window


def _window(cell, seconds: float, traced: bool):
    """Steps of `cell` until `seconds` have passed: (items, failed,
    window seconds, profiler or None)."""
    import torch

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cell.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    items, failed = [], 0
    t0 = time.perf_counter()
    with torch.profiler.record_function(WINDOW):
        while True:
            k = len(items) + failed
            try:
                with torch.profiler.record_function(cell.span):
                    items.append(cell.step(k))
            except Exception:  # a failed request counts and the run goes on
                traceback.print_exc()
                failed += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if cell.device.type == "cuda":
            torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    return items, failed, window_s, prof


def run_cell(spec: Dict[str, Any], bench: Dict[str, Any], seed: int,
             seconds: float, traced: bool, device) -> Dict[str, Any]:
    """Set up, measure and judge one cell; the result line's keys."""
    import torch

    from sfm_bench import trace as trace_lib

    cell = load_module("traffic", spec["driver"]).Cell(spec, seed, device)
    if device.type == "cuda":
        torch.empty(0, device=device)  # the context, before its statistics
        torch.cuda.reset_peak_memory_stats(device)
    cell.setup()
    setup_s = time.perf_counter() - T_START
    items, failed, window_s, prof = _window(cell, seconds, traced)
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": int(spec["chips"]),
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                    device)) if device.type == "cuda" else 0)}
    run = Run(cell=spec["name"], items=items, window_s=window_s,
              facts=dict(cell.facts))
    out: Dict[str, Any] = {}
    if prof is not None:
        run.trace = trace_lib.summarise(prof, WINDOW, {cell.span})
        del prof
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": [list(x) for x in run.trace.device_ops],
            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    for line in cell.notes(items, window_s):
        print(line, file=sys.stderr)
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check(items)
    metrics: Dict[str, Any] = {}
    if not traced:
        values = dict(cell.end_to_end(items, window_s), setup_s=setup_s)
        for m in metrics_of(bench, spec["name"], "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in metrics_of(bench, spec["name"], "per_layer"):
            v = load_module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = (failed == 0 and len(items) > 0
               and all(c["value"] <= c["limit"] for c in checks))
    result = {"correct": bool(correct), "attempted": len(items) + failed,
              "failed": failed, "metrics": metrics, "device": dev_info}
    result.update(out)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = manifest()
    spec = cell_spec(bench, args.workload)

    import torch

    chips = int(spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sfm_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(spec, bench, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"sfm_bench: the run imported {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
