"""The control: the reference put in the program's place in the precision
below the configuration's, judged by a cell's own comparison.  A sound
comparison finds it not correct.  Benchmark runs never run it.

    python3 -m sfm_bench.control --workload <cell> --seeds 1,2,3

Prints one JSON line a seed: each number the cell compares, with its
limit.  Each traffic driver (`traffic/<driver>.py`) holds its cells'
control as `control(spec, seed, device)`, found by the driver's name.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sfm_bench import run as harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    spec = harness.cell_spec(harness.manifest(), args.workload)
    driver = harness.load_module("traffic", spec["driver"])
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": driver.control(spec, seed, device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
