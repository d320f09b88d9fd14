"""Each cell run as the driver runs it, on the card: a short window that
comes out correct and prints the result line last."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from sfm_bench.tests.tiny import REPO

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", ["submodel80.depthmaps"])
def test_cell_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, "-m", "sfm_bench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
