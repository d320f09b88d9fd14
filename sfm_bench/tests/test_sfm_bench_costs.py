"""`costs.py` holds the same peaks and operation counts as `chip_smoke.py`
(read as text, not imported), and its bounds follow from them."""

from __future__ import annotations

import os
import re

import pytest

from sfm_bench.tests.tiny import REPO
from sfm_bench import costs

SCALARS = ["HBM_BYTES_PER_S", "PEAK_INT8_OPS", "FLOPS_COST_OBS",
           "FLOPS_COST_DENSE_SLOT", "FLOPS_ROTATION", "FLOPS_RESJAC_OBS",
           "FLOPS_ASSEMBLE_SLOT", "FLOPS_BACKSUB_SLOT"]


@pytest.fixture(scope="module")
def smoke_text():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        return f.read()


@pytest.mark.parametrize("name", SCALARS)
def test_scalar_equals_the_smokes(smoke_text, name):
    m = re.search(rf"^{name} = ([0-9.e_]+)", smoke_text, re.M)
    assert m, name
    assert float(m.group(1)) == getattr(costs, name)


@pytest.mark.parametrize("name", ["PEAK_FLOPS", "PEAK_MMA_FLOPS"])
def test_peaks_equal_the_smokes(smoke_text, name):
    m = re.search(rf"^{name} = \{{(.*?)\}}", smoke_text, re.M)
    assert m, name
    found = dict(re.findall(r"torch\.(float\d+): ([0-9.e]+)", m.group(1)))
    assert {k: float(v) for k, v in found.items()} == getattr(costs, name)


def test_bounds_at_the_venice_map():
    """Rows 1-2 at BAL Venice's real sizes are bound by bytes: 347,173
    observations read (uv, inverse sd, three int32 indices) and, for row 2,
    27 doubles written each."""
    n = (347173, 52, 52, 64053)
    tables = (6 * 52 + 3 * 52 + 3 * 64053) * 8
    read = 347173 * (3 * 8 + 3 * 4) + tables
    assert costs.resjac_bound_s(*n) == pytest.approx(
        (read + 347173 * 27 * 8) / 3.35e12)
    assert costs.cost_bound_s(*n) == pytest.approx((read + 8) / 3.35e12)
