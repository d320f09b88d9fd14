"""Sizes and specs a CPU test can hold: the cells' own code paths on
smaller maps."""

from __future__ import annotations

import copy
import os

from sfm_bench import run as harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {
    "submodel80.depthmaps": dict(
        sizes=dict(views=24, undistorted_image_size=[160, 120], points=1500),
        settings=dict(depthmap_resolution=40, depthmap_num_neighbors=3),
        params=dict(supersample=1)),
}


def tiny_spec(bench, cell):
    """The cell's spec at TINY's sizes."""
    spec = copy.deepcopy(harness.cell_spec(bench, cell))
    t = TINY[cell]
    spec["config"]["sizes"].update(t["sizes"])
    spec["config"]["settings"].update(t["settings"])
    spec["params"].update(t["params"])
    return spec
