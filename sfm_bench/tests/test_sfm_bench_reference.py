"""The plain references against the port at tiny sizes on the CPU, step by
step: what the reference works out again (neighbours, depth range, greys)
equals what the port derives from the same
inputs."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from sfm_bench.tests.tiny import tiny_spec
from sfm_bench import scene as scene_lib
from sfm_bench.reference import patchmatch as ref_pm
from sfm_bench.traffic import depthmaps as dense_driver

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dense_cell(bench):
    cell = dense_driver.Cell(tiny_spec(bench, "submodel80.depthmaps"), 11,
                             CPU)
    cell.setup()
    yield cell
    cell.release()
    cell.check([])


def test_neighbours_equal_the_ports(dense_cell):
    sc = dense_cell.scene
    k = int(dense_cell.settings["depthmap_num_neighbors"])
    for v, name in enumerate(dense_cell.names):
        want = [dense_cell.names[i] for i in ref_pm.neighbours(
            v, dense_cell.names, sc["centres"], sc["points"], sc["obs_point"],
            sc["obs_view"], k)]
        assert dense_cell.neighbours[name] == want


def test_depth_range_and_grey_equal_the_ports(dense_cell):
    from opensfm_tpu_torch import dense

    sc = dense_cell.scene
    width = int(dense_cell.settings["depthmap_resolution"])
    for v in (0, 7):
        shot = dense_cell.rec.shots[dense_cell.names[v]]
        got = dense.compute_depth_range(dense_cell.rec, shot,
                                        dense_cell.udata.config)
        want = ref_pm.depth_range(sc["points"], sc["R"][v], sc["centres"][v])
        np.testing.assert_allclose(got, want, rtol=1e-12)
        grey = dense._scaled_gray(dense_cell.udata, dense_cell.rec,
                                  dense_cell.names[v], width, CPU)[0]
        np.testing.assert_array_equal(
            grey, ref_pm.scaled_grey(dense_cell.rgb[v], width, CPU).numpy())


def test_images_hold_the_rendered_pixels(dense_cell):
    from opensfm_tpu_torch import io

    path = os.path.join(dense_cell.work, "undistorted", "images",
                        dense_cell.names[3])
    np.testing.assert_array_equal(io.imread(path), dense_cell.rgb[3])


def test_patch_match_equals_the_ports(dense_cell):
    """The reference's raw depthmap against the port's on the same shot;
    on the CPU both take the same arithmetic."""
    sc = dense_cell.scene
    v = 5
    name = dense_cell.names[v]
    nbrs = [dense_cell.names.index(n) for n in dense_cell.neighbours[name]]
    dense_cell.step(v)  # the port saves the shot's raw depthmap
    o = np.load(os.path.join(dense_cell.work, "undistorted", "depthmaps",
                             name + ".raw.npz"))
    want = ref_pm.depthmap(dense_cell.rgb, v, nbrs, sc["focal"], sc["R"],
                           sc["t"], sc["centres"], sc["points"],
                           dense_cell.settings, torch.float32, CPU)
    ids = dense_driver._ids(dense_cell.neighbours[name], o["nghbr"])
    assert ref_pm.disagreement(
        (o["depth"], o["plane"], o["score"], ids),
        (want[0], want[1], want[2],
         dense_driver._ids(dense_cell.neighbours[name], want[3])),
        1e-6) == 0.0
    assert np.mean(want[0] > 0) > 0.2  # PatchMatch found surfaces


def test_orbit_scene_meets_its_sizes(bench):
    spec = tiny_spec(bench, "submodel80.depthmaps")
    sizes = spec["config"]["sizes"]
    sc = scene_lib.orbit_scene(sizes, 17, CPU)
    counts = np.bincount(sc["obs_point"], minlength=sizes["points"])
    assert len(sc["points"]) == sizes["points"]
    assert counts.min() >= sizes["min_track"]
    assert counts.max() <= sizes["max_track"]
    pairs = set(zip(sc["obs_point"].tolist(), sc["obs_view"].tolist()))
    assert len(pairs) == len(sc["obs_point"])  # no point twice in a view


def test_scenes_repeat_from_the_seed(bench):
    spec = tiny_spec(bench, "submodel80.depthmaps")
    a = scene_lib.orbit_scene(spec["config"]["sizes"], 2**31 + 5, CPU)
    b = scene_lib.orbit_scene(spec["config"]["sizes"], 2**31 + 5, CPU)
    np.testing.assert_array_equal(a["points"], b["points"])
    np.testing.assert_array_equal(a["obs_view"], b["obs_view"])
    np.testing.assert_array_equal(a["obs_xy"], b["obs_xy"])
    np.testing.assert_array_equal(a["grids"].numpy(), b["grids"].numpy())
