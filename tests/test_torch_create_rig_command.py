"""The port's `create_rig` command on a small render against the JAX
package's `create_rig` action, on the CPU.

`synthetic_images` renders 3 instances of its two-camera rig (a brown
camera left, a fisheye_opencv camera right, 0.4 m apart) at 320 x 240;
the port's `extract_metadata` gives each rig camera its model from the
overrides, and its `detect_features` detects the features that both
calibration subsets link.  Then each package calibrates the rig on its
own copy of the dataset (its own matching and reconstruction of the
subset; the JAX package's subset is given a copy of the overrides, which
its own subset does not link).  Held: the same rig assignments, and the
two packages' relative poses of the rig cameras within 0.005 m and 0.005
rad of each other (two reconstructions of 6 images agree to about their
noise, ~5e-4, not to round-off); and the baseline within 0.05 m of the
true 0.4 m after the similarity that maps the port's subset
reconstruction onto the true centres."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import synthetic_images as si
from opensfm_tpu.actions import create_rig as ref_create_rig
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet

CONFIG = {"feature_min_frames": 1500, "feature_process_size": 320}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes at once, and multi-threaded small ops then
    wait on each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rig_render") / "data")
    truth = si.write_image_dataset(path, n_views=3, width=320, height=240,
                                   step_deg=10.0, config=CONFIG, rig=si.RIG)
    command_runner(opensfm_commands, argv=["extract_metadata", path])
    command_runner(opensfm_commands,
                   argv=["detect_features", path, "--device", "cpu"])
    return path, truth


def _relative(cams):
    a, b = cams["left"].pose, cams["right"].pose
    return b.compose(a.inverse())


def test_create_rig_matches_reference(rendered, tmp_path):
    path, truth = rendered
    cams = DataSet(path).load_camera_models()
    assert sorted(c.projection_type for c in cams.values()) == [
        "brown", "fisheye_opencv"]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    shutil.copytree(path, ours, symlinks=True)
    shutil.copytree(path, theirs, symlinks=True)
    patterns = json.dumps(truth["rig_patterns"])
    command_runner(opensfm_commands, argv=[
        "create_rig", ours, "pattern", patterns, "--device", "cpu"])
    os.makedirs(os.path.join(theirs, "rig_calibration"))
    shutil.copy(os.path.join(theirs, "camera_models_overrides.json"),
                os.path.join(theirs, "rig_calibration"))
    ref_create_rig.run_dataset(RefDataSet(theirs), "pattern", patterns)

    got, want = DataSet(ours), RefDataSet(theirs)
    assert got.load_rig_assignments() == want.load_rig_assignments()
    assert len(got.load_rig_assignments()) == 3
    rel, ref_rel = _relative(got.load_rig_cameras()), _relative(
        want.load_rig_cameras())
    assert np.linalg.norm(rel.translation - ref_rel.translation) < 0.005
    assert np.linalg.norm(rel.rotation - ref_rel.rotation) < 0.005
    # The truth fixes the metric scale of the subset's reconstruction.
    rec = DataSet(os.path.join(ours, "rig_calibration")) \
        .load_reconstruction()
    grade = si.grade_reconstruction(rec, truth)
    assert grade["shots"] == 6
    baseline = np.linalg.norm(rel.get_origin()) * grade["scale"]
    assert abs(baseline - 0.4) < 0.05
