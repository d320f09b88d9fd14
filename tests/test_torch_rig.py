"""The port's rig handling against the JAX package on the CPU.

The rig functions (`rig.py`): pattern grouping, instance groups, the
relative poses of rig cameras from a reconstruction (1e-12), the count of
reconstructed instances, and the calibration subsets proposed from GPS
(the same instances drawn, the camera model overrides linked).  The
bundle builder on the JAX package's synthetic rig scene (4 rig cameras,
6 instances) with depth priors on some observations: the same problem
arrays, type segments, rig-camera priors, locks and depth rows.  The
slice as a whole: that scene at seed 42 through the port's
`incremental_reconstruction` meets the strict bounds of
tests/test_reconstruction_incremental.py:121-133 (the JAX package is not
re-run)."""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from opensfm_tpu import geo as ref_geo
from opensfm_tpu import rig as ref_rig
from opensfm_tpu.ba import problem as ref_problem
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.synthetic_data import (
    synthetic_dataset,
    synthetic_examples,
    synthetic_scene,
)
from opensfm_tpu_torch import pymap, reconstruction, rig
from opensfm_tpu_torch.ba import problem as port_problem
from opensfm_tpu_torch.dataset import DataSet


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work (the suite runs in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rig_scene(tmp_path_factory):
    """The JAX package's rig scene at seed 42, as its own end-to-end test
    builds it, written as a dataset directory by its writers (EXIF, camera
    models, tracks, reference frame, rig cameras and assignments, and the
    true reconstruction)."""
    np.random.seed(42)
    reference = ref_geo.TopocentricConverter(47.0, 6.0, 0)
    gt = synthetic_examples.synthetic_rig_scene(reference)
    scene = synthetic_scene.SyntheticInputData(
        gt.get_reconstruction(), reference, 40, 1.0, 0.1, 0.1, (0.0, 0.0),
        False,
    )
    ds = synthetic_dataset.SyntheticDataSet(
        scene.reconstruction, scene.exifs, scene.features,
        scene.tracks_manager,
    )
    path = str(tmp_path_factory.mktemp("rig") / "data")
    os.makedirs(path)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump({"align_method": "orientation_prior"}, f)
    writer = RefDataSet(path)
    for shot_id, exif in scene.exifs.items():
        writer.save_exif(shot_id, exif)
    writer.save_camera_models(scene.reconstruction.cameras)
    writer.save_tracks_manager(scene.tracks_manager)
    writer.save_reference_lla({"latitude": 47.0, "longitude": 6.0,
                               "altitude": 0.0})
    writer.save_rig_cameras(ds.load_rig_cameras())
    writer.save_rig_assignments(ds.load_rig_assignments())
    writer.save_reconstruction([scene.reconstruction], "truth.json")
    return scene, path


def _pose_close(a, b, tol=1e-12):
    np.testing.assert_allclose(a.rotation, b.rotation, rtol=0, atol=tol)
    np.testing.assert_allclose(a.translation, b.translation, rtol=0, atol=tol)


def test_pattern_grouping_matches_reference():
    images = [f"{k:03d}_{c}.jpg" for k in range(5) for c in ("a", "b", "c")]
    images += ["lonely_a.jpg", "single.jpg"]
    patterns = {"A": "_a", "B": "_b", "C": "_c"}
    got = rig.create_instances_with_patterns(images, patterns)
    assert got == ref_rig.create_instances_with_patterns(images, patterns)
    assert rig.group_instances(got[0]) == ref_rig.group_instances(got[0])


def test_rig_cameras_from_reconstruction_match_reference(rig_scene):
    """compute_relative_pose through create_rig_cameras_from_reconstruction
    on the true reconstruction, with one shot of one instance missing (that
    instance is left out), and count_reconstructed_instances."""
    _, path = rig_scene
    rec = DataSet(path).load_reconstruction("truth.json")[0]
    ref = RefDataSet(path).load_reconstruction("truth.json")[0]
    instances = DataSet(path).load_rig_assignments()
    dropped = instances[2][1][0]
    rec.remove_shot(dropped)
    ref.remove_shot(dropped)
    got = rig.create_rig_cameras_from_reconstruction(rec, instances)
    want = ref_rig.create_rig_cameras_from_reconstruction(ref, instances)
    assert sorted(got) == sorted(want) and len(got) == 4
    for k in got:
        _pose_close(got[k].pose, want[k].pose)
    assert rig.count_reconstructed_instances(instances, rec) \
        == ref_rig.count_reconstructed_instances(instances, ref) \
        == len(instances) - 1


def _gps_dataset(path):
    """24 two-camera instances with GPS (placeholder image files): 18 along
    a street, 6 a kilometre away, and camera model overrides."""
    os.makedirs(path)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump({}, f)
    ref = ref_geo.TopocentricConverter(47.0, 6.0, 0)
    data = RefDataSet(path)
    images = []
    for k in range(24):
        x = 3.0 * k if k < 18 else 1000.0 + 3.0 * k
        lat, lon, alt = ref.to_lla(x, 0.0, 0.0)
        for cam in ("left", "right"):
            image = f"view_{k:03d}_{cam}.jpg"
            images.append(image)
            data.save_exif(image, {"camera": cam, "gps": {
                "latitude": lat, "longitude": lon, "altitude": alt}})
    os.makedirs(os.path.join(path, "images"))
    for image in images:  # placeholders: the subsets link them
        open(os.path.join(path, "images", image), "wb").close()
    data.save_reference_lla({"latitude": 47.0, "longitude": 6.0,
                             "altitude": 0.0})
    with open(os.path.join(path, "camera_models_overrides.json"), "w") as f:
        json.dump({}, f)


def test_calibration_subsets_match_reference(tmp_path):
    """The first two proposed subsets draw the same instances (the largest
    GPS component, 15 of its 18 drawn with the same generator), the first
    links just its images, and the port's subset links the camera model
    overrides."""
    path = str(tmp_path / "gps")
    _gps_dataset(path)
    patterns = {"left": "_left", "right": "_right"}
    instances, _ = rig.create_instances_with_patterns(
        DataSet(path).images(), patterns)
    got = rig.propose_subset_dataset_from_instances(
        DataSet(path), instances, "rig_calibration")
    want = ref_rig.propose_subset_dataset_from_instances(
        RefDataSet(path), instances, "rig_calibration_ref")
    for k in range(2):
        (sub, picked), (_, ref_picked) = next(got), next(want)
        assert picked == ref_picked and len(picked) == 15
        assert all(int(p[0][0][5:8]) < 18 for p in picked)
        if k == 0:  # later rounds link into the same directory, as the JAX
            # package's do
            assert sorted(sub.images()) == sorted(
                i for p in picked for i, _ in p)
    assert os.path.islink(os.path.join(path, "rig_calibration",
                                       "camera_models_overrides.json"))


class _Captured(Exception):
    pass


def _built_problem(module, monkeypatch, data, depth_every):
    """The problem `bundle` builds for a package on the scene's true
    reconstruction, every `depth_every`-th observation with a depth prior
    (z for even features, radial for odd)."""
    seen = {}

    def capture(problem, *args, **kwargs):
        seen["problem"] = problem
        raise _Captured

    monkeypatch.setattr(module, "_solve_full_bundle", capture)
    rec = data.load_reconstruction("truth.json")[0]
    rec.add_correspondences_from_tracks_manager(data.load_tracks_manager())
    depth_cls = type(pymap.Depth(1.0, False, 1.0))
    if module is ref_problem:
        from opensfm_tpu import pymap as ref_pymap
        depth_cls = ref_pymap.Depth
    k = 0
    for sid in sorted(rec.shots):
        for lm_id, obs in sorted(
                rec.shots[sid].get_landmark_observations().items()):
            if k % depth_every == 0:
                obs.depth_prior = depth_cls(5.0 + 0.01 * k, obs.id % 2 == 1,
                                            0.1)
            k += 1
    cfg = dict(data.config, bundle_use_gps=True)
    with pytest.raises(_Captured):
        module.bundle(rec, data.load_camera_models(), data.load_rig_cameras(),
                      None, cfg)
    return seen["problem"]


def test_rig_bundle_problem_matches_reference(rig_scene, monkeypatch):
    """`ba.problem.bundle`'s builder on the rig scene: the same arrays as
    the JAX package's, the type segments, the rig cameras (locked: 24 shots
    over 4 rig cameras is 6 a camera, at most 10), their priors, and the
    depth rows."""
    _, path = rig_scene
    got = _built_problem(port_problem, monkeypatch, DataSet(path), 7)
    want = _built_problem(ref_problem, monkeypatch, RefDataSet(path), 7)
    assert got.ptype == want.ptype and len(got.ptype) == 1
    assert not got.opt_rigcam.any()
    assert np.abs(got.rigcam).max() > 0.1
    assert (got.obs_depth_inv_sd > 0).sum() > 100
    assert got.obs_depth_radial.any() and not got.obs_depth_radial.all()
    for f in ("inst", "rigcam", "cam", "points", "obs_uv", "obs_inv_sd",
              "obs_point", "obs_inst", "obs_rigcam", "obs_cam", "point_obs",
              "gps_pos", "gps_inv_sd", "cam_prior", "cam_prior_inv_sd",
              "cam_log_mask", "rigcam_prior", "rigcam_prior_inv_sd",
              "opt_inst", "opt_rigcam", "opt_cam", "opt_points", "up_inst",
              "up_rigcam", "up_vec", "up_inv_sd", "obs_depth",
              "obs_depth_inv_sd", "obs_depth_radial"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape and np.array_equal(a, b), f


def test_rig_scene_meets_the_strict_bounds(rig_scene):
    """The JAX package's rig scene at seed 42 through the port: every
    bound of its own end-to-end rig test holds (aligned positions < 0.005,
    rotations < 0.001, points < 0.05, GPS < 0.15), and the bundles take
    the generic route."""
    scene, path = rig_scene
    data = DataSet(path)
    report, recs = reconstruction.incremental_reconstruction(
        data, data.load_tracks_manager(), device="cpu")
    errors = synthetic_scene.compare(scene.reconstruction, {},
                                     copy.deepcopy(recs[0]))
    assert recs[0].reference.lat == 47.0
    assert recs[0].reference.lon == 6.0
    assert errors["ratio_cameras"] == 1.0
    assert 0.7 < errors["ratio_points"] < 1.0
    assert 0 < errors["aligned_position_rmse"] < 0.005
    assert 0 < errors["aligned_rotation_rmse"] < 0.001
    assert 0 < errors["aligned_points_rmse"] < 0.05
    assert 0 < errors["absolute_gps_rmse"] < 0.15
    assert len(recs[0].rig_cameras) == 4
    assert "generic" in json.dumps(report)
