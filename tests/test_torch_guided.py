"""Guided matching in the port against the JAX package on the CPU:
`compute_inliers_bearing_epipolar` (masks equal but within 1e-12 of the
threshold, where float64 rounding may decide), `match` with a relative
pose (the same matches with the JAX package's RANSAC draws injected, as
tests/test_torch_match_features_command.py injects them), and
`match_images_with_pairs(poses=...)`, on a matching dataset
(`synthetic_bundle.write_matching_dataset`, 5 images x 500 features) whose
relative poses are the generator's."""

import shutil

import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu import matching as ref_matching
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import matching
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.geometry.pose import Pose
from opensfm_tpu_torch.geometry.triangulation import (
    epipolar_angle_two_bearings_many,
)
from opensfm_tpu_torch.ops.kernels import top2
from opensfm_tpu_torch.robust import ransac
from test_torch_match_features_command import _jax_draws

CPU = torch.device("cpu")
NEAR_THRESHOLD = 1e-12  # radians of the epipolar angle


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small eager ops (RANSAC), as
    tests/test_torch_match_features_command.py runs them: the suite runs in
    several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _angles(b1, b2, pose):
    return epipolar_angle_two_bearings_many(
        *(torch.as_tensor(np.asarray(a, dtype=np.float64)) for a in
          (b1, b2, pose.get_rotation_matrix(), pose.translation))).numpy()


def _relative(i, j, n_shots):
    insts = sb.circle_shots(n_shots)
    p1 = Pose(insts[i, :3], insts[i, 3:])
    p2 = Pose(insts[j, :3], insts[j, 3:])
    return p2.compose(p1.inverse())


def test_epipolar_mask_matches_reference():
    rng = np.random.default_rng(5)
    points = rng.normal(size=(300, 3)) + np.array([0, 0, 6.0])
    relative = Pose([0.05, -0.3, 0.02], [-1.0, 0.1, 0.2])
    b1 = points / np.linalg.norm(points, axis=1, keepdims=True)
    p2 = points @ relative.get_rotation_matrix().T + relative.translation
    b2 = p2 / np.linalg.norm(p2, axis=1, keepdims=True)
    b2 = np.concatenate([b2, rng.normal(size=(100, 3))])
    b2[300:] /= np.linalg.norm(b2[300:], axis=1, keepdims=True)
    for threshold in (1e-6, 0.006, 0.05):
        want = ref_matching.compute_inliers_bearing_epipolar(
            b1, b2, relative, threshold)
        got = matching.compute_inliers_bearing_epipolar(
            b1, b2, relative, threshold, device=CPU)
        assert got.dtype == torch.bool and got.shape == (300, 400)
        decided = np.abs(_angles(b1, b2, relative) - threshold) > \
            NEAR_THRESHOLD
        np.testing.assert_array_equal(got.numpy()[decided], want[decided])
        assert np.all(np.diag(got.numpy()[:, :300]))
        assert got.numpy().mean() < 0.5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("guided") / "src")
    sb.write_matching_dataset(path, n_shots=5, n_points=500, track_window=3,
                              features_per_image=500, seed=6)
    return path


PAIRS = [("shot_00000.jpg", "shot_00001.jpg"),
         ("shot_00001.jpg", "shot_00003.jpg"),
         ("shot_00004.jpg", "shot_00002.jpg")]


def _poses():
    return {(a, b): _relative(int(a[5:10]), int(b[5:10]), 5)
            for a, b in PAIRS}


def test_guided_match_matches_reference(dataset, tmp_path, monkeypatch):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(dataset, a)
    shutil.copytree(dataset, b)
    ref_data, data = RefDataSet(a), DataSet(b)
    ref_cam = ref_data.load_camera_models()["synthetic_camera"]
    cam = data.load_camera_models()["synthetic_camera"]
    monkeypatch.setattr(ransac, "draw_subsets", _jax_draws)
    masked = top2.top2_sqdist.launches_masked
    poses = _poses()
    for (im1, im2), pose in poses.items():
        want = ref_matching.match(im1, im2, ref_cam, ref_cam, ref_data,
                                  ref_data.config, pose)
        got = matching.match(im1, im2, cam, cam, data, data.config, pose,
                             device=CPU)
        assert len(want) >= 20
        np.testing.assert_array_equal(got, want)
        # The descriptor matches before RANSAC, and each one on its line.
        want_p = ref_matching._match_descriptors_guided_impl(
            im1, im2, ref_cam, ref_cam, pose, ref_data, ref_data.config)
        got_p = matching._match_descriptors_guided_impl(
            im1, im2, cam, cam, pose, data, data.config, device=CPU)
        np.testing.assert_array_equal(got_p[2], want_p[2])
        assert got_p[3] == want_p[3] == "BRUTEFORCE"
        p1, p2, m = got_p[0], got_p[1], got_p[2]
        angles = _angles(cam.bearings_many(p1[m[:, 0], :2]),
                         cam.bearings_many(p2[m[:, 1], :2]), pose)
        assert np.diag(angles).max() < data.config["guided_matching_threshold"]
    # The CPU runs the plain version: no kernel launch is counted.
    assert top2.top2_sqdist.launches_masked == masked
    ref_matching.clear_cache()
    matching.clear_cache()


def test_match_images_with_pairs_poses(dataset, tmp_path, monkeypatch):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(dataset, a)
    shutil.copytree(dataset, b)
    ref_data, data = RefDataSet(a), DataSet(b)
    exifs = {im: data.load_exif(im) for im in data.images()}
    monkeypatch.setattr(ransac, "draw_subsets", _jax_draws)
    poses = _poses()
    want = ref_matching.match_images_with_pairs(ref_data, {}, exifs, PAIRS,
                                                poses)
    got = matching.match_images_with_pairs(data, {}, exifs, PAIRS,
                                           poses=poses, device=CPU)
    assert list(got) == list(want) == PAIRS
    for pair in PAIRS:
        np.testing.assert_array_equal(got[pair], want[pair])
    # Without poses the pairs take the unguided search.
    plain = matching.match_images_with_pairs(data, {}, exifs, PAIRS[:1],
                                             device=CPU)
    want_plain = ref_matching.match_images_with_pairs(ref_data, {}, exifs,
                                                      PAIRS[:1])
    np.testing.assert_array_equal(plain[PAIRS[0]], want_plain[PAIRS[0]])
    ref_matching.clear_cache()
    matching.clear_cache()
