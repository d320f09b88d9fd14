"""The port's tracks stage against the JAX package on the CPU: union-find,
the native core (built at first use under build/native/), track linking,
common tracks, the `tracks.csv` codec, and the `create_tracks` command,
whose `tracks.csv` must be byte-identical to the reference's from the same
features and matches on the native path and on the Python path."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu import native as ref_native
from opensfm_tpu import tracking as ref_tracking
from opensfm_tpu.actions import create_tracks as ref_create_tracks
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.unionfind import UnionFind as RefUnionFind
from opensfm_tpu_torch import native, pymap, tracking
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.unionfind import UnionFind

N_SHOTS = 6
N_POINTS = 400


@pytest.fixture(scope="module")
def matched_dataset(tmp_path_factory):
    """A 6-image matching dataset (features of 400 points seen from their 3
    nearest images, plus distractors) with matches written from the truth,
    12 % of them replaced by wrong ones so that some linked tracks see an
    image twice and are dropped."""
    path = str(tmp_path_factory.mktemp("tracks") / "data")
    feature_points = sb.write_matching_dataset(
        path, n_shots=N_SHOTS, n_points=N_POINTS, track_window=3,
        features_per_image=N_POINTS, seed=3)
    data = DataSet(path)
    images = data.images()
    rng = np.random.default_rng(4)
    for a, im1 in enumerate(images):
        matches = {}
        for im2 in images[a + 1:]:
            p1, p2 = feature_points[im1], feature_points[im2]
            f2_of = {int(p): f for f, p in enumerate(p2) if p >= 0}
            m = np.array([(f1, f2_of[int(p)]) for f1, p in enumerate(p1)
                          if p >= 0 and int(p) in f2_of], dtype=np.int64)
            if len(m) == 0:
                continue
            wrong = rng.random(len(m)) < 0.12
            m[wrong, 1] = rng.integers(0, len(p2), int(wrong.sum()))
            matches[im2] = m
        data.save_matches(im1, matches)
    return path


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def test_union_find_matches_reference():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 60, (80, 2))
    ours, ref = UnionFind(), RefUnionFind()
    for a, b in edges:
        ours.union(int(a), int(b))
        ref.union(int(a), int(b))
    assert ours.clusters() == ref.clusters()
    assert [ours.find(i) for i in range(60)] == [ref.find(i) for i in range(60)]


def test_native_core_builds_lazily_and_matches_reference():
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent.name == "native"
    rng = np.random.default_rng(1)
    u, v = rng.integers(0, 50, 40), rng.integers(0, 50, 40)
    labels, k = native.union_find_components(u, v, 50)
    ref_labels, ref_k = ref_native.union_find_components(u, v, 50)
    assert k == ref_k and np.array_equal(labels, ref_labels)
    with pytest.raises(native.NativeError):
        native.union_find_components(np.array([7]), np.array([0]), 3)


@pytest.mark.parametrize("codec", ["native", "python"])
def test_tracks_codec_round_trip_matches_reference(matched_dataset, codec,
                                                   monkeypatch):
    if codec == "python":
        monkeypatch.setattr(native, "NATIVE_AVAILABLE", False)
        monkeypatch.setattr(ref_native, "NATIVE_AVAILABLE", False)
    data = DataSet(matched_dataset)
    features, colors, segs, insts, depths = tracking.load_features(
        data, data.images())
    matches = tracking.load_matches(data, data.images())
    tm = tracking.create_tracks_manager(features, colors, segs, insts,
                                        matches, 2, depths)
    text = tm.as_string()
    from opensfm_tpu import pymap as ref_pymap

    ref_tm = ref_pymap.TracksManager.instanciate_from_string(text)
    assert ref_tm.as_string() == text
    back = pymap.TracksManager.instanciate_from_string(text)
    assert back.as_string() == text
    assert back.num_tracks() == tm.num_tracks()


@pytest.mark.parametrize("linking", ["native", "python"])
def test_create_tracks_is_byte_identical_to_reference(
        matched_dataset, tmp_path, linking, monkeypatch):
    """The port's `create_tracks` and the reference's, from the same
    features and matches, write the same tracks.csv bytes; the report says
    which path linked and serialized the tracks."""
    if linking == "python":
        monkeypatch.setattr(native, "NATIVE_AVAILABLE", False)
        monkeypatch.setattr(ref_native, "NATIVE_AVAILABLE", False)
    ours = _copy(matched_dataset, str(tmp_path / "ours"))
    ref = _copy(matched_dataset, str(tmp_path / "ref"))
    command_runner(opensfm_commands,
                   argv=["create_tracks", ours, "--device", "cpu"])
    ref_create_tracks.run_dataset(RefDataSet(ref))
    with open(os.path.join(ours, "tracks.csv"), "rb") as f:
        ours_bytes = f.read()
    with open(os.path.join(ref, "tracks.csv"), "rb") as f:
        ref_bytes = f.read()
    assert ours_bytes == ref_bytes
    report = json.loads(DataSet(ours).load_report("tracks.json"))
    assert report["paths"] == {"linking": linking, "codec": linking}
    assert report["device"] == "cpu"
    tm = DataSet(ours).load_tracks_manager()
    assert report["num_tracks"] == tm.num_tracks() > 100
    # Some linked clusters saw an image twice and were dropped.
    assert tm.num_tracks() < N_POINTS


def test_common_tracks_match_reference(matched_dataset):
    data = DataSet(matched_dataset)
    features, colors, segs, insts, depths = tracking.load_features(
        data, data.images())
    text = tracking.create_tracks_manager(
        features, colors, segs, insts,
        tracking.load_matches(data, data.images()), 2, depths).as_string()
    from opensfm_tpu import pymap as ref_pymap

    tm = pymap.TracksManager.instanciate_from_string(text)
    ref_tm = ref_pymap.TracksManager.instanciate_from_string(text)
    images = data.images()
    t, p1, p2 = tracking.common_tracks(tm, images[0], images[1])
    rt, rp1, rp2 = ref_tracking.common_tracks(ref_tm, images[0], images[1])
    assert t == rt and np.array_equal(p1, rp1) and np.array_equal(p2, rp2)
    ours = tracking.all_common_tracks(tm)
    ref = ref_tracking.all_common_tracks(ref_tm)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key][0] == ref[key][0]
        assert np.array_equal(ours[key][1], ref[key][1])
        assert np.array_equal(ours[key][2], ref[key][2])
    assert tracking.all_common_tracks_without_features(tm) == \
        ref_tracking.all_common_tracks_without_features(ref_tm)


def test_create_tracks_without_device_needs_cuda(matched_dataset, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ours = _copy(matched_dataset, str(tmp_path / "ours"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        command_runner(opensfm_commands, argv=["create_tracks", ours])
    assert not os.path.exists(os.path.join(ours, "tracks.csv"))
