"""The port's `stats` numbers against the JAX package's on the CPU.

First the JAX package's own tests/test_stats.py assertions, run against
the port on the port's circle scene (seed 42, the same scene: see
tests/test_torch_synthetic_data.py).  Then `compute_all_statistics` of both
packages on the same scene, with and without its GCPs, and on the null
scene: the same nested keys in the same order, integers, booleans and
strings equal, the histogram edges equal, and floats within REL_TOL.
"""

import copy

import numpy as np
import pytest
import torch

from opensfm_tpu import stats as ref_stats
from opensfm_tpu import types as ref_types
from opensfm_tpu.synthetic_data import synthetic_dataset as ref_sd
from opensfm_tpu_torch import stats, types
from opensfm_tpu_torch.synthetic_data import synthetic_dataset as sd
from test_torch_synthetic_data import scenes

# Floats of the two packages' statistics, relative to the larger value,
# and absolute below 1: all but the GCP errors are the same NumPy
# reductions of equal inputs (equal bits); the GCPs are triangulated in
# torch f64 against jnp f64, ~1e-14 m apart on errors of ~100 m, so a mean
# that cancels to 7.7e-3 m is 2.0e-12 relative off.  Measured at most
# 3.1e-14 this way (seed 42, with the GCPs).
REL_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene_synthetic():
    return scenes("circle", 42)[1][1]


@pytest.fixture(scope="module")
def null_scene():
    return types.Reconstruction()


def make_dataset(scene, rec):
    return sd.SyntheticDataSet(rec, scene.exifs, scene.features,
                               scene.tracks_manager)


# -- tests/test_stats.py, against the port ------------------------------------


def test_processing_statistics_normal(scene_synthetic):
    reference = scene_synthetic.reconstruction
    dataset = make_dataset(scene_synthetic, reference)
    ps = stats.processing_statistics(dataset, [reference])
    assert list(ps.keys()) == ["steps_times", "date", "area"]
    assert ps["steps_times"] == {
        "Feature Extraction": -1,
        "Features Matching": -1,
        "Tracks Merging": -1,
        "Reconstruction": -1,
        "Total Time": 0,
    }
    assert ps["date"] == "unknown"
    assert 3000 < ps["area"] < 4500


def test_processing_statistics_null(scene_synthetic, null_scene):
    dataset = make_dataset(scene_synthetic, null_scene)
    ps = stats.processing_statistics(dataset, [null_scene])
    assert ps["date"] == "unknown"
    assert ps["area"] == -1


def test_features_statistics_normal(scene_synthetic):
    reference = scene_synthetic.reconstruction
    dataset = make_dataset(scene_synthetic, reference)
    fs = stats.features_statistics(
        dataset, scene_synthetic.tracks_manager, [reference]
    )
    assert list(fs.keys()) == ["detected_features", "reconstructed_features"]
    assert fs["detected_features"] == fs["reconstructed_features"]
    rf = fs["reconstructed_features"]
    assert 0 < rf["min"] <= rf["median"] <= rf["max"]
    assert 200 < rf["mean"] < 2000


def test_features_statistics_null(scene_synthetic, null_scene):
    dataset = make_dataset(scene_synthetic, null_scene)
    fs = stats.features_statistics(
        dataset, scene_synthetic.tracks_manager, [null_scene]
    )
    assert fs["reconstructed_features"] == {
        "min": -1, "max": -1, "mean": -1, "median": -1,
    }


def test_reconstruction_statistics_normal(scene_synthetic):
    reference = copy.deepcopy(scene_synthetic.reconstruction)
    dataset = make_dataset(scene_synthetic, reference)
    rs = stats.reconstruction_statistics(
        dataset, scene_synthetic.tracks_manager, [reference]
    )
    assert rs["components"] == 1
    assert rs["has_gps"]
    assert not rs["has_gcp"]
    assert rs["initial_shots_count"] == 20
    assert rs["reconstructed_shots_count"] == 20
    assert 4000 < rs["reconstructed_points_count"] <= 5000
    assert rs["observations_count"] > 10000
    assert 3.0 < rs["average_track_length"] < 4.0
    assert rs["average_track_length_over_two"] >= rs["average_track_length"]
    assert 0 < rs["reprojection_error_normalized"] < 0.01
    assert 0 < rs["reprojection_error_pixels"] < 3.0


def test_reconstruction_statistics_null(scene_synthetic, null_scene):
    dataset = make_dataset(scene_synthetic, null_scene)
    rs = stats.reconstruction_statistics(
        dataset, scene_synthetic.tracks_manager, [null_scene]
    )
    assert rs["components"] == 1
    assert not rs["has_gps"]
    assert not rs["has_gcp"]
    assert rs["initial_shots_count"] == 0
    assert rs["reconstructed_shots_count"] == 0
    assert rs["reconstructed_points_count"] == 0
    assert rs["observations_count"] == 0
    assert rs["average_track_length"] == -1
    assert rs["average_track_length_over_two"] == -1
    assert rs["reprojection_error_normalized"] == -1.0
    assert rs["reprojection_error_pixels"] == -1.0


def test_cameras_statistics_normal(scene_synthetic):
    reference = scene_synthetic.reconstruction
    dataset = make_dataset(scene_synthetic, reference)
    cs = stats.cameras_statistics(dataset, [reference])
    assert set(cs.keys()) == {"1"}
    entry = cs["1"]
    assert entry["initial_values"] == {"k1": -0.1, "k2": 0.01, "focal": 0.7}
    assert entry["optimized_values"] == {"k1": -0.1, "k2": 0.01, "focal": 0.7}
    assert entry["bias"]["scale"] == 1.0
    assert list(entry["bias"]["translation"]) == [0.0, 0.0, 0.0]


def test_cameras_statistics_null(scene_synthetic, null_scene):
    dataset = make_dataset(scene_synthetic, null_scene)
    assert stats.cameras_statistics(dataset, [null_scene]) == {}


def test_rig_statistics_normal(scene_synthetic):
    reference = scene_synthetic.reconstruction
    dataset = make_dataset(scene_synthetic, reference)
    assert stats.rig_statistics(dataset, [reference]) == {}


def test_gps_errors_normal(scene_synthetic):
    reference = scene_synthetic.reconstruction
    ge = stats.gps_errors([reference])
    assert set(ge.keys()) == {"average_error", "error", "mean", "std"}
    assert 3.0 < ge["average_error"] < 7.0


def test_gps_errors_null(null_scene):
    assert stats.gps_errors([null_scene]) == {}


def test_gcp_errors_normal(scene_synthetic):
    reference = scene_synthetic.reconstruction
    dataset = make_dataset(scene_synthetic, reference)
    assert stats.gcp_errors(dataset, [reference], device="cpu") == {}


def test_gcp_errors_absent_file_and_other_failures(scene_synthetic):
    """An absent GCP file is "no GCPs", as the JAX package's try/except
    makes it; any other failure to load them raises."""
    reference = scene_synthetic.reconstruction

    class Missing(sd.SyntheticDataSet):
        def load_ground_control_points(self):
            raise FileNotFoundError("ground_control_points.json")

    class Broken(sd.SyntheticDataSet):
        def load_ground_control_points(self):
            raise ValueError("malformed GCP file")

    args = (reference, scene_synthetic.exifs, scene_synthetic.features,
            scene_synthetic.tracks_manager)
    assert stats.gcp_errors(Missing(*args), [reference], device="cpu") == {}
    with pytest.raises(ValueError):
        stats.gcp_errors(Broken(*args), [reference], device="cpu")


# -- compute_all_statistics: the port against the JAX package -----------------


def _as_plain(v):
    if isinstance(v, tuple):
        return [_as_plain(x) for x in v]
    if isinstance(v, list):
        return [_as_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return [_as_plain(x) for x in v.tolist()]
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def assert_same_stats(got, want, path="", worst=None):
    """Same keys in the same order, ints / bools / strings equal, floats
    within REL_TOL (see there); returns the largest gap."""
    worst = [0.0] if worst is None else worst
    got, want = _as_plain(got), _as_plain(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            assert_same_stats(got[key], want[key], f"{path}.{key}", worst)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same_stats(g, w, f"{path}[{k}]", worst)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), path
        gap = abs(got - want) / max(abs(got), abs(want), 1.0)
        worst[0] = max(worst[0], gap if got != want else 0.0)
        assert gap <= REL_TOL or got == want, (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)
    return worst[0]


def _jax_scene_copy():
    jax_in = scenes("circle", 42)[0][1]
    return jax_in, copy.deepcopy(jax_in.reconstruction)


@pytest.mark.parametrize("with_gcps", [False, True])
def test_compute_all_statistics_equal(with_gcps):
    jax_in, jax_rec = _jax_scene_copy()
    port_in = scenes("circle", 42)[1][1]
    port_rec = copy.deepcopy(port_in.reconstruction)
    gcps = {"gcps": jax_in.gcps} if with_gcps else {}
    want = ref_stats.compute_all_statistics(
        ref_sd.SyntheticDataSet(jax_rec, jax_in.exifs, jax_in.features,
                                jax_in.tracks_manager, **gcps),
        jax_in.tracks_manager, [jax_rec])
    gcps = {"gcps": port_in.gcps} if with_gcps else {}
    got = stats.compute_all_statistics(
        sd.SyntheticDataSet(port_rec, port_in.exifs, port_in.features,
                            port_in.tracks_manager, **gcps),
        port_in.tracks_manager, [port_rec], device="cpu")
    assert_same_stats(got, want)
    rs, rs_want = got["reconstruction_statistics"], \
        want["reconstruction_statistics"]
    for key in ("reprojection_histogram_pixels",
                "reprojection_histogram_normalized"):
        counts, edges = rs[key]
        assert len(counts) == 30 and len(edges) == 31
        assert list(edges) == list(rs_want[key][1])
    assert rs["has_gcp"] is with_gcps
    assert ("ce90" in got["gcp_errors"]) is with_gcps
    assert "reprojection_histogram" not in rs


def test_compute_all_statistics_null():
    jax_in = scenes("circle", 42)[0][1]
    port_in = scenes("circle", 42)[1][1]
    want = ref_stats.compute_all_statistics(
        ref_sd.SyntheticDataSet(ref_types.Reconstruction(), jax_in.exifs,
                                jax_in.features, jax_in.tracks_manager),
        jax_in.tracks_manager, [ref_types.Reconstruction()])
    got = stats.compute_all_statistics(
        sd.SyntheticDataSet(types.Reconstruction(), port_in.exifs,
                            port_in.features, port_in.tracks_manager),
        port_in.tracks_manager, [types.Reconstruction()], device="cpu")
    assert_same_stats(got, want)
    assert got["reconstruction_statistics"][
        "reprojection_histogram_pixels"] == ([], [])
    assert got["gps_errors"] == {} and got["gcp_errors"] == {}
