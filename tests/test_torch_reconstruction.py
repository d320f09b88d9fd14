"""The port's growth-loop pieces and the incremental reconstruction against
the JAX package on the CPU.

Pieces, on one synthetic map loaded by both packages: `triangulate_tracks`
(FULL, and ROBUST with the JAX package's slot pairs injected), the
neighbourhood of a shot, `bundle_shot_poses`, `bundle_local`, and
`align_reconstruction` (naive, orientation prior, GPS bias).  Tolerances:
1e-9 relative for triangulation and alignment (f64, closed form or a fixed
number of Gauss-Newton steps); 1e-6 absolute for the bundles, as the
`bundle` command's parity test (the LM stops on a relative cost drop of
1e-10, so the states agree to about the square root of that).

The slice as a whole: the port's `incremental_reconstruction` on the JAX
package's synthetic circle scene at seed 42, written to a dataset directory
with the JAX package's writers and read back by the port's `DataSet`, meets
the strict bounds of tests/test_reconstruction_incremental.py:56-83, GPS
bias included (the JAX package is not re-run here)."""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

import synthetic_bundle as sb
from opensfm_tpu import align as ref_align
from opensfm_tpu import geo as ref_geo
from opensfm_tpu import io as ref_io
from opensfm_tpu import reconstruction as ref_rec
from opensfm_tpu.ba import problem as ref_problem
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.synthetic_data import synthetic_examples, synthetic_scene
from opensfm_tpu_torch import align, geo, reconstruction
from opensfm_tpu_torch.ba import problem
from opensfm_tpu_torch.dataset import DataSet

REL = 1e-9
ATOL_BUNDLE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes at once, and multi-threaded small ops then
    wait on each other's cores (tens of times slower); one thread is within
    2x of eight when the module runs alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def map_path(tmp_path_factory):
    """A 10-shot circle map (300 points, tracks of 4, poses and points
    perturbed), 40 of its observations moved far off, a reference frame, and
    GCPs (3 with positions shifted off the GPS frame, seen from 3 shots)."""
    path = str(tmp_path_factory.mktemp("map") / "data")
    prob = sb.make_problem(10, 300, seed=2, track_window=4)
    rng = np.random.default_rng(9)
    bad = rng.choice(len(prob.obs_uv), 40, replace=False)
    prob.obs_uv[bad] += rng.normal(0, 0.05, (40, 2))
    sb.write_dataset(path, prob, {"bundle_distributed": "no"})
    with open(os.path.join(path, "reference_lla.json"), "w") as f:
        json.dump({"latitude": 47.0, "longitude": 6.0, "altitude": 0.0}, f)
    reference = geo.TopocentricConverter(47.0, 6.0, 0.0)
    points = []
    for k in range(3):
        pid = 7 + 11 * k
        obs = [o for o in np.flatnonzero(prob.obs_point == pid)][:3]
        lat, lon, alt = reference.to_lla(
            *(prob.points[pid] + [0.3, -0.2, 1.5]))
        points.append({
            "id": f"g{k}",
            "position": {"latitude": lat, "longitude": lon, "altitude": alt},
            "observations": [
                {"shot_id": sb.shot_id(int(prob.obs_inst[o])),
                 "projection": list(prob.obs_uv[o])} for o in obs],
        })
    with open(os.path.join(path, "ground_control_points.json"), "w") as f:
        json.dump({"points": points}, f)
    return path


def _load(path, ours: bool):
    """(data, reconstruction with its observations, tracks manager) of the
    map in one package."""
    data = DataSet(path) if ours else RefDataSet(path)
    rec = data.load_reconstruction()[0]
    rec.reference = (geo if ours else ref_geo).TopocentricConverter(
        47.0, 6.0, 0.0)
    tm = data.load_tracks_manager()
    rec.add_correspondences_from_tracks_manager(tm)
    for shot in rec.shots.values():
        shot.metadata.orientation.value = 1
    return data, rec, tm


def _assert_same_map(ours, ref, atol=None, tol=REL):
    assert set(ours.shots) == set(ref.shots)
    assert set(ours.points) == set(ref.points)
    for k, s in ref.shots.items():
        for a, b in ((ours.shots[k].pose.rotation, s.pose.rotation),
                     (ours.shots[k].pose.translation, s.pose.translation)):
            if atol is None:
                assert rel(a, b) < tol
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    for k, p in ref.points.items():
        if atol is None:
            assert rel(ours.points[k].coordinates, p.coordinates) < tol
        else:
            np.testing.assert_allclose(ours.points[k].coordinates,
                                       p.coordinates, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["FULL", "ROBUST"])
def test_triangulate_tracks_matches_reference(map_path, mode):
    data, rec, tm = _load(map_path, ours=True)
    ref_data, ref, ref_tm = _load(map_path, ours=False)
    # A threshold above the poses' perturbation (0.01 rad), below the moved
    # observations' offsets.
    config = dict(data.config, triangulation_type=mode,
                  triangulation_threshold=0.03)
    tracks = sorted(rec.points)
    for r in (rec, ref):
        r.points = {}
    np.random.seed(3)
    ref_rec.triangulate_tracks(tracks, ref_tm, ref, config)
    pairs = None
    if mode == "ROBUST":
        # The JAX package's draws: uniform numbers from the global NumPy
        # RNG over its padded [n_pad, 11, 2] (n_pad >= 512, a power of
        # two), mapped to slot pairs by its formula; rows of the kept
        # tracks (every track here has >= 2 reconstructed views).
        np.random.seed(3)
        n = len(tracks)
        lens = np.array([len(tm.get_track_observations(t)) for t in tracks])
        n_pad = max(1 << int(n - 1).bit_length(), 512)
        u = np.random.random((n_pad, reconstruction.ROBUST_TRIES, 2))[:n]
        i = np.floor(u[..., 0] * lens[:, None]).astype(np.int64)
        j = np.floor(u[..., 1] * (lens[:, None] - 1)).astype(np.int64)
        pairs = np.stack([i, np.where(j >= i, j + 1, j)], axis=-1)
    size = reconstruction.triangulate_tracks(
        tracks, tm, rec, config, device="cpu", pairs=pairs)
    assert size["tracks"] == len(tracks) and size["rays"] == 4
    assert size["points"] == len(ref.points) > 200
    _assert_same_map(rec, ref)
    for k, p in ref.points.items():
        assert set(rec.points[k].get_observations()) == \
            set(p.get_observations())
    if mode == "ROBUST":
        # The moved observations were left out of some points.
        n_obs = sum(p.number_of_observations() for p in rec.points.values())
        assert n_obs < 4 * len(rec.points)


def test_robust_pairs_are_distinct_slots():
    lens = np.array([2, 3, 8, 5])
    pairs = reconstruction.robust_pairs(lens)
    assert pairs.shape == (4, reconstruction.ROBUST_TRIES, 2)
    assert np.all(pairs[..., 0] != pairs[..., 1])
    assert np.all(pairs < lens[:, None, None]) and np.all(pairs >= 0)
    assert np.array_equal(pairs, reconstruction.robust_pairs(lens))


def test_shot_neighborhood_matches_reference(map_path):
    _, rec, _ = _load(map_path, ours=True)
    _, ref, _ = _load(map_path, ours=False)
    for central in (sb.shot_id(0), sb.shot_id(5)):
        for radius, min_common, max_shots in ((3, 20, 30), (2, 50, 3)):
            assert problem.shot_neighborhood(
                rec, central, radius, min_common, max_shots) == \
                ref_problem.shot_neighborhood(
                    ref, central, radius, min_common, max_shots)


def test_bundle_shot_poses_matches_reference(map_path):
    data, rec, _ = _load(map_path, ours=True)
    ref_data, ref, _ = _load(map_path, ours=False)
    shots = {sb.shot_id(2), sb.shot_id(3)}
    report = problem.bundle_shot_poses(
        rec, shots, data.load_camera_models(), {}, data.config, device="cpu")
    ref_report = ref_problem.bundle_shot_poses(
        ref, shots, ref_data.load_camera_models(), {}, ref_data.config)
    assert report["final_cost"] < report["initial_cost"]
    assert report["final_cost"] == pytest.approx(ref_report["final_cost"],
                                                 rel=1e-6)
    assert report["route"] in ("canonical", "dense", "fused_dense")
    _assert_same_map(rec, ref, atol=ATOL_BUNDLE)


def test_bundle_local_matches_reference(map_path):
    data, rec, _ = _load(map_path, ours=True)
    ref_data, ref, _ = _load(map_path, ours=False)
    config = dict(data.config, local_bundle_radius=2)
    report, shots = problem.bundle_local(
        rec, data.load_camera_models(), {}, sb.shot_id(4), None, config,
        device="cpu")
    ref_report, ref_shots = ref_problem.bundle_local(
        ref, ref_data.load_camera_models(), {}, sb.shot_id(4), None,
        dict(ref_data.config, local_bundle_radius=2))
    assert shots == ref_shots
    assert report["final_cost"] == pytest.approx(ref_report["final_cost"],
                                                 rel=1e-6)
    _assert_same_map(rec, ref, atol=ATOL_BUNDLE)


@pytest.mark.parametrize("method", ["naive", "orientation_prior", "gps_bias"])
def test_align_reconstruction_matches_reference(map_path, method):
    data, rec, _ = _load(map_path, ours=True)
    ref_data, ref, _ = _load(map_path, ours=False)
    # Move both maps off their GPS frame first.
    for r, mod in ((rec, align), (ref, ref_align)):
        mod.apply_similarity(r, 1.3, np.eye(3), np.array([2.0, -1.0, 0.5]))
    config = dict(data.config)
    kw = {}
    gcp, ref_gcp = [], []
    if method == "gps_bias":
        config["bundle_compensate_gps_bias"] = True
        kw["bias_override"] = True
        gcp = data.load_ground_control_points()
        ref_gcp = ref_data.load_ground_control_points()
        assert len(gcp) == 3
    else:
        config["align_method"] = method
    res = align.align_reconstruction(rec, gcp, config, device="cpu", **kw)
    ref_res = ref_align.align_reconstruction(ref, ref_gcp, config, **kw)
    assert res is not None and ref_res is not None
    for a, b in zip(res, ref_res):
        assert rel(a, b) < REL
    _assert_same_map(rec, ref)
    if method == "gps_bias":
        cam = next(iter(rec.cameras))
        bias, ref_bias = rec.biases[cam], ref.biases[cam]
        assert rel(bias.translation, ref_bias.translation) < REL
        assert rel(bias.rotation, ref_bias.rotation) < REL
        assert bias.scale == pytest.approx(ref_bias.scale, rel=REL)


def test_circle_scene_meets_the_strict_bounds(tmp_path):
    """The JAX package's circle scene (20 shots, 5,000 points, GPS noise 5,
    GCPs with a [10, 0, 100] shift) at seed 42, as its own end-to-end test
    builds it, through the port: every strict bound of that test holds."""
    np.random.seed(42)
    reference = ref_geo.TopocentricConverter(47.0, 6.0, 0)
    gt = synthetic_examples.synthetic_circle_scene(reference)
    scene = synthetic_scene.SyntheticInputData(
        gt.get_reconstruction(), reference, 40, 1.0, 5.0, 0.1,
        (0.01, 0.1), False, 10, [10.0, 0.0, 100.0],
    )
    path = str(tmp_path / "circle")
    os.makedirs(path)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump({"bundle_compensate_gps_bias": True,
                        "bundle_use_gcp": True, "bundle_max_iterations": 20},
                       f)
    writer = RefDataSet(path)
    for shot_id, exif in scene.exifs.items():
        writer.save_exif(shot_id, exif)
    writer.save_camera_models(scene.reconstruction.cameras)
    writer.save_tracks_manager(scene.tracks_manager)
    writer.save_reference_lla({"latitude": 47.0, "longitude": 6.0,
                               "altitude": 0.0})
    with open(os.path.join(path, "ground_control_points.json"), "w") as f:
        ref_io.write_ground_control_points(list(scene.gcps.values()), f)

    data = DataSet(path)
    report, recs = reconstruction.incremental_reconstruction(
        data, data.load_tracks_manager(), device="cpu")
    assert len(recs) == 1
    errors = synthetic_scene.compare(scene.reconstruction, scene.gcps,
                                     copy.deepcopy(recs[0]))

    assert recs[0].reference.lat == 47.0
    assert recs[0].reference.lon == 6.0
    assert errors["ratio_cameras"] == 1.0
    assert 0.7 < errors["ratio_points"] < 1.0
    assert 0 < errors["aligned_position_rmse"] < 0.03
    assert 0 < errors["aligned_rotation_rmse"] < 0.003
    assert 0 < errors["aligned_points_rmse"] < 0.1
    assert 3.0 < errors["absolute_gps_rmse"] < 7.0
    assert 0.01 < errors["absolute_gcp_rmse_horizontal"] < 0.05
    assert 0.08 < errors["absolute_gcp_rmse_vertical"] < 0.18
    translation = recs[0].biases["1"].translation
    assert 9.8 < translation[0] < 10.4
    assert 99.8 < translation[2] < 100.4
    assert report["device"] == "cpu"
    assert report["not_reconstructed_images"] == []
