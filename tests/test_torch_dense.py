"""The port's dense stage against the JAX package's on the CPU.

PatchMatch (`ops.depthmap`) on the JAX test's slanted plane
(`tests/test_dense.py::make_two_view_plane`, imported) and a third view:
- `_score_candidate` on the same planes and arrays, both in float32: the
  same valid pixels; scores within 1e-5 at >= 99.9 % of them and within
  2e-5 everywhere (measured: 99.95 %, at most 1.10e-5: float32
  cancellation in the variances, rounded in another order by XLA); the
  same best neighbour at >= 99.9 % of pixels (measured: all); depths
  within 1e-6 relative at >= 99.9 % (measured: 2.3e-7 at the 99.9th
  percentile) and inverse depths within 1e-5 everywhere (measured
  3.8e-6, where a random plane's nu . r nearly vanishes);
- one `_pm_half_iteration` from the same float32 state and noise, at
  64 x 64 and at the odd 63 x 65: the plane chosen alike (nu within 1e-4
  relative) at >= SAME_PLANE_SHARE of pixels (measured: 99.71 % and
  99.58 %; the rest are near-ties a one-ulp score difference decides);
- `patch_match_depthmap` meets the JAX test's own bounds (the same call),
  and agrees with the JAX package's result (whose state x64 promotes to
  f64) within 1 % of depth at >= PM_AGREE_SHARE of the pixels both score
  above 0.7 (measured: 99.39 %; the same 80.05 % of pixels confident in
  both; median error on the plane 0.361 % against the JAX package's
  0.366 %);
- `plane_sweep_depthmap` (BRUTE_FORCE) on the same views: within 1e-4
  relative of the JAX package's depth at >= SWEEP_AGREE_SHARE of pixels
  (measured: 99.88 %, the rest one plane apart) and its median error on
  the plane below 3 % (measured: 2.03 %; the planes are 3.8 % apart at
  5 m).

The dense command on 3 rendered views of 240 x 180 with their true poses
and projected tracks, undistorted by the JAX package (module fixture;
depthmaps of 64 x 48, two consistent views, each shot having two
neighbours):
- `find_neighboring_images` and `compute_depth_range`: equal;
- `clean_depthmap`, `prune_depthmap` and `merge_depthmaps` fed the JAX
  package's raw depthmaps: equal masks, points and normals within 1e-5
  relative, the same merged cloud;
- `compute_depthmaps` through both packages: both `merged.ply` clouds
  within POINT_CLOUD_MEDIAN_M / POINT_CLOUD_P90_M of the scene's surfaces
  (`synthetic_images.grade_point_cloud`, the true poses: identity
  similarity), point counts within POINT_COUNT_SHARE of each other.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_images as si
from opensfm_tpu import dense as ref_dense
from opensfm_tpu import pymap as ref_pymap
from opensfm_tpu import types as ref_types
from opensfm_tpu.actions import compute_depthmaps as ref_compute
from opensfm_tpu.actions import undistort as ref_undistort
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.dataset import UndistortedDataSet as RefUDataSet
from opensfm_tpu.geometry.cameras import Camera as RefCamera
from opensfm_tpu.geometry.pose import Pose as RefPose
from opensfm_tpu.geometry.rotation import rotvec_to_matrix
from opensfm_tpu.ops import depthmap as ref_depthmap
from opensfm_tpu_torch import dense, io, pymap, types
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet, UndistortedDataSet
from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose
from opensfm_tpu_torch.ops import depthmap
from test_dense import make_two_view_plane

SCORE_TOL = 1e-5
SAME_PLANE_SHARE = 0.99
PM_AGREE_SHARE = 0.98
SWEEP_AGREE_SHARE = 0.99
REL_TOL = 1e-5
# The dense command's clouds at 64 x 48 (measured: 393 / 392 points,
# median 0.0408 / 0.0399 m, 90th percentile 0.325 / 0.294 m for the JAX
# package / the port); the bounds are about 1.5 to 2 times the larger.
POINT_CLOUD_MEDIAN_M = 0.08
POINT_CLOUD_P90_M = 0.5
POINT_COUNT_SHARE = 0.1
VIEWS, WIDTH, HEIGHT, RESOLUTION = 3, 240, 180, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _three_views(H=64, W=64):
    """The JAX test's two views of the slanted plane and a third one, 0.3 m
    to the other side: (rays, ref image, true depth, [(R, t)] of the three
    views, neighbour images, focal)."""
    rays, img1, z1, (R1, t1), img2, (R2, t2), f = make_two_view_plane(H, W)
    R3 = np.asarray(rotvec_to_matrix(np.array([0.0, -0.05, 0.0])))
    t3 = np.array([0.3, 0.0, 0.0])
    n, c = np.array([1.5, 0.0, -1.0]), -4.0
    o3 = -R3.T @ t3
    d3 = rays @ R3
    z3 = (c - o3 @ n) / (d3 @ n)
    X3 = o3 + d3 * z3[..., None]
    img3 = (0.5 + 0.25 * np.sin(7 * X3[..., 0])
            + 0.25 * np.cos(9 * X3[..., 1] + 3 * X3[..., 0])
            ).astype(np.float32)
    return rays, img1, z1, [(R1, t1), (R2, t2), (R3, t3)], [img2, img3], f


def _arrays(H=64, W=64):
    """The port's prepared arrays of the three-view scene and an initial
    plane field, as torch (CPU) and as jnp, all float32."""
    rays, img1, _, poses, grays, f = _three_views(H, W)
    (R1, t1), nbs = poses[0], poses[1:]
    rays_t, arrays = depthmap.prepare(
        img1, rays, R1, t1, grays, [R for R, _ in nbs], [t for _, t in nbs],
        [f, f], 7, "cpu")
    nu = depthmap.random_init(np.random.default_rng(3), rays, 2.0, 8.0)
    nu_t = torch.as_tensor(nu, dtype=torch.float32)
    to_j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    return (nu_t, rays_t, arrays), (to_j(nu_t), to_j(rays_t),
                                    tuple(to_j(a) for a in arrays))


STATICS = (2.0, 8.0, 1e-5)


def test_score_candidate_against_reference():
    (nu, _, arrays), (jnu, _, jarrays) = _arrays()
    score, nghbr, depth = depthmap._score_candidate(nu, *arrays, *STATICS)
    chunked = depthmap._score_candidate(nu, *arrays, *STATICS, chunk=1)
    for a, b in zip((score, nghbr, depth), chunked):
        assert torch.equal(a, b)  # chunking changes nothing
    rs, rn, rd = (np.asarray(x) for x in ref_depthmap._score_candidate(
        jnu, *jarrays, *STATICS))
    score, nghbr, depth = score.numpy(), nghbr.numpy(), depth.numpy()
    both = (score > -1) & (rs > -1)
    assert both.mean() > 0.3
    assert np.array_equal(score > -1, rs > -1)
    diff = np.abs(score - rs)[both]
    assert (diff <= SCORE_TOL).mean() >= 0.999 and diff.max() <= 2 * SCORE_TOL
    assert (nghbr == rn).mean() >= 0.999
    assert (np.abs(depth - rd) <= 1e-6 * np.abs(rd)).mean() >= 0.999
    assert np.abs(1.0 / depth - 1.0 / rd).max() <= 1e-5


@pytest.mark.parametrize("size", [(64, 64), (63, 65)])
def test_half_iteration_against_reference(size):
    """Odd sizes too: there the roll across a border brings a pixel of the
    same parity, which the port takes from the current state as the JAX
    package does."""
    (nu, rays, arrays), (jnu, jrays, jarrays) = _arrays(*size)
    H, W = nu.shape[:2]
    s, n, d = depthmap._score_candidate(nu, *arrays, *STATICS)
    js, jn, jd = ref_depthmap._pm_init_score(jnu, *jarrays, *STATICS)
    noise_d, noise_n = depthmap.random_refinements(
        np.random.default_rng(4), H, W)
    state = depthmap._pm_half_iteration(
        (nu, d, s, n), 1, torch.as_tensor(noise_d, dtype=torch.float32),
        torch.as_tensor(noise_n, dtype=torch.float32), rays, *arrays,
        *STATICS)
    ref_state = ref_depthmap._pm_half_iteration(
        (jnu, jd, js, jn), 1, jnp.asarray(noise_d, dtype=jnp.float32),
        jnp.asarray(noise_n, dtype=jnp.float32), jrays, *jarrays,
        min_depth=2.0, max_depth=8.0, min_patch_variance=1e-5)
    nu1, ref_nu1 = state[0].numpy(), np.asarray(ref_state[0])
    changed = np.any(ref_nu1 != np.asarray(jnu), axis=-1)
    assert changed.mean() > 0.3  # half the pixels, most of them improved
    alike = np.all(np.abs(nu1 - ref_nu1) <= 1e-4 * np.abs(ref_nu1), axis=-1)
    assert alike.mean() >= SAME_PLANE_SHARE


@pytest.fixture(scope="module")
def slanted_plane():
    rays, img1, z1, (R1, t1), img2, (R2, t2), f = make_two_view_plane()
    kw = dict(min_depth=2.0, max_depth=8.0, iterations=4, patch_size=7,
              seed=1)
    port = depthmap.patch_match_depthmap(img1, rays, R1, t1, [img2], [R2],
                                         [t2], [f], device="cpu", **kw)
    ref = ref_depthmap.patch_match_depthmap(img1, rays, R1, t1, [img2], [R2],
                                            [t2], [f], **kw)
    return rays, z1, port, [np.asarray(x) for x in ref]


def test_patch_match_slanted_plane_against_reference(slanted_plane):
    rays, z1, (depth, nu, score, nghbr), ref = slanted_plane
    # tests/test_dense.py's bounds on the same call.
    inner = np.s_[6:-6, 6:-6]
    good = score[inner] > 0.7
    assert good.mean() > 0.7
    rel_err = np.abs(depth[inner] - z1[inner]) / z1[inner]
    assert np.median(rel_err[good]) < 0.01
    assert (rel_err[good] < 0.05).mean() > 0.8
    assert np.all(nghbr == 0)
    conf = score > 0.7
    inv_z = np.einsum("hwc,hwc->hw", rays, nu)
    assert np.allclose(1.0 / depth[conf], inv_z[conf], rtol=1e-4)
    # Against the JAX package's result.
    both = conf & (ref[2] > 0.7)
    assert both.mean() > 0.6
    agree = np.abs(depth - ref[0]) <= 0.01 * np.abs(ref[0])
    assert agree[both].mean() >= PM_AGREE_SHARE


def test_patch_match_low_variance_masked():
    rays, img1, z1, (R1, t1), img2, (R2, t2), f = make_two_view_plane()
    depth, _, score, _ = depthmap.patch_match_depthmap(
        np.full_like(img1, 0.5), rays, R1, t1, [img2], [R2], [t2], [f],
        min_depth=2.0, max_depth=8.0, iterations=1, device="cpu")
    assert np.all(depth == 0.0) and np.all(score == -1.0)


def _plane_shots():
    """The slanted plane's two views as shots of both packages."""
    rays, img1, z1, (R1, t1), img2, (R2, t2), f = make_two_view_plane()
    out = []
    for C, T, P in ((Camera, types, Pose), (RefCamera, ref_types, RefPose)):
        cam = C.create_perspective(f, 0.0, 0.0)
        cam.id, cam.width, cam.height = "c", 64, 64
        rec = T.Reconstruction()
        rec.add_camera(cam)
        shots = []
        for i, (R, t) in enumerate(((R1, t1), (R2, t2))):
            pose = P()
            pose.set_rotation_matrix(R)
            pose.translation = t
            shots.append(rec.create_shot(f"s{i}", "c", pose))
        out.append(shots)
    return img1, img2, z1, out


def test_plane_sweep_against_reference():
    img1, img2, z1, (shots, ref_shots) = _plane_shots()
    depth, score, nghbr = dense.plane_sweep_depthmap(
        img1, shots[0], [img2], [shots[1]], 2.0, 8.0, device="cpu")
    rd, rs, rn = ref_dense.plane_sweep_depthmap(
        img1, ref_shots[0], [img2], [ref_shots[1]], 2.0, 8.0)
    agree = np.abs(depth - rd) <= 1e-4 * rd
    assert agree.mean() >= SWEEP_AGREE_SHARE
    assert np.array_equal(nghbr, rn)
    good = (score > 0.5)[6:-6, 6:-6]
    rel = (np.abs(depth - z1) / z1)[6:-6, 6:-6]
    assert good.mean() > 0.7 and np.median(rel[good]) < 0.03


@pytest.fixture(scope="module")
def dense_views(tmp_path_factory):
    """VIEWS rendered views with their true reconstruction and tracks,
    undistorted by the JAX package, then `compute_depthmaps` through the
    JAX package's action and the port's command on two copies."""
    root = tmp_path_factory.mktemp("dense")
    path, port = str(root / "ref"), str(root / "port")
    si.write_image_dataset(path, VIEWS, WIDTH, HEIGHT, seed=0,
                           step_deg=10.0,
                           config={"depthmap_resolution": RESOLUTION,
                                   "depthmap_min_consistent_views": 2})
    si.write_true_reconstruction(path, VIEWS, WIDTH, HEIGHT, step_deg=10.0,
                                 n_points=400)
    ref_undistort.run_dataset(RefDataSet(path))
    shutil.copytree(path, port)
    ref_compute.run_dataset(RefDataSet(path))
    report = command_runner(opensfm_commands,
                            argv=["compute_depthmaps", port, "--device",
                                  "cpu"])
    return path, port, report


def _udata(path, ref=False):
    if ref:
        return RefUDataSet(RefDataSet(path), os.path.join(path,
                                                          "undistorted"))
    return UndistortedDataSet(DataSet(path), os.path.join(path,
                                                          "undistorted"))


def test_neighbours_and_depth_range_exact(dense_views):
    path, _, report = dense_views
    udata, ref_udata = _udata(path), _udata(path, ref=True)
    (rec,) = udata.load_undistorted_reconstruction()
    (ref_rec,) = ref_udata.load_undistorted_reconstruction()
    common = dense.common_tracks_double_dict(
        udata.load_undistorted_tracks_manager())
    ref_common = ref_dense.common_tracks_double_dict(
        ref_udata.load_undistorted_tracks_manager())
    assert common == ref_common
    for sid, shot in rec.shots.items():
        ns = dense.find_neighboring_images(shot, common, rec, 10)
        assert ns == ref_dense.find_neighboring_images(
            ref_rec.shots[sid], ref_common, ref_rec, 10)
        assert len(ns) == VIEWS and report["neighbors"][sid] == ns[1:]
        assert dense.compute_depth_range(rec, shot, udata.config) == \
            ref_dense.compute_depth_range(ref_rec, ref_rec.shots[sid],
                                          ref_udata.config)
    p, q, r = (np.array(x) for x in ([0.1, 0.2, 0.3], [1.0, -2.0, 0.5],
                                     [-0.4, 0.9, 2.0]))
    assert dense.angle_between_points(p, q, r) == \
        ref_dense.angle_between_points(p, q, r)


def test_clean_prune_merge_on_reference_raw(dense_views, tmp_path):
    path, _, _ = dense_views
    ref_udata = _udata(path, ref=True)
    fresh = str(tmp_path / "fresh")
    shutil.copytree(path, fresh, ignore=shutil.ignore_patterns(
        "*.clean.npz", "*.pruned.npz", "merged.ply"))
    udata = _udata(fresh)
    (rec,) = udata.load_undistorted_reconstruction()
    shot_ids = sorted(rec.shots)
    for sid in shot_ids:
        nbrs = list(udata.load_raw_depthmap(sid)[4])
        dense.clean_depthmap(udata, rec, nbrs, sid, "cpu")
        clean, ref_clean = (u.load_clean_depthmap(sid)[0]
                            for u in (udata, ref_udata))
        assert (clean > 0).mean() > 0.1
        assert np.array_equal(clean > 0, ref_clean > 0)
        assert np.array_equal(clean, ref_clean)
    for sid in shot_ids:
        dense.prune_depthmap(udata, rec, [], sid, "cpu")
        port, ref = (u.load_pruned_depthmap(sid) for u in (udata, ref_udata))
        assert len(port[0]) == len(ref[0]) > 100
        for a, b in zip(port[:2], ref[:2]):  # points, normals
            assert np.all(np.abs(a - b) <= REL_TOL * np.maximum(
                np.abs(b), 1.0))
        assert np.array_equal(port[2], ref[2])  # colours
        assert np.array_equal(port[3], ref[3])  # labels
    assert dense.merge_depthmaps(udata, rec) == sum(
        len(ref_udata.load_pruned_depthmap(s)[0]) for s in shot_ids)
    with open(udata.point_cloud_file()) as f, \
            open(ref_udata.point_cloud_file()) as g:
        assert f.read() == g.read()


def test_compute_depthmaps_command_against_reference(dense_views):
    path, port, report = dense_views
    assert report["shots"] == VIEWS
    assert set(report["raw_s_per_shot"]) == set(report["neighbors"])
    truth = {"scale": 1.0, "rotation": np.eye(3).tolist(),
             "translation": [0.0, 0.0, 0.0]}
    grades = []
    for p in (path, port):
        with open(_udata(p).point_cloud_file()) as f:
            points = io.point_cloud_from_ply(f)[0]
        grades.append(si.grade_point_cloud(points, truth))
    for g in grades:
        assert g["points"] > 200
        assert g["median_m"] <= POINT_CLOUD_MEDIAN_M
        assert g["p90_m"] <= POINT_CLOUD_P90_M
    assert report["merged_points"] == grades[1]["points"]
    assert abs(grades[0]["points"] - grades[1]["points"]) <= \
        POINT_COUNT_SHARE * grades[0]["points"]
