"""The rest of the port's `reconstruct` stage against the JAX package on the
CPU: the merge of partial reconstructions, `triangulation_reconstruction`,
`reconstruct_from_prior` and `extend_reconstruction`.

Scenes are the JAX package's synthetic circle scenes, built as its own
tests build them (same parameters and seeds), written to a dataset
directory with the JAX package's writers; the port reads it with its
`DataSet`, the JAX package with its own.  Each case runs both packages on
the same inputs with the JAX package's random draws injected into the
port (`jax_draws`: the similarity and absolute-pose RANSAC samples, as
tests/test_torch_multiview.py injects them, and the robust triangulation's
slot pairs from the global NumPy generator, as
tests/test_torch_reconstruction.py does), then holds the port to the
reference: the same shots, camera centres within CENTRE_TOL of the
reference's after the similarity that best maps one set onto the other,
and the JAX tests' own bounds against the truth for both.

- the seeded merge (fewer than 10 similarity inliers: a thin bridge of 12
  common points, 8 scattered metres off, the second part displaced 1.5 m)
  of tests/test_reconstruction_incremental.py:167-236, split from the
  port's own incremental reconstruction of the seed-0 scene, as the JAX
  test splits its own: one reconstruction of every shot, aligned position
  RMS < 0.05 and rotation RMS < 0.005;
- the direct merge (>= 10 inliers) of two overlapping partials of that
  reconstruction, the second moved by a similarity: the same bounds;
- `triangulation_reconstruction` on tests/test_reconstruction_triangulation
  .py's scene (seed 42, GPS noise 0.1): that test's bounds;
- `reconstruct_from_prior` and `extend_reconstruction` through the port's
  commands and the JAX package's actions on a 6-image chain, graded
  against the generator's truth.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import synthetic_bundle as sb
from opensfm_tpu import geo as ref_geo
from opensfm_tpu import io as ref_io
from opensfm_tpu import reconstruction as ref_rec
from opensfm_tpu.actions import extend_reconstruction as ref_extend
from opensfm_tpu.actions import reconstruct_from_prior as ref_prior
from opensfm_tpu.align import apply_similarity as ref_apply_similarity
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.synthetic_data import synthetic_examples, synthetic_scene
from opensfm_tpu_torch import io, multiview, reconstruction
from opensfm_tpu_torch.align import apply_similarity
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.robust import ransac
from test_torch_multiview import jax_samples

# Port against reference, camera centres after a similarity fit (metres).
# Under the same draws the two packages differ only by rounding: measured
# 7.0e-13 (seeded merge), 2.3e-13 (direct), 3.6e-13 (triangulation),
# 1.4e-14 (prior) and 5.0e-9 (extend, whose growth loop runs more bundles,
# each stopping on a relative cost drop of 1e-10).
CENTRE_TOL = 1e-6
# opensfm_tpu/robust/ransac.py ransac_absolute_pose_batched's cap on
# candidates x padded rows x hypotheses of one chunk.
JAX_BATCH_CAP = 4 << 20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batched_layout(sizes, iterations):
    """The JAX package's (padded rows, hypotheses per chunk) of a batched
    absolute-pose run over candidates of `sizes` rows."""
    runnable = [s for s in sizes if s >= 3]
    n_pad = max(64, 1 << int(max(runnable) - 1).bit_length())
    k = int(max(iterations, 64))
    return n_pad, int(min(k, max(64, JAX_BATCH_CAP
                                 // max(len(runnable) * n_pad, 1))))


def _jax_robust_pairs(tracks, tracks_manager, rec):
    """The JAX package's robust-triangulation slot pairs: uniform numbers
    from the global NumPy generator over its padded [n_pad, tries, 2]
    (n_pad >= 512, a power of two), one row per track with >= 2
    reconstructed views (opensfm_tpu/reconstruction.py:633-638)."""
    lens = []
    for t in tracks:
        n = sum(1 for s in tracks_manager.get_track_observations(t)
                if s in rec.shots)
        if n >= 2:
            lens.append(n)
    if not lens:
        return None
    n = len(lens)
    n_pad = max(1 << int(n - 1).bit_length(), 512)
    u = np.random.random((n_pad, reconstruction.ROBUST_TRIES, 2))[:n]
    col = np.maximum(np.array(lens), 2)[:, None]
    i = np.floor(u[..., 0] * col).astype(np.int64)
    j = np.floor(u[..., 1] * (col - 1)).astype(np.int64)
    return np.stack([i, np.where(j >= i, j + 1, j)], axis=-1)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's similarity RANSAC, absolute-pose RANSAC (single and
    batched) and robust triangulation take the JAX package's draws (its
    seed 42 and layouts); the caller seeds NumPy's global generator alike
    before each package's run."""
    similarity = multiview.fit_similarity_transform
    single = multiview.absolute_pose_ransac
    batched = multiview.absolute_pose_ransac_batched
    triangulate = reconstruction.triangulate_tracks

    def fit_similarity_transform(p1, p2, max_iterations=1000, threshold=1,
                                 device=None, samples=None):
        return similarity(p1, p2, max_iterations, threshold, device=device,
                          samples=jax_samples(len(p1), max_iterations, 3))

    def absolute_pose_ransac(bs, Xs, threshold, iterations,
                             probability=0.999, device=None, samples=None):
        return single(bs, Xs, threshold, iterations, probability,
                      device=device,
                      samples=jax_samples(len(bs), iterations, 3))

    def absolute_pose_ransac_batched(bs_list, Xs_list, threshold,
                                     iterations, probability=0.999,
                                     device=None, samples=None):
        sizes = [len(b) for b in bs_list]
        if max(sizes, default=0) < 3:
            return batched(bs_list, Xs_list, threshold, iterations,
                           probability, device=device)
        n_pad, k_chunk = _batched_layout(sizes, iterations)
        k = int(max(iterations, 64))
        rows = -(-k // k_chunk) * k_chunk
        draws = np.stack([
            jax_samples(s, iterations, 3, n_pad=n_pad, k_chunk=k_chunk)
            if s >= 3 else np.zeros((rows, 3), np.int64) for s in sizes])
        chunk = ransac.CHUNK
        ransac.CHUNK = k_chunk  # the port's chunks laid out as JAX's
        try:
            return batched(bs_list, Xs_list, threshold, iterations,
                           probability, device=device, samples=draws)
        finally:
            ransac.CHUNK = chunk

    def triangulate_tracks(tracks, tracks_manager, rec, config, device=None,
                           pairs=None):
        if pairs is None and str(config.get(
                "triangulation_type", "FULL")).upper() == "ROBUST":
            pairs = _jax_robust_pairs(tracks, tracks_manager, rec)
        return triangulate(tracks, tracks_manager, rec, config,
                           device=device, pairs=pairs)

    monkeypatch.setattr(multiview, "fit_similarity_transform",
                        fit_similarity_transform)
    monkeypatch.setattr(multiview, "absolute_pose_ransac",
                        absolute_pose_ransac)
    monkeypatch.setattr(multiview, "absolute_pose_ransac_batched",
                        absolute_pose_ransac_batched)
    monkeypatch.setattr(reconstruction, "triangulate_tracks",
                        triangulate_tracks)


def _circle_scene(seed, gps_noise, imu_noise, gcp_noise):
    np.random.seed(seed)
    reference = ref_geo.TopocentricConverter(47.0, 6.0, 0)
    gt = synthetic_examples.synthetic_circle_scene(reference)
    return synthetic_scene.SyntheticInputData(
        gt.get_reconstruction(), reference, 40, 1.0, gps_noise, imu_noise,
        gcp_noise, False, 10, [10.0, 0.0, 100.0],
    )


def _write_scene(path, scene):
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
    return DataSet(path), RefDataSet(path)


def _centre_gap(ours, ref):
    """Same shots; RMS of the port's camera centres against the
    reference's after the similarity that best maps them onto them."""
    assert set(ours.shots) == set(ref.shots)
    ids = sorted(ref.shots)
    a = np.array([ours.shots[s].pose.get_origin() for s in ids])
    b = np.array([ref.shots[s].pose.get_origin() for s in ids])
    ma, mb = a.mean(0), b.mean(0)
    U, S, Vt = np.linalg.svd((b - mb).T @ (a - ma))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.sum((a - ma) ** 2)
    d = s * (a - ma) @ R.T + mb - b
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


@pytest.fixture(scope="module")
def scene0(tmp_path_factory):
    """The seed-0 circle scene of test_seeded_merge_two_partials and the
    port's own incremental reconstruction of it (the JAX test splits its
    own reconstruction of the scene)."""
    scene = _circle_scene(0, 5.0, 0.1, (0.01, 0.1))
    data, ref_data = _write_scene(
        str(tmp_path_factory.mktemp("merge") / "d"), scene)
    _, recs = reconstruction.incremental_reconstruction(
        data, data.load_tracks_manager(), device="cpu")
    assert len(recs) == 1 and len(recs[0].shots) == 20
    return scene, data, ref_data, io.reconstruction_to_json(recs[0])


def _both_splits(scene0, displace):
    """The port's reconstruction split into two overlapping partials, the
    shots [0, 2n/3) and [n/2, n), as port and as reference maps, the
    second displaced by `displace(rec, apply_similarity)` in each."""
    _, data, ref_data, rec_json = scene0
    out = []
    for codec, ds, apply in ((io, data, apply_similarity),
                             (ref_io, ref_data, ref_apply_similarity)):
        rec = codec.reconstruction_from_json(rec_json)
        rec.reference = ds.load_reference()
        shots = sorted(rec.shots)
        n = len(shots)
        r1, r2 = copy.deepcopy(rec), copy.deepcopy(rec)
        for s in shots:
            if s not in shots[: n * 2 // 3]:
                r1.remove_shot(s)
            if s not in shots[n // 2:]:
                r2.remove_shot(s)
        displace(r2, apply)
        out.append((r1, r2))
    return shots, out


def _assert_reunited(scene, merged, shots):
    assert len(merged) == 1, "the merge failed to unite the partials"
    r = merged[0]
    assert set(r.shots) == set(shots)
    errors = synthetic_scene.compare(scene.reconstruction, {},
                                     copy.deepcopy(r))
    assert 0 < errors["aligned_position_rmse"] < 0.05
    assert 0 < errors["aligned_rotation_rmse"] < 0.005


def test_seeded_merge_two_partials(scene0, jax_draws):
    """The JAX test's thin bridge, through both packages' seeded merge."""
    scene, data, ref_data, _ = scene0

    def thin_bridge(r2, apply):
        rng = np.random.default_rng(7)
        apply(r2, 1.0, np.eye(3), np.array([1.5, -0.9, 0.6]))
        pids = sorted(r2.points)
        keep = set(pids[:: max(1, len(pids) // 12)][:12])
        for pid in pids:
            if pid not in keep:
                r2.remove_point(pid)
        for i, pid in enumerate(sorted(keep)):
            if i % 3 != 0:  # 8 of 12 scattered, 4 clean
                r2.points[pid].coordinates = (
                    np.asarray(r2.points[pid].coordinates)
                    + rng.normal(0.0, 3.0, 3))

    shots, ((r1, r2), (q1, q2)) = _both_splits(scene0, thin_bridge)
    np.random.seed(0)
    merged = reconstruction.merge_two_reconstructions(
        r1, r2, data.config, tracks_manager=data.load_tracks_manager(),
        data=data, device="cpu")
    np.random.seed(0)
    ref = ref_rec.merge_two_reconstructions(
        q1, q2, ref_data.config,
        tracks_manager=ref_data.load_tracks_manager(), data=ref_data)
    _assert_reunited(scene, merged, shots)
    _assert_reunited(scene, ref, shots)
    assert merged[0].merge_settle_moved < 5e-3
    assert _centre_gap(merged[0], ref[0]) < CENTRE_TOL


def test_direct_merge_two_partials(scene0, jax_draws):
    """Overlapping partials sharing hundreds of clean points, the second
    moved by a similarity: the >= 10-inlier direct merge in both."""
    scene, data, ref_data, _ = scene0
    c, s = np.cos(0.3), np.sin(0.3)

    def move(r2, apply):
        apply(r2, 1.7, np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]),
              np.array([4.0, -2.0, 1.0]))

    shots, ((r1, r2), (q1, q2)) = _both_splits(scene0, move)
    assert len(set(r1.points) & set(r2.points)) > 100
    merged = reconstruction.merge_two_reconstructions(
        r1, r2, data.config, device="cpu")
    ref = ref_rec.merge_two_reconstructions(q1, q2, ref_data.config)
    _assert_reunited(scene, merged, shots)
    _assert_reunited(scene, ref, shots)
    assert not hasattr(merged[0], "merge_settle_moved")
    assert _centre_gap(merged[0], ref[0]) < CENTRE_TOL


def test_reconstruction_triangulation(tmp_path, jax_draws):
    """tests/test_reconstruction_triangulation.py's scene and bounds, both
    packages on one dataset."""
    scene = _circle_scene(42, 0.1, 1.0, (0.0, 0.0))
    data, ref_data = _write_scene(str(tmp_path / "tri"), scene)
    np.random.seed(0)
    report, recs = reconstruction.triangulation_reconstruction(
        data, data.load_tracks_manager(), device="cpu")
    np.random.seed(0)
    _, ref = ref_rec.triangulation_reconstruction(
        ref_data, ref_data.load_tracks_manager())
    assert report["device"] == "cpu"
    assert len(recs) == len(ref) == 1
    assert _centre_gap(recs[0], ref[0]) < CENTRE_TOL
    assert set(recs[0].points) == set(ref[0].points)
    for rec in (recs[0], ref[0]):
        errors = synthetic_scene.compare(scene.reconstruction, scene.gcps,
                                         copy.deepcopy(rec))
        assert rec.reference.lat == 47.0
        assert rec.reference.lon == 6.0
        assert errors["ratio_cameras"] == 1.0
        assert 0.7 < errors["ratio_points"] <= 1.0
        assert 0 < errors["aligned_position_rmse"] < 0.045
        assert 0 < errors["aligned_rotation_rmse"] < 0.006
        assert 0 < errors["aligned_points_rmse"] < 0.12
        assert 0.01 < errors["absolute_gps_rmse"] < 0.1
        assert 0.001 < errors["absolute_gcp_rmse_horizontal"] < 0.05
        assert 0.001 < errors["absolute_gcp_rmse_vertical"] < 0.04
        translation = rec.biases["1"].translation
        assert 9.8 < translation[0] < 10.2
        assert 99.8 < translation[2] < 100.2


N_SHOTS, N_POINTS = 6, 400


def _write_matches(path, feature_points):
    """Matches of every image pair from the truth."""
    data = DataSet(path)
    images = data.images()
    for a, im1 in enumerate(images):
        matches = {}
        for im2 in images[a + 1:]:
            p1, p2 = feature_points[im1], feature_points[im2]
            f2_of = {int(p): f for f, p in enumerate(p2) if p >= 0}
            m = np.array([(f1, f2_of[int(p)]) for f1, p in enumerate(p1)
                          if p >= 0 and int(p) in f2_of], dtype=np.int64)
            if len(m):
                matches[im2] = m
        data.save_matches(im1, matches)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A 6-image dataset with truth matches, its tracks and the port's
    reconstruction."""
    root = tmp_path_factory.mktemp("prior")
    path = str(root / "data")
    feature_points = sb.write_matching_dataset(
        path, n_shots=N_SHOTS, n_points=N_POINTS, track_window=3,
        features_per_image=N_POINTS, seed=11)
    _write_matches(path, feature_points)
    for argv in (["create_tracks", path, "--device", "cpu"],
                 ["reconstruct", path, "--device", "cpu"]):
        command_runner(opensfm_commands, argv=argv)
    return root, path, feature_points


def _copies(chain, name):
    """Two copies of the chain's dataset: the port's and the reference's."""
    root, path, _ = chain
    out = []
    for who in ("ours", "ref"):
        dst = str(root / f"{name}_{who}")
        shutil.copytree(path, dst)
        out.append(dst)
    return out


def _grade(path, filename, feature_points):
    data = DataSet(path)
    recs = data.load_reconstruction(filename)
    shots, points = sb.matching_scene(N_SHOTS, N_POINTS, seed=11)
    return sb.grade_reconstruction(recs, data.load_tracks_manager(),
                                   feature_points, shots, points)


def test_reconstruct_from_prior_command(chain, jax_draws):
    feature_points = chain[2]
    ours, theirs = _copies(chain, "prior")
    np.random.seed(0)
    report = command_runner(opensfm_commands, argv=[
        "reconstruct_from_prior", ours, "--device", "cpu"])
    np.random.seed(0)
    ref_prior.run_dataset(RefDataSet(theirs))
    assert report["device"] == "cpu"
    for path in (ours, theirs):
        grade = _grade(path, "reconstruction.prior.json", feature_points)
        assert grade["shots"] == N_SHOTS and grade["reconstructions"] == 1
        assert grade["centre_rms"] < 0.01
        assert grade["point_rms"] < 0.03
        assert grade["reprojection_rms"] < 2 * sb.NOISE
    a = DataSet(ours).load_reconstruction("reconstruction.prior.json")[0]
    b = RefDataSet(theirs).load_reconstruction("reconstruction.prior.json")[0]
    assert _centre_gap(a, b) < CENTRE_TOL
    assert set(a.points) == set(b.points)


def test_extend_reconstruction_command(chain, jax_draws):
    """Two shots removed from the reconstruction come back, in both."""
    feature_points = chain[2]
    ours, theirs = _copies(chain, "extend")
    data = DataSet(ours)
    rec = data.load_reconstruction()[0]
    for shot in sorted(rec.shots)[-2:]:
        rec.remove_shot(shot)
    for path in (ours, theirs):
        DataSet(path).save_reconstruction([rec], "partial.json")
    np.random.seed(0)
    report = command_runner(opensfm_commands, argv=[
        "extend_reconstruction", ours, "--input", "partial.json",
        "--output", "extended.json", "--device", "cpu"])
    np.random.seed(0)
    ref_extend.run_dataset(RefDataSet(theirs), "partial.json",
                           "extended.json")
    assert report["device"] == "cpu" and len(report["steps"]) >= 1
    for path in (ours, theirs):
        grade = _grade(path, "extended.json", feature_points)
        assert grade["shots"] == N_SHOTS and grade["reconstructions"] == 1
        assert grade["centre_rms"] < 0.01
        assert grade["point_rms"] < 0.03
    a = DataSet(ours).load_reconstruction("extended.json")[0]
    b = RefDataSet(theirs).load_reconstruction("extended.json")[0]
    assert _centre_gap(a, b) < CENTRE_TOL
