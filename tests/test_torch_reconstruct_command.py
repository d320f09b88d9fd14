"""The `reconstruct` command end to end on a 6-image chain, against the JAX
package on the CPU: one `tracks.csv` (the port's `create_tracks` over
matches written from the generator's truth), two copies, the reference's
`actions.reconstruct.run_dataset` on one (run once for the module) and the
port's command on the other.  Both reconstruct the same shots; their camera
centres agree within 5 mm after a similarity fit (the two draw their RANSAC
samples differently, and the images carry 5e-4 of noise, so the results
differ at the noise level, not bit for bit), and both are graded against the
truth.  Also: a run that ends in two partials merges them (here they share
no track, so both stay), `--algorithm triangulation`,
`extend_reconstruction` and `reconstruct_from_prior` run through the
command runner and agree with the JAX package's actions under the same
draws, and partial saves are written.  Three test names still say
"raise": they are kept, and each docstring says what the test now checks."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import synthetic_bundle as sb
from opensfm_tpu.actions import extend_reconstruction as ref_extend
from opensfm_tpu.actions import reconstruct as ref_reconstruct
from opensfm_tpu.actions import reconstruct_from_prior as ref_prior
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import reconstruction
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from test_torch_merge import CENTRE_TOL as MERGE_CENTRE_TOL
from test_torch_merge import jax_draws  # noqa: F401 (a fixture)

N_SHOTS = 6
N_POINTS = 400
CENTRE_TOL = 0.005  # metres, port vs reference after a similarity fit


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


def _write_matches(path, feature_points, keep_pair=lambda i, j: True):
    """Matches of every image pair from the truth, 5 % of them wrong."""
    data = DataSet(path)
    images = data.images()
    rng = np.random.default_rng(4)
    for a, im1 in enumerate(images):
        matches = {}
        for b in range(a + 1, len(images)):
            im2 = images[b]
            if not keep_pair(a, b):
                continue
            p1, p2 = feature_points[im1], feature_points[im2]
            f2_of = {int(p): f for f, p in enumerate(p2) if p >= 0}
            m = np.array([(f1, f2_of[int(p)]) for f1, p in enumerate(p1)
                          if p >= 0 and int(p) in f2_of], dtype=np.int64)
            if len(m) == 0:
                continue
            wrong = rng.random(len(m)) < 0.05
            m[wrong, 1] = rng.integers(0, len(p2), int(wrong.sum()))
            matches[im2] = m
        data.save_matches(im1, matches)


def _set_config(path, **kw):
    with open(os.path.join(path, "config.yaml")) as f:
        cfg = yaml.safe_load(f) or {}
    cfg.update(kw)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    path = str(root / "data")
    feature_points = sb.write_matching_dataset(
        path, n_shots=N_SHOTS, n_points=N_POINTS, track_window=3,
        features_per_image=N_POINTS, seed=11)
    _write_matches(path, feature_points)
    command_runner(opensfm_commands,
                   argv=["create_tracks", path, "--device", "cpu"])
    ref_path = str(root / "ref")
    shutil.copytree(path, ref_path)
    ref_reconstruct.run_dataset(RefDataSet(ref_path))
    return dict(root=root, path=path, ref=ref_path,
                feature_points=feature_points)


def _copy(chain, name):
    dst = str(chain["root"] / name)
    shutil.copytree(chain["path"], dst)
    return dst


def _centres(rec, ids):
    return np.array([rec.shots[s].pose.get_origin() for s in ids])


def _fit_rms(a, b):
    """RMS of a - b after the similarity that best maps a onto b."""
    ma, mb = a.mean(0), b.mean(0)
    U, S, Vt = np.linalg.svd((b - mb).T @ (a - ma))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.sum((a - ma) ** 2)
    d = s * (a - ma) @ R.T + mb - b
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def test_reconstruct_matches_reference(chain):
    path = _copy(chain, "ours")
    report = command_runner(opensfm_commands,
                            argv=["reconstruct", path, "--device", "cpu"])
    ours = DataSet(path).load_reconstruction()
    ref = RefDataSet(chain["ref"]).load_reconstruction()
    assert len(ours) == len(ref) == 1
    assert set(ours[0].shots) == set(ref[0].shots)
    assert len(ours[0].shots) == N_SHOTS
    ids = sorted(ref[0].shots)
    assert _fit_rms(_centres(ours[0], ids), _centres(ref[0], ids)) \
        < CENTRE_TOL

    shots, points = sb.matching_scene(N_SHOTS, N_POINTS, seed=11)
    tm = DataSet(path).load_tracks_manager()
    for rec in (ours, ref):
        grade = sb.grade_reconstruction(rec, tm, chain["feature_points"],
                                        shots, points)
        assert grade["shots"] == N_SHOTS and grade["reconstructions"] == 1
        assert grade["centre_rms"] < 0.01
        assert grade["point_rms"] < 0.03
        assert grade["reprojection_rms"] < 2 * sb.NOISE

    # The report: timings, the device, and each bundle's LM route.
    saved = json.loads(DataSet(path).load_report("reconstruction.json"))
    assert saved["device"] == "cpu" == report["device"]
    assert set(saved["wall_times"]) == {"compute_image_pairs",
                                        "compute_reconstructions"}
    grow = saved["reconstructions"][0]["grow"]
    routes = {grow["bundle_final"]["route"]}
    for step in grow["steps"]:
        routes.add(step["bundle_shot_poses"]["route"])
        assert step["triangulation"]["tracks"] >= 0
        assert step["resection_rounds"]
    assert routes <= {"canonical", "dense", "fused_dense"}


def test_reconstruct_without_device_needs_cuda(chain, monkeypatch):
    path = _copy(chain, "nocuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        command_runner(opensfm_commands, argv=["reconstruct", path])
    assert not os.path.exists(os.path.join(path, "reconstruction.json"))


def test_two_partials_raise_unless_merging_is_off(chain, tmp_path):
    """Images 0-2 and 3-5 matched only among themselves: two partial
    reconstructions sharing no track.  With merge_partial_reconstructions
    on (the default) the run no longer raises: the merge finds nothing to
    join and both partials are saved, as with it off."""
    path = str(tmp_path / "split")
    feature_points = sb.write_matching_dataset(
        path, n_shots=N_SHOTS, n_points=N_POINTS, track_window=3,
        features_per_image=N_POINTS, seed=11)
    _write_matches(path, feature_points,
                   keep_pair=lambda i, j: (i < 3) == (j < 3))
    command_runner(opensfm_commands,
                   argv=["create_tracks", path, "--device", "cpu"])
    report = command_runner(opensfm_commands,
                            argv=["reconstruct", path, "--device", "cpu"])
    recs = DataSet(path).load_reconstruction()
    assert sorted(len(r.shots) for r in recs) == [3, 3]
    assert "merge_time" in report
    _set_config(path, merge_partial_reconstructions=False)
    report = command_runner(opensfm_commands,
                            argv=["reconstruct", path, "--device", "cpu"])
    recs = DataSet(path).load_reconstruction()
    assert sorted(len(r.shots) for r in recs) == [3, 3]
    assert "merge_time" not in report


@pytest.mark.parametrize("argv,output", [
    (["reconstruct", "--algorithm", "triangulation"], "reconstruction.json"),
    (["extend_reconstruction"], "reconstruction.json"),
    (["reconstruct_from_prior"], "reconstruction.prior.json"),
])
def test_unported_entry_points_raise(chain, argv, output, jax_draws):
    """The entry points that raised before this slice now run through the
    command runner on the CPU, from the reference's reconstruction, with
    the JAX package's draws (tests/test_torch_merge.py `jax_draws`): the
    JAX package's action on a copy writes the same shots, camera centres
    within MERGE_CENTRE_TOL of the port's after a similarity fit."""
    name = "unported_" + argv[-1]
    path, theirs = _copy(chain, name), _copy(chain, name + "_ref")
    for dst in (path, theirs):
        shutil.copy(os.path.join(chain["ref"], "reconstruction.json"),
                    os.path.join(dst, "reconstruction.json"))
    np.random.seed(0)
    report = command_runner(opensfm_commands,
                            argv=[argv[0], path] + argv[1:]
                            + ["--device", "cpu"])
    np.random.seed(0)
    ref_data = RefDataSet(theirs)
    if argv[0] == "reconstruct":
        ref_reconstruct.run_dataset(ref_data, "triangulation")
    elif argv[0] == "extend_reconstruction":
        ref_extend.run_dataset(ref_data)
    else:
        ref_prior.run_dataset(ref_data)
    assert report["device"] == "cpu"
    recs = DataSet(path).load_reconstruction(output)
    ref = RefDataSet(theirs).load_reconstruction(output)
    assert len(recs) == len(ref) == 1 and len(recs[0].shots) >= 2
    assert set(recs[0].shots) == set(ref[0].shots)
    ids = sorted(ref[0].shots)
    assert _fit_rms(_centres(recs[0], ids), _centres(ref[0], ids)) \
        < MERGE_CENTRE_TOL


def test_partial_saves_raise(chain):
    """save_partial_reconstructions writes a reconstruction.<time>.json
    before each resection round of the growth loop."""
    path = _copy(chain, "partial")
    _set_config(path, save_partial_reconstructions=True)
    data = DataSet(path)
    reconstruction.incremental_reconstruction(
        data, data.load_tracks_manager(), device="cpu")
    partials = [f for f in os.listdir(path)
                if f.startswith("reconstruction.") and f.endswith(".json")
                and f != "reconstruction.json"]
    assert len(partials) >= 1
    for f in partials:
        assert len(DataSet(path).load_reconstruction(f)) == 1
