"""The port's GCP annotation tool (`opensfm_tpu_torch.annotation`) against
`annotation_gui_gcp` (the JAX package's tool) on the CPU.

The fixture is the seed-42 circle scene of the port's `synthetic_data` (20
shots, 10 GCPs; its truth poses and points, noisy observations), written by
`chip_smoke.write_annotation_dataset` as the tool's two sequences: shots
sorted by id go to sequence a and b in turn (disjoint shots, common GCPs),
each with every other point that two of its shots observe, and b moved by
`chip_smoke.ANNOT_SIMILARITY` (scale 1.3, 20 deg yaw, 5 m).  Both packages
read the same files.  Every GCP is triangulated or not with at least
GCP_MARGIN (10 %) of room on both of `triangulate_gcp`'s thresholds (ray
angle 1 deg, reprojection 0.02 rad) in each sequence and in each merged map
before and after its bundle, so no rounding flips a GCP between its
triangulation and the bundle's `to_topocentric` fallback.

- `find_alignment`, the reprojection and geopositional errors,
  `compute_gcp_std`, wrong counts, sorted errors, `decompose_covariance`
  and the GUI helpers equal, floats at 1e-9;
- `bundle_with_fixed_images` as `align` calls it, with and without
  covariances: written-back poses and points, every shot's covariance
  (fixed instances too) at 1e-8 relative, the same `valid`;
- `align` in rigid, flex and full: gcp_std_report.json key for key, floats
  at 1e-8 relative, `accepted` equal;
- `analyze_dataset` at 1e-9, one HTTP round trip through the port's server,
  `/analyze`'s error reports and device errors, `device=None` without CUDA,
  and imports free of `jax` and `opensfm_tpu`.
"""

import inspect
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from annotation_gui_gcp import main as ref_main
from annotation_gui_gcp import run_ba as ref_run_ba
from annotation_gui_gcp.lib.gcp_manager import GroundControlPointManager
from chip_smoke import (ANNOT_MIN_COMMON, GCP_MARGIN, annotation_similarity,
                        gcp_margin, gcp_margins, write_annotation_dataset)
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import geo
from opensfm_tpu_torch.annotation import main as port_main
from opensfm_tpu_torch.annotation import run_ba as port_run_ba
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.synthetic_data import (synthetic_examples,
                                              synthetic_scene)

REL_HELPERS = 1e-9  # triangulations, reprojections, the similarity
REL_BUNDLE = 1e-8  # the two LM cores round apart only (as the BA tests)
POINT_STRIDE = 2  # every other point: the file's serial time
MODES = ("rigid", "flex", "full")
STD_THRESHOLD = 0.5  # full's `accepted` is then True in both packages


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.RandomState(42)
    reference = geo.TopocentricConverter(47.0, 6.0, 0)
    scene = synthetic_examples.synthetic_circle_scene(reference, rng=rng)
    inp = synthetic_scene.SyntheticInputData(
        scene.get_reconstruction(), reference, 40, 1.0, 5.0, 0.1,
        (0.01, 0.1), False, 10, [10.0, 0.0, 100.0], rng=rng)
    root = str(tmp_path_factory.mktemp("annotation") / "circle")
    write_annotation_dataset(root, inp.reconstruction, inp.tracks_manager,
                             inp.gcps.values(), point_stride=POINT_STRIDE)
    return root


def _state(rec):
    ids = sorted(rec.shots)
    return dict(
        ids=ids,
        poses=np.array([np.r_[rec.shots[s].pose.rotation,
                              rec.shots[s].pose.translation] for s in ids]),
        points=np.array([rec.points[p].coordinates
                         for p in sorted(rec.points)]),
        covariances=[rec.shots[s].covariance for s in ids])


def _recorder(fn, sink):
    """`bundle_with_fixed_images` that records the GCP margins of the
    merged map before and after, and the written-back state."""
    def wrapped(reconstruction, camera_priors, gcp, *args, **kw):
        before = gcp_margins(gcp, reconstruction.shots)
        valid = fn(reconstruction, camera_priors, gcp, *args, **kw)
        sink.append(dict(valid=valid, margins=(before, gcp_margins(
            gcp, reconstruction.shots)), **_state(reconstruction)))
        return valid
    return wrapped


@pytest.fixture(scope="module")
def runs(dataset):
    """align in each mode through both packages: (report, the report file,
    the recorded bundle) by (package, mode)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for pkg, mod, kw in (("jax", ref_run_ba, {}),
                             ("port", port_run_ba, {"device": "cpu"})):
            sink = []
            mp.setattr(mod, "bundle_with_fixed_images",
                       _recorder(mod.bundle_with_fixed_images, sink))
            for mode in MODES:
                report = mod.align(dataset, mode=mode,
                                   std_threshold=STD_THRESHOLD, **kw)
                with open(os.path.join(dataset, "gcp_std_report.json")) as f:
                    written = json.load(f)
                bundled = sink.pop() if mode != "rigid" else None
                out[pkg, mode] = (report, written, bundled)
    return out


def _close(got, want, rel, path=""):
    """got == want key for key; floats within rel of the larger, NaN = NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], rel, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rel, f"{path}[{k}]")
    elif isinstance(want, float) and isinstance(got, float):
        if np.isnan(want):
            assert np.isnan(got), path
        else:
            assert abs(got - want) <= rel * max(abs(got), abs(want)), \
                (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _array_close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-300)


def _loaded(path):
    """(gcps, sequence a, sequence b) through each package's DataSet."""
    port, ref = DataSet(path), RefDataSet(path)
    return ((port.load_ground_control_points(), *port.load_reconstruction()),
            (ref.load_ground_control_points(), *ref.load_reconstruction()))


def test_fixture_gcps_clear_of_thresholds(dataset, runs):
    (gcps, rec_a, rec_b), _ = _loaded(dataset)
    assert len(rec_a.shots) == len(rec_b.shots) == 10
    assert not set(rec_a.shots) & set(rec_b.shots)
    for rec in (rec_a, rec_b):
        assert gcp_margin(gcp_margins(gcps, rec.shots)) >= GCP_MARGIN
    for pkg in ("jax", "port"):
        for mode in ("flex", "full"):
            for margins in runs[pkg, mode][2]["margins"]:
                assert gcp_margin(margins) >= GCP_MARGIN, (pkg, mode)


def test_find_alignment_equal_and_recovers_the_move(dataset):
    (gcps, *port_recs), (ref_gcps, *ref_recs) = _loaded(dataset)
    port_coords = [port_run_ba.triangulate_gcps(gcps, r, device="cpu")
                   for r in port_recs]
    ref_coords = [ref_run_ba.triangulate_gcps(ref_gcps, r) for r in ref_recs]
    for got, want in zip(port_coords, ref_coords):
        assert [c is None for c in got] == [c is None for c in want]
        _array_close([c for c in got if c is not None],
                     [c for c in want if c is not None], REL_HELPERS)
    common = sum(a is not None and b is not None for a, b in zip(*ref_coords))
    assert common >= ANNOT_MIN_COMMON
    s, A, b = port_run_ba.find_alignment(*port_coords, device="cpu")
    s_ref, A_ref, b_ref = ref_run_ba.find_alignment(*ref_coords)
    assert abs(s - s_ref) <= REL_HELPERS * s_ref
    _array_close(A, A_ref, REL_HELPERS)
    _array_close(b, b_ref, REL_HELPERS)
    # It undoes the stated move within the GCPs' triangulation noise.
    s0, A0, b0 = annotation_similarity()
    assert abs(s * s0 - 1.0) < 1e-2
    np.testing.assert_allclose(A, A0.T, atol=1e-2)
    np.testing.assert_allclose(b, -A0.T @ b0 / s0, atol=0.2)


def test_find_alignment_reference_case_and_errors():
    """tests/test_annotation_gcp.py's case, then the errors: fewer than 3
    common points raise in both packages; coincident points raise in the
    port, where the JAX package returns a non-finite rotation."""
    rng = np.random.default_rng(0)
    pts1 = rng.normal(size=(10, 3))
    theta = 0.4
    A_true = np.array([[np.cos(theta), -np.sin(theta), 0],
                       [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]])
    pts0 = [2.5 * A_true @ p + np.array([1.0, -2.0, 0.5]) for p in pts1]
    pts0[3] = None
    got = port_run_ba.find_alignment(pts0, list(pts1), device="cpu")
    want = ref_run_ba.find_alignment(pts0, list(pts1))
    assert abs(got[0] - want[0]) <= REL_HELPERS * want[0]
    assert np.isclose(got[0], 2.5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1], A_true, atol=1e-9)
    two = [np.zeros(3), np.ones(3), None]
    for fn, kw in ((port_run_ba.find_alignment, {"device": "cpu"}),
                   (ref_run_ba.find_alignment, {})):
        with pytest.raises(RuntimeError, match="at least 3"):
            fn(two, two, **kw)
    same = [np.ones(3)] * 4
    with pytest.raises(RuntimeError, match="Degenerate"):
        port_run_ba.find_alignment(same, same, device="cpu")
    with np.errstate(all="ignore"):
        assert not np.all(np.isfinite(ref_run_ba.find_alignment(same,
                                                                same)[1]))


def test_reprojection_helpers_equal(dataset):
    (gcps, rec_a, rec_b), (ref_gcps, ref_a, ref_b) = _loaded(dataset)
    for rec, ref in ((rec_a, ref_a), (rec_b, ref_b)):
        got = port_run_ba.reproject_gcps(gcps, rec, device="cpu")
        want = ref_run_ba.reproject_gcps(ref_gcps, ref)
        _close(got, want, REL_HELPERS)
        assert any(want.values())
        _close(port_run_ba.gcp_geopositional_error(gcps, rec, device="cpu"),
               ref_run_ba.gcp_geopositional_error(ref_gcps, ref),
               REL_HELPERS)
        _close(port_run_ba.compute_gcp_std(got),
               ref_run_ba.compute_gcp_std(want), REL_HELPERS)
        errors = sorted(e["error"] for r in want.values() for e in r.values())
        k = len(errors) // 2  # between two errors, clear of rounding
        threshold = 0.5 * (errors[k - 1] + errors[k])
        assert (port_run_ba.get_number_of_wrong_annotations_per_gcp(
            got, threshold) == ref_run_ba.
            get_number_of_wrong_annotations_per_gcp(want, threshold))
        ranked = port_run_ba.get_sorted_reprojection_errors(got)
        assert [r[:2] for r in ranked] == [
            r[:2] for r in ref_run_ba.get_sorted_reprojection_errors(want)]
        _close([r[2] for r in ranked],
               [r[2] for r in ref_run_ba.get_sorted_reprojection_errors(want)],
               REL_HELPERS)


def test_reference_helper_cases():
    """tests/test_annotation_gcp.py's helper cases, on the port."""
    reprojections = {
        "g1": {"im1": {"error": 0.003}, "im2": {"error": 0.004}},
        "g2": {"im1": {"error": 0.1}},
    }
    assert port_run_ba.compute_gcp_std(reprojections) == \
        ref_run_ba.compute_gcp_std(reprojections)
    assert port_run_ba.get_number_of_wrong_annotations_per_gcp(
        reprojections, 0.01) == {"g1": 0, "g2": 1}
    assert port_run_ba.get_sorted_reprojection_errors(reprojections)[0] == \
        ("g2", "im1", 0.1)
    assert np.isnan(port_run_ba.compute_gcp_std({"g": {}}))
    assert np.isnan(ref_run_ba.compute_gcp_std({"g": {}}))


def test_decompose_covariance_equal(runs):
    cov = np.asarray(runs["port", "full"][2]["covariances"][0])[3:, 3:]
    for case in (np.diag([4.0, 1.0, 0.25]), cov):
        got = port_run_ba.decompose_covariance(case)
        want = ref_run_ba.decompose_covariance(case)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert np.allclose(sorted(port_run_ba.decompose_covariance(
        np.diag([4.0, 1.0, 0.25]))[1]), [0.5, 1.0, 2.0])


@pytest.mark.parametrize("mode", ["flex", "full"])
def test_bundle_with_fixed_images_equal(runs, mode):
    """`bundle_with_fixed_images` as `align` calls it: without covariances
    (flex) and with them (full)."""
    got, want = runs["port", mode][2], runs["jax", mode][2]
    assert got["ids"] == want["ids"] and len(got["ids"]) == 20
    assert got["valid"] == want["valid"]
    _array_close(got["poses"], want["poses"], REL_BUNDLE)
    _array_close(got["points"], want["points"], REL_BUNDLE)
    if mode == "flex":
        assert got["valid"] is False
        assert all(c is None for c in got["covariances"] + want["covariances"])
        return
    assert got["valid"] is True
    # One block an instance on every shot, the fixed ones of a too.
    assert all(c is not None and np.shape(c) == (6, 6)
               for c in got["covariances"])
    _array_close(np.array(got["covariances"]), np.array(want["covariances"]),
                 REL_BUNDLE)


@pytest.mark.parametrize("mode", MODES)
def test_align_report_equal(runs, mode):
    got, got_file, _ = runs["port", mode]
    want, want_file, _ = runs["jax", mode]
    _close(got_file, want_file, REL_BUNDLE)
    assert json.loads(json.dumps(got)) == got_file
    assert got.get("accepted") == want.get("accepted")
    if mode == "full":
        assert got["accepted"] is True and got["covariance_valid"] is True
        assert len(got["shot_stds"]) == 10
    assert got["gcp_reprojection_rms"] < 0.016


def test_analyze_dataset_equal(dataset):
    got = port_main.analyze_dataset(dataset, device="cpu")
    want = ref_main.analyze_dataset(dataset)
    assert set(got) == {"reprojections", "geo_errors"}
    _close(got, want, REL_HELPERS)


def test_gui_helpers_equal(dataset, tmp_path):
    managers = {}
    for pkg in ("port", "jax"):
        path = tmp_path / pkg
        path.mkdir()
        (path / "reference_lla.json").write_text(json.dumps(
            {"latitude": 47.0, "longitude": 6.0, "altitude": 10.0}))
        m = GroundControlPointManager(str(path))
        for pid, obs in (("p1", ("im1", "im2", "im3")), ("p2", ("im1",))):
            m.add_point(pid)
            for k, im in enumerate(obs):
                m.add_point_observation(pid, im, [0.1 * k, 0.2])
        managers[pkg] = m
    port_m, ref_m = managers["port"], managers["jax"]
    for image in ("im1", "im2", "absent"):
        assert port_main.visible_points(port_m, image) == \
            ref_main.visible_points(ref_m, image)
    for pid in ("p1", "p2", "absent"):
        assert port_main.point_images(port_m, pid) == \
            ref_main.point_images(ref_m, pid)
        for shown in ([], ["im2"], ["im1", "im3"]):
            assert port_main.cp_finder_candidates(port_m, pid, shown) == \
                ref_main.cp_finder_candidates(ref_m, pid, shown)
    assert port_main.point_color("p1") == ref_main.point_color("p1")
    got = port_main.set_position_from_world(
        port_m, str(tmp_path / "port"), "cp0", 100.0, 50.0, 2.0)
    want = ref_main.set_position_from_world(
        ref_m, str(tmp_path / "jax"), "cp0", 100.0, 50.0, 2.0)
    _close(got, want, REL_HELPERS)
    assert (tmp_path / "port" / "ground_control_points.json").read_text() \
        == (tmp_path / "jax" / "ground_control_points.json").read_text()
    assert port_main.load_model_payload(dataset) == \
        ref_main.load_model_payload(dataset)
    assert "error" in port_main.load_model_payload(str(tmp_path))
    assert port_main.set_position_from_world(
        port_m, str(dataset) + "_absent", "cp0", 0.0, 0.0) == \
        {"error": "no reference_lla.json"}


def _request(port, route, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=data,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def test_http_round_trip(dataset, tmp_path):
    path = str(tmp_path / "served")
    shutil.copytree(dataset, path)
    server = port_main.make_server(path, 0, "cpu", host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        with open(os.path.join(os.path.dirname(ref_main.__file__),
                               "templates", "annotation.html"), "rb") as f:
            assert _request(port, "/") == f.read()
        shot = sorted(DataSet(path).load_reconstruction()[0].shots)[0]
        assert json.loads(_request(port, "/add_observation", {
            "point_id": "cp-new", "shot_id": shot,
            "projection": [0.1, 0.2]})) == {"ok": True}
        assert json.loads(_request(
            port, f"/visible_points?image={urllib.parse.quote(shot)}")
        )["points"]["cp-new"]["projection"] == [0.1, 0.2]
        assert "cp-new" in GroundControlPointManager(path).points
        served = json.loads(_request(port, "/analyze", {}))
        _close(served, json.loads(json.dumps(
            port_main.analyze_dataset(path, device="cpu"))), REL_HELPERS)
        assert served["reprojections"]["cp-new"] == {}
        rigid = json.loads(_request(port, "/analyze", {"mode": "rigid"}))
        _close(rigid, json.loads(json.dumps(port_run_ba.align(
            path, mode="rigid", device="cpu"))), REL_HELPERS)
        assert rigid["mode"] == "rigid"
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def test_analysis_errors_and_device_errors(tmp_path, monkeypatch):
    """/analyze reports a dataset's faults and lets device errors through."""
    empty = str(tmp_path)
    for mode in ("rigid", "flex", "full"):
        got = port_main.run_analysis(empty, mode, device="cpu")
        assert got == ref_main_error(empty, mode)
    assert "error" in port_main.run_analysis(empty, "reproject",
                                             device="cpu")
    for exc in (torch.OutOfMemoryError("CUDA out of memory"),
                RuntimeError("CUDA error: an illegal memory access"),
                RuntimeError("fused_cost kernel launch failed (cuda error "
                             "700)")):
        def boom(*args, **kw):
            raise exc
        monkeypatch.setattr(port_run_ba, "align", boom)
        with pytest.raises(type(exc)):
            port_main.run_analysis(empty, "full", device="cpu")
    monkeypatch.setattr(port_run_ba, "align", lambda *a, **k: (_ for _ in ())
                        .throw(RuntimeError("Need at least 3 common GCPs "
                                            "to align")))
    assert port_main.run_analysis(empty, "full", device="cpu") == {
        "error": "RuntimeError: Need at least 3 common GCPs to align"}


def ref_main_error(path, mode):
    """The JAX handler's {"error": ...} for an align that raises."""
    try:
        ref_run_ba.align(path, mode=mode)
    except (RuntimeError, OSError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    raise AssertionError("align did not raise")


def test_device_default_is_cuda(dataset, tmp_path, monkeypatch):
    """No --device: CUDA, and an error where it is absent; --device cpu
    runs the CLI."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_run_ba.align(dataset, mode="rigid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_run_ba.main([dataset])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.make_server(dataset, 0, host="127.0.0.1")
    path = str(tmp_path / "cli")
    shutil.copytree(dataset, path)
    port_run_ba.main([path, "--device", "cpu", "--std-threshold",
                      str(STD_THRESHOLD)])
    with open(os.path.join(path, "gcp_std_report.json")) as f:
        report = json.load(f)
    assert report["mode"] == "full" and report["accepted"] is True


def test_public_functions_match():
    """Every public function of the JAX tool has its port, with the same
    parameters plus `device` where device math runs."""
    for ref_mod, port_mod in ((ref_run_ba, port_run_ba),
                              (ref_main, port_main)):
        names = [n for n, f in vars(ref_mod).items()
                 if inspect.isfunction(f) and not n.startswith("_")
                 and f.__module__ == ref_mod.__name__]
        assert names
        for name in names:
            want = list(inspect.signature(getattr(ref_mod, name)).parameters)
            got = list(inspect.signature(getattr(port_mod, name)).parameters)
            assert got[:len(want)] == want, name
            assert set(got[len(want):]) <= {"device", "argv"}, name
    assert inspect.signature(port_run_ba.align).parameters["mode"].default \
        == "full"


def test_imports_load_neither_jax_nor_reference():
    code = ("import sys\n"
            "import opensfm_tpu_torch.annotation.run_ba\n"
            "import opensfm_tpu_torch.annotation.main\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'opensfm_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
