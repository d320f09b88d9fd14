"""The last public functions of the JAX package that the port lacked, each
against the JAX package on the same inputs, on the CPU:
`robust/ransac.ransac_line` and `make_ransac_core`,
`pymap.TracksManager.merge_tracks_manager`, `geometry/polynomial.polyval`
and `roots`, `features.build_flann_index`,
`FeatureLoader.load_points_colors_segmentations_instances`,
`tracking.as_graph` and `as_weighted_graph`, and `dense.py_int`."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensfm_tpu import dense as ref_dense
from opensfm_tpu import feature_loader as ref_feature_loader
from opensfm_tpu import features as ref_features
from opensfm_tpu import pymap as ref_pymap
from opensfm_tpu import tracking as ref_tracking
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.geometry import polynomial as ref_poly
from opensfm_tpu.robust import ransac as ref_ransac
from opensfm_tpu_torch import dense, feature_loader, features, pymap, tracking
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.geometry import polynomial
from opensfm_tpu_torch.robust import ransac
from test_torch_multiview import jax_samples


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def line_points():
    """120 points near y = 0.5 x + 1 (sigma 0.01), 30 % of them moved off
    the line."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-5, 5, 120)
    y = 0.5 * x + 1.0 + rng.normal(0, 0.01, 120)
    out = rng.random(120) < 0.3
    y[out] += rng.uniform(1, 4, out.sum()) * rng.choice([-1, 1], out.sum())
    return np.stack([x, y], axis=1)


def test_ransac_line_matches_reference(line_points):
    """Under the JAX package's draws, the same model (to 1e-9) and the same
    inliers."""
    want = ref_ransac.ransac_line(line_points, 0.05, iterations=200)
    got = ransac.ransac_line(
        line_points, 0.05, iterations=200, device="cpu",
        samples=jax_samples(len(line_points), 200, 2))
    np.testing.assert_array_equal(got.inliers_indices, want.inliers_indices)
    np.testing.assert_allclose(got.model, np.asarray(want.model), rtol=1e-9,
                               atol=1e-12)
    assert got.score == pytest.approx(want.score, rel=1e-9)
    assert abs(got.model[0] - 0.5) < 0.01 and abs(got.model[1] - 1.0) < 0.01


def _line_callables():
    """The reference's per-problem line callables, in torch."""

    def minimal(p, _):
        dx = p[1, 0] - p[0, 0]
        a = (p[1, 1] - p[0, 1]) / torch.where(
            torch.abs(dx) < 1e-15, torch.full_like(dx, 1e-15), dx)
        return torch.stack([a, p[0, 1] - a * p[0, 0]])[None], \
            (torch.abs(dx) > 1e-15)[None]

    def error(ab, p, _):
        return torch.abs(ab[0] * p[:, 0] - p[:, 1] + ab[1]) \
            / torch.sqrt(ab[0] * ab[0] + 1.0)

    def nonminimal(ab, p, _, mask):
        w = mask.to(p.dtype)
        n = torch.clamp_min(torch.sum(w), 1.0)
        mx, my = torch.sum(w * p[:, 0]) / n, torch.sum(w * p[:, 1]) / n
        cov = torch.sum(w * (p[:, 0] - mx) * (p[:, 1] - my))
        var = torch.clamp_min(torch.sum(w * (p[:, 0] - mx) ** 2), 1e-15)
        a = cov / var
        return torch.stack([a, my - a * mx])

    return minimal, error, nonminimal


def test_make_ransac_core_matches_reference(line_points):
    """A core built from per-problem callables: under the reference core's
    own draws (its PRNG key, 256 hypotheses), the same best model, cost and
    inliers."""
    n, k = len(line_points), 256
    mask = np.ones(n, bool)
    key = jax.random.PRNGKey(7)
    ref_core = ref_ransac.make_ransac_core(
        ref_ransac._line_minimal, ref_ransac._line_error,
        ref_ransac._line_nonminimal, 2)
    want = ref_core(key, jnp.asarray(line_points), jnp.asarray(line_points),
                    jnp.asarray(0.05), jnp.asarray(mask), k)
    idx = np.array(ref_ransac._sample_indices(
        key, n, k, 2, jnp.asarray(mask / n)))
    core = ransac.make_ransac_core(*_line_callables(), 2)
    pts = torch.as_tensor(line_points)
    got = core(idx, pts, pts, 0.05, torch.as_tensor(mask))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-9, atol=1e-12)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-9)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _managers(module):
    """Three managers: two share observations (so their tracks merge), the
    third is disjoint."""
    obs = module.Observation
    a, b, c = (module.TracksManager() for _ in range(3))
    a.add_observation("s1", "t1", obs(0.1, 0.2, 1.0, 1, 2, 3, 10))
    a.add_observation("s2", "t1", obs(0.3, 0.4, 1.0, 4, 5, 6, 11))
    a.add_observation("s2", "t2", obs(0.5, 0.6, 1.0, 7, 8, 9, 12))
    b.add_observation("s2", "u1", obs(0.3, 0.4, 1.0, 4, 5, 6, 11))
    b.add_observation("s3", "u1", obs(0.7, 0.8, 2.0, 1, 1, 1, 13))
    b.add_observation("s3", "u2", obs(0.9, 0.1, 1.0, 2, 2, 2, 14))
    c.add_observation("s4", "v1", obs(0.2, 0.2, 1.0, 3, 3, 3, 15))
    return [a, b, c]


def _tracks(manager):
    return {t: {s: (o.id, tuple(o.point)) for s, o in
                manager.get_track_observations(t).items()}
            for t in manager.get_track_ids()}


def test_merge_tracks_manager_matches_reference():
    got = pymap.TracksManager.merge_tracks_manager(_managers(pymap))
    want = ref_pymap.TracksManager.merge_tracks_manager(_managers(ref_pymap))
    assert _tracks(got) == _tracks(want)
    assert got.num_tracks() == 4


def test_polyval_and_roots_match_reference():
    rng = np.random.default_rng(5)
    coeffs = rng.normal(size=(16, 5))
    x = rng.normal(size=(16, 7))
    np.testing.assert_allclose(
        polynomial.polyval(torch.as_tensor(coeffs), torch.as_tensor(x)),
        np.asarray(ref_poly.polyval(jnp.asarray(coeffs), jnp.asarray(x))),
        rtol=1e-12, atol=1e-12)
    got = polynomial.roots(torch.as_tensor(coeffs)).numpy()
    want = np.asarray(ref_poly.roots(jnp.asarray(coeffs)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    # Each root is a root of its polynomial.
    vals = np.stack([np.polyval(c, r) for c, r in zip(coeffs, got)])
    assert np.abs(vals).max() < 1e-8


def test_build_flann_index_matches_reference():
    desc = np.random.default_rng(1).integers(0, 255, (50, 128)).astype(
        np.uint8)
    got = features.build_flann_index(desc, {})
    want = ref_features.build_flann_index(desc, {})
    assert got.dtype == want.dtype == np.float32
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("semantic", [True, False])
def test_load_points_colors_segmentations_instances(tmp_path, semantic):
    """The same arrays from one features file through both loaders."""
    rng = np.random.default_rng(2)
    sem = features.SemanticData(
        rng.integers(0, 5, 30).astype(np.int16),
        rng.integers(0, 3, 30).astype(np.int16), ["a", "b"]) \
        if semantic else None
    fd = features.FeaturesData(
        rng.random((30, 4)), rng.integers(0, 255, (30, 128)).astype(np.uint8),
        rng.integers(0, 255, (30, 3)).astype(np.uint8), sem)
    (tmp_path / "images").mkdir()
    DataSet(str(tmp_path)).save_features("a.jpg", fd)
    got = feature_loader.instance.load_points_colors_segmentations_instances(
        DataSet(str(tmp_path)), "a.jpg")
    want = ref_feature_loader.instance \
        .load_points_colors_segmentations_instances(
            RefDataSet(str(tmp_path)), "a.jpg")
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    assert (got[2] is None) == (not semantic)
    assert feature_loader.instance.load_points_colors_segmentations_instances(
        DataSet(str(tmp_path)), "missing.jpg") is None


def _edge_attrs(graph):
    return {tuple(sorted(map(str, e))): {
        k: (tuple(np.ravel(v)) if isinstance(v, np.ndarray) else v)
        for k, v in d.items()} for *e, d in graph.edges(data=True)}


def test_graphs_match_reference():
    pytest.importorskip("networkx")
    got_tm = pymap.TracksManager.merge_tracks_manager(_managers(pymap))
    want_tm = ref_pymap.TracksManager.merge_tracks_manager(
        _managers(ref_pymap))
    for fn, ref_fn in ((tracking.as_graph, ref_tracking.as_graph),
                       (tracking.as_weighted_graph,
                        ref_tracking.as_weighted_graph)):
        got, want = fn(got_tm), ref_fn(want_tm)
        assert dict(got.nodes(data=True)) == dict(want.nodes(data=True))
        assert _edge_attrs(got) == _edge_attrs(want)


def test_graphs_need_networkx(monkeypatch):
    monkeypatch.setitem(sys.modules, "networkx", None)
    manager = _managers(pymap)[0]
    for fn in (tracking.as_graph, tracking.as_weighted_graph):
        with pytest.raises(ImportError, match="networkx"):
            fn(manager)


def test_py_int_matches_reference():
    a = np.array([-1.6, -0.5, 0.4, 0.5, 1.5, 2.5, 3.49, 1e3 + 0.51])
    np.testing.assert_array_equal(dense.py_int(a), ref_dense.py_int(a))
