"""The port's matching stack against the JAX package on the CPU: descriptor
matching and WORDS masks, pair selection, the polynomial and 5-point
solvers, and essential / fundamental RANSAC with the JAX package's random
draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensfm_tpu import pairs_selection as ref_pairs
from opensfm_tpu.geometry import essential as ref_ess
from opensfm_tpu.geometry import polynomial as ref_poly
from opensfm_tpu.ops import matching as ref_matching
from opensfm_tpu.robust import ransac as ref_ransac
from opensfm_tpu_torch import pairs_selection
from opensfm_tpu_torch.geometry import essential as ess
from opensfm_tpu_torch.geometry import polynomial as poly
from opensfm_tpu_torch.geometry.pose import Pose
from opensfm_tpu_torch.ops import linalg
from opensfm_tpu_torch.ops import matching
from opensfm_tpu_torch.robust import ransac

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_samples(n, iterations, s, seed=42, mask=None):
    """The JAX package's draws for a RANSAC run over n rows, in the port's
    injected layout [n_chunks * k_chunk, s]."""
    n_pad = max(64, 1 << int(n - 1).bit_length())
    m = np.zeros(n_pad, dtype=bool)
    m[:n] = True if mask is None else mask
    p = m.astype(np.float64)
    p = p / max(p.sum(), 1.0)
    k = max(iterations, 64)
    k_chunk = min(k, ransac.CHUNK)
    n_chunks = -(-k // ransac.CHUNK)
    return np.concatenate([
        np.asarray(ref_ransac._sample_indices(
            jax.random.PRNGKey(seed + ci * 7919), n_pad, k_chunk, s,
            jnp.asarray(p)))
        for ci in range(n_chunks)])


# ---------------------------------------------------------------------------
# Descriptor matching
# ---------------------------------------------------------------------------


def _descriptors(seed, n1=700, n2=900, shared=400):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (shared, 128))
    d1 = rng.integers(0, 256, (n1, 128))
    d2 = rng.integers(0, 256, (n2, 128))
    p1 = rng.permutation(n1)[:shared]
    p2 = rng.permutation(n2)[:shared]
    d1[p1] = np.clip(base + rng.integers(-20, 21, base.shape), 0, 255)
    d2[p2] = np.clip(base + rng.integers(-20, 21, base.shape), 0, 255)
    # Ties: a copy of a database row makes its query ambiguous.
    d2[p2[:20] + 0] = d2[p2[:20]]
    d2[-10:] = d2[p2[20:30]]
    return d1.astype(np.uint8), d2.astype(np.uint8), p1, p2


@pytest.mark.parametrize("symmetric", [True, False], ids=["mutual", "oneway"])
def test_match_brute_force_matches_reference(symmetric):
    d1, d2, _, _ = _descriptors(0)
    want = ref_matching.match_brute_force_symmetric(d1, d2, 0.8, symmetric)
    got = matching.match_brute_force_symmetric(d1, d2, 0.8, symmetric,
                                               device=CPU)
    assert len(want) > 300
    np.testing.assert_array_equal(got, want)


def test_words_matching_matches_reference():
    rng = np.random.default_rng(1)
    d1, d2, p1, p2 = _descriptors(1)
    w1 = rng.integers(0, 300, (len(d1), 20))
    w2 = rng.integers(0, 300, (len(d2), 20))
    shared = rng.integers(0, 300, len(p1))  # one word per shared descriptor
    w1[p1, 0] = shared
    w2[p2, 0] = shared
    for checks in (1, 5, 20):
        want_mask = ref_matching.word_compatibility_mask(w1, w2, checks)
        got_mask = matching.word_compatibility_mask(w1, w2, checks, CPU)
        np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    m12 = ref_matching.word_compatibility_mask(w1, w2, 20)
    m21 = ref_matching.word_compatibility_mask(w2, w1, 20)
    want = ref_matching.match_brute_force_symmetric(
        d1, d2, 0.8, True, mask12=m12, mask21=m21)
    got = matching.match_brute_force_symmetric(
        d1, d2, 0.8, True, mask12=torch.from_numpy(m12),
        mask21=torch.from_numpy(m21), device=CPU)
    assert len(want) > 50
    np.testing.assert_array_equal(got, want)
    want = ref_matching.match_brute_force(d1, d2, 0.8, mask12=m12)
    got = matching.match_brute_force(d1, d2, 0.8,
                                     mask12=torch.from_numpy(m12), device=CPU)
    np.testing.assert_array_equal(got, want)


def test_match_small_inputs_and_mask_shape():
    d = np.zeros((1, 8), np.uint8)
    assert matching.match_brute_force_symmetric(d, d, 0.8).shape == (0, 2)
    d1, d2, _, _ = _descriptors(2, 40, 50, 30)
    with pytest.raises(ValueError, match="candidate mask shape"):
        matching.match_brute_force_symmetric(
            d1, d2, 0.8, mask12=torch.ones((12, 10), dtype=torch.bool),
            device=CPU)
    # A uint8 set against a float one is promoted by the wrapper.
    np.testing.assert_array_equal(
        matching.match_brute_force_symmetric(d1, d2.astype(np.float32), 0.8,
                                             device=CPU),
        matching.match_brute_force_symmetric(d1, d2, 0.8, device=CPU))


def test_match_without_device_runs_on_cuda(monkeypatch):
    """No device means cuda, for the search as for RANSAC; without CUDA the
    entry points raise instead of searching on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d1, d2, _, _ = _descriptors(3, 40, 50, 30)
    w = np.zeros((40, 1), np.int64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matching.match_brute_force_symmetric(d1, d2, 0.8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matching.match_brute_force(d1, d2, 0.8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        matching.word_compatibility_mask(w, w, 1)


# ---------------------------------------------------------------------------
# Pair selection (the fixtures of tests/test_matching.py)
# ---------------------------------------------------------------------------


class _FakeData:
    def __init__(self, package, exifs, **config):
        if package == "ref":
            from opensfm_tpu import config as cm
            from opensfm_tpu.geo import TopocentricConverter
        else:
            from opensfm_tpu_torch import config as cm
            from opensfm_tpu_torch.geo import TopocentricConverter
        self.config = cm.default_config()
        self.config.update(config)
        self._reference = TopocentricConverter(52.0, 13.0, 0)
        self.exifs = exifs

    def init_reference(self, images=None):
        pass

    def load_reference(self):
        return self._reference


def _exif_at(lat, lon, t=0.0, opk=None):
    exif = {"gps": {"latitude": lat, "longitude": lon, "altitude": 0.0},
            "capture_time": t}
    if opk is not None:
        exif["opk"] = dict(zip(("omega", "phi", "kappa"), opk))
    return exif


def _fixture(name):
    if name == "clusters":
        exifs = {}
        for i in range(3):
            exifs[f"a{i}"] = _exif_at(52.0, 13.0 + i * 1e-5)
            exifs[f"b{i}"] = _exif_at(52.1, 13.0 + i * 1e-5)
        return exifs, dict(matching_gps_distance=150)
    if name == "exhaustive":
        exifs = {f"im{i}": _exif_at(52.0, 13.0 + i * 1e-5) for i in range(4)}
        return exifs, dict(matching_gps_distance=0)
    if name == "time":
        exifs = {f"im{i}": _exif_at(52.0, 13.0, t=float(i)) for i in range(5)}
        for v in exifs.values():
            v["gps"] = {}
        return exifs, dict(matching_gps_distance=0, matching_time_neighbors=1)
    if name == "order":
        exifs = {f"im{i}": _exif_at(52.0, 13.0 + i * 1e-4) for i in range(7)}
        return exifs, dict(matching_gps_distance=0,
                           matching_order_neighbors=2)
    if name == "neighbors_graph":
        rng = np.random.default_rng(5)
        exifs = {f"im{i}": _exif_at(52.0 + 1e-4 * rng.random(),
                                    13.0 + 1e-4 * rng.random())
                 for i in range(9)}
        return exifs, dict(matching_gps_distance=0, matching_gps_neighbors=3,
                           matching_graph_rounds=3)
    if name == "opk":
        rng = np.random.default_rng(6)
        exifs = {f"im{i}": _exif_at(52.0, 13.0 + i * 2e-4,
                                    opk=rng.uniform(-10, 10, 3))
                 for i in range(6)}
        return exifs, dict(matching_gps_distance=40)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["clusters", "exhaustive", "time", "order",
                                  "neighbors_graph", "opk"])
def test_pair_selection_matches_reference(name):
    exifs, config = _fixture(name)
    images = sorted(exifs)
    want, want_report = ref_pairs.match_candidates_from_metadata(
        images, images, exifs, _FakeData("ref", exifs, **config), {})
    got, got_report = pairs_selection.match_candidates_from_metadata(
        images, images, exifs, _FakeData("port", exifs, **config), {})
    assert len(want) > 0
    # Same process and the same insertion order: the same orientation too.
    assert got == want
    assert got_report == want_report


def test_bow_and_vlad_pair_selection_raise(tmp_path):
    """BoW and VLAD pair selection no longer raise NotImplementedError: with
    either neighbour count above 0 the port selects the JAX package's pairs
    (tests/test_torch_pairs_vocab.py holds more cases)."""
    import synthetic_bundle as sb
    from opensfm_tpu import vlad as ref_vlad
    from opensfm_tpu.dataset import DataSet as RefDataSet
    from opensfm_tpu_torch import vlad
    from opensfm_tpu_torch.dataset import DataSet

    # Both VLAD caches hold histograms by image name: start them empty.
    ref_vlad.instance.clear_cache()
    vlad.instance.clear_cache()
    path = str(tmp_path / "data")
    sb.write_matching_dataset(path, n_shots=4, n_points=200, track_window=2,
                              features_per_image=150, seed=3)
    data, ref_data = DataSet(path), RefDataSet(path)
    images = data.images()
    exifs = {im: data.load_exif(im) for im in images}
    for key in ("matching_bow_neighbors", "matching_vlad_neighbors"):
        override = {"matching_gps_distance": 0, key: 1}
        want, want_report = ref_pairs.match_candidates_from_metadata(
            images, images, exifs, ref_data, override)
        got, got_report = pairs_selection.match_candidates_from_metadata(
            images, images, exifs, data, override, device=CPU)
        assert {tuple(sorted(p)) for p in got} == \
            {tuple(sorted(p)) for p in want}
        assert got_report == want_report
    ref_vlad.instance.clear_cache()
    vlad.instance.clear_cache()


# ---------------------------------------------------------------------------
# Polynomials and the 5-point solver
# ---------------------------------------------------------------------------


def test_real_roots_and_charpoly_match_reference():
    rng = np.random.default_rng(3)
    roots = rng.uniform(-3, 3, (16, 10))
    roots[:8, 8:] = [[1.0, 2.0]]  # some complex pairs via perturbation
    coeffs = np.stack([np.poly(r) for r in roots])
    coeffs[:8, -1] += 0.5
    want_r, want_real = ref_poly.real_roots(jnp.asarray(coeffs),
                                            iterations=80, imag_tol=1e-6)
    got_r, got_real = poly.real_roots(torch.from_numpy(coeffs),
                                      iterations=80, imag_tol=1e-6)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(got_real.numpy(), np.asarray(want_real))

    A = rng.normal(size=(6, 10, 10))
    want = np.stack([np.asarray(ref_ess._charpoly(jnp.asarray(a))) for a in A])
    got = ess._charpoly(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def _bearings(rng, n, outliers=0, pose=None):
    pose = pose or Pose([0.05, -0.2, 0.1], [1.0, 0.1, 0.2])
    X = rng.uniform(-3, 3, (n, 3)) + [0, 0, 10.0]
    x = X / np.linalg.norm(X, axis=1, keepdims=True)
    Xc = X @ pose.get_rotation_matrix().T + pose.translation
    y = Xc / np.linalg.norm(Xc, axis=1, keepdims=True)
    if outliers:
        bad = rng.choice(n, outliers, replace=False)
        y[bad] = rng.normal(size=(outliers, 3))
        y[bad] /= np.linalg.norm(y[bad], axis=1, keepdims=True)
    return x, y


def _is_essential_through(E, x, y, tol=1e-6):
    """E passes through the five pairs and lies on the essential manifold:
    y^T E x = 0, det E = 0 and 2 E E^T E - tr(E E^T) E = 0, to `tol` (the
    solver accepts eigenvectors with a residual up to 1e-3 (1 + |lambda|),
    so a valid candidate can be off by more than rounding)."""
    EEt = E @ E.T
    return (np.abs(np.einsum("ni,ij,nj->n", y, E, x)).max() < tol
            and abs(np.linalg.det(E)) < tol
            and np.abs(2 * EEt @ E - np.trace(EEt) * E).max() < tol)


def test_five_point_solutions_match_reference_as_a_set():
    """The ten candidates agree with the reference's as a set, up to sign
    and order: the nullspace basis is LAPACK's choice.  Each candidate's
    validity flag (realness, inverse-iteration residual) is a threshold on
    a value that is ill-conditioned near a close eigenvalue pair, so a few
    flags flip with rounding; every valid candidate of either package is a
    true solution, and the reference's valid candidates are among the
    port's ten and nearly all flagged valid there too."""
    rng = np.random.default_rng(4)
    xs, ys = zip(*[_bearings(rng, 5, pose=Pose(rng.normal(0, 0.2, 3),
                                               rng.normal(0, 1, 3)))
                   for _ in range(24)])
    xs, ys = np.stack(xs), np.stack(ys)
    Es, valid = ess.essential_five_points(torch.from_numpy(xs),
                                          torch.from_numpy(ys))
    found = agreed = close = 0
    for b in range(len(xs)):
        want_E, want_v = ref_ess.essential_five_points(jnp.asarray(xs[b]),
                                                       jnp.asarray(ys[b]))
        want = np.asarray(want_E)[np.asarray(want_v)].reshape(-1, 9)
        slots = Es[b].numpy().reshape(-1, 9)
        assert valid[b].any()
        for e in slots[valid[b].numpy()]:
            assert _is_essential_through(e.reshape(3, 3), xs[b], ys[b])
        for e in want:  # each reference solution, up to sign
            d = np.minimum(np.abs(slots - e).max(1), np.abs(slots + e).max(1))
            # 1e-12 for most; a candidate whose inverse iteration stopped
            # short of convergence (a close eigenvalue) lands within 1e-5.
            assert d.min() < 1e-5
            close += d.min() < 1e-9
            found += 1
            agreed += bool(valid[b][d.argmin()])
    assert agreed >= 0.9 * found
    assert close >= 0.9 * found


def test_degenerate_samples_do_not_raise():
    """Singular systems give inf/NaN that the validity masks drop, where
    torch.linalg.solve would raise."""
    x = torch.tensor([[0.0, 0.0, 1.0]] * 5, dtype=torch.float64)
    Es, valid = ess.essential_five_points(x[None], x[None])
    assert not bool(valid.any())
    sol = linalg.solve_small(torch.zeros((2, 4, 4), dtype=torch.float64),
                             torch.ones((2, 4), dtype=torch.float64))
    assert not bool(torch.isfinite(sol).all())
    E = ess.essential_n_points(x, x, mask=torch.zeros(5, dtype=torch.bool))
    assert E.shape == (3, 3)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 7, 7))
    b = rng.normal(size=(3, 7))
    np.testing.assert_allclose(
        linalg.solve_small(torch.from_numpy(A), torch.from_numpy(b)).numpy(),
        np.linalg.solve(A, b[..., None])[..., 0], rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# RANSAC with injected draws
# ---------------------------------------------------------------------------


def _same_up_to_sign(a, b, tol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max()) < tol


def test_ransac_essential_matches_reference_with_injected_draws():
    rng = np.random.default_rng(5)
    x, y = _bearings(rng, 200, outliers=60)
    want = ref_ransac.ransac_essential(x, y, 0.004, iterations=1000)
    got = ransac.ransac_essential(x, y, 0.004, iterations=1000, device=CPU,
                                  samples=jax_samples(200, 1000, 5))
    assert want.num_inliers >= 130
    np.testing.assert_array_equal(got.inliers_indices, want.inliers_indices)
    assert _same_up_to_sign(got.model, want.model)
    # The port's own generator finds the same inliers here (a clean split).
    own = ransac.ransac_essential(x, y, 0.004, iterations=1000, device=CPU)
    np.testing.assert_array_equal(own.inliers_indices, want.inliers_indices)


def test_ransac_fundamental_matches_reference_with_injected_draws():
    rng = np.random.default_rng(1)
    gt = Pose([0.02, -0.1, 0.03], [0.5, 0.1, -0.1])
    X = rng.uniform(-3, 3, (150, 3)) + [0, 0, 10.0]
    x1 = (X[:, :2] / X[:, 2:]) * 0.8
    Xc2 = X @ gt.get_rotation_matrix().T + gt.translation
    x2 = (Xc2[:, :2] / Xc2[:, 2:]) * 0.8
    bad = rng.choice(150, 40, replace=False)
    x2[bad] += rng.normal(0, 0.3, (40, 2))
    mask = np.ones(150, dtype=bool)
    mask[:3] = False
    want = ref_ransac.ransac_fundamental(x1, x2, 0.002, iterations=500,
                                         mask=mask)
    got = ransac.ransac_fundamental(
        x1, x2, 0.002, iterations=500, mask=mask, device=CPU,
        samples=jax_samples(150, 500, 8, mask=mask))
    assert want.num_inliers >= 100
    np.testing.assert_array_equal(got.inliers_indices, want.inliers_indices)
    assert _same_up_to_sign(got.model, want.model)
    assert got.score == pytest.approx(want.score, rel=1e-9)


def test_ransac_too_few_samples_and_bad_injection():
    x, y = _bearings(np.random.default_rng(2), 4)
    assert ransac.ransac_essential(x, y, 0.01, device=CPU).model is None
    x, y = _bearings(np.random.default_rng(2), 20)
    with pytest.raises(ValueError, match="samples must be"):
        ransac.ransac_essential(x, y, 0.01, device=CPU,
                                samples=np.zeros((3, 5), np.int64))
