"""The port's VLAD against the JAX package on the CPU: `unnormalized_vlad`,
`signed_square_root_normalize` and `vlad_distances` (mirroring
tests/test_vlad.py), the residual sums on seeded descriptors, and
`VladCache`'s precedence (the dataset's file, its trained cache, the
packaged vocabulary, training).

The residual sums are float64 in both packages, over the same float32
nearest centres: they agree to VLAD_TOL (a sum of a few hundred residuals
of 0..255 in another order)."""

import os

import numpy as np
import pytest
import torch

from opensfm_tpu import vlad as ref_vlad
from opensfm_tpu.config import default_config as ref_default_config
from opensfm_tpu_torch import vlad
from opensfm_tpu_torch.config import default_config
from test_torch_bow import CENTRE_TOL_REL, _blobs

CPU = torch.device("cpu")
VLAD_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_vlad_distances_order():
    im = "im1"
    other_ims = ["im2", "im3"]
    histograms = {
        "im1": np.array([1, 0, 0]),
        "im2": np.array([0, 1, 0]),
        "im3": np.array([1, 1, 0]) / np.linalg.norm([1, 1, 0]),
    }
    im_res, distance_res, other_res = vlad.vlad_distances(
        im, other_ims, histograms
    )
    assert im_res == im
    assert len(distance_res) == len(other_ims)
    assert other_res == other_ims
    order = np.argsort(distance_res)
    assert other_ims[order[0]] == "im3"
    assert other_ims[order[1]] == "im2"
    assert (vlad.vlad_distances(im, other_ims, histograms)
            == ref_vlad.vlad_distances(im, other_ims, histograms))
    assert vlad.vlad_distances("im9", other_ims, histograms) == ("im9", [], [])


def test_signed_square_root_normalize():
    v = np.array([1, 0.01])
    res = vlad.signed_square_root_normalize(v)
    assert pytest.approx(np.linalg.norm(res), 1e-6) == 1
    assert pytest.approx(v[0] / v[1], 1e-6) == 10 * res[0] / res[1]
    w = np.random.default_rng(0).normal(size=300)
    np.testing.assert_array_equal(vlad.signed_square_root_normalize(w),
                                  ref_vlad.signed_square_root_normalize(w))
    np.testing.assert_array_equal(
        vlad.signed_square_root_normalize(np.zeros(4)), np.zeros(4))


def test_unnormalized_vlad():
    features = np.array([[0, 1.1]])
    centers = np.array([[1.0, 0.0], [0.0, 1.0]])
    res = vlad.unnormalized_vlad(features, centers, device=CPU)
    assert res is not None
    assert res[0] == res[1] == res[2] == 0
    assert pytest.approx(res[3], 1e-6) == 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_unnormalized_vlad_matches_reference(seed):
    centers = _blobs(20 + seed, 64, 128, 64, spread=0.0)
    features = np.clip(_blobs(30 + seed, 3000, 128, 64), 0, 255).astype(
        np.uint8).astype(np.float64)
    want = ref_vlad.unnormalized_vlad(features, centers)
    got = vlad.unnormalized_vlad(features, centers, device=CPU)
    assert got.dtype == np.float64 and got.shape == (64 * 128,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=VLAD_TOL * np.abs(want).max())
    np.testing.assert_array_equal(
        vlad.unnormalized_vlad(features, centers, device=CPU), got)


class _FakeData:
    def __init__(self, path, config, features=None):
        self.data_path = str(path)
        self.config = config
        self._features = features or {}

    def images(self):
        return sorted(self._features)

    def load_features(self, image):
        from opensfm_tpu_torch.features import FeaturesData

        d = self._features[image]
        return FeaturesData(np.zeros((len(d), 4)), d, None)


def test_vlad_cache_precedence(tmp_path):
    # (3) The packaged vocabulary where the domain matches; nothing trained.
    cache = vlad.VladCache()
    words = cache.load_words(_FakeData(tmp_path, default_config()),
                             device=CPU)
    want = ref_vlad.VladCache().load_words(
        _FakeData(tmp_path, ref_default_config()))
    assert words.shape == (64, 128)
    np.testing.assert_array_equal(words, want)
    assert not os.path.isfile(tmp_path / "vlad_vocabulary.npz")
    assert cache.load_words(None) is words  # held until clear_cache
    cache.clear_cache()

    # (4) A float domain trains on up to 2,000 descriptors an image, as the
    # reference draws them, and caches the centres.
    rng = np.random.default_rng(4)
    features = {f"im{i}": rng.uniform(-0.5, 0.5, (2500, 64)).astype(
        np.float32) for i in range(2)}
    a, b = tmp_path / "ref", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    config = dict(default_config(), feature_type="AKAZE")
    want = ref_vlad.VladCache().load_words(
        _FakeData(a, dict(ref_default_config(), feature_type="AKAZE"),
                  features))
    got = cache.load_words(_FakeData(b, config, features), device=CPU)
    np.testing.assert_allclose(got, want, rtol=0, atol=CENTRE_TOL_REL)
    np.testing.assert_array_equal(np.load(b / "vlad_vocabulary.npz")["words"],
                                  got)

    # (2) The trained cache beats the packaged vocabulary...
    cache.clear_cache()
    again = cache.load_words(_FakeData(b, default_config()), device=CPU)
    np.testing.assert_array_equal(again, got)
    # (1) ...and the dataset's own vlad_file beats both.
    np.savez(b / default_config()["vlad_file"],
             words=np.ones((4, 64), np.float64))
    cache.clear_cache()
    own = cache.load_words(_FakeData(b, default_config()), device=CPU)
    assert own.dtype == np.float32 and own.shape == (4, 64)
