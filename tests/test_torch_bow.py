"""The port's vocabularies, k-means and word assignment against the JAX
package on the CPU: `ops/kmeans.train_kmeans` and `assign_words_topk`,
`bow.BagOfWords`, `load_vocabulary`'s precedence (mirroring
tests/test_bow_pretrained.py), the packaged vocabularies' bytes, and
`detect_features` with `matcher_type: WORDS` on a small dataset.

Word ids are judged as a share of equal ids: XLA's and MKL's float32
products sum in different orders, so a word can flip where two words are
near-equally distant.  Every flip must be a near-tie: its two words'
float64 distances differ by at most NEAR_TIE_REL of |x|^2 + |c|^2 (flips
measured on this host: at most 2.5e-7 of it, on 2,000 descriptors x 50
words of the packaged 10,000-word vocabulary)."""

import hashlib
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu import bow as ref_bow
from opensfm_tpu.actions import detect_features as ref_detect
from opensfm_tpu.config import default_config as ref_default_config
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.ops import kmeans as ref_kmeans
from opensfm_tpu_torch import bow
from opensfm_tpu_torch.actions import detect_features
from opensfm_tpu_torch.config import default_config
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.ops import kmeans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NEAR_TIE_REL = 1e-6  # a flip's float64 distance gap over |x|^2 + |c|^2
MIN_SHARE = 0.999  # equal word ids
# K-means centres: float32 sums in another order; at most 4.6e-5 apart on
# descriptors of 0..255 over 30 iterations on this host, so 2e-6 of the
# largest |x| (5.1e-4 there).
CENTRE_TOL_REL = 2e-6
VOCABULARIES = ("bow_hahog_root_uchar_10000.npz",
                "bow_hahog_root_uchar_1024.npz", "vlad_hahog_root_uchar_64.npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_words_agree(x, centers, got, want, min_share=MIN_SHARE):
    """got == want but for near-ties; returns the share of equal ids."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    equal = got == want
    share = equal.mean()
    assert share >= min_share, share
    rows, cols = np.nonzero(~equal)
    if len(rows):
        x64 = np.asarray(x, dtype=np.float64)[rows]
        c64 = np.asarray(centers, dtype=np.float64)

        def d(ids):
            c = c64[ids]
            return ((x64 - c) ** 2).sum(axis=1), (x64 ** 2).sum(axis=1) + (
                c ** 2).sum(axis=1)

        dg, scale = d(got[rows, cols])
        dw, _ = d(want[rows, cols])
        assert (np.abs(dg - dw) <= NEAR_TIE_REL * scale).all(), \
            np.max(np.abs(dg - dw) / scale)
    return share


def _blobs(seed, n, d, k, spread=8.0):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 255, (k, d))
    return (centres[rng.integers(0, k, n)]
            + rng.normal(0, spread, (n, d))).astype(np.float32)


@pytest.mark.parametrize("case", ["blobs", "uniform", "fewer_points"])
def test_train_kmeans_matches_reference(case):
    rng = np.random.default_rng(3)
    if case == "blobs":
        x, k = _blobs(3, 6000, 128, 64), 64
    elif case == "uniform":
        x, k = rng.uniform(0, 255, (3000, 64)).astype(np.float32), 100
    else:  # tiled to reach the centres, as the reference tiles
        x, k = _blobs(4, 40, 128, 8), 64
    want = ref_kmeans.train_kmeans(x, k)
    got = kmeans.train_kmeans(x, k, device=CPU)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CENTRE_TOL_REL * np.abs(x).max())


def test_train_kmeans_chunks_do_not_change_centres(monkeypatch):
    """The per-cluster sums run in chunks of rows: a chunk of 7 rows gives
    the one-chunk result to rounding."""
    x = _blobs(5, 500, 32, 16)
    whole = kmeans.train_kmeans(x, 16, device=CPU)
    monkeypatch.setattr(kmeans, "CHUNK_ENTRIES", 7 * 16)
    np.testing.assert_allclose(kmeans.train_kmeans(x, 16, device=CPU), whole,
                               rtol=0, atol=CENTRE_TOL_REL * 255)


def test_assign_words_topk_matches_reference():
    centers = np.load(os.path.join(bow.PACKAGE_VOCAB_DIR, VOCABULARIES[0]))[
        "words"].astype(np.float32)
    rng = np.random.default_rng(0)
    x = np.clip(centers[rng.integers(0, len(centers), 2000)]
                + rng.normal(0, 20, (2000, 128)), 0, 255).astype(np.uint8)
    want = np.asarray(ref_kmeans.assign_words_topk(
        jnp.asarray(x, dtype=jnp.float32), jnp.asarray(centers), 50))
    got = kmeans.assign_words_topk(torch.as_tensor(x),
                                   torch.as_tensor(centers), 50)
    assert got.dtype == torch.int64
    assert_words_agree(x, centers, got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 0], want[:, 0])


def test_assign_words_topk_ties_take_the_lower_word():
    """Duplicate centres tie exactly: `lax.top_k` lists the lower index
    first, and so does the port, also across chunks of rows."""
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 10, (6, 4)).astype(np.float32)
    centers = np.concatenate([base, base[::-1], base[:2]])
    x = np.concatenate([base, rng.uniform(0, 10, (30, 4))]).astype(np.float32)
    want = np.asarray(ref_kmeans.assign_words_topk(
        jnp.asarray(x), jnp.asarray(centers), 5))
    for chunk in (kmeans.CHUNK_ENTRIES, 3 * len(centers)):
        kmeans.CHUNK_ENTRIES, saved = chunk, kmeans.CHUNK_ENTRIES
        try:
            got = kmeans.assign_words_topk(torch.as_tensor(x),
                                           torch.as_tensor(centers), 5)
        finally:
            kmeans.CHUNK_ENTRIES = saved
        np.testing.assert_array_equal(got.numpy(), want)
    assert kmeans.assign_words_topk(torch.zeros((0, 4)),
                                    torch.as_tensor(centers), 3).shape == (0, 3)


def test_bag_of_words_histograms_match_reference():
    rng = np.random.default_rng(2)
    words = _blobs(6, 300, 128, 300, spread=0.0)
    freq = rng.integers(1, 50, 300)
    ref_bag = ref_bow.BagOfWords(words, freq)
    bag = bow.BagOfWords(words, freq)
    np.testing.assert_array_equal(bag.weights, ref_bag.weights)
    h = []
    for seed in (0, 1):
        desc = _blobs(7 + seed, 400, 128, 300)
        want_w = ref_bag.map_to_words(desc, 1)
        got_w = bag.map_to_words(desc, 1, device=CPU)
        assert got_w.dtype == np.int32
        assert assert_words_agree(desc, words, got_w, want_w) == 1.0
        got_h = bag.histogram(got_w)
        np.testing.assert_array_equal(got_h, ref_bag.histogram(want_w))
        assert abs(got_h.sum() - 1.0) < 1e-12
        h.append(got_h)
    assert bag.bow_distance(*h) == ref_bag.bow_distance(*h)
    assert bag.map_to_words(np.zeros((0, 128)), 4, device=CPU).shape == (0, 4)


@pytest.mark.parametrize("name", VOCABULARIES)
def test_packaged_vocabularies_are_byte_equal(name):
    def sha(directory):
        with open(os.path.join(directory, name), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert bow.PACKAGE_VOCAB_DIR == os.path.join(
        REPO, "opensfm_tpu_torch", "data", "bow")
    assert sha(bow.PACKAGE_VOCAB_DIR) == sha(ref_bow.PACKAGE_VOCAB_DIR)


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


def test_load_vocabulary_precedence(tmp_path):
    # (2) The packaged vocabulary where the domain matches; nothing trained.
    config = default_config()
    bag = bow.load_vocabulary(_FakeData(tmp_path, config), device=CPU)
    ref = ref_bow.load_vocabulary(_FakeData(tmp_path, ref_default_config()))
    assert bag.words.shape == (10000, 128)
    np.testing.assert_array_equal(bag.words, ref.words)
    np.testing.assert_array_equal(bag.weights, ref.weights)
    assert not os.path.isfile(tmp_path / "bow_vocabulary.npz")
    small = bow.resolve_vocabulary_path("bow_hahog_root_uchar_1024.npz")
    assert np.load(small)["words"].shape == (1024, 128)
    assert bow.resolve_vocabulary_path("") is None
    assert bow.resolve_vocabulary_path("missing.npz") is None

    # (1) A dataset's own file wins, whatever the domain.
    override = np.zeros((8, 128), dtype=np.float32)
    np.savez(tmp_path / config["bow_file"], words=override,
             frequencies=np.ones(8))
    words, freq = bow.load_bow_words_and_frequencies(
        config, _FakeData(tmp_path, config))
    assert words.shape == (8, 128)
    for feature_type in ("HAHOG", "AKAZE"):
        cfg = dict(config, feature_type=feature_type)
        assert bow.load_vocabulary(_FakeData(tmp_path, cfg),
                                   device=CPU).words.shape == (8, 128)


def test_trained_vocabulary_matches_reference(tmp_path):
    """(3) A float domain trains on the dataset: the reference's sample,
    centres and frequencies, and the same cache file, read back after."""
    rng = np.random.default_rng(10)
    features = {f"im{i}": rng.uniform(-0.5, 0.5, (700, 64)).astype(np.float32)
                for i in range(3)}
    config = dict(default_config(), feature_type="AKAZE")
    ref_config = dict(ref_default_config(), feature_type="AKAZE")
    a, b = tmp_path / "ref", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    assert not bow.descriptor_domain_matches_packaged_vocab(config)
    want = ref_bow.load_vocabulary(_FakeData(a, ref_config, features))
    got = bow.load_vocabulary(_FakeData(b, config, features), device=CPU)
    np.testing.assert_allclose(got.words, want.words, rtol=0,
                               atol=CENTRE_TOL_REL)
    np.testing.assert_array_equal(got.frequencies, want.frequencies)
    cached = np.load(b / "bow_vocabulary.npz")
    assert sorted(cached.files) == sorted(np.load(a / "bow_vocabulary.npz")
                                          .files)
    again = bow.load_vocabulary(_FakeData(b, config, {}), device=CPU)
    np.testing.assert_array_equal(again.words, got.words)


def test_detect_features_words_match_reference(tmp_path):
    src = str(tmp_path / "src")
    sb.write_matching_dataset(src, n_shots=3, n_points=300, track_window=2,
                              features_per_image=400, seed=2,
                              config={"matcher_type": "WORDS"})
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    ref_detect.run_dataset(RefDataSet(a))
    report = detect_features.run_dataset(DataSet(b), device="cpu")
    data, ref_data = DataSet(b), RefDataSet(a)
    centers = np.load(os.path.join(bow.PACKAGE_VOCAB_DIR, VOCABULARIES[0]))[
        "words"]
    assert sorted(report["words"]) == data.images()
    for image in data.images():
        got, want = data.load_words(image), ref_data.load_words(image)
        assert got.dtype == want.dtype == np.uint16
        assert got.shape == (400, 50)
        assert_words_agree(data.load_features(image).descriptors, centers,
                           got.astype(np.int64), want.astype(np.int64))
