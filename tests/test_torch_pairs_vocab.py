"""BoW and VLAD pair selection in the port against the JAX package on the
CPU: `pairs_selection.match_candidates_from_metadata` with
`matching_bow_neighbors` / `matching_vlad_neighbors` above 0, with and
without GPS preemption, on one matching dataset
(`synthetic_bundle.write_matching_dataset`: 8 images x 500 features, GPS
in the EXIF) copied once per package.  The pair sets and the report are
equal.  Pairs are compared as sorted pairs: `ordered_pairs` orients them by
`set.pop()`."""

import shutil

import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu import pairs_selection as ref_pairs
from opensfm_tpu import vlad as ref_vlad
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import pairs_selection, vlad
from opensfm_tpu_torch.dataset import DataSet

CASES = {
    "bow": dict(matching_bow_neighbors=2),
    "bow_gps": dict(matching_bow_neighbors=2, matching_bow_gps_neighbors=3),
    "vlad": dict(matching_vlad_neighbors=2),
    "vlad_gps": dict(matching_vlad_neighbors=2,
                     matching_vlad_gps_distance=12.0),
    "bow_vlad_gps": dict(matching_bow_neighbors=1, matching_vlad_neighbors=1,
                         matching_gps_neighbors=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pairs_vocab") / "src")
    sb.write_matching_dataset(path, n_shots=8, n_points=800, track_window=3,
                              features_per_image=500, seed=4,
                              config={"matching_gps_distance": 0})
    return path


def _sorted_pairs(pairs):
    return {tuple(sorted(p)) for p in pairs}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vocabulary_pair_selection_matches_reference(dataset, tmp_path, case):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    shutil.copytree(dataset, a)
    shutil.copytree(dataset, b)
    ref_data, data = RefDataSet(a), DataSet(b)
    images = data.images()
    exifs = {im: data.load_exif(im) for im in images}
    # Both VLAD caches hold histograms by image name: start them empty.
    ref_vlad.instance.clear_cache()
    vlad.instance.clear_cache()
    want, want_report = ref_pairs.match_candidates_from_metadata(
        images, images, exifs, ref_data, CASES[case])
    got, got_report = pairs_selection.match_candidates_from_metadata(
        images, images, exifs, data, CASES[case], device="cpu")
    ref_vlad.instance.clear_cache()
    vlad.instance.clear_cache()
    assert got_report == want_report
    assert _sorted_pairs(got) == _sorted_pairs(want)
    key = "num_pairs_bow" if "bow" in case else "num_pairs_vlad"
    assert got_report[key] > 0
    assert len(got) < len(images) * (len(images) - 1) // 2  # a selection


def test_preempt_candidates_matches_reference(dataset):
    data = DataSet(dataset)
    images = data.images()
    exifs = {im: data.load_exif(im) for im in images}
    data.init_reference()
    reference = data.load_reference()
    for neighbors, distance in ((0, 0), (3, 0), (0, 12.0)):
        want = ref_pairs.preempt_candidates(images, images, exifs, reference,
                                            neighbors, distance)
        got = pairs_selection.preempt_candidates(images, images, exifs,
                                                 reference, neighbors,
                                                 distance)
        assert got[1] == want[1]
        assert {k: sorted(v) for k, v in got[0].items()} == \
            {k: sorted(v) for k, v in want[0].items()}
    hist = {im: np.random.default_rng(i).random(5)
            for i, im in enumerate(images)}
    cands = {images[0]: images[1:]}
    l1 = lambda u, v: float(np.abs(u - v).sum())  # noqa: E731
    assert (pairs_selection._closest_by_histogram(cands, hist, 3, l1)
            == ref_pairs._closest_by_histogram(cands, hist, 3, l1))
