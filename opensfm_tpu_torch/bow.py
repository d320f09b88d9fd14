"""Bag-of-visual-words: vocabularies, word assignment, tf-idf histograms.

Port of `opensfm_tpu.bow` (OpenSfM bow.py:11-76).  A vocabulary named by
`config["bow_file"]` is looked up in the dataset directory, then in the
port's own data directory (`opensfm_tpu_torch/data/bow/`, byte-equal copies
of the vocabularies the JAX package ships); where neither applies, one is
trained on the dataset's descriptors (`ops/kmeans`) and cached in the
dataset directory.  Word assignment runs on `device` (CUDA unless told
otherwise); histograms and distances are host numpy, as in the reference.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.ops import kmeans

logger = logging.getLogger(__name__)

DEFAULT_WORDS = 1024
TRAIN_SAMPLE = 200_000

PACKAGE_VOCAB_DIR = os.path.join(os.path.dirname(__file__), "data", "bow")


def resolve_vocabulary_path(filename: str, data=None) -> Optional[str]:
    """Find a vocabulary file: the dataset directory first (a user
    override), then the port's data directory."""
    if not filename:
        return None
    candidates = []
    if data is not None:
        candidates.append(os.path.join(data.data_path, filename))
    candidates.append(os.path.join(PACKAGE_VOCAB_DIR, filename))
    for path in candidates:
        if os.path.isfile(path):
            return path
    return None


class BagOfWords:
    def __init__(self, words: np.ndarray, frequencies: np.ndarray) -> None:
        self.words = np.asarray(words, dtype=np.float32)
        self.frequencies = np.asarray(frequencies, dtype=np.float64)
        self.weights = np.log(
            np.sum(self.frequencies) / np.maximum(self.frequencies, 1.0)
        )
        self._words_on = {}

    def words_on(self, device: torch.device) -> torch.Tensor:
        """The vocabulary as a float32 tensor on `device`, uploaded once."""
        key = str(device)
        if key not in self._words_on:
            self._words_on[key] = torch.as_tensor(self.words, device=device)
        return self._words_on[key]

    def map_to_words(
        self, descriptors: np.ndarray, k: int = 1, matcher_type: str = "FLANN",
        device=None,
    ) -> np.ndarray:
        """The k nearest words [N, k] int32 of each descriptor, nearest
        first (every `matcher_type` is the exact search)."""
        if len(descriptors) == 0:
            return np.zeros((0, k), dtype=np.int32)
        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(descriptors), device=dev)
        idx = kmeans.assign_words_topk(x, self.words_on(dev), k)
        return idx.cpu().numpy().astype(np.int32)

    def histogram(self, words: np.ndarray) -> np.ndarray:
        """tf-idf weighted, L1-normalized word histogram (bow.py:27-36)."""
        h = np.bincount(
            np.asarray(words).reshape(-1), minlength=len(self.words)
        ).astype(float)
        h = h * self.weights
        total = h.sum()
        return h / total if total > 0 else h

    def bow_distance(self, h1: np.ndarray, h2: np.ndarray) -> float:
        return float(np.abs(h1 - h2).sum())


def load_bow_words_and_frequencies(config, data=None):
    """The configured vocabulary's (words, frequencies) where its file is
    found (bow.py:52-62), else None."""
    path = resolve_vocabulary_path(config.get("bow_file", ""), data)
    if path is None:
        return None
    c = np.load(path)
    logger.debug("Loaded BoW vocabulary %s", path)
    return c["words"].astype(np.float32), c["frequencies"]


def train_bag_of_words(
    data, images: Optional[List[str]] = None, n_words: int = DEFAULT_WORDS,
    device=None,
) -> BagOfWords:
    """Train (or load the cached `bow_vocabulary.npz`) dataset-specific
    vocabulary: the reference's `default_rng(42)` sample of up to
    TRAIN_SAMPLE descriptors, k-means on `device`, frequencies from the
    sample's nearest words."""
    cache = os.path.join(data.data_path, "bow_vocabulary.npz")
    if os.path.isfile(cache):
        c = np.load(cache)
        return BagOfWords(c["words"], c["frequencies"])

    rng = np.random.default_rng(42)
    sample = []
    total = 0
    for image in images or data.images():
        fd = data.load_features(image)
        if fd is None or fd.descriptors is None or len(fd.descriptors) == 0:
            continue
        d = fd.descriptors.astype(np.float32)
        take = min(len(d), max(TRAIN_SAMPLE // max(len(images or data.images()), 1), 100))
        sample.append(d[rng.choice(len(d), take, replace=False)])
        total += take
        if total >= TRAIN_SAMPLE:
            break
    if not sample:
        raise RuntimeError("No descriptors available to train BoW vocabulary")
    descriptors = np.concatenate(sample)
    logger.info(
        "Training BoW vocabulary: %d words from %d descriptors",
        n_words, len(descriptors),
    )
    words = kmeans.train_kmeans(descriptors, n_words, device=device)

    bow = BagOfWords(words, np.ones(n_words))
    assignments = bow.map_to_words(descriptors, 1, device=device)
    frequencies = np.bincount(assignments.reshape(-1), minlength=n_words) + 1
    bow = BagOfWords(words, frequencies)
    np.savez_compressed(cache, words=words, frequencies=frequencies)
    return bow


def descriptor_domain_matches_packaged_vocab(config) -> bool:
    """The packaged vocabularies are trained on root+uchar HAHOG/SIFT
    descriptors (uint8 scale).  Float-scale configs (feature_root off,
    SIFT_CV/ORB/AKAZE/SURF) live on another scale, where those centroids
    degrade pair ranking: they train locally instead."""
    feature_type = str(config.get("feature_type", "HAHOG")).upper()
    return (
        feature_type in ("HAHOG", "SIFT")
        and bool(config.get("feature_root", True))
        and bool(config.get("hahog_normalize_to_uchar", True))
    )


def load_vocabulary(data, device=None) -> BagOfWords:
    """The vocabulary for `data`, by precedence: (1) the dataset's own
    `config["bow_file"]` (an explicit user override), (2) the packaged one
    where the descriptor domain matches what it was trained on (root-uchar
    HAHOG/SIFT), (3) one trained on the dataset (on `device`)."""
    filename = data.config.get("bow_file", "")
    local = (
        os.path.join(data.data_path, filename) if filename else None
    )
    if local and os.path.isfile(local):
        c = np.load(local)
        return BagOfWords(c["words"].astype(np.float32), c["frequencies"])
    if descriptor_domain_matches_packaged_vocab(data.config):
        pretrained = load_bow_words_and_frequencies(data.config, data)
        if pretrained is not None:
            return BagOfWords(*pretrained)
    return train_bag_of_words(data, device=device)
