"""VLAD image descriptors and distances.

Port of `opensfm_tpu.vlad` (OpenSfM vlad.py:11-81 and the C++
`compute_vlad_descriptor` / `compute_vlad_distances`).  Each image's
residual aggregation is one batched sum on `device` (CUDA unless told
otherwise) in float64: the residuals to each descriptor's nearest centre,
summed per centre by a one-hot product, in a fixed order; normalisation
and distances are host numpy, as in the reference.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import bow, feature_loader, resolve_device
from opensfm_tpu_torch.ops import kmeans

logger = logging.getLogger(__name__)

VLAD_WORDS = 64


def unnormalized_vlad(features: np.ndarray, centers: np.ndarray,
                      device=None) -> np.ndarray:
    """Sum of the residuals to each feature's nearest centre, flattened
    [K * D] float64 (vlad.py:11-22); the nearest centre by the float32
    search of `ops/kmeans`."""
    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(features, dtype=np.float64), device=dev)
    c = torch.as_tensor(np.asarray(centers), device=dev)
    assign = kmeans.assign_words_topk(f, c, 1)[:, 0]
    residuals = f - c.to(torch.float64)[assign]
    one_hot = torch.nn.functional.one_hot(assign, c.shape[0]).to(
        torch.float64)
    return (one_hot.T @ residuals).reshape(-1).cpu().numpy()


def signed_square_root_normalize(v: np.ndarray) -> np.ndarray:
    """SSR + L2 normalization (vlad.py:25-32)."""
    v = np.sign(v) * np.sqrt(np.abs(v))
    norm = np.linalg.norm(v)
    return v / norm if norm > 0 else v


def vlad_distances(
    image: str, other_images: Iterable[str], histograms: Dict[str, np.ndarray]
) -> Tuple[str, List[float], List[str]]:
    """L2 distances from one image to others (vlad.py:35-51)."""
    if image not in histograms:
        return image, [], []
    distances = []
    others = []
    h = histograms[image]
    for other in other_images:
        if other != image and other in histograms:
            distances.append(float(np.linalg.norm(h - histograms[other])))
            others.append(other)
    return image, distances, others


class VladCache:
    """Centres and per-image VLAD histograms (vlad.py:54-81)."""

    def __init__(self) -> None:
        self._centers: Optional[np.ndarray] = None
        self._histograms: Dict[str, np.ndarray] = {}

    def clear_cache(self) -> None:
        self._centers = None
        self._histograms = {}

    def load_words(self, data, device=None) -> np.ndarray:
        """The centres, by precedence: (1) the dataset's own
        `config["vlad_file"]` (an explicit user override); (2) the dataset's
        trained cache `vlad_vocabulary.npz`, which keeps the neighbour order
        of datasets processed before; (3) the packaged vocabulary where the
        descriptor domain matches it; (4) k-means on `device` over up to
        2,000 descriptors an image, drawn with `default_rng(7)`, then
        cached."""
        if self._centers is None:
            cache = os.path.join(data.data_path, "vlad_vocabulary.npz")
            filename = data.config.get("vlad_file", "")
            local = os.path.join(data.data_path, filename) if filename else ""
            if local and os.path.isfile(local):
                self._centers = np.load(local)["words"].astype(np.float32)
                return self._centers
            pretrained = (
                bow.resolve_vocabulary_path(filename, data)
                if bow.descriptor_domain_matches_packaged_vocab(data.config)
                else None
            )
            if os.path.isfile(cache):
                self._centers = np.load(cache)["words"]
            elif pretrained is not None:
                self._centers = np.load(pretrained)["words"].astype(np.float32)
            else:
                rng = np.random.default_rng(7)
                sample = []
                for image in data.images():
                    fd = data.load_features(image)
                    if fd is None or fd.descriptors is None:
                        continue
                    d = fd.descriptors.astype(np.float32)
                    take = min(len(d), 2000)
                    sample.append(d[rng.choice(len(d), take, replace=False)])
                descriptors = np.concatenate(sample)
                self._centers = kmeans.train_kmeans(descriptors, VLAD_WORDS,
                                                    device=device)
                np.savez_compressed(cache, words=self._centers)
        return self._centers

    def vlad_histogram(self, data, image: str,
                       device=None) -> Optional[np.ndarray]:
        if image not in self._histograms:
            features_data = feature_loader.instance.load_all_data(
                data, image, masked=True
            )
            if features_data is None or features_data.descriptors is None:
                return None
            words = self.load_words(data, device=device)
            v = unnormalized_vlad(
                features_data.descriptors.astype(np.float64), words,
                device=device,
            )
            self._histograms[image] = signed_square_root_normalize(v)
        return self._histograms[image]


instance = VladCache()
