"""Feature extraction harness: read images, detect, mask, save.

Port of `opensfm_tpu.features_processing` (reference
`opensfm/features_processing.py:48-344`): a producer thread decodes images
(a bounded queue of 4) while the detector runs on the device, one image at
a time on one stream, as in the JAX package.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, List

import numpy as np

from opensfm_tpu_torch import bow, features, resolve_device
from opensfm_tpu_torch.features import SemanticData
from opensfm_tpu_torch.io import UnsupportedImage

logger = logging.getLogger(__name__)


def run_features_processing(data, images: List[str], force: bool,
                            device=None) -> Dict[str, Any]:
    """Extract features for all images (features_processing.py:48-109) on
    `device` (CUDA unless told otherwise).  Returns a report: per image,
    the seconds spent waiting for its decode and detecting it, and its
    feature count; where the WORDS matcher or BoW pair selection needs
    words, the seconds of each image's word assignment ("words")."""
    device = resolve_device(device)
    need_words = (
        data.config.get("matcher_type", "").upper() == "WORDS"
        or data.config.get("matching_bow_neighbors", 0) > 0
    )
    report: Dict[str, Any] = {"device": str(device), "images": {}}
    to_process = [
        im for im in images if force or not data.features_exist(im)
    ]
    if not to_process:
        logger.info("All features already extracted.")
        if need_words:
            report["words"] = _assign_words(data, images, force, device)
        return report

    read_queue: "queue.Queue" = queue.Queue(maxsize=4)

    def producer() -> None:
        for image in to_process:
            try:
                array = data.load_image(image)
            except (ImportError, UnsupportedImage) as e:
                # A format this host cannot decode fails the command; an
                # unreadable file is skipped, as in the JAX package.
                read_queue.put((image, e))
                return
            except Exception as e:
                logger.error("Failed loading %s: %s", image, e)
                array = None
            read_queue.put((image, array))
        read_queue.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    processed = 0
    while True:
        t0 = time.perf_counter()
        item = read_queue.get()
        if item is None:
            break
        image, array = item
        if isinstance(array, Exception):
            thread.join()
            raise array
        if array is None:
            continue
        t1 = time.perf_counter()
        n = detect(data, image, array, device=device)
        report["images"][image] = dict(
            wait_s=t1 - t0, detect_s=time.perf_counter() - t1, features=n)
        processed += 1
        logger.info("Extracted features for %s (%d/%d)", image, processed,
                    len(to_process))
    thread.join()

    if need_words:
        report["words"] = _assign_words(data, images, force, device)
    return report


def _assign_words(data, images: List[str], force: bool,
                  device=None) -> Dict[str, float]:
    """Assign each image's descriptors to their `bow_words_to_match`
    closest vocabulary words (features_processing.py:269-336): a second
    pass once every image has features, one image's descriptors a search
    on `device`, against the vocabulary of `bow.load_vocabulary`.  Returns
    the seconds spent on each image (its load, search and save)."""
    to_assign = [im for im in images if force or not data.words_exist(im)]
    seconds: Dict[str, float] = {}
    if not to_assign:
        return seconds
    bows = bow.load_vocabulary(data, device=device)
    n_closest = data.config.get("bow_words_to_match", 50)
    for image in to_assign:
        t0 = time.perf_counter()
        fd = data.load_features(image)
        if fd is None or fd.descriptors is None:
            continue
        words = bows.map_to_words(
            fd.descriptors, n_closest,
            data.config.get("bow_matcher_type", "FLANN"), device=device,
        )
        data.save_words(image, words)
        seconds[image] = time.perf_counter() - t0
        logger.info("Assigned %d-closest words for %s", n_closest, image)
    return seconds


def detect(data, image: str, image_array: np.ndarray, device=None) -> int:
    """Detect features for one image, apply masks, sort by scale, save
    (features_processing.py:259-344); returns the number saved."""
    config = data.config
    exif = data.load_exif(image) if data.exif_exists(image) else {}
    is_panorama = exif.get("projection_type") in ("equirectangular", "spherical")

    features_data = features.extract_features(image_array, config,
                                              is_panorama, device=device)

    # Bake segmentation if requested and available.
    if config.get("features_bake_segmentation"):
        segmentation = data.load_segmentation(image)
        instances = data.load_instances(image)
        if segmentation is not None:
            px = features.denormalized_image_coordinates(
                features_data.points[:, :2],
                segmentation.shape[1], segmentation.shape[0],
            )
            xs = np.clip(px[:, 0].astype(int), 0, segmentation.shape[1] - 1)
            ys = np.clip(px[:, 1].astype(int), 0, segmentation.shape[0] - 1)
            seg_values = segmentation[ys, xs]
            inst_values = instances[ys, xs] if instances is not None else None
            features_data.semantic = SemanticData(
                seg_values, inst_values, data.segmentation_labels()
            )

    # Apply the binary mask.
    mask = data.load_features_mask(image, features_data.points[:, :2])
    if mask is not None and len(mask) == len(features_data.points):
        features_data = features_data.mask(mask)

    # Sort by decreasing scale (features_processing.py:314-318).
    if len(features_data.points):
        order = np.argsort(-features_data.points[:, 2])
        features_data = features_data.mask(order)

    data.save_features(image, features_data)
    return len(features_data.points)

