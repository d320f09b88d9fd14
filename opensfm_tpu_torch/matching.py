"""Pairwise descriptor matching + robust geometric filtering.

Port of `opensfm_tpu.matching` (OpenSfM matching.py: match_images:28,
match_images_with_pairs:63, match_descriptors:219,
_match_descriptors_guided_impl:260, _match_descriptors_impl:341,
match_robust:463, match:563-634, match_words:637, robust_match:906,
robust_match_fundamental:780, robust_match_calibrated:871,
apply_adhoc_filters:939, unfilter_matches:932).

Every matcher type runs the exact top-2 search of `ops/matching` on
`device` (the CUDA kernel on the card):
  FLANN / BRUTEFORCE -> exact search over all candidates,
  WORDS              -> exact search restricted by the word-compatibility
                        mask (the semantics of pyfeatures match_using_words),
  guided             -> exact mutual search restricted by the epipolar-angle
                        mask from the pair's relative pose, built on
                        `device` in float64.
Batched RANSAC on `device` filters the matches.  `device=None` is cuda
(`resolve_device`) for the search and RANSAC alike.
"""

from __future__ import annotations

import logging
from timeit import default_timer as timer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import (feature_loader, pairs_selection, resolve_device,
                               robust)
from opensfm_tpu_torch.geometry.triangulation import (
    epipolar_angle_two_bearings_many,
)
from opensfm_tpu_torch.ops.matching import (
    match_brute_force,
    match_brute_force_symmetric,
    word_compatibility_mask,
)

logger = logging.getLogger(__name__)


def clear_cache() -> None:
    feature_loader.instance.clear_cache()


def match_images(
    data, config_override: Dict[str, Any],
    ref_images: List[str], cand_images: List[str], device=None,
) -> Tuple[Dict[Tuple[str, str], Any], Dict[str, Any]]:
    """Candidate selection + matching for ref x cand images
    (matching.py:28-60)."""
    all_images = list(set(ref_images + cand_images))
    exifs = {im: data.load_exif(im) for im in all_images}
    pairs, preport = pairs_selection.match_candidates_from_metadata(
        ref_images, cand_images, exifs, data, config_override, device=device
    )
    logger.info(
        "Matching %d image pairs (%d ref images)", len(pairs), len(ref_images)
    )
    matches = match_images_with_pairs(data, config_override, exifs, pairs,
                                      device=device)
    return matches, preport


def match_images_with_pairs(
    data, config_override: Dict[str, Any],
    exifs: Dict[str, Any], pairs: List[Tuple[str, str]],
    poses: Optional[Dict[Tuple[str, str], Any]] = None, device=None,
) -> Dict[Tuple[str, str], Any]:
    """Match the given pairs (matching.py:63-130); `poses` maps a pair to
    the relative pose of its second camera from its first, which restricts
    that pair's search to epipolar-consistent candidates (guided
    matching)."""
    config = dict(data.config)
    config.update(config_override)
    cameras = data.load_camera_models()

    matches_per_pair = {}
    start = timer()
    for i, (im1, im2) in enumerate(pairs):
        camera1 = cameras[exifs[im1]["camera"]]
        camera2 = cameras[exifs[im2]["camera"]]
        pose = poses.get((im1, im2)) if poses else None
        matches = match(im1, im2, camera1, camera2, data, config, pose,
                        device=device)
        matches_per_pair[im1, im2] = matches
        if (i + 1) % 50 == 0:
            logger.info("Matched %d / %d pairs", i + 1, len(pairs))
    logger.info(
        "Matched %d pairs in %.1f seconds", len(pairs), timer() - start
    )
    return matches_per_pair


def save_matches(data, images_ref: List[str], matched_pairs) -> None:
    """Group per-pair matches by first image and save (matching.py:132-160)."""
    matches_per_im1: Dict[str, Dict[str, np.ndarray]] = {
        im: {} for im in images_ref
    }
    for (im1, im2), m in matched_pairs.items():
        matches_per_im1[im1][im2] = np.asarray(m)
    for im1, im1_matches in matches_per_im1.items():
        data.save_matches(im1, im1_matches)


# ---------------------------------------------------------------------------
# Descriptor matching
# ---------------------------------------------------------------------------


def _load_pair_descriptors(data, im1: str, im2: str, config=None):
    # matching_use_segmentation appends the weighted segmentation-label
    # column to both descriptor matrices (feature_loading.py:16-24,111 in
    # OpenSfM), so cross-class candidates lose every top-2 ranking.
    seg = bool(config.get("matching_use_segmentation", False)) if config else False
    fd1 = feature_loader.instance.load_features_index(
        data, im1, masked=True, segmentation_in_descriptor=seg
    )
    fd2 = feature_loader.instance.load_features_index(
        data, im2, masked=True, segmentation_in_descriptor=seg
    )
    if fd1 is None or fd2 is None:
        return None
    features1, d1 = fd1
    features2, d2 = fd2
    if len(features1.points) < 2 or len(features2.points) < 2:
        return None
    return features1, d1, features2, d2


def _match_descriptors_impl(
    im1: str, im2: str, camera1, camera2, data, config: Dict[str, Any],
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
    """Descriptor matching with matcher_type dispatch + adhoc filters
    (matching.py:341-460)."""
    dummy = np.zeros((0, 2))
    matcher_type = str(config.get("matcher_type", "FLANN")).upper()
    loaded = _load_pair_descriptors(data, im1, im2, config)
    if loaded is None:
        return dummy, dummy, np.zeros((0, 2), dtype=int), matcher_type
    features1, d1, features2, d2 = loaded

    symmetric = config.get("symmetric_matching", True)
    ratio = config.get("lowes_ratio", 0.8)

    if matcher_type == "WORDS":
        words1 = feature_loader.instance.load_words(data, im1, masked=True)
        words2 = feature_loader.instance.load_words(data, im2, masked=True)
        if words1 is None or words2 is None:
            return dummy, dummy, np.zeros((0, 2), dtype=int), matcher_type
        words_fn = match_words_symmetric if symmetric else match_words
        matches = words_fn(d1, words1, d2, words2, config, device=device)
    elif matcher_type in ("FLANN", "BRUTEFORCE"):
        # Both route to the exact matcher; "FLANN" keeps its config name only.
        matches = match_brute_force_symmetric(d1, d2, ratio, symmetric,
                                              device=device)
    else:
        raise ValueError(f"Invalid matcher_type: {matcher_type}")

    if config.get("matching_use_filters", False):
        matches = apply_adhoc_filters(
            data, matches, im1, camera1, features1.points,
            im2, camera2, features2.points,
        )
    return (
        features1.points, features2.points,
        np.asarray(matches, dtype=int).reshape(-1, 2), matcher_type,
    )


def _match_descriptors_guided_impl(
    im1: str, im2: str, camera1, camera2, relative_pose, data,
    config: Dict[str, Any], device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
    """Guided matching: mutual exact search restricted to the candidates
    within `guided_matching_threshold` of the epipolar geometry of the
    pair's relative pose (matching.py:260-338)."""
    dummy = np.zeros((0, 2))
    matcher_type = "BRUTEFORCE"
    loaded = _load_pair_descriptors(data, im1, im2, config)
    if loaded is None:
        return dummy, dummy, np.zeros((0, 2), dtype=int), matcher_type
    features1, d1, features2, d2 = loaded

    b1 = feature_loader.instance.load_bearings(
        data, im1, masked=True, camera=camera1
    )
    b2 = feature_loader.instance.load_bearings(
        data, im2, masked=True, camera=camera2
    )
    if b1 is None or b2 is None:
        return dummy, dummy, np.zeros((0, 2), dtype=int), matcher_type

    epipolar_mask = compute_inliers_bearing_epipolar(
        b1, b2, relative_pose, config.get("guided_matching_threshold", 0.006),
        device=device,
    )
    ratio = config.get("lowes_ratio", 0.8)
    matches = match_brute_force_symmetric(
        d1, d2, ratio, symmetric=True, mask12=epipolar_mask, device=device
    )

    if config.get("matching_use_filters", False):
        matches = apply_adhoc_filters(
            data, matches, im1, camera1, features1.points,
            im2, camera2, features2.points,
        )
    return (
        features1.points, features2.points,
        np.asarray(matches, dtype=int).reshape(-1, 2), matcher_type,
    )


def compute_inliers_bearing_epipolar(
    b1: np.ndarray, b2: np.ndarray, pose, threshold: float, device=None,
) -> torch.Tensor:
    """[N1, N2] bool mask on `device` (CUDA unless told otherwise) of the
    bearing pairs whose symmetric epipolar angle under `pose` (cam1 to cam2,
    relative) is below `threshold` (matching.py:847-869), in float64."""
    dev = resolve_device(device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    angles = epipolar_angle_two_bearings_many(
        f64(b1), f64(b2), f64(pose.get_rotation_matrix()),
        f64(pose.translation))
    return angles < threshold


def match_words(
    d1: np.ndarray, words1: np.ndarray, d2: np.ndarray, words2: np.ndarray,
    config: Dict[str, Any], device=None,
) -> np.ndarray:
    """WORDS matching: exact search restricted to word-compatible candidates
    (matching.py:637-656; pyfeatures match_using_words)."""
    ratio = config.get("lowes_ratio", 0.8)
    num_checks = config.get("bow_num_checks", 20)
    mask12 = word_compatibility_mask(words1, words2, num_checks, device)
    return match_brute_force(d1, d2, ratio, mask12=mask12, device=device)


def match_words_symmetric(
    d1: np.ndarray, words1: np.ndarray, d2: np.ndarray, words2: np.ndarray,
    config: Dict[str, Any], device=None,
) -> np.ndarray:
    """Mutual WORDS matching (matching.py:659-680)."""
    ratio = config.get("lowes_ratio", 0.8)
    num_checks = config.get("bow_num_checks", 20)
    mask12 = word_compatibility_mask(words1, words2, num_checks, device)
    mask21 = word_compatibility_mask(words2, words1, num_checks, device)
    return match_brute_force_symmetric(
        d1, d2, ratio, symmetric=True, mask12=mask12, mask21=mask21,
        device=device,
    )


def match_descriptors(
    im1: str, im2: str, camera1, camera2, data,
    config_override: Dict[str, Any], device=None,
) -> np.ndarray:
    """Descriptor matching only, indices remapped to the unmasked feature
    set (matching.py:219-257)."""
    config = dict(data.config)
    config.update(config_override)
    _, _, matches, _ = _match_descriptors_impl(
        im1, im2, camera1, camera2, data, config, device=device
    )
    m1 = feature_loader.instance.load_mask(data, im1)
    m2 = feature_loader.instance.load_mask(data, im2)
    if m1 is not None and m2 is not None:
        matches = unfilter_matches(matches, m1, m2)
    return np.asarray(matches, dtype=int).reshape(-1, 2)


def match_robust(
    im1: str, im2: str, matches, camera1, camera2, data,
    config_override: Dict[str, Any], input_is_masked: bool = True,
    device=None,
) -> np.ndarray:
    """Robust geometric filtering of precomputed descriptor matches
    (matching.py:463-543)."""
    config = dict(data.config)
    config.update(config_override)
    fd1 = feature_loader.instance.load_all_data(data, im1, masked=input_is_masked)
    fd2 = feature_loader.instance.load_all_data(data, im2, masked=input_is_masked)
    if fd1 is None or fd2 is None or len(fd1.points) < 2 or len(fd2.points) < 2:
        return np.zeros((0, 2), dtype=int)
    np_matches = np.asarray(matches, dtype=int).reshape(-1, 2)
    rmatches = robust_match(
        fd1.points, fd2.points, camera1, camera2, np_matches, config,
        device=device,
    )
    rmatches = np.asarray(rmatches, dtype=int).reshape(-1, 2)
    if input_is_masked:
        m1 = feature_loader.instance.load_mask(data, im1)
        m2 = feature_loader.instance.load_mask(data, im2)
        if m1 is not None and m2 is not None:
            rmatches = unfilter_matches(rmatches, m1, m2)
    if len(rmatches) < config.get("robust_matching_min_match", 20):
        return np.zeros((0, 2), dtype=int)
    return np.asarray(rmatches, dtype=int).reshape(-1, 2)


def match(
    im1: str, im2: str, camera1, camera2, data, config: Dict[str, Any],
    guided_matching_pose=None, device=None,
) -> np.ndarray:
    """Descriptor matching + robust geometric filter for one pair
    (matching.py:563-634)."""
    time_start = timer()

    if guided_matching_pose is not None:
        p1, p2, matches, matcher_type = _match_descriptors_guided_impl(
            im1, im2, camera1, camera2, guided_matching_pose, data, config,
            device=device,
        )
    else:
        p1, p2, matches, matcher_type = _match_descriptors_impl(
            im1, im2, camera1, camera2, data, config, device=device
        )
    time_2d = timer()

    min_matches = config.get("robust_matching_min_match", 20)
    if len(matches) < min_matches:
        logger.debug(
            "Matching %s and %s.  Matcher: %s (%d matches) FAILED",
            im1, im2, matcher_type, len(matches),
        )
        return np.zeros((0, 2), dtype=int)

    rmatches = robust_match(p1, p2, camera1, camera2, matches, config,
                            device=device)
    rmatches = np.asarray(rmatches, dtype=int).reshape(-1, 2)
    time_robust = timer()

    if len(rmatches) < min_matches:
        return np.zeros((0, 2), dtype=int)

    logger.debug(
        "Matching %s and %s.  Matcher: %s (%d) T-desc: %.3f "
        "Robust: (%d) T-robust: %.3f",
        im1, im2, matcher_type, len(matches), time_2d - time_start,
        len(rmatches), time_robust - time_2d,
    )
    return rmatches


# ---------------------------------------------------------------------------
# Robust geometric filters
# ---------------------------------------------------------------------------


def _all_undistorted_perspective(cameras) -> bool:
    """F-RANSAC applies only to undistorted perspective/brown pairs
    (robust_match, matching.py:906-929)."""
    for camera in cameras:
        if camera.projection_type not in ("perspective", "brown"):
            return False
        if abs(camera.k1) > 1e-8 or abs(camera.k2) > 1e-8:
            return False
    return True


def robust_match(
    p1: np.ndarray, p2: np.ndarray, camera1, camera2,
    matches: np.ndarray, config: Dict[str, Any], device=None,
) -> np.ndarray:
    """F-RANSAC for undistorted perspective pairs, E-RANSAC otherwise."""
    if len(matches) == 0:
        return matches
    if _all_undistorted_perspective([camera1, camera2]):
        return robust_match_fundamental(p1, p2, matches, config,
                                        device=device)[1]
    return robust_match_calibrated(p1, p2, camera1, camera2, matches, config,
                                   device=device)


def robust_match_fundamental(
    p1: np.ndarray, p2: np.ndarray, matches: np.ndarray,
    config: Dict[str, Any], device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Filter with fundamental matrix RANSAC (matching.py:780-845)."""
    threshold = config["robust_matching_threshold"]
    x1 = p1[matches[:, 0], :2]
    x2 = p2[matches[:, 1], :2]
    result = robust.ransac_fundamental(x1, x2, threshold, iterations=1000,
                                       device=device)
    if result.model is None or result.num_inliers < 8:
        return np.zeros((3, 3)), np.zeros((0, 2), dtype=int)
    return np.asarray(result.model), matches[result.inliers_indices]


def robust_match_calibrated(
    p1: np.ndarray, p2: np.ndarray, camera1, camera2,
    matches: np.ndarray, config: Dict[str, Any], device=None,
) -> np.ndarray:
    """Filter with essential matrix RANSAC on bearings
    (matching.py:871-903)."""
    threshold = config["robust_matching_calib_threshold"]
    b1 = camera1.bearings_many(p1[matches[:, 0], :2])
    b2 = camera2.bearings_many(p2[matches[:, 1], :2])
    result = robust.ransac_essential(b1, b2, threshold, iterations=1000,
                                     device=device)
    if result.model is None:
        return np.zeros((0, 2), dtype=int)
    return matches[result.inliers_indices]


def unfilter_matches(matches, m1, m2) -> np.ndarray:
    """Remap masked-feature indices to full-feature indices
    (matching.py:932-938)."""
    if len(matches) == 0:
        return np.zeros((0, 2), dtype=int)
    i1 = np.flatnonzero(m1)
    i2 = np.flatnonzero(m2)
    matches = np.asarray(matches, dtype=int)
    return np.column_stack([i1[matches[:, 0]], i2[matches[:, 1]]])


# ---------------------------------------------------------------------------
# Adhoc static-content filters (matching.py:939-1067)
# ---------------------------------------------------------------------------


def apply_adhoc_filters(
    data, matches, im1: str, camera1, p1: np.ndarray,
    im2: str, camera2, p2: np.ndarray,
) -> np.ndarray:
    """Remove matches on likely-static content: identical positions,
    panorama poles, known camera watermarks (matching.py:939-958)."""
    matches = np.asarray(matches, dtype=int).reshape(-1, 2)
    matches = _non_static_matches(p1, p2, matches)
    matches = _not_on_pano_poles_matches(p1, p2, matches, camera1, camera2)
    matches = _not_on_vermont_watermark(p1, p2, matches, im1, im2, data)
    matches = _not_on_blackvue_watermark(p1, p2, matches, im1, im2, data)
    return matches


def _non_static_matches(
    p1: np.ndarray, p2: np.ndarray, matches: np.ndarray
) -> np.ndarray:
    """Drop matches with (near-)identical normalized positions — rig
    occluders, watermarks, dust — unless that would discard an almost
    entirely static image (matching.py:960-980)."""
    if len(matches) == 0:
        return matches
    threshold = 0.001
    d = p1[matches[:, 0], :2] - p2[matches[:, 1], :2]
    keep = (d[:, 0] ** 2 + d[:, 1] ** 2) >= threshold**2
    static_ratio_threshold = 0.85
    removed_ratio = 1.0 - keep.sum() / max(len(matches), 1)
    if removed_ratio > static_ratio_threshold:
        return matches
    return matches[keep]


def _not_on_pano_poles_matches(
    p1: np.ndarray, p2: np.ndarray, matches: np.ndarray, camera1, camera2
) -> np.ndarray:
    """Drop matches near the top/bottom of panoramas — sky and carhood
    (matching.py:983-1007)."""
    if len(matches) == 0:
        return matches
    min_lat, max_lat = -0.125, 0.125
    pano_types = ("spherical", "equirectangular", "dual")
    is_pano1 = camera1.projection_type in pano_types
    is_pano2 = camera2.projection_type in pano_types
    if not (is_pano1 or is_pano2):
        return matches
    keep = np.ones(len(matches), dtype=bool)
    if is_pano1:
        y1 = p1[matches[:, 0], 1]
        keep &= (y1 > min_lat) & (y1 < max_lat)
    if is_pano2:
        y2 = p2[matches[:, 1], 1]
        keep &= (y2 > min_lat) & (y2 < max_lat)
    return matches[keep]


def _not_on_vermont_watermark(
    p1: np.ndarray, p2: np.ndarray, matches: np.ndarray,
    im1: str, im2: str, data,
) -> np.ndarray:
    """Filter the VTrans_Camera watermark region: keep y > -0.255
    (matching.py:1010-1035)."""
    if len(matches) == 0:
        return matches
    meta1 = data.load_exif(im1)
    meta2 = data.load_exif(im2)
    if (
        meta1.get("make") == "VTrans_Camera"
        and meta1.get("model") == "VTrans_Camera"
    ):
        matches = matches[p1[matches[:, 0], 1] > -0.255]
    if len(matches) and (
        meta2.get("make") == "VTrans_Camera"
        and meta2.get("model") == "VTrans_Camera"
    ):
        matches = matches[p2[matches[:, 1], 1] > -0.255]
    return matches


def _not_on_blackvue_watermark(
    p1: np.ndarray, p2: np.ndarray, matches: np.ndarray,
    im1: str, im2: str, data,
) -> np.ndarray:
    """Filter the Blackvue watermark region: keep y < 0.263 (matching.py:
    1038-1067)."""
    if len(matches) == 0:
        return matches
    meta1 = data.load_exif(im1)
    meta2 = data.load_exif(im2)
    if str(meta1.get("make", "")).lower() == "blackvue":
        matches = matches[p1[matches[:, 0], 1] < 0.263]
    if len(matches) and str(meta2.get("make", "")).lower() == "blackvue":
        matches = matches[p2[matches[:, 1], 1] < 0.263]
    return matches
