"""Candidate pair prefiltering: GPS distance, Delaunay graph, time, order,
BoW and VLAD similarity.

Port of `opensfm_tpu.pairs_selection` (OpenSfM pairs_selection.py:
match_candidates_from_metadata:581-687, by_distance:154, by_graph:220,
by_time:526, by_order:562, with_bow:285, with_vlad:351,
preempt_candidates:433, ordered_pairs:798): host code in numpy and scipy,
but for the word assignment and VLAD aggregation of `bow` and `vlad`,
which run on the device.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Any, Dict, List, Set, Tuple

import numpy as np

from opensfm_tpu_torch import bow, feature_loader, vlad

logger = logging.getLogger(__name__)


def has_gps_info(exif: Dict[str, Any]) -> bool:
    return bool(
        exif and "gps" in exif
        and "latitude" in exif["gps"] and "longitude" in exif["gps"]
    )


def sorted_pair(im1: str, im2: str) -> Tuple[str, str]:
    return (im1, im2) if im1 < im2 else (im2, im1)


def ordered_pairs(
    pairs: Set[Tuple[str, str]], images_ref: List[str]
) -> List[Tuple[str, str]]:
    """Orient pairs so the first element is a ref image
    (pairs_selection.py:798-825)."""
    per_image = defaultdict(list)
    for im1, im2 in pairs:
        per_image[im1].append(im2)
        per_image[im2].append(im1)

    ordered: Set[Tuple[str, str]] = set()
    remaining = set(images_ref)
    if len(remaining) > 0:
        next_image = remaining.pop()
        while next_image:
            im1 = next_image
            for im2 in per_image[im1]:
                if (im2, im1) not in ordered:
                    ordered.add((im1, im2))
            next_image = remaining.pop() if remaining else None
    return list(ordered)


def get_gps_point(
    exif: Dict[str, Any], reference
) -> Tuple[np.ndarray, np.ndarray]:
    """GPS representative point + vertical viewing direction
    (pairs_selection.py:35-46)."""
    gps = exif["gps"]
    direction = np.array([0.0, 0.0, 1.0])
    return (
        np.array(
            reference.to_topocentric(gps["latitude"], gps["longitude"], 0)
        ),
        direction,
    )


DEFAULT_Z = 1.0
MAXIMUM_Z = 8000
SAMPLE_Z = 100


def _sign(x: float) -> float:
    return 1.0 if x > 0.0 else -1.0


def get_gps_opk_point(
    exif: Dict[str, Any], reference
) -> Tuple[np.ndarray, np.ndarray]:
    """GPS position + OPK-derived viewing direction, homogenized to z = 1
    (pairs_selection.py:58-74)."""
    import math

    from opensfm_tpu_torch.geometry.angles import rotation_from_opk

    opk = exif["opk"]
    omega, phi, kappa = (
        math.radians(opk["omega"]),
        math.radians(opk["phi"]),
        math.radians(opk["kappa"]),
    )
    R_camera = np.asarray(rotation_from_opk(omega, phi, kappa))
    z_axis = R_camera[2]
    origin, _ = get_gps_point(exif, reference)
    return origin, z_axis / (_sign(z_axis[2]) * z_axis[2]) * DEFAULT_Z


def find_best_altitude(
    origin: Dict[str, np.ndarray], directions: Dict[str, np.ndarray]
) -> float:
    """Altitude minimizing the XY bounding box of the projected points:
    sample every SAMPLE_Z, regress a parabola, take its extremum
    (pairs_selection.py:77-105)."""
    directions_base = np.array(list(directions.values()))
    origin_base = np.array(list(origin.values()))

    samples_x, samples_y = [], []
    for current_z in range(1, MAXIMUM_Z, SAMPLE_Z):
        scaled = origin_base + directions_base / DEFAULT_Z * current_z
        current_size = (
            (np.max(scaled[:, 0]) - np.min(scaled[:, 0])) ** 2
            + (np.max(scaled[:, 1]) - np.min(scaled[:, 1])) ** 2
        )
        samples_x.append(current_z)
        samples_y.append(current_size)

    coeffs = np.polyfit(samples_x, samples_y, 2)
    extrema = -coeffs[1] / (2 * coeffs[0])
    if extrema < 0:
        logger.info(
            "Altitude is negative (%s): viewing directions are probably "
            "divergent; using default altitude %s", extrema, DEFAULT_Z,
        )
        extrema = DEFAULT_Z
    return extrema


def get_representative_points(
    images: List[str], exifs: Dict[str, Any], reference
) -> Dict[str, np.ndarray]:
    """Topocentric point per image for distance-based pair selection: raw
    GPS, or GPS pushed along the viewing direction to the common ground
    altitude when orientation (OPK) tags exist
    (pairs_selection.py:108-151)."""
    origin: Dict[str, np.ndarray] = {}
    directions: Dict[str, np.ndarray] = {}
    had_orientation = False
    for image in images:
        exif = exifs[image]
        gps = exif.get("gps", {})
        if "latitude" not in gps or "longitude" not in gps:
            continue
        if "opk" in exif:
            had_orientation = True
            origin[image], directions[image] = get_gps_opk_point(
                exif, reference
            )
        else:
            origin[image], directions[image] = get_gps_point(exif, reference)

    if had_orientation:
        altitude = find_best_altitude(origin, directions)
        logger.info("Altitude for orientation based matching %s", altitude)
        return {
            k: origin[k] + directions[k] / DEFAULT_Z * altitude
            for k in origin
        }
    return origin


def _gps_positions(
    images: List[str], exifs: Dict[str, Any], reference
) -> Dict[str, np.ndarray]:
    return get_representative_points(images, exifs, reference)


def match_candidates_by_distance(
    images_ref: List[str], images_cand: List[str],
    exifs: Dict[str, Any], reference,
    max_neighbors: int, max_distance: float,
) -> Set[Tuple[str, str]]:
    """GPS-nearby pairs via cKDTree (pairs_selection.py:154-212)."""
    from scipy import spatial

    if max_neighbors <= 0 and max_distance <= 0:
        return set()
    max_neighbors = max_neighbors or 99999999
    max_distance = max_distance or 99999999.0
    k = min(len(images_cand), max_neighbors + 1)
    if k <= 1:
        return set()

    pos_ref = _gps_positions(images_ref, exifs, reference)
    pos_cand = _gps_positions(images_cand, exifs, reference)
    cand_names = list(pos_cand.keys())
    points = np.array([pos_cand[c] for c in cand_names])
    tree = spatial.cKDTree(points)

    pairs = set()
    for im_ref, p in pos_ref.items():
        distances, neighbors = tree.query(
            p, k=k, distance_upper_bound=max_distance
        )
        if k == 1:
            distances, neighbors = [distances], [neighbors]
        for d, j in zip(np.atleast_1d(distances), np.atleast_1d(neighbors)):
            if j >= len(cand_names):
                continue
            im_cand = cand_names[j]
            if im_cand != im_ref:
                pairs.add(sorted_pair(im_ref, im_cand))
    return pairs


def match_candidates_by_graph(
    images_ref: List[str], images_cand: List[str],
    exifs: Dict[str, Any], reference, rounds: int,
) -> Set[Tuple[str, str]]:
    """Jittered-Delaunay rounds over GPS positions
    (pairs_selection.py:220-282)."""
    if len(images_ref) < 4 or rounds < 1:
        return set()
    from scipy import spatial

    images = sorted(set(images_ref + images_cand))
    positions = _gps_positions(images, exifs, reference)
    points = np.array([positions[im][:2] for im in images])

    pairs = set()
    rng = np.random.default_rng(42)
    scale = max(np.std(points, axis=0).max(), 1e-6)
    for r in range(rounds):
        jitter = rng.normal(0, 0.01 * scale, points.shape) if r else 0.0
        try:
            tri = spatial.Delaunay(points + jitter)
        except Exception:
            continue
        for simplex in tri.simplices:
            for i in range(3):
                for j in range(i + 1, 3):
                    a, b = images[simplex[i]], images[simplex[j]]
                    if a != b:
                        pairs.add(sorted_pair(a, b))
    return pairs


def match_candidates_by_time(
    images_ref: List[str], images_cand: List[str],
    exifs: Dict[str, Any], max_neighbors: int,
) -> Set[Tuple[str, str]]:
    """Capture-time neighbors (pairs_selection.py:526-559)."""
    if max_neighbors <= 0:
        return set()
    images = sorted(set(images_ref + images_cand))
    times = np.array([[exifs[im].get("capture_time", 0.0)] for im in images])
    from scipy import spatial

    tree = spatial.cKDTree(times)
    k = min(len(images), max_neighbors + 1)
    pairs = set()
    for i, im_ref in enumerate(images):
        if im_ref not in images_ref:
            continue
        _, neighbors = tree.query(times[i], k=k)
        for j in np.atleast_1d(neighbors):
            if j < len(images) and images[j] != im_ref:
                pairs.add(sorted_pair(im_ref, images[j]))
    return pairs


def match_candidates_by_order(
    images_ref: List[str], images_cand: List[str], max_neighbors: int
) -> Set[Tuple[str, str]]:
    """Filename-order neighbors (pairs_selection.py:562-578)."""
    if max_neighbors <= 0:
        return set()
    images = sorted(set(images_ref + images_cand))
    pairs = set()
    for i, im in enumerate(images):
        if im not in images_ref:
            continue
        a = max(0, i - max_neighbors)
        b = min(len(images), i + max_neighbors + 1)
        for j in range(a, b):
            if images[j] != im:
                pairs.add(sorted_pair(im, images[j]))
    return pairs


def preempt_candidates(
    images_ref: List[str], images_cand: List[str],
    exifs: Dict[str, Any], reference,
    max_gps_neighbors: int, max_gps_distance: float,
):
    """GPS-preempted candidate set per ref image, and every image whose
    histogram is needed (pairs_selection.py:433)."""
    preempted_cand = {im: images_cand for im in images_ref}
    if max_gps_distance > 0 or max_gps_neighbors > 0:
        gps_pairs = match_candidates_by_distance(
            images_ref, images_cand, exifs, reference,
            max_gps_neighbors, max_gps_distance,
        )
        preempted_cand = defaultdict(list)
        for p in gps_pairs:
            if p[0] in images_ref:
                preempted_cand[p[0]].append(p[1])
            if p[1] in images_ref:
                preempted_cand[p[1]].append(p[0])
    need_load = set(images_ref)
    for cands in preempted_cand.values():
        need_load.update(cands)
    return preempted_cand, need_load


def _closest_by_histogram(
    preempted_cand: Dict[str, List[str]],
    histograms: Dict[str, np.ndarray],
    max_neighbors: int,
    distance_fn,
) -> Set[Tuple[str, str]]:
    """Each ref image paired with its `max_neighbors` candidates closest by
    histogram distance, ties by name."""
    pairs = set()
    for im, cands in preempted_cand.items():
        if im not in histograms:
            continue
        scored = []
        for other in cands:
            if other == im or other not in histograms:
                continue
            scored.append((distance_fn(histograms[im], histograms[other]), other))
        scored.sort()
        for _, other in scored[:max_neighbors]:
            pairs.add(sorted_pair(im, other))
    return pairs


def match_candidates_with_bow(
    data, images_ref, images_cand, exifs, reference,
    max_neighbors, gps_distance, gps_neighbors, other_cameras, device=None,
) -> Set[Tuple[str, str]]:
    """BoW tf-idf similarity neighbours (pairs_selection.py:285-348): each
    image's nearest words on `device`, L1 distances between histograms on
    the host."""
    if max_neighbors <= 0:
        return set()
    preempted_cand, need_load = preempt_candidates(
        images_ref, images_cand, exifs, reference, gps_neighbors, gps_distance
    )
    bag = bow.load_vocabulary(data, device=device)
    histograms = {}
    for im in need_load:
        fd = feature_loader.instance.load_all_data(data, im, masked=True)
        if fd is None or fd.descriptors is None:
            continue
        words = bag.map_to_words(fd.descriptors, 1, device=device)
        histograms[im] = bag.histogram(words)
    return _closest_by_histogram(
        preempted_cand, histograms, max_neighbors,
        lambda a, b: float(np.abs(a - b).sum()),
    )


def match_candidates_with_vlad(
    data, images_ref, images_cand, exifs, reference,
    max_neighbors, gps_distance, gps_neighbors, other_cameras, histograms,
    device=None,
) -> Set[Tuple[str, str]]:
    """VLAD similarity neighbours (pairs_selection.py:351-430): each
    image's VLAD on `device`, L2 distances on the host."""
    if max_neighbors <= 0:
        return set()
    preempted_cand, need_load = preempt_candidates(
        images_ref, images_cand, exifs, reference, gps_neighbors, gps_distance
    )
    hists = dict(histograms)
    for im in need_load:
        if im not in hists:
            h = vlad.instance.vlad_histogram(data, im, device=device)
            if h is not None:
                hists[im] = h
    return _closest_by_histogram(
        preempted_cand, hists, max_neighbors,
        lambda a, b: float(np.linalg.norm(a - b)),
    )


def match_candidates_from_metadata(
    images_ref: List[str], images_cand: List[str],
    exifs: Dict[str, Any], data, config_override: Dict[str, Any],
    device=None,
) -> Tuple[List[Tuple[str, str]], Dict[str, Any]]:
    """Union of all enabled pair-selection strategies
    (pairs_selection.py:581-687); BoW and VLAD run their device steps on
    `device` (CUDA unless told otherwise)."""
    config = dict(data.config)
    config.update(config_override)

    max_distance = config["matching_gps_distance"]
    gps_neighbors = config["matching_gps_neighbors"]
    graph_rounds = config["matching_graph_rounds"]
    time_neighbors = config["matching_time_neighbors"]
    order_neighbors = config["matching_order_neighbors"]
    bow_neighbors = config["matching_bow_neighbors"]
    vlad_neighbors = config["matching_vlad_neighbors"]

    data.init_reference()
    reference = data.load_reference()

    if not all(map(has_gps_info, exifs.values())):
        if gps_neighbors != 0:
            logger.warning(
                "Not all images have GPS info. Disabling matching_gps_neighbors."
            )
        gps_neighbors = 0
        max_distance = 0
        graph_rounds = 0

    images_ref = sorted(images_ref)

    if (
        max_distance == gps_neighbors == time_neighbors == order_neighbors
        == bow_neighbors == vlad_neighbors == graph_rounds == 0
    ):
        d = t = g = o = b = v = set()
        pairs = {
            sorted_pair(i, j)
            for i in images_ref
            for j in images_cand
            if i != j
        }
    else:
        d = match_candidates_by_distance(
            images_ref, images_cand, exifs, reference, gps_neighbors, max_distance
        )
        g = match_candidates_by_graph(
            images_ref, images_cand, exifs, reference, graph_rounds
        )
        t = match_candidates_by_time(images_ref, images_cand, exifs, time_neighbors)
        o = match_candidates_by_order(images_ref, images_cand, order_neighbors)
        b = match_candidates_with_bow(
            data, images_ref, images_cand, exifs, reference,
            bow_neighbors, config["matching_bow_gps_distance"],
            config["matching_bow_gps_neighbors"],
            config["matching_bow_other_cameras"], device=device,
        )
        v = match_candidates_with_vlad(
            data, images_ref, images_cand, exifs, reference,
            vlad_neighbors, config["matching_vlad_gps_distance"],
            config["matching_vlad_gps_neighbors"],
            config["matching_vlad_other_cameras"], {}, device=device,
        )
        pairs = d | g | t | o | set(b) | set(v)

    pairs = ordered_pairs(pairs, images_ref)
    report = {
        "num_pairs_distance": len(d),
        "num_pairs_graph": len(g),
        "num_pairs_time": len(t),
        "num_pairs_order": len(o),
        "num_pairs_bow": len(b),
        "num_pairs_vlad": len(v),
    }
    return pairs, report
