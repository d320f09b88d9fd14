"""Link pairwise matches into multi-view tracks.

Port of `opensfm_tpu.tracking` (reference `opensfm/tracking.py`:
create_tracks_manager:72-150, common_tracks:153, all_common_tracks:202).
Linking takes the native union-find (`opensfm_tpu_torch.native`) when it
builds and the Python `UnionFind` otherwise, as the JAX package does; the
caller can ask which one ran.  The networkx graph views of the reference
(`as_graph`, `as_weighted_graph`) are not ported.  This is host work: no
tensor is made here.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from opensfm_tpu_torch import native, pymap
from opensfm_tpu_torch.pymap import TracksManager
from opensfm_tpu_torch.unionfind import UnionFind

logger = logging.getLogger(__name__)

TPairTracks = Tuple[List[str], np.ndarray, np.ndarray]


def load_features(dataset, images):
    """Per-image features/colors/semantics/depths from a dataset
    (tracking.py:18-53)."""
    features, colors, segmentations, instances, depths = {}, {}, {}, {}, {}
    for im in images:
        features_data = dataset.load_features(im)
        if not features_data:
            continue
        features[im] = features_data.points[:, :3]
        colors[im] = features_data.colors
        semantic = features_data.semantic
        if semantic:
            segmentations[im] = semantic.segmentation
            if semantic.has_instances():
                instances[im] = semantic.instances
        if features_data.depths is not None:
            depths[im] = features_data.depths
    return features, colors, segmentations, instances, depths


def load_matches(dataset, images):
    matches = {}
    for im1 in images:
        try:
            im1_matches = dataset.load_matches(im1)
        except IOError:
            continue
        for im2 in im1_matches:
            if im2 in images:
                matches[im1, im2] = im1_matches[im2]
    return matches


def _good_track(track: List[Tuple[str, int]], min_length: int) -> bool:
    """A track is good if long enough with one observation per image."""
    if len(track) < min_length:
        return False
    images = [image for image, _ in track]
    return len(images) == len(set(images))


def create_tracks_manager(
    features: Dict[str, np.ndarray],
    colors: Dict[str, np.ndarray],
    segmentations: Dict[str, np.ndarray],
    instances: Dict[str, np.ndarray],
    matches: Dict[Tuple[str, str], List[Tuple[int, int]]],
    min_length: int,
    depths: Optional[Dict[str, np.ndarray]] = None,
    depth_is_radial: bool = True,
    depth_std_deviation: float = 1.0,
    report: Optional[Dict[str, str]] = None,
) -> TracksManager:
    """Union-find merge of pairwise matches into tracks
    (tracking.py:72-150).  `report`, when given, gets "linking": "native"
    or "python", the path that linked the tracks."""
    depths = depths or {}
    use_native = bool(matches) and native.available()
    if report is not None:
        report["linking"] = "native" if use_native else "python"
    if use_native:
        tracks = _link_tracks_native(features, matches, min_length)
    else:
        uf = UnionFind()
        for im1, im2 in matches:
            for f1, f2 in matches[im1, im2]:
                uf.union((im1, int(f1)), (im2, int(f2)))
        tracks = [t for t in uf.clusters() if _good_track(t, min_length)]

    tracks_manager = TracksManager()
    num_observations = 0
    for track_id, track in enumerate(tracks):
        for image, feature_id in track:
            if image not in features:
                continue
            x, y, s = features[image][feature_id]
            r, g, b = colors[image][feature_id]
            segmentation = (
                int(segmentations[image][feature_id])
                if image in segmentations
                else pymap.NO_SEMANTIC_VALUE
            )
            instance = (
                int(instances[image][feature_id])
                if image in instances
                else pymap.NO_SEMANTIC_VALUE
            )
            obs = pymap.Observation(
                x, y, s, int(r), int(g), int(b), feature_id, segmentation, instance
            )
            if image in depths:
                depth_value = float(depths[image][feature_id])
                if np.isfinite(depth_value):
                    obs.depth_prior = pymap.Depth(
                        depth_value,
                        depth_is_radial,
                        max(depth_std_deviation * depth_value, depth_std_deviation),
                    )
            tracks_manager.add_observation(image, str(track_id), obs)
            num_observations += 1
    logger.info(
        "%d tracks, %d observations added to TracksManager",
        len(tracks), num_observations,
    )
    return tracks_manager


def _link_tracks_native(
    features: Dict[str, np.ndarray],
    matches: Dict[Tuple[str, str], List[Tuple[int, int]]],
    min_length: int,
) -> List[List[Tuple[str, int]]]:
    """Vectorized track linking through the C++ union-find.

    Nodes are (image, feature) pairs flattened to integers via per-image
    offsets; edges come straight from the match arrays with no Python loop
    over individual correspondences.
    """
    images = sorted({im for pair in matches for im in pair})
    image_index = {im: i for i, im in enumerate(images)}

    # Per-image feature-count bound (features when known, else max matched id).
    counts = np.zeros(len(images), dtype=np.int64)
    for i, im in enumerate(images):
        if im in features:
            counts[i] = len(features[im])
    for (im1, im2), m in matches.items():
        m = np.asarray(m)
        if len(m) == 0:
            continue
        i1, i2 = image_index[im1], image_index[im2]
        counts[i1] = max(counts[i1], int(m[:, 0].max()) + 1)
        counts[i2] = max(counts[i2], int(m[:, 1].max()) + 1)
    offsets = np.zeros(len(images), dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    n_nodes = int(counts.sum())
    if n_nodes == 0:
        return []

    edge_chunks_u, edge_chunks_v = [], []
    for (im1, im2), m in matches.items():
        m = np.asarray(m, dtype=np.int64)
        if len(m) == 0:
            continue
        edge_chunks_u.append(offsets[image_index[im1]] + m[:, 0])
        edge_chunks_v.append(offsets[image_index[im2]] + m[:, 1])
    if not edge_chunks_u:
        return []
    u = np.concatenate(edge_chunks_u)
    v = np.concatenate(edge_chunks_v)

    labels_all, _ = native.union_find_components(u, v, n_nodes)

    nodes = np.unique(np.concatenate([u, v]))
    labels = labels_all[nodes].astype(np.int64)
    img_idx = np.searchsorted(offsets, nodes, side="right") - 1
    feat_idx = nodes - offsets[img_idx]

    # Good track: >= min_length observations, one observation per image.
    sizes = np.bincount(labels)
    pair_key = labels * len(images) + img_idx
    uniq_key, key_counts = np.unique(pair_key, return_counts=True)
    bad = np.zeros(sizes.shape[0], dtype=bool)
    bad[np.unique(uniq_key[key_counts > 1] // len(images))] = True
    keep = (sizes[labels] >= min_length) & ~bad[labels]

    labels, img_idx, feat_idx = labels[keep], img_idx[keep], feat_idx[keep]
    if labels.size == 0:
        return []
    order = np.argsort(labels, kind="stable")
    labels, img_idx, feat_idx = labels[order], img_idx[order], feat_idx[order]
    boundaries = np.flatnonzero(np.diff(labels)) + 1
    tracks: List[List[Tuple[str, int]]] = []
    for grp_img, grp_feat in zip(
        np.split(img_idx, boundaries), np.split(feat_idx, boundaries)
    ):
        tracks.append(
            [(images[i], int(f)) for i, f in zip(grp_img, grp_feat)]
        )
    return tracks


def common_tracks(
    tracks_manager: TracksManager, im1: str, im2: str
) -> TPairTracks:
    """(track ids, points1, points2) for tracks seen in both images
    (tracking.py:153-180)."""
    t1 = tracks_manager.get_shot_observations(im1)
    t2 = tracks_manager.get_shot_observations(im2)
    tracks, p1, p2 = [], [], []
    for track, obs in t1.items():
        if track in t2:
            p1.append(obs.point)
            p2.append(t2[track].point)
            tracks.append(track)
    return tracks, np.array(p1), np.array(p2)


def all_common_tracks_with_features(
    tracks_manager: TracksManager, include_features: bool = True
) -> Dict[Tuple[str, str], TPairTracks]:
    """Common tracks for all image pairs sharing enough tracks
    (tracking.py:202-244)."""
    tracks_in_pairs: Dict[Tuple[str, str], List[Tuple[str, object, object]]] = {}
    for track_id in tracks_manager.get_track_ids():
        obs = tracks_manager.get_track_observations(track_id)
        shots = sorted(obs.keys())
        for i in range(len(shots)):
            for j in range(i + 1, len(shots)):
                key = (shots[i], shots[j])
                tracks_in_pairs.setdefault(key, []).append(
                    (track_id, obs[shots[i]], obs[shots[j]])
                )
    result = {}
    for key, entries in tracks_in_pairs.items():
        tracks = [e[0] for e in entries]
        if include_features:
            p1 = np.array([e[1].point for e in entries])
            p2 = np.array([e[2].point for e in entries])
        else:
            p1 = p2 = np.zeros((0, 2))
        result[key] = (tracks, p1, p2)
    return result


def all_common_tracks_without_features(
    tracks_manager: TracksManager,
) -> Dict[Tuple[str, str], List[str]]:
    return {
        k: v[0]
        for k, v in all_common_tracks_with_features(
            tracks_manager, include_features=False
        ).items()
    }


def all_common_tracks(
    tracks_manager: TracksManager, include_features: bool = True
) -> Dict[Tuple[str, str], TPairTracks]:
    return all_common_tracks_with_features(tracks_manager, include_features)


def _networkx():
    try:
        import networkx
    except ImportError as e:
        raise ImportError("as_graph and as_weighted_graph need networkx, "
                          "which is not installed") from e
    return networkx


def as_weighted_graph(tracks_manager: TracksManager):
    """Images as nodes, edges weighted by their common track count (a
    networkx graph; needs networkx)."""
    graph = _networkx().Graph()
    for shot_id in tracks_manager.get_shot_ids():
        graph.add_node(shot_id, bipartite=0)
    connectivity = tracks_manager.get_all_pairs_connectivity()
    for (im1, im2), size in connectivity.items():
        graph.add_edge(im1, im2, weight=size)
    return graph


def as_graph(tracks_manager: TracksManager):
    """The bipartite images-tracks graph, each edge carrying its
    observation (a networkx graph; needs networkx)."""
    graph = _networkx().Graph()
    for track_id in tracks_manager.get_track_ids():
        graph.add_node(track_id, bipartite=1)
    for shot_id in tracks_manager.get_shot_ids():
        graph.add_node(shot_id, bipartite=0)
    for track_id in tracks_manager.get_track_ids():
        for im, obs in tracks_manager.get_track_observations(track_id).items():
            graph.add_edge(
                im, track_id,
                feature=obs.point, feature_scale=obs.scale,
                feature_id=obs.id, feature_color=obs.color,
                feature_segmentation=obs.segmentation,
                feature_instance=obs.instance,
            )
    return graph
