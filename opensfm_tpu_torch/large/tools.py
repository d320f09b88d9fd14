"""Submodel clustering + global alignment.

Port of `opensfm_tpu.large.tools` (reference `opensfm/large/tools.py`:
kmeans:37, add_cluster_neighbors:49, add_camera_constraints_soft:120,
add_camera_constraints_hard:162, add_point_constraints:217,
align_reconstructions:278, apply_transformations:310).  The device math is
the common-track similarity RANSAC of `add_point_constraints`
(`reconstruction.resect_reconstruction`) and the alignment solve
(`ba.alignment`), both on `device` (CUDA unless told otherwise).
"""

from __future__ import annotations

import itertools
import logging
import time
from collections import namedtuple
from typing import Callable, Dict, List

import numpy as np

from opensfm_tpu_torch import align, dataset, multiview, pymap
from opensfm_tpu_torch import reconstruction as orec
from opensfm_tpu_torch.ba.alignment import (
    RARelativeMotionConstraint,
    ReconstructionAlignment,
)
from opensfm_tpu_torch.geometry.pose import _rotvec_to_matrix_np
from opensfm_tpu_torch.large.metadataset import MetaDataSet

logger = logging.getLogger(__name__)

PartialReconstruction = namedtuple("PartialReconstruction", ["submodel_path", "idx"])


def kmeans(samples: np.ndarray, nclusters: int, max_iter: int = 100, attempts: int = 20):
    """GPS position k-means (tools.py:37-46)."""
    from scipy.cluster.vq import kmeans2

    best = None
    rng = np.random.default_rng(42)
    for _ in range(attempts):
        seed = int(rng.integers(0, 2**31 - 1))
        centers, labels = kmeans2(
            samples, nclusters, iter=max_iter, minit="++", seed=seed
        )
        cost = float(
            np.sum((samples - centers[labels]) ** 2)
        )
        if best is None or cost < best[0]:
            best = (cost, labels, centers)
    return best[1], best[2]


def add_cluster_neighbors(
    positions: np.ndarray, labels: np.ndarray, centers: np.ndarray,
    max_distance: float,
) -> List[List[int]]:
    """Grow each cluster with nearby images (tools.py:49-70)."""
    clusters = []
    for label in np.arange(centers.shape[0]):
        cluster_indices = np.where(labels == label)[0]
        cluster_positions = positions[cluster_indices]
        other_indices = np.where(labels != label)[0]
        cluster = list(cluster_indices)
        for i in other_indices:
            distances = np.linalg.norm(
                cluster_positions - positions[i][None, :], axis=1
            )
            if distances.min() < max_distance:
                cluster.append(i)
        clusters.append(cluster)
    return clusters


def scale_matrix(covariance: np.ndarray) -> np.ndarray:
    """Inverse-covariance square root (tools.py:90-100)."""
    try:
        L = np.linalg.cholesky(np.linalg.inv(covariance))
        return L.T
    except np.linalg.LinAlgError:
        return np.diag(1.0 / np.sqrt(np.maximum(np.diag(covariance), 1e-12)))


def invert_similarity(s, A, b):
    """(s, A, b)^-1 (tools.py:103-114)."""
    s_inv = 1.0 / s
    A_inv = A.T
    b_inv = -s_inv * A_inv.dot(b)
    return s_inv, A_inv, b_inv


def partial_reconstruction_name(key: PartialReconstruction) -> str:
    return str(key.submodel_path) + "_index" + str(key.idx)


def add_camera_constraints_soft(
    ra: ReconstructionAlignment,
    reconstruction_shots: Dict[PartialReconstruction, Dict[str, pymap.Shot]],
    reconstruction_name: Callable[[PartialReconstruction], str],
) -> None:
    """Per-shot GPS + rec<->shot relative motion (tools.py:120-160)."""
    added_shots = set()
    for key in reconstruction_shots:
        shots = reconstruction_shots[key]
        rec_name = reconstruction_name(key)
        ra.add_reconstruction(rec_name, 0, 0, 0, 0, 0, 0, 1, False)
        for shot_id, shot in shots.items():
            shot_name = str(shot_id)
            R = shot.pose.rotation
            t = shot.pose.translation
            if shot_id not in added_shots:
                ra.add_shot(shot_name, R[0], R[1], R[2], t[0], t[1], t[2], False)
                if shot.metadata.gps_position.has_value:
                    gps = shot.metadata.gps_position.value
                    gps_sd = (
                        shot.metadata.gps_accuracy.value
                        if shot.metadata.gps_accuracy.has_value
                        else 15.0
                    )
                    ra.add_absolute_position_constraint(
                        shot_name, gps[0], gps[1], gps[2], gps_sd
                    )
                added_shots.add(shot_id)
            covariance = np.diag([1e-5, 1e-5, 1e-5, 1e-2, 1e-2, 1e-2])
            sm = scale_matrix(covariance)
            rmc = RARelativeMotionConstraint(
                rec_name, shot_name, R[0], R[1], R[2], t[0], t[1], t[2]
            )
            for i in range(6):
                for j in range(6):
                    rmc.set_scale_matrix(i, j, sm[i, j])
            ra.add_relative_motion_constraint(rmc)


def add_camera_constraints_hard(
    ra: ReconstructionAlignment,
    reconstruction_shots: Dict[PartialReconstruction, Dict[str, pymap.Shot]],
    reconstruction_name: Callable[[PartialReconstruction], str],
    add_common_camera_constraint: bool,
) -> None:
    """Constant per-rec shot copies + common-camera ties (tools.py:162-214)."""
    for key in reconstruction_shots:
        shots = reconstruction_shots[key]
        rec_name = reconstruction_name(key)
        ra.add_reconstruction(rec_name, 0, 0, 0, 0, 0, 0, 1, False)
        for shot_id, shot in shots.items():
            shot_name = rec_name + str(shot_id)
            R = shot.pose.rotation
            t = shot.pose.translation
            ra.add_shot(shot_name, R[0], R[1], R[2], t[0], t[1], t[2], True)

    if add_common_camera_constraint:
        all_shot_ids = {}
        for key, shots in reconstruction_shots.items():
            for shot_id in shots:
                all_shot_ids.setdefault(shot_id, []).append(key)
        for shot_id, keys in all_shot_ids.items():
            if len(keys) < 2:
                continue
            for k1, k2 in itertools.combinations(keys, 2):
                ra.add_common_camera_constraint(
                    reconstruction_name(k1),
                    reconstruction_name(k1) + str(shot_id),
                    reconstruction_name(k2),
                    reconstruction_name(k2) + str(shot_id),
                    1.0,
                )


def add_point_constraints(
    ra: ReconstructionAlignment,
    reconstruction_shots: Dict[PartialReconstruction, Dict[str, pymap.Shot]],
    reconstruction_name: Callable[[PartialReconstruction], str],
    device=None,
) -> None:
    """Cross-submodel common-track similarity RANSAC + common-point ties
    (tools.py:217-257)."""
    scale_threshold = 1.3
    minimum_inliers = 20

    datasets = {}
    recs = {}
    tracks = {}
    for key in reconstruction_shots:
        if key.submodel_path not in datasets:
            data = dataset.DataSet(key.submodel_path)
            datasets[key.submodel_path] = data
        data = datasets[key.submodel_path]
        if data.reconstruction_exists():
            all_recs = data.load_reconstruction()
            if key.idx < len(all_recs):
                recs[key] = all_recs[key.idx]
        if data.tracks_exists():
            tracks[key] = data.load_tracks_manager()

    for k1, k2 in itertools.combinations(reconstruction_shots.keys(), 2):
        if k1 not in recs or k2 not in recs:
            continue
        if k1 not in tracks or k2 not in tracks:
            continue
        r1, r2 = recs[k1], recs[k2]
        status, T, inliers = orec.resect_reconstruction(
            r1, r2, tracks[k1], tracks[k2],
            threshold=0.3, min_inliers=minimum_inliers, device=device,
        )
        if not status:
            continue
        s, R, t = multiview.decompose_similarity_transform(T)
        if s > scale_threshold or s < 1.0 / scale_threshold or len(inliers) < minimum_inliers:
            continue
        rec_name1 = reconstruction_name(k1)
        rec_name2 = reconstruction_name(k2)
        for t1, t2 in inliers:
            c1 = r1.points[t1].coordinates
            c2 = r2.points[t2].coordinates
            ra.add_common_point_constraint(
                rec_name1, c1[0], c1[1], c1[2],
                rec_name2, c2[0], c2[1], c2[2], 1e-1,
            )


def load_reconstruction_shots(meta_data: MetaDataSet):
    """Per-submodel shots (tools.py:260-276)."""
    reconstruction_shots = {}
    for submodel_path in meta_data.get_submodel_paths():
        data = dataset.DataSet(submodel_path)
        if not data.reconstruction_exists():
            continue
        reconstruction = data.load_reconstruction()
        for index, partial in enumerate(reconstruction):
            key = PartialReconstruction(submodel_path, index)
            reconstruction_shots[key] = partial.shots
    return reconstruction_shots


def align_reconstructions(
    reconstruction_shots,
    reconstruction_name: Callable[[PartialReconstruction], str],
    use_points_constraints: bool,
    camera_constraint_type: str = "soft_camera_constraint",
    device=None,
    report=None,
):
    """Global pose-graph alignment (tools.py:278-307): the per-submodel
    similarities (s, A, b) that carry each partial into the common frame.
    A `report` dict receives the solve's seconds, steps, costs and
    Jacobian shape."""
    ra = ReconstructionAlignment(device=device)
    if camera_constraint_type == "soft_camera_constraint":
        add_camera_constraints_soft(ra, reconstruction_shots, reconstruction_name)
    if camera_constraint_type == "hard_camera_constraint":
        add_camera_constraints_hard(
            ra, reconstruction_shots, reconstruction_name, True
        )
    if use_points_constraints:
        add_point_constraints(ra, reconstruction_shots, reconstruction_name,
                              device=device)

    logger.info("Running alignment")
    start = time.time()
    ra.run()
    logger.info(ra.brief_report())
    if report is not None:
        report.update(
            seconds=time.time() - start, iterations=ra.iterations,
            trials=ra.trials, initial_cost=ra.initial_cost,
            final_cost=ra.final_cost, jacobian_shape=list(ra.jacobian_shape))

    transformations = {}
    for key in reconstruction_shots:
        rec_name = reconstruction_name(key)
        r = ra.get_reconstruction(rec_name)
        s = r.scale
        A = _rotvec_to_matrix_np(np.array([r.rx, r.ry, r.rz]))
        b = np.array([r.tx, r.ty, r.tz])
        transformations[key] = invert_similarity(s, A, b)
    return transformations


def apply_transformations(transformations) -> None:
    """Apply per-submodel similarities; save reconstruction.aligned.json
    (tools.py:310-328)."""
    submodels = itertools.groupby(
        sorted(transformations.keys(), key=lambda key: key.submodel_path),
        lambda key: key.submodel_path,
    )
    for submodel_path, keys in submodels:
        data = dataset.DataSet(submodel_path)
        if not data.reconstruction_exists():
            continue
        reconstruction = data.load_reconstruction()
        for key in keys:
            partial = reconstruction[key.idx]
            s, A, b = transformations[key]
            align.apply_similarity(partial, s, A, b)
        data.save_reconstruction(reconstruction, "reconstruction.aligned.json")
