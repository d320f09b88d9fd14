"""Incremental structure-from-motion.

Port of the incremental path of `opensfm_tpu.reconstruction` (the
reference `opensfm/reconstruction.py:1-1847`): the sequential growth loop
stays host-side Python, and every numeric hot spot is a batched torch
computation on `device` (CUDA unless told otherwise):

- pair reconstructability runs one batched rotation-only RANSAC over all
  candidate pairs (`relative_pose_ransac_rotation_only_batched`) where the
  JAX package calls it pair by pair;
- two-view geometry and resection run the batched LO-RANSAC engine
  (`opensfm_tpu_torch.robust`); a resection round of B candidates is one
  batched computation per chunk;
- track triangulation runs over ALL pending tracks at once on padded [N, T]
  ray arrays (the JAX package's vmapped kernels, :519-647), with the plain
  shapes: no power-of-two compile buckets;
- bundle adjustment is the Schur-complement LM core of `ba.lm`.

The ROBUST triangulation draws its slot pairs from a seeded CPU
`torch.Generator` (or takes them injected), not from the global NumPy RNG.
Also here: the merge of partial reconstructions (similarity and absolute
pose RANSAC through the batched engine, bundles through `ba.lm`), partial
saves, `triangulation_reconstruction` and `reconstruct_from_prior`.
"""

from __future__ import annotations

import copy
import datetime
import logging
import time
from collections import defaultdict
from itertools import combinations
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import io as io_mod
from opensfm_tpu_torch import multiview, pymap, resolve_device, rig, tracking, types
from opensfm_tpu_torch.align import align_reconstruction, apply_similarity
from opensfm_tpu_torch.ba import problem as ba_problem
from opensfm_tpu_torch.geometry import essential as ess
from opensfm_tpu_torch.geometry import triangulation as tri
from opensfm_tpu_torch.geometry.pose import Pose
from opensfm_tpu_torch.reconstruction_helpers import get_image_metadata

logger = logging.getLogger(__name__)

ROBUST_TRIES = 11  # slot pairs tried per track by the ROBUST triangulation
ROBUST_SEED = 42  # seed of the CPU generator of those pairs


class Chronometer:
    """Wall-clock laps (reconstruction.py:1821-1847)."""

    def __init__(self) -> None:
        self.start()

    def start(self) -> None:
        t = time.time()
        self.times = [("start", t)]

    def lap(self, key: str) -> None:
        self.times.append((key, time.time()))

    def lap_times(self) -> List[Tuple[str, float]]:
        return [
            (k, t - self.times[i][1])
            for i, (k, t) in enumerate(self.times[1:])
        ]

    def total_time(self) -> float:
        return self.times[-1][1] - self.times[0][1]


# ---------------------------------------------------------------------------
# Bundle wrappers
# ---------------------------------------------------------------------------


def bundle(reconstruction, camera_priors, rig_camera_priors, gcp, config,
           device=None):
    return ba_problem.bundle(
        reconstruction, camera_priors, rig_camera_priors, gcp, config,
        device=device,
    )


def bundle_local(
    reconstruction, camera_priors, rig_camera_priors, gcp, central_shot_id,
    config, device=None,
):
    report, bundled = ba_problem.bundle_local(
        reconstruction, camera_priors, rig_camera_priors, central_shot_id,
        gcp, config, device=device,
    )
    return bundled, report


def bundle_shot_poses(
    reconstruction, shot_ids, camera_priors, rig_camera_priors, config,
    device=None,
):
    return ba_problem.bundle_shot_poses(
        reconstruction, shot_ids, camera_priors, rig_camera_priors, config,
        device=device,
    )


# ---------------------------------------------------------------------------
# Pair selection for bootstrap
# ---------------------------------------------------------------------------


def pairwise_reconstructability(common_tracks: int, rotation_inliers: int) -> float:
    """Likeliness of a pair giving a good initial reconstruction
    (reconstruction.py:193-200): pairs with enough non-rotational motion."""
    outliers = common_tracks - rotation_inliers
    outlier_ratio = float(outliers) / common_tracks
    if outlier_ratio >= 0.3:
        return outliers
    return 0.0


def compute_image_pairs(track_dict, data, device=None) -> List[Tuple[str, str]]:
    """All matched pairs sorted by decreasing reconstructability
    (reconstruction.py:208-221).  The rotation-only RANSAC of every pair
    runs as one batched computation."""
    cameras = data.load_camera_models()
    threshold = 4 * data.config["five_point_algo_threshold"]
    keys, b1s, b2s = [], [], []
    for (im1, im2), (_, p1, p2) in track_dict.items():
        camera1 = cameras[data.load_exif(im1)["camera"]]
        camera2 = cameras[data.load_exif(im2)["camera"]]
        keys.append((im1, im2))
        b1s.append(camera1.bearings_many(p1))
        b2s.append(camera2.bearings_many(p2))
    Rs = multiview.relative_pose_ransac_rotation_only_batched(
        b1s, b2s, threshold, 1000, 0.999, device=device
    )
    result = []
    for (im1, im2), b1, b2, R in zip(keys, b1s, b2s, Rs):
        inliers = _two_view_rotation_inliers(b1, b2, R, threshold)
        result.append((im1, im2, pairwise_reconstructability(len(b1),
                                                              len(inliers))))
    pairs = [(im1, im2) for im1, im2, r in result if r > 0]
    score = [r for im1, im2, r in result if r > 0]
    order = np.argsort(-np.array(score))
    return [pairs[o] for o in order]


# ---------------------------------------------------------------------------
# Two-view geometry
# ---------------------------------------------------------------------------


def _two_view_reconstruction_inliers(b1, b2, Rt, threshold,
                                     device=None) -> np.ndarray:
    """Indices agreeing with [R|t] via the triangulation-based error."""
    return multiview.relative_pose_inliers(Rt, b1, b2, threshold,
                                           device=device)


def _two_view_rotation_inliers(b1, b2, R, threshold) -> np.ndarray:
    br1 = b1 @ R.T
    ok = np.linalg.norm(br1 - b2, axis=1) < threshold
    return np.nonzero(ok)[0]


def two_view_reconstruction_rotation_only(p1, p2, camera1, camera2, threshold,
                                          device=None):
    """Rotation-only two-view fit (reconstruction.py:387-412)."""
    b1 = camera1.bearings_many(p1)
    b2 = camera2.bearings_many(p2)
    R = multiview.relative_pose_ransac_rotation_only(
        b1, b2, threshold, 1000, 0.999, device=device)
    inliers = _two_view_rotation_inliers(b1, b2, R, threshold)
    return R, inliers


def two_view_reconstruction_5pt(b1, b2, Rt, threshold, iterations,
                                device=None):
    """Refine an essential-based relative pose and collect inliers
    (reconstruction.py:415-485, without the rarely-used Necker check)."""
    inliers = _two_view_reconstruction_inliers(b1, b2, Rt, threshold, device)
    if len(inliers) <= 5:
        return None, None, []
    dev = resolve_device(device)
    mask = np.zeros(len(b1), dtype=bool)
    mask[inliers] = True

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    Rt_refined = ess.refine_relative_pose(
        f64(Rt), f64(b1), f64(b2), mask=torch.as_tensor(mask, device=dev),
        iterations=min(iterations, 50),
    ).cpu().numpy()
    inliers = _two_view_reconstruction_inliers(b1, b2, Rt_refined, threshold,
                                               device)
    return Rt_refined[:, :3], Rt_refined[:, 3], inliers


def two_view_reconstruction_plane_based(b1, b2, threshold, device=None):
    """Homography-based two-view fit for planar scenes
    (reconstruction.py:298-333)."""
    x1 = multiview.euclidean(b1)
    x2 = multiview.euclidean(b2)
    H, _ = multiview.homography_ransac(x1, x2, threshold, 1000, device=device)
    if H is None:
        return None, None, []
    motions = multiview.motion_from_plane_homography(H)
    if not motions:
        return None, None, []
    motion_inliers = []
    for R, t, _, _ in motions:
        # The homography motions are cam2-from-cam1 in inverse form.
        Rt = np.hstack([R.T, (-R.T @ t)[:, None]])
        inliers = _two_view_reconstruction_inliers(b1, b2, Rt, threshold,
                                                   device)
        motion_inliers.append(inliers)
    best = int(np.argmax([len(i) for i in motion_inliers]))
    R, t, _, _ = motions[best]
    Rt = np.hstack([R.T, (-R.T @ t)[:, None]])
    p = Pose()
    p.set_rotation_matrix(Rt[:, :3])
    return p.rotation, Rt[:, 3], motion_inliers[best]


def two_view_reconstruction_general(
    p1, p2, camera1, camera2, threshold, iterations,
    check_reversal=False, reversal_ratio=1.0, device=None,
):
    """Best of essential-based and plane-based two-view reconstruction
    (reconstruction.py:488-560).  Returns (rvec, t, inliers, report) with
    the world-to-cam pose of camera 2 (camera 1 at identity)."""
    b1 = camera1.bearings_many(p1)
    b2 = camera2.bearings_many(p2)

    Rt_robust = multiview.relative_pose_ransac(b1, b2, threshold, 1000, 0.999,
                                               device=device)
    R_5p, t_5p, inliers_5p = two_view_reconstruction_5pt(
        b1, b2, Rt_robust, threshold, iterations, device=device
    )
    valid_5pt = R_5p is not None

    R_plane, t_plane, inliers_plane = two_view_reconstruction_plane_based(
        b1, b2, threshold, device=device
    )
    valid_plane = R_plane is not None

    report = {
        "5_point_inliers": len(inliers_5p),
        "plane_based_inliers": len(inliers_plane),
    }
    if valid_5pt and len(inliers_5p) > len(inliers_plane):
        report["method"] = "5_point"
        p = Pose()
        p.set_rotation_matrix(R_5p)
        return p.rotation, t_5p, inliers_5p, report
    elif valid_plane:
        report["method"] = "plane_based"
        return R_plane, t_plane, inliers_plane, report
    report["decision"] = "Could not find initial motion"
    return None, None, [], report


# ---------------------------------------------------------------------------
# Shots
# ---------------------------------------------------------------------------


def add_shot(data, reconstruction, rig_assignments, shot_id, pose) -> Set[str]:
    """Add a shot (and its rig siblings) to the reconstruction
    (reconstruction.py:249-296)."""
    added_shots = set()
    if shot_id not in rig_assignments:
        camera_id = data.load_exif(shot_id)["camera"]
        shot = reconstruction.create_shot(shot_id, camera_id, pose)
        shot.metadata = get_image_metadata(data, shot_id)
        return {shot_id}

    instance_id, _, instance_shots = rig_assignments[shot_id]
    reconstruction.add_rig_instance(pymap.RigInstance(instance_id))
    for shot in instance_shots:
        _, rig_camera_id, _ = rig_assignments[shot]
        camera_id = data.load_exif(shot)["camera"]
        if rig_camera_id not in reconstruction.rig_cameras:
            rig_cameras = data.load_rig_cameras()
            reconstruction.add_rig_camera(rig_cameras[rig_camera_id])
        created = reconstruction.create_shot(
            shot, camera_id, None, rig_camera_id, instance_id
        )
        created.metadata = get_image_metadata(data, shot)
        added_shots.add(shot)
    # The given shot's pose drives the instance pose.
    reconstruction.rig_instances[instance_id].update_instance_pose_with_shot(
        shot_id, pose
    )
    return added_shots


def reconstruction_from_relative_pose(data, tracks_manager, im1, im2, R, t,
                                      device=None):
    """Initialize a two-shot reconstruction (reconstruction.py:563-631)."""
    report: Dict[str, Any] = {}
    min_inliers = data.config["five_point_algo_min_inliers"]
    camera_priors = data.load_camera_models()
    rig_camera_priors = data.load_rig_cameras()
    rig_assignments = rig.rig_assignments_per_image(data.load_rig_assignments())

    reconstruction = types.Reconstruction()
    reconstruction.reference = data.load_reference()
    reconstruction.cameras = camera_priors
    for rig_camera in rig_camera_priors.values():
        reconstruction.add_rig_camera(rig_camera)

    new_shots = add_shot(data, reconstruction, rig_assignments, im1, Pose())
    if im2 not in new_shots:
        new_shots |= add_shot(
            data, reconstruction, rig_assignments, im2, Pose(R, t)
        )

    align_reconstruction(reconstruction, [], data.config, device=device)
    triangulate_shot_features(tracks_manager, reconstruction, new_shots,
                              data.config, device=device)
    logger.info("Triangulated: %d", len(reconstruction.points))
    report["triangulated_points"] = len(reconstruction.points)
    if len(reconstruction.points) < min_inliers:
        report["decision"] = "Initial motion did not generate enough points"
        return None, report

    to_adjust = {s for s in new_shots if s != im1}
    report["bundle_shot_poses"] = [bundle_shot_poses(
        reconstruction, to_adjust, camera_priors, rig_camera_priors,
        data.config, device=device,
    )]
    report["retriangulation"] = retriangulate(tracks_manager, reconstruction,
                                              data.config, device=device)
    if len(reconstruction.points) < min_inliers:
        report["decision"] = (
            "Re-triangulation after initial motion did not generate enough points"
        )
        return None, report
    report["bundle_shot_poses"].append(bundle_shot_poses(
        reconstruction, to_adjust, camera_priors, rig_camera_priors,
        data.config, device=device,
    ))
    report["decision"] = "Success"
    return reconstruction, report


def bootstrap_reconstruction(data, tracks_manager, im1, im2, p1, p2,
                             device=None):
    """Start a reconstruction from a two-view pair
    (reconstruction.py:633-675)."""
    logger.info("Starting reconstruction with %s and %s", im1, im2)
    report: Dict[str, Any] = {
        "image_pair": (im1, im2),
        "common_tracks": len(p1),
    }
    camera_priors = data.load_camera_models()
    camera1 = camera_priors[data.load_exif(im1)["camera"]]
    camera2 = camera_priors[data.load_exif(im2)["camera"]]

    threshold = data.config["five_point_algo_threshold"]
    iterations = data.config["five_point_refine_rec_iterations"]
    R, t, inliers, report["two_view_reconstruction"] = two_view_reconstruction_general(
        p1, p2, camera1, camera2, threshold, iterations,
        data.config["five_point_reversal_check"],
        data.config["five_point_reversal_ratio"], device=device,
    )
    if R is None or t is None:
        return None, report

    rec, rec_report = reconstruction_from_relative_pose(
        data, tracks_manager, im1, im2, R, t, device=device
    )
    report.update(rec_report)
    return rec, report


# ---------------------------------------------------------------------------
# Resection
# ---------------------------------------------------------------------------


def count_tracks_per_shot(tracks_manager, shot_ids, track_ids) -> Dict[str, int]:
    """pysfm.count_tracks_per_shot equivalent."""
    track_set = set(track_ids)
    return {
        shot_id: sum(
            1
            for t in tracks_manager.get_shot_observations(shot_id)
            if t in track_set
        )
        for shot_id in shot_ids
    }


def reconstructed_points_for_images(tracks_manager, reconstruction, images):
    """(image, num reconstructed points) sorted descending
    (reconstruction.py:677-693)."""
    non_reconstructed = [im for im in images if im not in reconstruction.shots]
    res = count_tracks_per_shot(
        tracks_manager, non_reconstructed, list(reconstruction.points.keys())
    )
    return sorted(res.items(), key=lambda x: -x[1])


def _resect_gather(data, tracks_manager, reconstruction, shot_id):
    """Host-side correspondence gather for one resection candidate:
    (bearings, Xs, track_ids) or None when < 5 common points."""
    camera = reconstruction.cameras[data.load_exif(shot_id)["camera"]]
    Xs, ids, pts2d = [], [], []
    for track, obs in tracks_manager.get_shot_observations(shot_id).items():
        if track in reconstruction.points:
            pts2d.append(obs.point)
            Xs.append(reconstruction.points[track].coordinates)
            ids.append(track)
    if len(pts2d) < 5:
        return None, len(pts2d)
    bs = camera.bearings_many(np.asarray(pts2d))
    return (bs, np.asarray(Xs), ids), len(pts2d)


def _resect_finalize(
    data, tracks_manager, reconstruction, shot_id, T, bs, Xs, ids,
    threshold, min_inliers, rig_assignments, device=None,
):
    """Accept/reject one candidate from its RANSAC pose and, on accept,
    add the shot(s) + inlier observations (the tail of reconstruction.py
    :695-762)."""
    R, t = T[:, :3], T[:, 3]
    reprojected_bs = (Xs @ R.T + t)
    reprojected_bs /= np.linalg.norm(reprojected_bs, axis=1)[:, None]
    inliers = np.linalg.norm(reprojected_bs - bs, axis=1) < threshold
    ninliers = int(inliers.sum())

    logger.info("%s resection inliers: %d / %d", shot_id, ninliers, len(bs))
    report = {"num_common_points": len(bs), "num_inliers": ninliers}
    if ninliers < min_inliers:
        return False, set(), report

    assert shot_id not in reconstruction.shots
    new_shots = add_shot(
        data, reconstruction, rig_assignments, shot_id, _pose_from_Rt(R, t)
    )
    if shot_id in rig_assignments:
        triangulate_shot_features(tracks_manager, reconstruction, new_shots,
                                  data.config, device=device)
    for i, ok in enumerate(inliers):
        if ok:
            add_observation_to_reconstruction(
                tracks_manager, reconstruction, shot_id, ids[i]
            )
    report["shots"] = list(new_shots)
    return True, new_shots, report


def resect(data, tracks_manager, reconstruction, shot_id, threshold,
           min_inliers, device=None):
    """P3P-RANSAC a new shot against reconstructed points
    (reconstruction.py:695-762)."""
    rig_assignments = rig.rig_assignments_per_image(data.load_rig_assignments())
    gathered, n_common = _resect_gather(
        data, tracks_manager, reconstruction, shot_id
    )
    if gathered is None:
        return False, set(), {"num_common_points": n_common}
    bs, Xs, ids = gathered
    T = multiview.absolute_pose_ransac(bs, Xs, threshold, 1000, 0.999,
                                       device=device)
    return _resect_finalize(
        data, tracks_manager, reconstruction, shot_id, T, bs, Xs, ids,
        threshold, min_inliers, rig_assignments, device=device,
    )


def resect_candidates_batched(
    data, tracks_manager, reconstruction, shot_ids, threshold, min_inliers,
    device=None,
):
    """Try a ROUND of resection candidates with ONE batched P3P-RANSAC and
    accept the FIRST candidate with enough inliers — the sequential walk's
    accept decision (a failed candidate leaves the reconstruction
    untouched, so later candidates see the same state) with the launches
    of one candidate.

    Returns (ok, new_shots, report, accepted_shot_id)."""
    rig_assignments = rig.rig_assignments_per_image(data.load_rig_assignments())
    gathered = {}
    reports = {}
    for shot_id in shot_ids:
        g, n_common = _resect_gather(
            data, tracks_manager, reconstruction, shot_id
        )
        if g is None:
            reports[shot_id] = {"num_common_points": n_common}
        else:
            gathered[shot_id] = g
    runnable = [s for s in shot_ids if s in gathered]
    if not runnable:
        return False, set(), reports, None
    results = multiview.absolute_pose_ransac_batched(
        [gathered[s][0] for s in runnable],
        [gathered[s][1] for s in runnable],
        threshold, 1000, 0.999, device=device,
    )
    poses = dict(zip(runnable, (T for T, _ in results)))
    for shot_id in shot_ids:
        if shot_id not in gathered:
            continue
        bs, Xs, ids = gathered[shot_id]
        ok, new_shots, report = _resect_finalize(
            data, tracks_manager, reconstruction, shot_id, poses[shot_id],
            bs, Xs, ids, threshold, min_inliers, rig_assignments,
            device=device,
        )
        reports[shot_id] = report
        if ok:
            return True, new_shots, reports, shot_id
    return False, set(), reports, None


def _pose_from_Rt(R, t) -> Pose:
    pose = Pose()
    pose.set_rotation_matrix(R)
    pose.translation = t
    return pose


def add_observation_to_reconstruction(
    tracks_manager, reconstruction, shot_id, track_id
):
    observation = tracks_manager.get_observation(shot_id, track_id)
    reconstruction.add_observation(shot_id, track_id, observation)


# ---------------------------------------------------------------------------
# Batched triangulation
# ---------------------------------------------------------------------------


def _batched_triangulate_arrays(origins, bearings, mask, thresholds,
                                min_angle, min_depth, iterations):
    """Midpoint triangulation + refinement over [N, T] rays, all tracks at
    once (the JAX package's vmapped `_make_triangulate_kernel`).  Returns
    (ok [N], X [N, 3])."""
    ok, X = tri.triangulate_bearings_midpoint(
        origins, bearings, mask, thresholds, min_angle, min_depth)
    X = tri.point_refinement(origins, bearings, X, mask, iterations)
    # Re-validate after refinement.
    rays = X[:, None, :] - origins
    ang = tri.angle_between_vectors(rays, bearings)
    depth = torch.sum(rays * bearings, dim=-1)
    ok = ok & torch.all(((ang <= thresholds) & (depth >= min_depth)) | ~mask,
                        dim=-1)
    return ok, X


def robust_pairs(lens: np.ndarray, n_tries: int = ROBUST_TRIES) -> np.ndarray:
    """[N, n_tries, 2] random distinct slot pairs (i, j) of tracks with
    `lens` rays, from a CPU generator seeded with ROBUST_SEED, by the JAX
    package's formula (reconstruction.py:636-641)."""
    generator = torch.Generator()
    generator.manual_seed(ROBUST_SEED)
    lens_col = np.maximum(np.asarray(lens, dtype=np.int64), 2)[:, None]
    u = torch.rand((len(lens_col), n_tries, 2), generator=generator,
                   dtype=torch.float64).numpy()
    i = np.floor(u[..., 0] * lens_col).astype(np.int64)
    j = np.floor(u[..., 1] * (lens_col - 1)).astype(np.int64)
    j = np.where(j >= i, j + 1, j)
    return np.stack([i, j], axis=-1)


def _batched_triangulate_robust(origins, bearings, mask, pairs, threshold,
                                min_angle, min_depth, iterations):
    """RANSAC-pairs robust triangulation (TrackTriangulator.
    triangulate_robust, reconstruction.py:922-1030) over [N, T] rays, all
    tracks and all K pairs at once.  pairs [N, K, 2] slot indices.
    Returns (ok [N], X [N, 3], inliers [N, T])."""
    N, T = mask.shape
    pairs = torch.clamp(pairs, 0, T - 1)
    rows = torch.arange(N, device=mask.device)[:, None, None]
    o2 = origins[rows, pairs]  # [N, K, 2, 3]
    b2 = bearings[rows, pairs]
    m2 = mask[rows, pairs]  # [N, K, 2]
    th2 = torch.full(m2.shape, threshold, dtype=origins.dtype,
                     device=origins.device)
    ok0, X = tri.triangulate_bearings_midpoint(o2, b2, m2, th2, min_angle,
                                               min_depth)
    X = tri.point_refinement(o2, b2, X, m2, iterations)  # [N, K, 3]
    rays = X[:, :, None, :] - origins[:, None]  # [N, K, T, 3]
    rb = rays / torch.clamp_min(torch.linalg.vector_norm(rays, dim=-1,
                                                         keepdim=True), 1e-12)
    inl = (torch.linalg.vector_norm(rb - bearings[:, None], dim=-1)
           < threshold) & mask[:, None]
    cnts = torch.where(ok0 & m2.all(dim=-1), inl.sum(dim=-1),
                       torch.full_like(inl.sum(dim=-1), -1))
    best = torch.argmax(cnts, dim=1)
    n = torch.arange(N, device=mask.device)
    cnt_best = cnts[n, best]
    Xb = X[n, best]
    inl_b = inl[n, best]

    # Least-squares refit over the pair's inliers; keep the better support
    # (the reference's quirk: the pair point is the one refined over the
    # inlier set, :991-1015).
    Xr = tri.point_refinement(origins, bearings, Xb, inl_b, iterations)
    rays = Xr[:, None, :] - origins
    rbr = rays / torch.clamp_min(torch.linalg.vector_norm(rays, dim=-1,
                                                          keepdim=True), 1e-12)
    inl_r = (torch.linalg.vector_norm(rbr - bearings, dim=-1)
             < threshold) & mask
    use_refit = inl_r.sum(dim=-1) > cnt_best
    X_final = torch.where(use_refit[:, None], Xr, Xb)
    inl_final = torch.where(use_refit[:, None], inl_r, inl_b)
    return cnt_best >= 2, X_final, inl_final


def triangulate_tracks(
    tracks: List[str],
    tracks_manager,
    reconstruction: types.Reconstruction,
    config,
    device=None,
    pairs: Optional[np.ndarray] = None,
) -> Dict[str, int]:
    """Batch-triangulate tracks and add valid points + observations.

    Replaces the reference's per-track TrackTriangulator loop
    (reconstruction.py:895-1183) with one padded [N, T] computation on
    `device`.  triangulation_type ROBUST runs the batched RANSAC-pairs
    version and adds only inlier observations (triangulate_robust:922); its
    [N, K, 2] slot pairs are `pairs` (one row per track with at least two
    reconstructed views, in `tracks` order) or `robust_pairs`'.  Returns
    the call's size: tracks N, rays T and points added."""
    size = {"tracks": 0, "rays": 0, "points": 0}
    if not tracks:
        return size
    robust_mode = str(config.get("triangulation_type", "FULL")).upper() == "ROBUST"
    reproj_threshold = config["triangulation_threshold"]
    min_ray_angle = np.radians(config["triangulation_min_ray_angle"])
    min_depth = config["triangulation_min_depth"]
    iterations = config["triangulation_refinement_iterations"]

    per_shot_tracks: Dict[str, List[int]] = defaultdict(list)
    per_shot_points: Dict[str, List[np.ndarray]] = defaultdict(list)
    track_obs: List[List[str]] = []
    kept_tracks: List[str] = []
    for track in tracks:
        obs = {
            sid: o
            for sid, o in tracks_manager.get_track_observations(track).items()
            if sid in reconstruction.shots
        }
        if len(obs) < 2:
            continue
        idx = len(kept_tracks)
        kept_tracks.append(track)
        track_obs.append(list(obs.keys()))
        for sid, o in obs.items():
            per_shot_tracks[sid].append(idx)
            per_shot_points[sid].append(o.point)

    if not kept_tracks:
        return size

    n = len(kept_tracks)
    t_max = max(len(o) for o in track_obs)
    # The plain shapes: the JAX package pads n and t to power-of-two buckets
    # (floors 512 and 8) to share compiled programs.
    origins = np.zeros((n, t_max, 3))
    bearings = np.zeros((n, t_max, 3))
    bearings[..., 2] = 1.0
    mask = np.zeros((n, t_max), dtype=bool)
    slots = np.zeros(n, dtype=np.int64)
    slot_of: Dict[Tuple[int, str], int] = {}

    for sid, idx_list in per_shot_tracks.items():
        shot = reconstruction.shots[sid]
        idx = np.asarray(idx_list, dtype=np.int64)
        bs = shot.camera.bearings_many(np.asarray(per_shot_points[sid])) \
            @ shot.pose.get_rotation_matrix()
        s = slots[idx]
        origins[idx, s] = shot.pose.get_origin()
        bearings[idx, s] = bs
        mask[idx, s] = True
        slots[idx] += 1
        if robust_mode:
            slot_of.update(zip(zip(idx_list, [sid] * len(idx_list)),
                               s.tolist()))

    dev = resolve_device(device)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    size.update(tracks=n, rays=t_max)
    if robust_mode:
        lens = np.array([len(o) for o in track_obs])
        if pairs is None:
            pairs = robust_pairs(lens)
        ok, X, inliers = _batched_triangulate_robust(
            f64(origins), f64(bearings), torch.as_tensor(mask, device=dev),
            torch.as_tensor(np.asarray(pairs), dtype=torch.int64, device=dev),
            reproj_threshold, min_ray_angle, min_depth, iterations,
        )
        ok, X, inliers = ok.cpu().numpy(), X.cpu().numpy(), inliers.cpu().numpy()
        for idx, track in enumerate(kept_tracks):
            if not ok[idx]:
                continue
            reconstruction.create_point(track, X[idx])
            size["points"] += 1
            for sid in track_obs[idx]:
                if inliers[idx, slot_of[(idx, sid)]]:
                    add_observation_to_reconstruction(
                        tracks_manager, reconstruction, sid, track
                    )
        return size

    thresholds = torch.full((n, t_max), reproj_threshold, dtype=torch.float64,
                            device=dev)
    ok, X = _batched_triangulate_arrays(
        f64(origins), f64(bearings), torch.as_tensor(mask, device=dev),
        thresholds, min_ray_angle, min_depth, iterations,
    )
    ok, X = ok.cpu().numpy(), X.cpu().numpy()
    for idx, track in enumerate(kept_tracks):
        if not ok[idx]:
            continue
        reconstruction.create_point(track, X[idx])
        size["points"] += 1
        for sid in track_obs[idx]:
            add_observation_to_reconstruction(
                tracks_manager, reconstruction, sid, track
            )
    return size


def triangulate_shot_features(tracks_manager, reconstruction, shot_ids, config,
                              device=None):
    """Triangulate all new tracks visible in the given shots
    (reconstruction.py:1143-1183)."""
    all_shots_ids = set(tracks_manager.get_shot_ids())
    tracks_ids = {
        t
        for s in shot_ids
        if s in all_shots_ids
        for t in tracks_manager.get_shot_observations(s)
        if t not in reconstruction.points
    }
    return triangulate_tracks(sorted(tracks_ids), tracks_manager,
                              reconstruction, config, device=device)


def retriangulate(tracks_manager, reconstruction, config,
                  device=None) -> Dict[str, Any]:
    """Re-triangulate every track from scratch (reconstruction.py:1186-1237)."""
    chrono = Chronometer()
    report: Dict[str, Any] = {"num_points_before": len(reconstruction.points)}
    reconstruction.points = {}
    all_shots_ids = set(tracks_manager.get_shot_ids())
    tracks = set()
    for image in reconstruction.shots.keys():
        if image in all_shots_ids:
            tracks.update(tracks_manager.get_shot_observations(image).keys())
    report["triangulation"] = triangulate_tracks(
        sorted(tracks), tracks_manager, reconstruction, config, device=device)
    report["num_points_after"] = len(reconstruction.points)
    chrono.lap("retriangulate")
    report["wall_time"] = chrono.total_time()
    return report


# ---------------------------------------------------------------------------
# Outlier removal
# ---------------------------------------------------------------------------


def compute_reprojection_errors(reconstruction: types.Reconstruction) -> None:
    """Raw reprojection residuals per (landmark, shot), vectorized per shot
    (the BundleAdjuster::ComputeReprojectionErrors writeback equivalent,
    bundle_adjuster.cc:1196 — std_deviation 1.0)."""
    for lm in reconstruction.points.values():
        lm.reprojection_errors = {}
    for shot in reconstruction.shots.values():
        items = [
            (lm_id, obs)
            for lm_id, obs in shot.get_landmark_observations().items()
            if lm_id in reconstruction.points
        ]
        if not items:
            continue
        X = np.asarray(
            [reconstruction.points[lm_id].coordinates for lm_id, _ in items]
        )
        uv = np.asarray([obs.point for _, obs in items])
        proj = shot.project_many(X)
        err = proj - uv
        for k, (lm_id, _) in enumerate(items):
            reconstruction.points[lm_id].reprojection_errors[shot.id] = err[k]


def get_error_distribution(points) -> Tuple[np.ndarray, float]:
    all_errors = []
    for track in points.values():
        all_errors += list(track.reprojection_errors.values())
    robust_mean = np.median(all_errors, axis=0)
    robust_std = 1.486 * np.median(
        np.linalg.norm(np.array(all_errors) - robust_mean, axis=1)
    )
    return robust_mean, robust_std


def get_actual_threshold(config, points) -> float:
    filter_type = config["bundle_outlier_filtering_type"]
    if filter_type == "FIXED":
        return config["bundle_outlier_fixed_threshold"]
    elif filter_type == "AUTO":
        mean, std = get_error_distribution(points)
        return config["bundle_outlier_auto_ratio"] * np.linalg.norm(mean + std)
    return 1.0


def remove_outliers(reconstruction, config, points=None) -> int:
    """Remove observations with large reprojection error; drop points left
    with < 2 observations (reconstruction.py:1253-1290)."""
    compute_reprojection_errors(reconstruction)
    if points is None:
        points = reconstruction.points
    threshold_sqr = get_actual_threshold(config, reconstruction.points) ** 2
    outliers = []
    for point_id in points:
        if point_id not in reconstruction.points:
            continue
        lm = reconstruction.points[point_id]
        for shot_id, error in lm.reprojection_errors.items():
            if error[0] ** 2 + error[1] ** 2 > threshold_sqr:
                outliers.append((point_id, shot_id))
    track_ids = set()
    for track, shot_id in outliers:
        reconstruction.map.remove_observation(shot_id, track)
        track_ids.add(track)
    for track in track_ids:
        if track in reconstruction.points:
            lm = reconstruction.points[track]
            if lm.number_of_observations() < 2:
                reconstruction.map.remove_landmark(track)
    logger.info("Removed outliers: %d", len(outliers))
    return len(outliers)


# ---------------------------------------------------------------------------
# Reconstruction merging
# ---------------------------------------------------------------------------


def shot_lla_and_compass(shot, reference) -> Tuple[float, float, float, float]:
    """Lat, lon, alt and compass angle of a reconstructed shot
    (reconstruction.py:1293-1302)."""
    topo = shot.pose.get_origin()
    lat, lon, alt = reference.to_lla(*topo)
    dz = shot.pose.get_R_cam_to_world()[:, 2]
    angle = np.rad2deg(np.arctan2(dz[0], dz[1]))
    angle = (angle + 360) % 360
    return lat, lon, alt, angle


def corresponding_tracks(tracks1, tracks2) -> List[Tuple[str, str]]:
    features1 = {obs.id: t1 for t1, obs in tracks1.items()}
    corresponding = []
    for t2, obs in tracks2.items():
        if obs.id in features1:
            corresponding.append((features1[obs.id], t2))
    return corresponding


def compute_common_tracks(
    reconstruction1, reconstruction2, tracks_manager1, tracks_manager2
) -> List[Tuple[str, str]]:
    common_tracks = set()
    common_images = set(reconstruction1.shots) & set(reconstruction2.shots)
    all1 = set(tracks_manager1.get_shot_ids())
    all2 = set(tracks_manager2.get_shot_ids())
    for image in common_images:
        if image not in all1 or image not in all2:
            continue
        at1 = tracks_manager1.get_shot_observations(image)
        at2 = tracks_manager2.get_shot_observations(image)
        for t1, t2 in corresponding_tracks(at1, at2):
            if t1 in reconstruction1.points and t2 in reconstruction2.points:
                common_tracks.add((t1, t2))
    return list(common_tracks)


def align_two_reconstruction(r1, r2, common_tracks, threshold, device=None):
    """Similarity T with r2 = T . r1 from common tracks
    (reconstruction.py:1329-1354), by the batched engine's similarity
    RANSAC on `device`."""
    if len(common_tracks) > 6:
        p1 = np.array([r1.points[t[0]].coordinates for t in common_tracks])
        p2 = np.array([r2.points[t[1]].coordinates for t in common_tracks])
        T, inliers = multiview.fit_similarity_transform(
            p1, p2, max_iterations=100, threshold=threshold, device=device
        )
        if len(inliers) > 0:
            return True, T, list(inliers)
    return False, None, []


def resect_reconstruction(
    reconstruction1, reconstruction2, tracks_manager1, tracks_manager2,
    threshold, min_inliers, device=None,
):
    """Similarity between two reconstructions from their common tracks
    (reconstruction.py:801-832)."""
    common_tracks = compute_common_tracks(
        reconstruction1, reconstruction2, tracks_manager1, tracks_manager2
    )
    worked, similarity, inliers = align_two_reconstruction(
        reconstruction1, reconstruction2, common_tracks, threshold,
        device=device,
    )
    if not worked or similarity is None or len(inliers) < min_inliers:
        return False, np.ones((4, 4)), []
    inliers = [common_tracks[i] for i in inliers]
    return True, similarity, inliers


def _copy_reconstruction(rec):
    """Deep copy via the JSON codec (keeps a merge attempt free of side
    effects, so a failed validation can be discarded)."""
    out = io_mod.reconstruction_from_json(io_mod.reconstruction_to_json(rec))
    out.reference = rec.reference
    return out


def _reresect_shots(r, shot_ids, tracks_manager, data, config, device=None):
    """Re-estimate the poses of `shot_ids` against the current point set
    with P3P-RANSAC (one batched computation for all of them), keeping a
    new pose only when it explains more observations than the existing
    one.  Shots of multi-shot rig instances are skipped (their pose is the
    instance's)."""
    threshold = config["resection_threshold"]
    gathered = {}
    for shot_id in sorted(shot_ids):
        shot = r.shots.get(shot_id)
        if shot is None or len(shot.rig_instance.shots) > 1:
            continue
        g, _ = _resect_gather(data, tracks_manager, r, shot_id)
        if g is not None:
            gathered[shot_id] = g
    if not gathered:
        return 0
    results = multiview.absolute_pose_ransac_batched(
        [g[0] for g in gathered.values()], [g[1] for g in gathered.values()],
        threshold, 1000, 0.999, device=device)

    def ninl(R, t, bs, Xs):
        pr = Xs @ R.T + t
        pr = pr / np.maximum(np.linalg.norm(pr, axis=1, keepdims=True), 1e-12)
        return int((np.linalg.norm(pr - bs, axis=1) < threshold).sum())

    improved = 0
    for (shot_id, (bs, Xs, _)), (T, _) in zip(gathered.items(), results):
        pose = r.shots[shot_id].pose
        if ninl(T[:, :3], T[:, 3], bs, Xs) > ninl(
                pose.get_rotation_matrix(), pose.translation, bs, Xs):
            r.shots[shot_id].pose = _pose_from_Rt(T[:, :3], T[:, 3])
            improved += 1
    if improved:
        logger.info("Post-merge re-resection improved %d shot poses", improved)
    return improved


def _union_into(a, b):
    for shot in a.shots.values():
        if shot.id not in b.shots:
            b.add_shot(shot)
    for point in a.points.values():
        if point.id not in b.points:
            b.add_point(point)
    return b


def merge_two_reconstructions(r1, r2, config, threshold=1.0,
                              tracks_manager=None, data=None, gcp=None,
                              device=None):
    """Merge two reconstructions with common track ids
    (reconstruction.py:1356-1380), as the JAX package does, in two regimes:

    - >= 10 similarity inliers: apply the similarity and merge directly.
    - fewer, with a tracks manager to consolidate with (a thin bridge
      between the parts): seed with the median translation of the common
      points (then the similarity RANSAC's transform when it found >= 3
      inliers), union the maps, retriangulate and bundle with a widened
      loss first and the configured one twice more, and accept when at
      least 10 points link shots of both parts (validated on copies: on
      rejection the originals come back untouched).  An accepted merge is
      re-resected shot by shot (keep-if-better) and settled by
      retriangulate + bundle rounds until no shot origin moves 5 mm (at
      most 5 rounds); the last displacement is `merge_settle_moved`."""
    common_ids = sorted(set(r1.points) & set(r2.points))
    common_tracks = [(t, t) for t in common_ids]
    worked, T, inliers = align_two_reconstruction(r1, r2, common_tracks,
                                                  threshold, device=device)
    strict_inliers = len(inliers or []) if worked else 0
    if strict_inliers < 10 and len(common_ids) < 3:
        return [r1, r2]

    if strict_inliers >= 10:
        s, A, b_ = multiview.decompose_similarity_transform(T)
        apply_similarity(r1, s, A, b_)
        r = _union_into(r1, r2)
        align_reconstruction(r, [], config, device=device)
        return [r]

    if tracks_manager is None or data is None:
        return [r1, r2]

    p1 = np.array([r1.points[t].coordinates for t in common_ids])
    p2 = np.array([r2.points[t].coordinates for t in common_ids])
    T_med = np.eye(4)
    T_med[:3, 3] = np.median(p2 - p1, axis=0)
    seeds = [("median-translation", T_med)]
    if worked and T is not None and len(inliers) >= 3:
        seeds.append(("similarity-ransac", T))

    part1_shots = set(r1.shots)
    camera_priors = data.load_camera_models()
    rig_camera_priors = data.load_rig_cameras()
    gcp = gcp or []

    def consolidate(r, cfg, remove=True):
        retriangulate(tracks_manager, r, cfg, device=device)
        align_reconstruction(r, gcp, cfg, device=device)
        bundle(r, camera_priors, rig_camera_priors, gcp, cfg, device=device)
        if remove:
            remove_outliers(r, cfg)

    for seed_name, T_seed in seeds:
        c1 = _copy_reconstruction(r1)
        c2 = _copy_reconstruction(r2)
        s, A, b_ = multiview.decompose_similarity_transform(T_seed)
        apply_similarity(c1, s, A, b_)
        r = _union_into(c1, c2)
        # Graduated consolidation: the seed can be metres off, so the first
        # bundle runs with a widened loss and no outlier removal.
        relaxed = dict(config)
        relaxed["loss_function_threshold"] = (
            4.0 * float(config.get("loss_function_threshold", 1.0))
        )
        consolidate(r, relaxed, remove=False)
        for _ in range(2):
            consolidate(r, config)
        cross = 0
        for point in r.points.values():
            obs_shots = set(point.get_observations())
            if (obs_shots & part1_shots) and (obs_shots - part1_shots):
                cross += 1
                if cross >= 10:
                    break
        if cross >= 10:
            logger.info(
                "Seeded merge accepted (%s seed): %d shots, %d points",
                seed_name, len(r.shots), len(r.points),
            )
            _reresect_shots(r, set(r.shots), tracks_manager, data, config,
                            device=device)
            prev = {sid: s.pose.get_origin() for sid, s in r.shots.items()}
            moved = float("inf")
            for _ in range(5):
                consolidate(r, config)
                cur = {sid: s.pose.get_origin() for sid, s in r.shots.items()}
                moved = max(float(np.linalg.norm(cur[sid] - prev[sid]))
                            for sid in cur)
                prev = cur
                if moved < 5e-3:
                    break
            r.merge_settle_moved = moved
            return [r]
        logger.info(
            "Seeded merge (%s seed) rejected: only %d cross-part points",
            seed_name, cross,
        )
    return [r1, r2]


def merge_reconstructions(reconstructions, config, tracks_manager=None,
                          data=None, gcp=None, device=None):
    """Greedily merge reconstructions (reconstruction.py:1383-1407)."""
    kw = dict(tracks_manager=tracks_manager, data=data, gcp=gcp,
              device=device)
    remaining = set(range(len(reconstructions)))
    merged = []
    num_merge = 0
    for i, j in combinations(range(len(reconstructions)), 2):
        if i in remaining and j in remaining:
            r = merge_two_reconstructions(
                reconstructions[i], reconstructions[j], config, **kw
            )
            if len(r) == 1:
                remaining -= {i, j}
                for k in sorted(remaining):
                    rr = merge_two_reconstructions(
                        r[0], reconstructions[k], config, **kw
                    )
                    if len(rr) == 1:
                        r = rr
                        remaining -= {k}
                merged.append(r[0])
                num_merge += 1
    for k in sorted(remaining):
        merged.append(reconstructions[k])
    logger.info("Merged %d reconstructions", num_merge)
    return merged


def paint_reconstruction(data, tracks_manager, reconstruction):
    """Color points from their track observations (reconstruction.py:1410)."""
    for k, point in reconstruction.points.items():
        obs = tracks_manager.get_track_observations(str(k))
        if obs:
            point.color = np.asarray(
                next(iter(obs.values())).color, dtype=np.int64
            )


# ---------------------------------------------------------------------------
# Growth policies
# ---------------------------------------------------------------------------


class ShouldBundle:
    """When to run global bundle (reconstruction.py:1410-1434)."""

    def __init__(self, data, reconstruction) -> None:
        self.interval = data.config["bundle_interval"]
        self.new_points_ratio = data.config["bundle_new_points_ratio"]
        self.reconstruction = reconstruction
        self.done()

    def should(self) -> bool:
        max_points = self.num_points_last * self.new_points_ratio
        max_shots = self.num_shots_last + self.interval
        return (
            len(self.reconstruction.points) >= max_points
            or len(self.reconstruction.shots) >= max_shots
        )

    def done(self) -> None:
        self.num_points_last = len(self.reconstruction.points)
        self.num_shots_last = len(self.reconstruction.shots)


class ShouldRetriangulate:
    """When to retriangulate (reconstruction.py:1436-1455)."""

    def __init__(self, data, reconstruction) -> None:
        self.active = data.config["retriangulation"]
        self.ratio = data.config["retriangulation_ratio"]
        self.reconstruction = reconstruction
        self.done()

    def should(self) -> bool:
        max_points = self.num_points_last * self.ratio
        return self.active and len(self.reconstruction.points) > max_points

    def done(self) -> None:
        self.num_points_last = len(self.reconstruction.points)


# ---------------------------------------------------------------------------
# Growth loop
# ---------------------------------------------------------------------------


def save_partial_reconstructions(data, tracks_manager, reconstruction) -> None:
    """With `save_partial_reconstructions` on, paint the growing map and
    save it as reconstruction.<ISO time>.json (reconstruction.py:1486-1493),
    once before every resection round."""
    if data.config["save_partial_reconstructions"]:
        paint_reconstruction(data, tracks_manager, reconstruction)
        data.save_reconstruction(
            [reconstruction],
            "reconstruction.{}.json".format(
                datetime.datetime.now().isoformat().replace(":", "_")
            ),
        )


def grow_reconstruction(data, tracks_manager, reconstruction, images, gcp,
                        device=None):
    """Incrementally add shots (reconstruction.py:1457-1597) on `device`.
    The report's steps hold each resection round's candidates and time,
    each triangulation's size and time, and each bundle's report."""
    config = data.config
    report: Dict[str, Any] = {"steps": []}
    camera_priors = data.load_camera_models()
    rig_camera_priors = data.load_rig_cameras()

    paint_reconstruction(data, tracks_manager, reconstruction)
    align_reconstruction(reconstruction, gcp, config, device=device)

    report["bundle_initial"] = bundle(
        reconstruction, camera_priors, rig_camera_priors, None, config,
        device=device)
    remove_outliers(reconstruction, config)
    paint_reconstruction(data, tracks_manager, reconstruction)

    should_bundle = ShouldBundle(data, reconstruction)
    should_retriangulate = ShouldRetriangulate(data, reconstruction)
    while True:
        save_partial_reconstructions(data, tracks_manager, reconstruction)
        candidates = reconstructed_points_for_images(
            tracks_manager, reconstruction, images
        )
        if not candidates:
            break

        threshold = config["resection_threshold"]
        min_inliers = config["resection_min_inliers"]
        # Candidate resections run in per-round batches: one batched RANSAC
        # covers `resection_batch_size` P3P problems (1 for the sequential
        # reference walk).
        batch = int(config.get("resection_batch_size", 8))
        accepted = None
        rounds = []
        t0 = time.time()
        if batch > 1:
            for i0 in range(0, len(candidates), batch):
                chunk = [im for im, _ in candidates[i0:i0 + batch]]
                rounds.append(len(chunk))
                ok, new_shots, chunk_reports, image = (
                    resect_candidates_batched(
                        data, tracks_manager, reconstruction, chunk,
                        threshold, min_inliers, device=device,
                    )
                )
                if ok:
                    accepted = (image, new_shots, chunk_reports[image])
                    break
        else:
            for image, _ in candidates:
                rounds.append(1)
                ok, new_shots, resrep = resect(
                    data, tracks_manager, reconstruction, image, threshold,
                    min_inliers, device=device,
                )
                if ok:
                    accepted = (image, new_shots, resrep)
                    break
        resection_time = time.time() - t0
        if accepted is None:
            logger.info("Some images can not be added")
            break
        image, new_shots, resrep = accepted

        images -= new_shots
        step: Dict[str, Any] = {
            "images": list(new_shots), "resection": resrep,
            "resection_rounds": rounds, "resection_time": resection_time,
        }
        step["bundle_shot_poses"] = bundle_shot_poses(
            reconstruction, new_shots, camera_priors, rig_camera_priors,
            config, device=device,
        )
        logger.info("Adding %s to the reconstruction", " and ".join(new_shots))
        report["steps"].append(step)

        np_before = len(reconstruction.points)
        t0 = time.time()
        step["triangulation"] = triangulate_shot_features(
            tracks_manager, reconstruction, new_shots, config, device=device)
        step["triangulation"]["time"] = time.time() - t0
        step["triangulated_points"] = len(reconstruction.points) - np_before

        if should_retriangulate.should():
            logger.info("Re-triangulating")
            align_reconstruction(reconstruction, gcp, config, device=device)
            step["bundle"] = bundle(
                reconstruction, camera_priors, rig_camera_priors, None, config,
                device=device,
            )
            step["retriangulation"] = retriangulate(
                tracks_manager, reconstruction, config, device=device
            )
            step["bundle_after_retriangulation"] = bundle(
                reconstruction, camera_priors, rig_camera_priors, None, config,
                device=device,
            )
            remove_outliers(reconstruction, config)
            should_retriangulate.done()
            should_bundle.done()
        elif should_bundle.should():
            align_reconstruction(reconstruction, gcp, config, device=device)
            step["bundle"] = bundle(
                reconstruction, camera_priors, rig_camera_priors, None, config,
                device=device,
            )
            remove_outliers(reconstruction, config)
            should_bundle.done()
        elif config["local_bundle_radius"] > 0:
            bundled_points, brep = bundle_local(
                reconstruction, camera_priors, rig_camera_priors, None, image,
                config, device=device,
            )
            remove_outliers(reconstruction, config, bundled_points)
            step["local_bundle"] = brep

    align_result = align_reconstruction(
        reconstruction, gcp, config, bias_override=True, device=device
    )
    if not align_result and config["bundle_compensate_gps_bias"]:
        config = dict(config)
        config["bundle_compensate_gps_bias"] = False

    report["bundle_final"] = bundle(
        reconstruction, camera_priors, rig_camera_priors, gcp, config,
        device=device)
    remove_outliers(reconstruction, config)

    if config["filter_final_point_cloud"]:
        filter_badly_conditioned_points(
            reconstruction, config["triangulation_min_ray_angle"]
        )
        remove_isolated_points(reconstruction)

    paint_reconstruction(data, tracks_manager, reconstruction)
    return reconstruction, report


def filter_badly_conditioned_points(reconstruction, min_ray_angle_degrees) -> int:
    """Remove points whose max subtended ray angle is too small
    (pysfm.filter_badly_conditioned_points, sfm/src/map_helpers.cc)."""
    min_angle = np.radians(min_ray_angle_degrees)
    to_remove = []
    for lm in reconstruction.points.values():
        origins = []
        for shot_id in lm.get_observations():
            if shot_id in reconstruction.shots:
                origins.append(reconstruction.shots[shot_id].pose.get_origin())
        if len(origins) < 2:
            continue
        rays = lm.coordinates[None, :] - np.asarray(origins)
        rays /= np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), 1e-12)
        dots = np.clip(rays @ rays.T, -1.0, 1.0)
        max_angle = np.arccos(dots).max()
        if max_angle < min_angle:
            to_remove.append(lm.id)
    for pid in to_remove:
        reconstruction.remove_point(pid)
    return len(to_remove)


def remove_isolated_points(reconstruction) -> int:
    """Remove points with fewer than 2 observations
    (pysfm.remove_isolated_points)."""
    to_remove = [
        lm.id
        for lm in reconstruction.points.values()
        if lm.number_of_observations() < 2
    ]
    for pid in to_remove:
        reconstruction.remove_point(pid)
    return len(to_remove)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def incremental_reconstruction(data, tracks_manager, device=None):
    """The full incremental pipeline (reconstruction.py:1712-1786) on
    `device` (CUDA unless told otherwise), partials merged when
    `merge_partial_reconstructions` is on."""
    device = resolve_device(device)
    logger.info("Starting incremental reconstruction")
    report: Dict[str, Any] = {}
    chrono = Chronometer()

    images = tracks_manager.get_shot_ids()
    data.init_reference(images)
    remaining_images = set(images)
    gcp = data.load_ground_control_points()

    common_tracks = tracking.all_common_tracks_with_features(tracks_manager)
    pairs = compute_image_pairs(common_tracks, data, device=device)
    chrono.lap("compute_image_pairs")
    report["num_candidate_image_pairs"] = len(pairs)
    report["reconstructions"] = []

    reconstructions = []
    for im1, im2 in pairs:
        if im1 in remaining_images and im2 in remaining_images:
            rec_report: Dict[str, Any] = {}
            report["reconstructions"].append(rec_report)
            _, p1, p2 = common_tracks[im1, im2]
            t0 = time.time()
            reconstruction, rec_report["bootstrap"] = bootstrap_reconstruction(
                data, tracks_manager, im1, im2, p1, p2, device=device
            )
            rec_report["bootstrap_time"] = time.time() - t0
            if reconstruction:
                remaining_images -= set(reconstruction.shots)
                t0 = time.time()
                reconstruction, rec_report["grow"] = grow_reconstruction(
                    data, tracks_manager, reconstruction, remaining_images,
                    gcp, device=device,
                )
                rec_report["grow_time"] = time.time() - t0
                reconstructions.append(reconstruction)
                reconstructions = sorted(reconstructions, key=lambda x: -len(x.shots))

    # Merge partial reconstructions that share triangulated tracks (the JAX
    # package's merge step, reconstruction.py:1420-1458; config-gated).
    if (
        len(reconstructions) > 1
        and data.config.get("merge_partial_reconstructions", True)
    ):
        n_before = len(reconstructions)
        t0 = time.time()
        reconstructions = merge_reconstructions(
            reconstructions, data.config, tracks_manager=tracks_manager,
            data=data, gcp=gcp, device=device,
        )
        if len(reconstructions) < n_before:
            camera_priors = data.load_camera_models()
            rig_camera_priors = data.load_rig_cameras()
            for rec in reconstructions:
                # Recover cross-part tracks neither partial could
                # triangulate alone, then one global bundle.
                retriangulate(tracks_manager, rec, data.config, device=device)
                align_reconstruction(rec, gcp, data.config, device=device)
                bundle(rec, camera_priors, rig_camera_priors, gcp,
                       data.config, device=device)
                remove_outliers(rec, data.config)
                paint_reconstruction(data, tracks_manager, rec)
            reconstructions = sorted(
                reconstructions, key=lambda x: -len(x.shots)
            )
            report["merge_settle_moved"] = [
                getattr(r, "merge_settle_moved", None)
                for r in reconstructions
            ]
        report["merge_time"] = time.time() - t0

    for k, r in enumerate(reconstructions):
        logger.info(
            "Reconstruction %d: %d images, %d points", k, len(r.shots), len(r.points)
        )
    logger.info("%d partial reconstructions in total.", len(reconstructions))
    chrono.lap("compute_reconstructions")
    report["wall_times"] = dict(chrono.lap_times())
    report["not_reconstructed_images"] = list(remaining_images)
    report["device"] = str(device)
    return report, reconstructions


def triangulation_reconstruction(data, tracks_manager, device=None):
    """Reconstruction from metadata-initialized poses: iterative
    retriangulation + bundle (reconstruction.py:1600-1665), on `device`."""
    from opensfm_tpu_torch.reconstruction_helpers import (
        reconstruction_from_metadata,
    )

    device = resolve_device(device)
    report: Dict[str, Any] = {}
    chrono = Chronometer()
    images = tracks_manager.get_shot_ids()
    reconstruction = reconstruction_from_metadata(data, images)

    config = data.config
    camera_priors = data.load_camera_models()
    rig_camera_priors = data.load_rig_cameras()
    gcp = data.load_ground_control_points()

    config_override = dict(config)
    config_override["triangulation_type"] = "ROBUST"
    config_override["bundle_max_iterations"] = 10

    report["steps"] = []
    outer_iterations = 3
    inner_iterations = 5
    for i in range(outer_iterations):
        rrep = retriangulate(tracks_manager, reconstruction, config_override,
                             device=device)
        step = {"retriangulation": rrep}
        report["steps"].append(step)
        for j in range(inner_iterations):
            if len(reconstruction.points) == 0:
                break
            align_reconstruction(reconstruction, gcp, config_override,
                                 device=device)
            step[f"bundle_{j}"] = bundle(
                reconstruction, camera_priors, rig_camera_priors, None,
                config_override, device=device,
            )
            remove_outliers(reconstruction, config_override)

    # GCP-only alignment + per-camera GPS bias, falling back to
    # uncompensated GPS if that fails (reconstruction.py:1656-1663).
    align_result = align_reconstruction(
        reconstruction, gcp, config, bias_override=True, device=device
    )
    if not align_result and config["bundle_compensate_gps_bias"]:
        config = dict(config)
        config["bundle_compensate_gps_bias"] = False
    report["bundle_final"] = bundle(
        reconstruction, camera_priors, rig_camera_priors, gcp, config,
        device=device)
    remove_outliers(reconstruction, config)
    paint_reconstruction(data, tracks_manager, reconstruction)
    chrono.lap("triangulation_reconstruction")
    report["wall_times"] = dict(chrono.lap_times())
    report["device"] = str(device)
    return report, [reconstruction]


def reconstruct_from_prior(data, tracks_manager, rec_prior, device=None):
    """Retriangulate a reconstruction from a prior model and bundle it
    (reconstruction.py:1789-1819), on `device`."""
    device = resolve_device(device)
    reconstruction = copy.deepcopy(rec_prior)
    report: Dict[str, Any] = {}
    config = data.config
    camera_priors = data.load_camera_models()
    rig_camera_priors = data.load_rig_cameras()
    gcp = data.load_ground_control_points()

    report["retriangulate"] = retriangulate(tracks_manager, reconstruction,
                                            config, device=device)
    align_reconstruction(reconstruction, gcp, config, device=device)
    report["bundle"] = bundle(
        reconstruction, camera_priors, rig_camera_priors, gcp, config,
        device=device,
    )
    remove_outliers(reconstruction, config)
    paint_reconstruction(data, tracks_manager, reconstruction)
    report["device"] = str(device)
    return report, reconstruction
