"""GCP-driven bundle analysis: alignment, reprojection audit, covariance.

Port of `annotation_gui_gcp/run_ba.py`, which mirrors the reference
`annotation_gui_gcp/run_ba.py` (merge_reconstructions:27,
resplit_reconstruction:64, gcp_geopositional_error:91, triangulate_gcps:128,
reproject_gcps:144, compute_gcp_std:198, find_alignment:210,
bundle_with_fixed_images:274, decompose_covariance:361, main:901).

The GCP triangulations, the similarity fit and the fixed-image bundle with
covariance recovery run on `device` (CUDA unless told otherwise): the
bundle on the port's LM core (`opensfm_tpu_torch.ba.lm`), whose mono
perspective maps take the hand-written kernels; marginal pose covariances
come from the Schur-reduced camera system.

    python -m opensfm_tpu_torch.annotation.run_ba <dataset> [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from opensfm_tpu_torch import dataset, log, multiview, resolve_device, types
from opensfm_tpu_torch.align import apply_similarity
from opensfm_tpu_torch.ba.lm import bundle_adjust
from opensfm_tpu_torch.ba.problem import _Builder
from opensfm_tpu_torch.geometry.transform import similarity_between_points

logger = logging.getLogger(__name__)


def merge_reconstructions(reconstructions, tracks_manager):
    """Merge points and shots of several reconstructions without alignment;
    track ids get an R<i>_ prefix (run_ba.py:27-62)."""
    merged = types.Reconstruction()
    merged.reference = reconstructions[0].reference
    for ix_r, reconstruction in enumerate(reconstructions):
        for camera in reconstruction.cameras.values():
            merged.add_camera(camera)
        for point in reconstruction.points.values():
            new_point = merged.create_point(
                f"R{ix_r}_{point.id}", point.coordinates
            )
            new_point.color = point.color
        for shot in reconstruction.shots.values():
            merged.add_shot(shot)
            obsdict = tracks_manager.get_shot_observations(shot.id)
            for track_id, obs in obsdict.items():
                merged_track_id = f"R{ix_r}_{track_id}"
                if merged_track_id in merged.points:
                    merged.add_observation(shot.id, merged_track_id, obs)
    return merged


def resplit_reconstruction(merged, original_reconstructions):
    """Invert merge_reconstructions (run_ba.py:64-88)."""
    split = []
    for ix_r, original in enumerate(original_reconstructions):
        r = types.Reconstruction()
        r.reference = merged.reference
        for shot_id in original.shots:
            r.add_shot(merged.shots[shot_id])
        for point_id in original.points:
            merged_point = merged.points[f"R{ix_r}_{point_id}"]
            new_point = r.create_point(point_id, merged_point.coordinates)
            new_point.color = merged_point.color
        for camera_id in original.cameras:
            r.add_camera(merged.cameras[camera_id])
        split.append(r)
    return split


def triangulate_gcps(gcps, reconstruction, device=None):
    return [
        multiview.triangulate_gcp(gcp, reconstruction.shots, device=device)
        for gcp in gcps
    ]


def gcp_geopositional_error(gcps, reconstruction, device=None):
    """Triangulated-vs-surveyed GCP position errors (run_ba.py:91-126)."""
    coords = triangulate_gcps(gcps, reconstruction, device=device)
    out = {}
    for gcp, triangulated in zip(gcps, coords):
        expected = (
            np.asarray(reconstruction.reference.to_topocentric(*gcp.lla_vec))
            if gcp.lla else None
        )
        if expected is not None and triangulated is not None:
            error = float(np.linalg.norm(expected - triangulated))
            planar = float(
                np.linalg.norm(expected[:2] - np.asarray(triangulated)[:2])
            )
            out[gcp.id] = {
                "expected_xyz": [float(x) for x in expected],
                "triangulated_xyz": [float(x) for x in triangulated],
                "error": error,
                "error_planar": planar,
            }
        else:
            out[gcp.id] = {"error": float("nan"), "error_planar": float("nan")}
    return out


def reproject_gcps(gcps, reconstruction, reproj_threshold=1.0, device=None):
    """Per-observation reprojection errors of triangulated GCPs
    (run_ba.py:144-178)."""
    output = {}
    for gcp in gcps:
        point = multiview.triangulate_gcp(gcp, reconstruction.shots,
                                          device=device)
        output[gcp.id] = {}
        if point is None:
            logger.info(
                "Could not triangulate %s with %d annotations",
                gcp.id, len(gcp.observations),
            )
            continue
        for observation in gcp.observations:
            if observation.shot_id not in reconstruction.shots:
                continue
            shot = reconstruction.shots[observation.shot_id]
            reproj = shot.project(point)
            error = float(np.linalg.norm(reproj - observation.projection))
            output[gcp.id][observation.shot_id] = {
                "error": error,
                "reprojection": [float(reproj[0]), float(reproj[1])],
            }
    return output


def get_sorted_reprojection_errors(gcp_reprojections):
    output = []
    for gcp_id in gcp_reprojections:
        for shot_id in gcp_reprojections[gcp_id]:
            e = gcp_reprojections[gcp_id][shot_id]["error"]
            output.append((gcp_id, shot_id, e))
    return sorted(output, key=lambda t: -t[2])


def get_number_of_wrong_annotations_per_gcp(gcp_reprojections, wrong_threshold):
    return {
        gcp_id: sum(
            1 for r in reprojections.values() if r["error"] > wrong_threshold
        )
        for gcp_id, reprojections in gcp_reprojections.items()
    }


def compute_gcp_std(gcp_errors):
    """RMS of all GCP reprojection errors (run_ba.py:198-207)."""
    all_errors = []
    for gcp_id in gcp_errors:
        errors = [e["error"] for e in gcp_errors[gcp_id].values()]
        if errors:
            logger.info(
                "gcp %s mean reprojection error = %g", gcp_id, np.mean(errors)
            )
        all_errors.extend(errors)
    all_errors = [e for e in all_errors if np.isfinite(e)]
    if not all_errors:
        return float("nan")
    return float(np.sqrt(np.mean(np.square(all_errors))))


def find_alignment(points0, points1, device=None):
    """(s, A, b) with points0 = s * A * points1 + b (run_ba.py:210-226).
    The Umeyama fit runs in f64 on `device`; a reflection (negative
    determinant) or fewer than 3 common points raises RuntimeError."""
    v0, v1 = [], []
    for p0, p1 in zip(points0, points1):
        if p0 is not None and p1 is not None:
            v0.append(np.asarray(p0))
            v1.append(np.asarray(p1))
    if len(v0) < 3:
        raise RuntimeError("Need at least 3 common GCPs to align")
    dev = resolve_device(device)
    T = similarity_between_points(
        torch.as_tensor(np.array(v1), dtype=torch.float64, device=dev),
        torch.as_tensor(np.array(v0), dtype=torch.float64, device=dev),
    ).cpu().numpy()
    sA = T[:3, :3]
    det = float(np.linalg.det(sA))
    if not det > 0.0:
        raise RuntimeError(f"Degenerate GCP alignment (det {det:g})")
    s = float(det ** (1.0 / 3.0))
    return s, sA / s, T[:3, 3]


def bundle_with_fixed_images(
    reconstruction, camera_priors, gcp, gcp_std, fixed_images, config,
    covariance=True, device=None,
):
    """Bundle adjust keeping some shots fixed, with optional pose
    covariance recovery (run_ba.py:274-358; covariance=False is the GUI's
    'flex' analysis mode).  With covariances, every shot of an instance
    gets that instance's block, fixed instances included."""
    builder = _Builder(reconstruction, config)
    for cam_id, camera in reconstruction.cameras.items():
        prior = camera_priors.get(cam_id, camera)
        builder.add_camera(camera, prior, fixed=True)
    for rig_camera in reconstruction.rig_cameras.values():
        builder.add_rig_camera(rig_camera, fixed=True)
    for instance in reconstruction.rig_instances.values():
        fixed = all(s in fixed_images for s in instance.shots)
        builder.add_instance(instance, fixed=fixed)
    for point in reconstruction.points.values():
        p_idx = builder.add_point(point.id, fixed=False)
        builder.add_point_prior(
            p_idx, point.coordinates, np.full(3, 1.0 / 100.0)
        )

    for shot in reconstruction.shots.values():
        i_idx = builder.inst_index[shot.rig_instance.id]
        r_idx = builder.rigcam_index[shot.rig_camera.id]
        c_idx = builder.cam_index[shot.camera.id]
        for lm_id, obs in shot.get_landmark_observations().items():
            p_idx = builder.point_index.get(lm_id)
            if p_idx is None:
                continue
            builder.add_obs(
                obs.point, obs.scale, p_idx, i_idx, r_idx, c_idx,
                shot.camera.projection_type,
            )

    # GCP observations with the measured annotation std.
    extra_coords = {}
    for point in gcp:
        coords = multiview.triangulate_gcp(point, reconstruction.shots,
                                           device=device)
        if coords is None:
            if point.lla:
                coords = np.asarray(
                    reconstruction.reference.to_topocentric(*point.lla_vec)
                )
            else:
                logger.warning("Cannot initialize GCP '%s'", point.id)
                continue
        point_id = "gcp-" + point.id
        p_idx = builder.add_point(point_id, fixed=False)
        extra_coords[point_id] = coords
        for observation in point.observations:
            shot = reconstruction.shots.get(observation.shot_id)
            if shot is None:
                continue
            builder.add_obs(
                observation.projection, gcp_std, p_idx,
                builder.inst_index[shot.rig_instance.id],
                builder.rigcam_index[shot.rig_camera.id],
                builder.cam_index[shot.camera.id],
                shot.camera.projection_type,
            )

    problem = builder.build(extra_coords)
    result = bundle_adjust(
        problem,
        max_iterations=int(config["bundle_max_iterations"]),
        compute_covariances=covariance,
        device=device,
    )
    builder.writeback(result)

    if not covariance:
        return False
    if not result.covariance_valid:
        logger.warning("Could not compute covariance")
    else:
        for i, iid in enumerate(builder.inst_ids):
            cov = result.covariances[i]
            for shot in reconstruction.rig_instances[iid].shots.values():
                shot.covariance = np.asarray(cov)
    return result.covariance_valid


def decompose_covariance(covariance):
    """Rotation + per-axis sigma from a covariance (run_ba.py:361-364)."""
    u, s, _ = np.linalg.svd(covariance)
    return u, np.sqrt(s)


def align(path: str, rec_a_ix: int = 0, rec_b_ix: int = 1,
          std_threshold: float = 0.3, px_threshold: float = 0.016,
          mode: str = "full", device=None):
    """Align reconstruction b onto a via shared GCPs and analyze
    (run_ba.py:622-898), writing `gcp_std_report.json`.  Modes mirror the
    reference GUI's three analysis buttons (lib/GUI.py:103-134): 'rigid' =
    similarity alignment only (--rigid), 'flex' = alignment + flexible
    bundle without covariances, 'full' = alignment + bundle + pose-covariance
    recovery.  Device math runs on `device` (CUDA unless told otherwise)."""
    device = resolve_device(device)
    data = dataset.DataSet(path)
    gcps = data.load_ground_control_points()
    if not gcps:
        raise RuntimeError("No ground control points in the dataset")
    tracks_manager = data.load_tracks_manager()
    all_recs = data.load_reconstruction()
    if len(all_recs) < 2:
        raise RuntimeError("Need at least two reconstructions to align")
    rec_a, rec_b = all_recs[rec_a_ix], all_recs[rec_b_ix]
    camera_priors = data.load_camera_models()

    for rec in (rec_a, rec_b):
        rec.add_correspondences_from_tracks_manager(tracks_manager)

    # Align b to a through the GCP triangulations.
    coords_a = triangulate_gcps(gcps, rec_a, device=device)
    coords_b = triangulate_gcps(gcps, rec_b, device=device)
    s, A, b = find_alignment(coords_a, coords_b, device=device)
    apply_similarity(rec_b, s, A, b)

    if mode == "rigid":
        merged = merge_reconstructions([rec_a, rec_b], tracks_manager)
        gcp_reprojections = reproject_gcps(gcps, merged, device=device)
        err = compute_gcp_std(gcp_reprojections)
        report = {
            "mode": "rigid",
            "alignment": {"scale": s, "translation": [float(x) for x in b]},
            "gcp_reprojection_rms": err,
            "gcp_errors_after_rigid": gcp_geopositional_error(
                gcps, merged, device=device),
        }
        with open(os.path.join(path, "gcp_std_report.json"), "w") as f:
            json.dump(report, f, indent=4)
        return report

    # Merge, bundle with a's shots fixed, recover covariances (full).
    merged = merge_reconstructions([rec_a, rec_b], tracks_manager)
    covariance_valid = bundle_with_fixed_images(
        merged, camera_priors, gcps, gcp_std=0.004,
        fixed_images=set(rec_a.shots), config=data.config,
        covariance=(mode == "full"), device=device,
    )

    gcp_reprojections = reproject_gcps(gcps, merged, device=device)
    err = compute_gcp_std(gcp_reprojections)

    shot_stds = []
    for shot_id in rec_b.shots:
        shot = merged.shots[shot_id]
        if shot.covariance is not None:
            _, sigmas = decompose_covariance(
                np.asarray(shot.covariance)[3:, 3:]
            )
            shot_stds.append((shot_id, float(max(sigmas))))
    median_std = (
        float(np.median([s for _, s in shot_stds])) if shot_stds else None
    )

    report = {
        "mode": mode,
        "alignment": {"scale": s, "translation": [float(x) for x in b]},
        "covariance_valid": bool(covariance_valid),
        "gcp_reprojection_rms": err,
        "median_shot_std": median_std,
        "shot_stds": sorted(shot_stds, key=lambda t: -t[1]),
        "accepted": bool(
            covariance_valid
            and median_std is not None
            and median_std < std_threshold
            and err < px_threshold
        ),
    }
    with open(os.path.join(path, "gcp_std_report.json"), "w") as f:
        json.dump(report, f, indent=4)
    return report


def parse_args(argv: Optional[list] = None):
    parser = argparse.ArgumentParser(
        description="Bundle with GCPs and analyze pose uncertainty"
    )
    parser.add_argument("dataset", help="dataset path")
    parser.add_argument("--rec-a", type=int, default=0)
    parser.add_argument("--rec-b", type=int, default=1)
    parser.add_argument("--std-threshold", type=float, default=0.3)
    parser.add_argument("--px-threshold", type=float, default=0.016)
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: cuda; 'cpu' to run on the "
        "CPU)",
    )
    return parser.parse_args(argv)


def main(argv: Optional[list] = None) -> None:
    log.setup()
    args = parse_args(argv)
    report = align(
        args.dataset, args.rec_a, args.rec_b,
        args.std_threshold, args.px_threshold, device=args.device,
    )
    logger.info(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
