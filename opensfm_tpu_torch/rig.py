"""Rig handling: pattern-based rig instance grouping and rig calibration.

Port of `opensfm_tpu.rig` (reference `opensfm/rig.py`:
rig_assignments_per_image:39, find_image_rig:47,
create_instances_with_patterns:70, compute_relative_pose:210,
create_rig_cameras_from_reconstruction:264, create_rigs_with_pattern:298):
images are grouped into rig instances by filename patterns, and the rig
cameras' relative poses are calibrated by an incremental reconstruction of
a GPS-connected subset of the instances (the `create_rig` command), run by
the port's own stages on a device.  The GPS neighbourhood graph's
connected components come from a union-find here (the reference uses
networkx), in networkx's order.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Set, Tuple

import numpy as np

from opensfm_tpu_torch import pymap, types
from opensfm_tpu_torch.geometry.pose import Pose

logger = logging.getLogger(__name__)

TRigPatterns = Dict[str, str]
TRigCameraGroup = Set[str]
TRigImage = Tuple[str, str]
TRigInstance = List[TRigImage]


def find_image_rig(image: str, rig_patterns: TRigPatterns):
    """(rig camera id, instance member id) for an image given patterns
    (rig.py:47-67)."""
    for rig_camera_id, pattern in rig_patterns.items():
        instance_member_id = re.sub(pattern, "", image)
        if instance_member_id == image:
            continue
        if instance_member_id != "":
            return rig_camera_id, instance_member_id
    return None, None


def create_instances_with_patterns(
    images: List[str], rig_patterns: TRigPatterns
) -> Tuple[Dict[str, TRigInstance], List[str]]:
    """Group images into rig instances by filename patterns (rig.py:70-102)."""
    per_instance: Dict[str, TRigInstance] = {}
    single_shots: List[str] = []
    for image in images:
        rig_camera_id, instance_member_id = find_image_rig(image, rig_patterns)
        if not rig_camera_id:
            single_shots.append(image)
            continue
        per_instance.setdefault(instance_member_id, []).append(
            (image, rig_camera_id)
        )

    instances_per_rig: Dict[str, TRigInstance] = {}
    for member_id, instance in per_instance.items():
        if len(instance) > 1:
            instances_per_rig[member_id] = instance
        else:
            single_shots += [image for image, _ in instance]
    return instances_per_rig, single_shots


def rig_assignments_per_image(
    rig_assignments: List[List[Tuple[str, str]]],
) -> Dict[str, Tuple[str, str, List[str]]]:
    """image -> (instance id, rig camera id, all images of the instance)
    (rig.py:39-45)."""
    assignments_per_image = {}
    for instance_id, instance in enumerate(rig_assignments):
        instance_shots = [s[0] for s in instance]
        for shot_id, rig_camera_id in instance:
            assignments_per_image[shot_id] = (
                str(instance_id), rig_camera_id, instance_shots,
            )
    return assignments_per_image


def compute_relative_pose(
    pose_instances: List[List[Tuple[pymap.Shot, str]]],
) -> Dict[str, pymap.RigCamera]:
    """Average rig camera poses over instances (rig.py:210-261): each
    instance's frame is its first shot's rotation at the mean of its shot
    centres; a rig camera's pose is its shot's pose relative to that frame,
    averaged over the instances (the chordal mean of the rotations, the
    mean of the translations)."""
    centers_shots: Dict[str, List[np.ndarray]] = {}
    rotation_shots: Dict[str, List[np.ndarray]] = {}
    for instance in pose_instances:
        origin_center = np.zeros(3)
        for shot, _ in instance:
            origin_center += shot.pose.get_origin()
        origin_center /= len(instance)
        R_instance = instance[0][0].pose.get_rotation_matrix()
        t_instance = -R_instance @ origin_center
        for shot, rig_camera_id in instance:
            # pose(rig camera) = pose(shot) o pose(instance)^-1
            R_rc = shot.pose.get_rotation_matrix() @ R_instance.T
            t_rc = shot.pose.translation - R_rc @ t_instance
            rotation_shots.setdefault(rig_camera_id, []).append(R_rc)
            centers_shots.setdefault(rig_camera_id, []).append(t_rc)

    rig_cameras: Dict[str, pymap.RigCamera] = {}
    for rig_camera_id in centers_shots:
        M = np.array(rotation_shots[rig_camera_id]).mean(axis=0)
        U, _, Vt = np.linalg.svd(M)
        R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
        pose = Pose()
        pose.set_rotation_matrix(R)
        pose.translation = np.array(centers_shots[rig_camera_id]).mean(axis=0)
        rig_cameras[rig_camera_id] = pymap.RigCamera(pose, rig_camera_id)
    return rig_cameras


def group_instances(
    rig_instances: Dict[str, TRigInstance],
) -> Dict[str, List[TRigInstance]]:
    """Group instances by their rig-camera signature (rig.py:118-127)."""
    per_rig_camera_group: Dict[str, List[TRigInstance]] = {}
    for cameras in rig_instances.values():
        cameras_group = ", ".join(sorted({c for _, c in cameras}))
        per_rig_camera_group.setdefault(cameras_group, []).append(cameras)
    return per_rig_camera_group


def _components_by_size(edges: List[Tuple[int, int]]) -> List[Set[int]]:
    """Connected components of the graph of `edges`, largest first, ties in
    the order networkx's `connected_components` yields them (by the first
    node of each in node-insertion order)."""
    parent: Dict[int, int] = {}  # in node-insertion order

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        for n in (a, b):
            parent.setdefault(n, n)
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    comps: Dict[int, Set[int]] = {}
    for n in list(parent):
        comps.setdefault(find(n), set()).add(n)
    return sorted(comps.values(), key=len, reverse=True)


def propose_subset_dataset_from_instances(
    data, rig_instances: Dict[str, TRigInstance], name: str
):
    """Yield (subset dataset, its instances): for each rig-camera group the
    largest connected set of instances in the graph joining each instance
    to its 6 nearest by GPS, at most `rig_calibration_subset_size` of them
    drawn at random (seed 42) on every round (rig.py:130-207)."""
    from scipy import spatial

    per_rig_camera_group = group_instances(rig_instances)
    data.init_reference()
    reference = data.load_reference()

    instances_to_pick: Dict[str, List[TRigInstance]] = {}
    for key, instances in per_rig_camera_group.items():
        gpses = []
        for i, instance in enumerate(instances):
            all_gps = []
            for image, _ in instance:
                gps = data.load_exif(image).get("gps", {})
                if "latitude" not in gps:
                    continue
                all_gps.append(
                    reference.to_topocentric(gps["latitude"], gps["longitude"], 0)
                )
            if all_gps:
                gpses.append((i, np.average(np.array(all_gps), axis=0)))
        if not gpses:
            instances_to_pick[key] = instances
            continue
        tree = spatial.cKDTree([x[1] for x in gpses])
        nn = min(6, len(gpses))
        edges = []
        for i, gps in gpses:
            distances, neighbors = tree.query(gps, k=nn)
            for n in np.atleast_1d(neighbors):
                if i == n or n >= len(gpses):
                    continue
                edges.append((i, gpses[n][0]))
        components = _components_by_size(edges)
        if components:
            instances_to_pick[key] = [instances[i]
                                      for i in list(components[0])]
        else:
            instances_to_pick[key] = instances

    rng = np.random.default_rng(42)
    subset_size = data.config["rig_calibration_subset_size"]
    while True:
        picked = []
        for key, instances in instances_to_pick.items():
            if len(instances) <= subset_size:
                picked += instances
            else:
                idx = rng.choice(len(instances), subset_size, replace=False)
                picked += [instances[i] for i in idx]
        images = [image for instance in picked for image, _ in instance]
        yield data.subset(name, images), picked


def count_reconstructed_instances(
    instances: List[TRigInstance], reconstruction
) -> int:
    """Instances whose every shot was reconstructed (rig.py:390-401)."""
    instances_map = {}
    instances_count = {}
    for i, instance in enumerate(instances):
        instances_count[i] = len(instance)
        for shot_id, _ in instance:
            instances_map[shot_id] = i
    for s in reconstruction.shots:
        if s in instances_map:
            instances_count[instances_map[s]] -= 1
    return len(instances) - sum(1 for c in instances_count.values() if c > 0)


def create_rig_cameras_from_reconstruction(
    reconstruction: types.Reconstruction, instances: List[TRigInstance]
) -> Dict[str, pymap.RigCamera]:
    """Rig cameras from the shot poses of a reconstruction, over the
    instances whose every shot it holds (rig.py:264-295)."""
    pose_instances = []
    for instance in instances:
        shots = []
        for image, rig_camera_id in instance:
            if image not in reconstruction.shots:
                break
            shots.append((reconstruction.shots[image], rig_camera_id))
        else:
            if shots:
                pose_instances.append(shots)
    return compute_relative_pose(pose_instances)


def create_rigs_with_pattern(data, patterns: TRigPatterns,
                             device=None) -> None:
    """Group the images into rig instances by `patterns` and calibrate the
    rig cameras by an incremental reconstruction of a subset of instances,
    up to `rig_calibration_max_rounds` subsets, on `device` (CUDA unless
    told otherwise); save `rig_cameras.json` and `rig_assignments.json`
    from the first subset that reconstructs every rig camera and at least
    `rig_calibration_completeness` of its instances (rig.py:298-387)."""
    from opensfm_tpu_torch.actions import (
        create_tracks,
        detect_features,
        extract_metadata,
        match_features,
        reconstruct,
    )

    instances_per_rig, single_shots = create_instances_with_patterns(
        data.images(), patterns
    )
    logger.info(
        "Found %d rig instances and %d single shots via pattern matching",
        len(instances_per_rig), len(single_shots),
    )

    count = 0
    max_rounds = data.config["rig_calibration_max_rounds"]
    best_rig_cameras = None
    for subset_data, instances in propose_subset_dataset_from_instances(
        data, instances_per_rig, "rig_calibration"
    ):
        if count >= max_rounds:
            break
        count += 1
        if len(subset_data.images()) == 0:
            continue
        logger.info(
            "Running SfM on a subset of %d images (round %d/%d)",
            len(subset_data.images()), count, max_rounds,
        )
        extract_metadata.run_dataset(subset_data)
        detect_features.run_dataset(subset_data, device=device)
        match_features.run_dataset(subset_data, device=device)
        create_tracks.run_dataset(subset_data, device=device)
        reconstruct.run_dataset(subset_data, "incremental", device=device)

        reconstructions = subset_data.load_reconstruction()
        if not reconstructions:
            logger.error("No reconstruction for the rig calibration subset.")
            continue
        reconstruction = reconstructions[0]

        rig_cameras = create_rig_cameras_from_reconstruction(
            reconstruction, list(instances_per_rig.values())
        )
        found_cameras = {c for i in instances_per_rig.values() for _, c in i}
        if set(rig_cameras.keys()) != found_cameras:
            logger.error(
                "Calibrated %d rig cameras but %d requested.",
                len(rig_cameras), len(found_cameras),
            )
            continue

        reconstructed = count_reconstructed_instances(instances, reconstruction)
        if reconstructed < len(instances) * data.config[
            "rig_calibration_completeness"
        ]:
            logger.error(
                "Not enough reconstructed instances: %d / %d",
                reconstructed, len(instances),
            )
            continue
        best_rig_cameras = rig_cameras
        break

    if best_rig_cameras is not None:
        data.save_rig_cameras(best_rig_cameras)
        data.save_rig_assignments(list(instances_per_rig.values()))
    else:
        logger.error("Could not calibrate rigs from image subsets")
