"""Rig handling: pattern-based rig instance grouping.

Port of the part of `opensfm_tpu.rig` that the growth loop calls
(reference `opensfm/rig.py`: rig_assignments_per_image:39,
find_image_rig:47, create_instances_with_patterns:70).  Rig calibration
(compute_relative_pose, create_rig_cameras_from_reconstruction,
create_rigs_with_pattern) is not ported, and the bundle raises on a rig
chain (`ba/lm.py` `_check_supported`).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Set, Tuple

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
