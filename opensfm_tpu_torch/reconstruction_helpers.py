"""Shot metadata helpers: EXIF -> ShotMeasurements, metadata-based poses.

Port of `opensfm_tpu.reconstruction_helpers` (reference
`opensfm/reconstruction_helpers.py:15-190`); host NumPy throughout.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Iterable, Optional

import numpy as np

from opensfm_tpu_torch import pymap, types
from opensfm_tpu_torch.geometry.pose import Pose, _rotvec_to_matrix_np

logger = logging.getLogger(__name__)

MAXIMUM_ALTITUDE = 1e4  # exif.py guard against bogus altitude tags


def guess_gravity_up_from_orientation_tag(orientation: int) -> np.ndarray:
    """Up vector in camera coords from the EXIF orientation tag
    (reconstruction_helpers.py:15-38)."""
    mapping = {
        1: [0, -1, 0], 2: [0, -1, 0], 3: [0, 1, 0], 4: [0, 1, 0],
        5: [-1, 0, 0], 6: [-1, 0, 0], 7: [1, 0, 0], 8: [1, 0, 0],
    }
    if orientation not in mapping:
        raise RuntimeError(f"Error: Unknown orientation tag: {orientation}")
    return np.array(mapping[orientation], dtype=np.float64)


def shot_gravity_up_in_image_axis(shot: pymap.Shot) -> Optional[np.ndarray]:
    if shot.metadata.gravity_down.has_value:
        return -np.asarray(shot.metadata.gravity_down.value, dtype=np.float64)
    if not shot.metadata.orientation.has_value:
        return None
    orientation = shot.metadata.orientation.value
    if not 1 <= orientation <= 8:
        logger.error("Unknown orientation tag %s for image %s", orientation, shot.id)
        orientation = 1
    return guess_gravity_up_from_orientation_tag(orientation)


def rotation_matrix_from_up_vector_and_compass(
    up_vector, compass_angle: float
) -> np.ndarray:
    """Camera rotation given up vector and compass (multiview.py:327-364)."""
    r3 = np.asarray(up_vector, dtype=np.float64)
    r3 = r3 / np.linalg.norm(r3)
    ez = np.array([0.0, 0.0, 1.0])
    r2 = ez - (ez @ r3) * r3
    r2n = np.linalg.norm(r2)
    if r2n > 1e-8:
        r2 /= r2n
        r1 = np.cross(r2, r3)
    else:
        r1 = np.array([1.0, 0.0, 0.0])
        r2 = np.cross(r3, r1)
    compass_rotation = _rotvec_to_matrix_np(
        np.radians(np.array([0.0, 0.0, compass_angle]))
    )
    return np.column_stack([r1, r2, r3]) @ compass_rotation


def rotation_from_orientation_compass(shot: pymap.Shot) -> Optional[np.ndarray]:
    up_vector = shot_gravity_up_in_image_axis(shot)
    if up_vector is None:
        return None
    angle = (
        shot.metadata.compass_angle.value
        if shot.metadata.compass_angle.has_value
        else 0.0
    )
    return rotation_matrix_from_up_vector_and_compass(list(up_vector), angle)


def rotation_from_angles(shot: pymap.Shot) -> Optional[np.ndarray]:
    if not shot.metadata.opk_angles.has_value:
        return None
    from opensfm_tpu_torch.geometry.angles import rotation_from_opk

    omega, phi, kappa = map(math.radians, shot.metadata.opk_angles.value)
    return rotation_from_opk(omega, phi, kappa)


def rotation_from_shot_metadata(shot: pymap.Shot) -> Optional[np.ndarray]:
    rotation = rotation_from_angles(shot)
    if rotation is None:
        rotation = rotation_from_orientation_compass(shot)
    return rotation


def exif_to_metadata(
    exif: Dict[str, Any], use_altitude: bool, reference
) -> pymap.ShotMeasurements:
    """Raw EXIF dict -> ShotMeasurements
    (reconstruction_helpers.py:129-178)."""
    metadata = pymap.ShotMeasurements()

    gps = exif.get("gps")
    if gps and "latitude" in gps and "longitude" in gps:
        lat, lon = gps["latitude"], gps["longitude"]
        if use_altitude:
            alt = min([MAXIMUM_ALTITUDE, gps.get("altitude", 2.0)])
        else:
            alt = 2.0  # arbitrary value used to align the reconstruction
        x, y, z = reference.to_topocentric(lat, lon, alt)
        metadata.gps_position.value = np.array([x, y, z])
        metadata.gps_accuracy.value = gps.get("dop", 15.0)
        if metadata.gps_accuracy.value == 0.0:
            metadata.gps_accuracy.value = 15.0

    opk = exif.get("opk")
    if opk and all(k in opk for k in ("omega", "phi", "kappa")):
        metadata.opk_angles.value = np.array(
            [opk["omega"], opk["phi"], opk["kappa"]]
        )
        metadata.opk_accuracy.value = opk.get("accuracy", 1.0)

    metadata.orientation.value = exif.get("orientation", 1)

    if "gravity_down" in exif:
        metadata.gravity_down.value = np.asarray(exif["gravity_down"])
    if "compass" in exif:
        metadata.compass_angle.value = exif["compass"]["angle"]
        if exif["compass"].get("accuracy") is not None:
            metadata.compass_accuracy.value = exif["compass"]["accuracy"]
    if "capture_time" in exif:
        metadata.capture_time.value = exif["capture_time"]
    if "skey" in exif:
        metadata.sequence_key.value = exif["skey"]
    return metadata


def get_image_metadata(data, image: str) -> pymap.ShotMeasurements:
    exif = data.load_exif(image)
    reference = data.load_reference()
    return exif_to_metadata(exif, data.config["use_altitude_tag"], reference)


def reconstruction_from_metadata(data, images: Iterable[str]) -> types.Reconstruction:
    """Initialize shot poses from EXIF GPS/orientation
    (reconstruction_helpers.py:86-127)."""
    from opensfm_tpu_torch import rig

    data.init_reference()
    rig_assignments = rig.rig_assignments_per_image(data.load_rig_assignments())

    reconstruction = types.Reconstruction()
    reconstruction.reference = data.load_reference()
    reconstruction.cameras = data.load_camera_models()
    for image in images:
        camera_id = data.load_exif(image)["camera"]
        if image in rig_assignments:
            rig_instance_id, rig_camera_id, _ = rig_assignments[image]
        else:
            rig_instance_id = image
            rig_camera_id = camera_id
        if rig_camera_id not in reconstruction.rig_cameras:
            reconstruction.add_rig_camera(pymap.RigCamera(Pose(), rig_camera_id))
        if rig_instance_id not in reconstruction.rig_instances:
            reconstruction.add_rig_instance(pymap.RigInstance(rig_instance_id))
        shot = reconstruction.create_shot(
            shot_id=image,
            camera_id=camera_id,
            rig_camera_id=rig_camera_id,
            rig_instance_id=rig_instance_id,
        )
        shot.metadata = get_image_metadata(data, image)
        if not shot.metadata.gps_position.has_value:
            reconstruction.remove_shot(image)
            continue
        gps_pos = shot.metadata.gps_position.value
        pose = Pose()
        rotation = rotation_from_shot_metadata(shot)
        if rotation is not None:
            pose.set_rotation_matrix(rotation)
        pose.set_origin(gps_pos)
        # For true multi-shot rigs the per-shot metadata pose is resolved by
        # rig calibration, not here (mirrors Shot::GetPose copy semantics).
        if len(shot.rig_instance.shots) == 1:
            shot.rig_instance.update_instance_pose_with_shot(image, pose)
        shot.scale = 1.0
    return reconstruction
