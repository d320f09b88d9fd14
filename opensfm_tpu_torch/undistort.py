"""Undistortion: rectify shots to ideal perspective, panoramas to cube faces.

Copy of `opensfm_tpu.undistort` (reference `opensfm/undistort.py:25-453`):
the ideal perspective camera of each model, the undistorted reconstruction
and tracks, and the undistorted images.  The pixel maps are computed on a
device in f64 (every destination pixel's bearing through the new camera,
projected through the old one: ComputeCameraMapping, geometry/camera.h:120)
and cast to f32, and the images resampled there by `ops.image.remap_linear`
(cv2.remap's INTER_LINEAR), so neither OpenCV nor PIL is needed.
"""

from __future__ import annotations

import logging
from timeit import default_timer as timer
from typing import Dict, List, Optional

import numpy as np
import torch

from opensfm_tpu_torch import pymap, resolve_device, types
from opensfm_tpu_torch.geometry.cameras import Camera, normalized_pixel_grid
from opensfm_tpu_torch.geometry.pose import Pose

logger = logging.getLogger(__name__)


def perspective_camera_from_perspective(camera: Camera) -> Camera:
    """Undistorted version of a perspective camera (undistort.py:253)."""
    new_camera = Camera.create_perspective(camera.focal, 0.0, 0.0)
    new_camera.id = camera.id
    new_camera.width = camera.width
    new_camera.height = camera.height
    return new_camera


def perspective_camera_from_brown(brown: Camera) -> Camera:
    """Ideal perspective camera from a Brown camera (undistort.py:264)."""
    new_camera = Camera.create_perspective(
        brown.focal * (1 + brown.aspect_ratio) / 2.0, 0.0, 0.0
    )
    new_camera.id = brown.id
    new_camera.width = brown.width
    new_camera.height = brown.height
    return new_camera


def perspective_camera_from_fisheye(fisheye: Camera) -> Camera:
    """Ideal perspective camera from a fisheye (undistort.py:277)."""
    new_camera = Camera.create_perspective(fisheye.focal, 0.0, 0.0)
    new_camera.id = fisheye.id
    new_camera.width = fisheye.width
    new_camera.height = fisheye.height
    return new_camera


def perspective_camera_from_fisheye_opencv(fisheye_opencv: Camera) -> Camera:
    new_camera = Camera.create_perspective(
        fisheye_opencv.focal * (1 + fisheye_opencv.aspect_ratio) / 2.0, 0.0, 0.0
    )
    new_camera.id = fisheye_opencv.id
    new_camera.width = fisheye_opencv.width
    new_camera.height = fisheye_opencv.height
    return new_camera


def perspective_camera_from_fisheye62(fisheye62: Camera) -> Camera:
    new_camera = Camera.create_perspective(
        fisheye62.focal * (1 + fisheye62.aspect_ratio) / 2.0, 0.0, 0.0
    )
    new_camera.id = fisheye62.id
    new_camera.width = fisheye62.width
    new_camera.height = fisheye62.height
    return new_camera


_PERSPECTIVE_FROM = {
    "perspective": perspective_camera_from_perspective,
    "brown": perspective_camera_from_brown,
    "fisheye": perspective_camera_from_fisheye,
    "fisheye_opencv": perspective_camera_from_fisheye_opencv,
    "fisheye62": perspective_camera_from_fisheye62,
    "radial": perspective_camera_from_brown,
    "simple_radial": perspective_camera_from_brown,
}
_PANORAMA = ("equirectangular", "spherical")


def undistort_reconstruction(
    tracks_manager: Optional[pymap.TracksManager],
    reconstruction: types.Reconstruction,
    data,
    udata,
) -> Dict[str, List[pymap.Shot]]:
    """Undistorted reconstruction + shot mapping (undistort.py:25-87)."""
    all_images = set(data.images()) if data else set(reconstruction.shots)
    urec = types.Reconstruction()
    urec.points = reconstruction.points
    urec.reference = reconstruction.reference
    rig_instance_count = iter(range(1_000_000))
    utracks_manager = pymap.TracksManager()

    logger.debug("Undistorting the reconstruction")
    undistorted_shots = {}
    for shot in reconstruction.shots.values():
        if shot.id not in all_images:
            continue
        pt = shot.camera.projection_type
        if pt in _PERSPECTIVE_FROM:
            ucamera = _PERSPECTIVE_FROM[pt](shot.camera)
            urec.add_camera(ucamera)
            subshots = [get_shot_with_different_camera(urec, shot, ucamera,
                                                       rig_instance_count)]
        elif pt in _PANORAMA:
            subshot_width = int(data.config["depthmap_resolution"]) if data else 640
            subshots = perspective_views_of_a_panorama(
                shot, subshot_width, urec, f"perspective_panorama_{shot.camera.id}",
                rig_instance_count,
            )
        else:
            logger.warning("Not undistorting unsupported camera type %s", pt)
            continue

        for subshot in subshots:
            if tracks_manager:
                add_subshot_tracks(tracks_manager, utracks_manager, shot, subshot)
        undistorted_shots[shot.id] = subshots

    udata.save_undistorted_reconstruction([urec])
    if tracks_manager:
        udata.save_undistorted_tracks_manager(utracks_manager)
    udata.save_undistorted_shot_ids(
        {shot_id: [s.id for s in subshots]
         for shot_id, subshots in undistorted_shots.items()}
    )
    return undistorted_shots


def get_shot_with_different_camera(
    urec: types.Reconstruction, shot: pymap.Shot, camera: Camera,
    rig_instance_count,
) -> pymap.Shot:
    """Same pose, new (undistorted) camera."""
    new_shot = urec.create_shot(shot.id, camera.id, shot.pose)
    new_shot.metadata.set(shot.metadata)
    return new_shot


PANORAMA_FACES = ["front", "left", "back", "right", "top", "bottom"]
PANORAMA_ROTATIONS = [
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
    [[0, 0, -1], [0, 1, 0], [1, 0, 0]],
    [[-1, 0, 0], [0, 1, 0], [0, 0, -1]],
    [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],
    [[1, 0, 0], [0, 0, -1], [0, 1, 0]],
    [[1, 0, 0], [0, 0, 1], [0, -1, 0]],
]


def perspective_views_of_a_panorama(
    spherical_shot: pymap.Shot, width: int, urec: types.Reconstruction,
    camera_id: str, rig_instance_count,
) -> List[pymap.Shot]:
    """Render a panorama as 6 cube faces grouped in a rig
    (undistort.py:310-357)."""
    camera = Camera.create_perspective(0.5, 0.0, 0.0)
    camera.id = camera_id
    camera.width = width
    camera.height = width
    urec.add_camera(camera)

    instance_id = f"panorama_rig_{next(rig_instance_count)}"
    urec.add_rig_instance(pymap.RigInstance(instance_id))
    shots = []
    for name, rotation in zip(PANORAMA_FACES, PANORAMA_ROTATIONS):
        rig_camera_id = f"{camera_id}_rig_{name}"
        if rig_camera_id not in urec.rig_cameras:
            rig_pose = Pose()
            rig_pose.set_rotation_matrix(np.array(rotation, dtype=np.float64))
            urec.add_rig_camera(pymap.RigCamera(rig_pose, rig_camera_id))
        shot_id = f"{spherical_shot.id}_perspective_view_{name}"
        shot = urec.create_shot(
            shot_id, camera.id,
            rig_camera_id=rig_camera_id, rig_instance_id=instance_id,
        )
        shot.metadata.set(spherical_shot.metadata)
        shots.append(shot)
    urec.rig_instances[instance_id].pose = spherical_shot.pose
    return shots


def compute_camera_mapping(
    from_camera: Camera, to_camera: Camera, width: int, height: int,
    rotation: Optional[np.ndarray] = None, device=None,
):
    """Pixel maps (map_x, map_y), [height, width] f32 tensors on `device`,
    resampling `from_camera` into `to_camera` (ComputeCameraMapping,
    geometry/camera.h:120): every destination pixel's bearing through
    `to_camera` (turned by `rotation`), projected through `from_camera`,
    in f64, then cast to f32."""
    dev = resolve_device(device)
    bearings = to_camera.bearings_many_torch(
        normalized_pixel_grid(width, height, dev))
    if rotation is not None:
        bearings = bearings @ torch.as_tensor(rotation, dtype=torch.float64,
                                              device=dev).T
    uv = from_camera.project_many_torch(bearings)
    size = max(from_camera.width, from_camera.height)
    map_x = uv[:, 0] * size + (from_camera.width - 1.0) / 2.0
    map_y = uv[:, 1] * size + (from_camera.height - 1.0) / 2.0
    return (map_x.reshape(height, width).to(torch.float32),
            map_y.reshape(height, width).to(torch.float32))


def undistort_image(
    image: np.ndarray, from_camera: Camera, to_camera: Camera,
    max_size: int = 100000, rotation: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Remap a uint8 image between camera models on `device`, as
    cv2.remap(..., INTER_LINEAR) does (`ops.image.remap_linear`)."""
    from opensfm_tpu_torch.ops.image import remap_linear

    width = min(to_camera.width, max_size)
    height = min(to_camera.height, max_size)
    map_x, map_y = compute_camera_mapping(
        from_camera, to_camera, width, height, rotation, device
    )
    return remap_linear(image, map_x, map_y, device).cpu().numpy()


def _pano_rotation(panoshot: pymap.Shot,
                   perspectiveshot: pymap.Shot) -> np.ndarray:
    """Relative rotation panorama -> perspective face."""
    return (perspectiveshot.pose.get_rotation_matrix()
            @ panoshot.pose.get_rotation_matrix().T)


def render_perspective_view_of_a_panorama(
    image: np.ndarray, panoshot: pymap.Shot, perspectiveshot: pymap.Shot,
    device=None,
) -> np.ndarray:
    """Render a cube face from a panorama (undistort.py:360-403)."""
    return undistort_image(
        image, panoshot.camera, perspectiveshot.camera,
        rotation=_pano_rotation(panoshot, perspectiveshot).T, device=device,
    )


def undistort_reconstruction_with_images(
    tracks_manager, reconstruction, data, udata, skip_images: bool = False,
    device=None, report: Optional[Dict] = None,
) -> Dict:
    """Undistort reconstruction + write undistorted images
    (undistort.py:90-127), the images remapped on `device`.  `report`,
    when given, receives the seconds spent loading, remapping and saving
    images and the number of images written."""
    dev = resolve_device(device)
    undistorted_shots = undistort_reconstruction(
        tracks_manager, reconstruction, data, udata
    )
    if skip_images:
        return undistorted_shots
    secs = {"load": 0.0, "remap": 0.0, "save": 0.0}
    written = 0
    max_size = data.config["undistorted_image_max_size"]
    for shot_id, subshots in undistorted_shots.items():
        shot = reconstruction.shots[shot_id]
        t0 = timer()
        image = data.load_image(shot_id)
        secs["load"] += timer() - t0
        for subshot in subshots:
            t0 = timer()
            if shot.camera.projection_type in _PANORAMA:
                undistorted = render_perspective_view_of_a_panorama(
                    image, shot, subshot, dev
                )
            else:
                undistorted = undistort_image(
                    image, shot.camera, subshot.camera, max_size, device=dev
                )
            t1 = timer()
            udata.save_undistorted_image(subshot.id, undistorted)
            secs["remap"] += t1 - t0
            secs["save"] += timer() - t1
            written += 1
        logger.info("Undistorted %s", shot_id)
    if report is not None:
        report.update(image_s=secs, images_written=written)
    return undistorted_shots


def _shot_observations(tracks_manager, shot_id):
    obs = tracks_manager.get_shot_observations(shot_id)
    points = np.array([o.point for o in obs.values()], dtype=np.float64)
    return obs, points.reshape(-1, 2)


def add_subshot_tracks(
    tracks_manager: pymap.TracksManager,
    utracks_manager: pymap.TracksManager,
    shot: pymap.Shot,
    subshot: pymap.Shot,
) -> None:
    """Remap tracks into the undistorted shots (undistort.py:406-450), all
    of a shot's observations in one batch."""
    if shot.id not in set(tracks_manager.get_shot_ids()):
        return
    if shot.camera.projection_type in _PANORAMA:
        add_pano_subshot_tracks(tracks_manager, utracks_manager, shot, subshot)
        return
    obs, points = _shot_observations(tracks_manager, shot.id)
    new_points = subshot.camera.project(shot.camera.bearing(points))
    for (track_id, o), p in zip(obs.items(), new_points):
        new_obs = o.copy()
        new_obs.point = p
        utracks_manager.add_observation(subshot.id, track_id, new_obs)


def add_pano_subshot_tracks(
    tracks_manager, utracks_manager, panoshot, perspectiveshot
) -> None:
    """Project panorama tracks into a cube face, keeping in-frustum obs."""
    rotation = _pano_rotation(panoshot, perspectiveshot)
    obs, points = _shot_observations(tracks_manager, panoshot.id)
    rotated = panoshot.camera.bearing(points) @ rotation.T
    front = rotated[:, 2] > 0
    features = np.zeros_like(points)
    features[front] = perspectiveshot.camera.project(rotated[front])
    keep = front & np.all((features >= -0.5) & (features <= 0.5), axis=1)
    for (track_id, o), p, k in zip(obs.items(), features, keep):
        if not k:
            continue
        new_obs = o.copy()
        new_obs.point = p
        utracks_manager.add_observation(perspectiveshot.id, track_id, new_obs)
