"""Per-shot 2.5D triangle meshes for the viewer.

Copy of `opensfm_tpu.mesh` (reference `opensfm/mesh.py:15-191`):
Delaunay-triangulate the reconstructed points visible in the image plane,
backed by the image corners at a far plane (scipy, on the host).
"""

from __future__ import annotations

import logging

import numpy as np

from opensfm_tpu_torch import pymap, types

logger = logging.getLogger(__name__)

PERSPECTIVE_TYPES = (
    "perspective", "brown", "radial", "simple_radial", "fisheye",
    "fisheye_opencv", "fisheye62", "fisheye624",
)


def triangle_mesh(
    shot_id: str, r: types.Reconstruction, tracks_manager: pymap.TracksManager
):
    """Triangle mesh of the reconstructed points seen in a shot
    (mesh.py:15-46)."""
    if shot_id not in r.shots or shot_id not in set(tracks_manager.get_shot_ids()):
        return [], []
    shot = r.shots[shot_id]
    if shot.camera.projection_type in PERSPECTIVE_TYPES:
        return triangle_mesh_perspective(shot_id, r, tracks_manager)
    if shot.camera.projection_type in ("equirectangular", "spherical"):
        return triangle_mesh_spherical(shot_id, r, tracks_manager)
    return [], []


def triangle_mesh_perspective(
    shot_id: str, r: types.Reconstruction, tracks_manager: pymap.TracksManager
):
    """Image-plane Delaunay over visible points (mesh.py:49-106)."""
    from scipy.spatial import Delaunay

    shot = r.shots[shot_id]
    cam = shot.camera

    dx = float(cam.width) / 2 / max(cam.width, cam.height)
    dy = float(cam.height) / 2 / max(cam.width, cam.height)
    corner_pixels = [[-dx, -dy], [-dx, dy], [dx, dy], [dx, -dy]]

    point_vertices, point_pixels, depths = [], [], []
    for track_id, obs in tracks_manager.get_shot_observations(shot_id).items():
        if track_id in r.points:
            point = r.points[track_id]
            depth = shot.pose.transform(point.coordinates)[2]
            if depth > 0:
                point_vertices.append(point.coordinates.tolist())
                depths.append(depth)
                point_pixels.append(obs.point.tolist())
    if len(depths) == 0:
        return [], []
    meandepth = np.median(depths)

    # Back the image corners at 4x the median depth.
    corner_vertices = []
    for pixel in corner_pixels:
        back_bearing = cam.bearing(np.asarray(pixel))
        point = shot.pose.transform_inverse(
            back_bearing * 4.0 * meandepth / back_bearing[2]
        )
        corner_vertices.append(point.tolist())
    vertices = corner_vertices + point_vertices
    pixels = corner_pixels + point_pixels

    try:
        tri = Delaunay(np.asarray(pixels))
    except Exception as e:  # scipy's QhullError on degenerate inputs
        logger.warning("Delaunay failed for %s: %s", shot_id, e)
        return [], []
    faces = tri.simplices.tolist()
    return vertices, faces


def triangle_mesh_spherical(
    shot_id: str, r: types.Reconstruction, tracks_manager: pymap.TracksManager
):
    """Spherical convex-hull mesh for panoramas (mesh.py:109-160)."""
    from scipy.spatial import ConvexHull

    shot = r.shots[shot_id]
    bearings = [
        np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, -1.0]),
        np.array([0.0, 1.0, 0.0]), np.array([0.0, -1.0, 0.0]),
        np.array([1.0, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0]),
    ]
    vertices = []
    depths = []
    for track_id, obs in tracks_manager.get_shot_observations(shot_id).items():
        if track_id in r.points:
            point = r.points[track_id].coordinates
            direction = shot.pose.transform(point)
            depth = np.linalg.norm(direction)
            if depth > 1e-6:
                bearings.append(direction / depth)
                vertices.append(point.tolist())
                depths.append(depth)
    if not vertices:
        return [], []
    meandepth = np.median(depths)
    for bearing in bearings[:6]:
        point = shot.pose.transform_inverse(bearing * 4.0 * meandepth)
        vertices.insert(0, point.tolist())
    vertices = vertices[:6][::-1] + vertices[6:]
    try:
        hull = ConvexHull(np.asarray(bearings))
    except Exception as e:  # scipy's QhullError on degenerate inputs
        logger.warning("ConvexHull failed for %s: %s", shot_id, e)
        return [], []
    return vertices, hull.simplices.tolist()
