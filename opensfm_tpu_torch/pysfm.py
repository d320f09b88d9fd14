"""`pysfm`-shaped API surface.

Port of `opensfm_tpu.pysfm`.  The reference exposes a pybind11 module
`pysfm` (opensfm/src/sfm/python/pybind.cc:12-43) with tracks surgery, map
filtering, BA helpers and map realignment; this module re-exports the
port's equivalents under the same names.

The heavy lifting (BA, filtering) lives in `opensfm_tpu_torch.ba.problem`
and `opensfm_tpu_torch.reconstruction`; the functions defined here are the
small host-side map and tracks algorithms:

- ``add_connections`` / ``remove_connections``
  (reference: sfm/src/tracks_helpers.cc:32-45)
- ``realign_maps`` (reference: sfm/src/retriangulation.cc:8-115)
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from opensfm_tpu_torch import pymap, types
from opensfm_tpu_torch.ba.problem import (
    bundle,
    bundle_local,
    bundle_shot_poses,
    shot_neighborhood,
    triangulate_gcp,
)
from opensfm_tpu_torch.geometry.pose import Similarity
from opensfm_tpu_torch.reconstruction import (
    count_tracks_per_shot,
    filter_badly_conditioned_points,
    remove_isolated_points,
)

__all__ = [
    "add_connections",
    "remove_connections",
    "count_tracks_per_shot",
    "filter_badly_conditioned_points",
    "remove_isolated_points",
    "realign_maps",
    "bundle",
    "bundle_local",
    "bundle_shot_poses",
    "shot_neighborhood",
    "triangulate_gcp",
]


def add_connections(
    tracks_manager: pymap.TracksManager,
    shot_id: str,
    connections: Iterable[str],
) -> None:
    """Connect `shot_id` to each track in `connections` with a default
    observation (reference: sfm/src/tracks_helpers.cc:32-38)."""
    default = pymap.Observation(0.0, 0.0, 1.0, 0, 0, 0, 0)
    for track_id in connections:
        tracks_manager.add_observation(shot_id, track_id, default.copy())


def remove_connections(
    tracks_manager: pymap.TracksManager,
    shot_id: str,
    connections: Iterable[str],
) -> None:
    """Disconnect `shot_id` from each track in `connections`
    (reference: sfm/src/tracks_helpers.cc:40-45)."""
    for track_id in connections:
        tracks_manager.remove_observation(shot_id, track_id)


def realign_maps(
    map_from: types.Reconstruction,
    map_to: types.Reconstruction,
    update_points: bool = True,
) -> None:
    """Remap `map_to` into `map_from`'s frame, shot by shot.

    Mirrors the reference's `pysfm.realign_maps`
    (sfm/src/retriangulation.cc:8-115): for every shot present in both maps,
    compute the per-shot similarity that carries `map_to`'s camera to
    `map_from`'s camera (expressed in `map_to`'s topocentric frame), move
    each point of `map_to` with the similarity of its nearest observing
    shot, copy camera parameters / scale / merge_cc over, update rig
    instance poses, and drop shots of `map_to` absent from `map_from`.
    """
    ref_from, ref_to = map_from.reference, map_to.reference
    offset = np.asarray(
        ref_to.to_topocentric(ref_from.lat, ref_from.lon, ref_from.alt),
        dtype=np.float64,
    )

    # Per-shot transforms X_to' = s * R @ (X_to) + t with
    # s = 1/scale_from, R = Rcw_from @ Rwc_to, t = -s*R@O_to + O_from+offset.
    transforms = {}
    for shot_id, shot_to in map_to.shots.items():
        if shot_id not in map_from.shots:
            continue
        shot_from = map_from.shots[shot_id]
        origin_from = shot_from.pose.get_origin() + offset
        scale_from = getattr(shot_from, "scale", 0.0)
        s = 1.0 / scale_from if scale_from != 0.0 else 1.0
        R = (
            shot_from.pose.get_rotation_matrix().T
            @ shot_to.pose.get_rotation_matrix()
        )
        t = -s * (R @ shot_to.pose.get_origin()) + origin_from
        transforms[shot_id] = Similarity(R, t, s)

    if update_points:
        for lm in map_to.points.values():
            point = np.asarray(lm.coordinates, dtype=np.float64)
            best_d2, best_shot = np.inf, None
            for obs_shot_id in lm.get_observations():
                if obs_shot_id not in map_from.shots:
                    continue
                shot_to = map_to.shots.get(obs_shot_id)
                if shot_to is None:
                    continue
                d2 = float(
                    np.sum((point - shot_to.pose.get_origin()) ** 2)
                )
                if d2 < best_d2:
                    best_d2, best_shot = d2, obs_shot_id
            if best_shot is None or best_shot not in transforms:
                continue
            lm.coordinates = transforms[best_shot].transform(point)

    to_delete = []
    for shot_id, shot_to in map_to.shots.items():
        if shot_id not in map_from.shots:
            to_delete.append(shot_id)
            continue
        shot_from = map_from.shots[shot_id]
        shot_to.camera.set_parameters_values(
            shot_from.camera.get_parameters_values()
        )
        shot_to.scale = getattr(shot_from, "scale", shot_to.scale)
        shot_to.merge_cc = getattr(shot_from, "merge_cc", shot_to.merge_cc)

    for instance in map_to.rig_instances.values():
        for shot_id, shot_to in instance.shots.items():
            shot_from = map_from.shots.get(shot_id)
            if shot_from is None:
                continue
            pose = shot_from.rig_instance.pose.copy()
            pose.set_origin(pose.get_origin() + offset)
            instance.pose = pose
            break

    for shot_id in to_delete:
        map_to.remove_shot(shot_id)
