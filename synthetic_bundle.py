"""Synthetic bundle-adjustment problems and datasets for the PyTorch port.

`make_problem` is a numpy copy of `__graft_entry__._make_problem` (which
imports the JAX package): a circle of shots looking at random points, the
observations projected with σ = 5e-4 noise, and the poses and points
perturbed.  It returns the port's `BAProblem` with the same arrays for the
same arguments.  `write_dataset` turns such a problem into a dataset
directory (`reconstruction.json`, `tracks.csv`, `camera_models.json`,
`config.yaml`) whose `bundle` command solves the same problem.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import yaml

from opensfm_tpu_torch import io, pymap, types
from opensfm_tpu_torch.ba.lm import BAProblem
from opensfm_tpu_torch.geometry import cameras as cl
from opensfm_tpu_torch.geometry.pose import Pose

NOISE = 0.0005  # image noise of the synthetic observations (normalized units)


def make_problem(n_shots=16, n_points=512, seed=0, track_window=None):
    """A synthetic circle-scene BA problem as flat arrays.

    `track_window=None` observes every point in every shot (dense, shot-major
    observations).  An integer K observes each point only from its K
    angularly-nearest shots (point-major observations, mean track length
    K)."""
    rng = np.random.default_rng(seed)
    cam_params = np.array([[-0.05, 0.002, 0.85]])
    points = rng.uniform(-4, 4, (n_points, 3))
    insts = []
    for i in range(n_shots):
        ang = 2 * np.pi * i / n_shots
        origin = np.array([10 * np.cos(ang), 10 * np.sin(ang), 0.0])
        z = -origin / np.linalg.norm(origin)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        pose = Pose()
        pose.set_rotation_matrix(np.stack([x, np.cross(z, x), z]))
        pose.set_origin(origin)
        insts.append(np.concatenate([pose.rotation, pose.translation]))
    insts = np.array(insts)

    if track_window is None:
        uv_per_shot = []
        for i in range(n_shots):
            pose = Pose(insts[i, :3], insts[i, 3:])
            pc = points @ pose.get_rotation_matrix().T + pose.translation
            uv = cl.project("perspective", pc, cam_params[0], xp=np)
            uv_per_shot.append(uv + rng.normal(0, NOISE, uv.shape))
        obs_uv = np.concatenate(uv_per_shot, axis=0)
        obs_point = np.tile(np.arange(n_points, dtype=np.int64), n_shots)
        obs_inst = np.repeat(np.arange(n_shots, dtype=np.int64), n_points)
        O = n_shots * n_points
        T = n_shots
        point_obs = (
            np.arange(T, dtype=np.int64)[None, :] * n_points
            + np.arange(n_points, dtype=np.int64)[:, None]
        )
    else:
        K = int(track_window)
        # The K nearest shots of an evenly spaced circle are a contiguous
        # index window around the closest one.
        pt_ang = np.arctan2(points[:, 1], points[:, 0])
        step_ang = 2 * np.pi / n_shots
        j0 = np.round(pt_ang / step_ang).astype(np.int64) % n_shots
        near = (
            j0[:, None] + (np.arange(K, dtype=np.int64) - K // 2)[None, :]
        ) % n_shots  # [NP, K]
        obs_point = np.repeat(np.arange(n_points, dtype=np.int64), K)
        obs_inst = near.reshape(-1).astype(np.int64)
        O = n_points * K
        T = K
        point_obs = np.arange(O, dtype=np.int64).reshape(n_points, K)
        Rm = np.stack(
            [Pose(insts[i, :3], insts[i, 3:]).get_rotation_matrix()
             for i in range(n_shots)]
        )
        pc = (
            np.einsum("oij,oj->oi", Rm[obs_inst], points[obs_point])
            + insts[obs_inst, 3:]
        )
        obs_uv = cl.project("perspective", pc, cam_params[0], xp=np)
        obs_uv = obs_uv + rng.normal(0, NOISE, obs_uv.shape)

    gps = np.array(
        [Pose(insts[i, :3], insts[i, 3:]).get_origin() for i in range(n_shots)]
    )
    insts_pert = insts + rng.normal(0, 0.01, insts.shape)
    points_pert = points + rng.normal(0, 0.05, points.shape)

    return BAProblem(
        inst=insts_pert, rigcam=np.zeros((1, 6)), cam=cam_params.copy(),
        points=points_pert,
        obs_uv=np.asarray(obs_uv), obs_inv_sd=np.full(O, 250.0),
        obs_point=np.asarray(obs_point, dtype=np.int64),
        obs_inst=np.asarray(obs_inst, dtype=np.int64),
        obs_rigcam=np.zeros(O, dtype=np.int64),
        obs_cam=np.zeros(O, dtype=np.int64),
        point_obs=point_obs,
        gps_pos=gps, gps_inv_sd=np.full(n_shots, 1.0),
        cam_prior=cam_params.copy(),
        cam_prior_inv_sd=np.full((1, 3), 100.0),
        cam_log_mask=np.array([[False, False, True]]),
        rigcam_prior=np.zeros((1, 6)), rigcam_prior_inv_sd=np.zeros((1, 6)),
        point_prior=np.zeros((n_points, 3)),
        point_prior_inv_sd=np.zeros((n_points, 3)),
        opt_inst=np.ones(n_shots, bool), opt_rigcam=np.zeros(1, bool),
        opt_cam=np.ones((1, 3), bool), opt_points=np.ones(n_points, bool),
        ptype="perspective", loss="SoftLOneLoss", loss_threshold=1.0,
    )


def shot_id(i: int) -> str:
    return f"shot_{i:05d}.jpg"


def write_dataset(path: str, problem: BAProblem,
                  config: Optional[Dict[str, Any]] = None) -> None:
    """Write `problem` (one perspective camera, one shot per instance, GPS at
    `gps_pos` with accuracy 1 / gps_inv_sd) as a dataset directory."""
    os.makedirs(path, exist_ok=True)
    k1, k2, focal = (float(v) for v in problem.cam[0, :3])
    camera = cl.Camera.create_perspective(focal, k1, k2)
    camera.id = "synthetic_camera"
    camera.width = camera.height = 1000

    rec = types.Reconstruction()
    rec.add_camera(camera)
    for i, pose6 in enumerate(problem.inst):
        shot = rec.create_shot(shot_id(i), camera.id,
                               pose=Pose(pose6[:3], pose6[3:]))
        shot.metadata.gps_position.value = np.asarray(problem.gps_pos[i])
        shot.metadata.gps_accuracy.value = 1.0 / float(problem.gps_inv_sd[i])
    for j, X in enumerate(problem.points):
        rec.create_point(str(j), np.asarray(X))

    tracks = pymap.TracksManager()
    next_feature = np.zeros(len(problem.inst), dtype=np.int64)
    for o in np.flatnonzero(np.asarray(problem.obs_inv_sd) > 0):
        i = int(problem.obs_inst[o])
        u, v = problem.obs_uv[o]
        obs = pymap.Observation(
            float(u), float(v), 1.0 / float(problem.obs_inv_sd[o]),
            128, 128, 128, int(next_feature[i]),
        )
        next_feature[i] += 1
        tracks.add_observation(shot_id(i), str(int(problem.obs_point[o])), obs)

    with open(os.path.join(path, "reconstruction.json"), "w") as f:
        io.json_dump(io.reconstructions_to_json([rec]), f)
    tracks.write_to_file(os.path.join(path, "tracks.csv"))
    with open(os.path.join(path, "camera_models.json"), "w") as f:
        io.json_dump(io.cameras_to_json({camera.id: camera}), f)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(config or {}), f)


def reprojection_rms(reconstruction: types.Reconstruction,
                     tracks: pymap.TracksManager) -> float:
    """RMS over observations and both coordinates of (projection - uv)."""
    sq, n = 0.0, 0
    for sid, shot in reconstruction.shots.items():
        obs = tracks.get_shot_observations(sid)
        ids = [t for t in obs if t in reconstruction.points]
        if not ids:
            continue
        X = np.array([reconstruction.points[t].coordinates for t in ids])
        uv = np.array([obs[t].point for t in ids])
        pose = shot.pose
        pc = X @ pose.get_rotation_matrix().T + pose.translation
        err = shot.camera.project(pc) - uv
        sq += float(np.sum(err * err))
        n += err.size
    return float(np.sqrt(sq / max(n, 1)))
