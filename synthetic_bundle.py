"""Synthetic bundle-adjustment problems and datasets for the PyTorch port.

`make_problem` is a numpy copy of `__graft_entry__._make_problem` (which
imports the JAX package): a circle of shots looking at random points, the
observations projected with σ = 5e-4 noise, and the poses and points
perturbed.  It returns the port's `BAProblem` with the same arrays for the
same arguments.  `write_dataset` turns such a problem into a dataset
directory (`reconstruction.json`, `tracks.csv`, `camera_models.json`,
`config.yaml`) whose `bundle` command solves the same problem.
`write_matching_dataset` writes the input of `match_features` on the same
circle of shots: features with uint8 descriptors (one random descriptor per
3D point plus small noise per observation, padded with random distractors),
optional words, EXIF with GPS and the camera; it returns which point each
feature observes, and `match_scores` grades written matches against it.
`matching_scene` gives the true shots and points of such a dataset, and
`grade_reconstruction` grades a reconstruction of it against them.
`make_model_problem` and `write_matching_dataset(camera_types=...)` give
the same scenes through any camera model, `make_model_problem` also with
rig instances (fixed or optimized rig cameras) and depth priors.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import yaml

from opensfm_tpu_torch import io, pymap, types
from opensfm_tpu_torch.ba.lm import BAProblem
from opensfm_tpu_torch.geometry import cameras as cl
from opensfm_tpu_torch.geometry.pose import Pose

NOISE = 0.0005  # image noise of the synthetic observations (normalized units)
CAMERA = (-0.05, 0.002, 0.85)  # k1, k2, focal of the synthetic camera


def circle_shots(n_shots: int) -> np.ndarray:
    """[n_shots, 6] (rotation vector, translation) of shots evenly spaced on
    a circle of radius 10 around the origin, each looking at the origin."""
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
    return np.array(insts)


def nearest_shots(points: np.ndarray, n_shots: int, k: int) -> np.ndarray:
    """[NP, k] the k angularly-nearest shots of each point: on an evenly
    spaced circle they are a contiguous index window around the closest."""
    pt_ang = np.arctan2(points[:, 1], points[:, 0])
    step_ang = 2 * np.pi / n_shots
    j0 = np.round(pt_ang / step_ang).astype(np.int64) % n_shots
    return (j0[:, None] + (np.arange(k, dtype=np.int64) - k // 2)[None, :]) \
        % n_shots


def make_problem(n_shots=16, n_points=512, seed=0, track_window=None):
    """A synthetic circle-scene BA problem as flat arrays.

    `track_window=None` observes every point in every shot (dense, shot-major
    observations).  An integer K observes each point only from its K
    angularly-nearest shots (point-major observations, mean track length
    K)."""
    rng = np.random.default_rng(seed)
    cam_params = np.array([CAMERA])
    points = rng.uniform(-4, 4, (n_points, 3))
    insts = circle_shots(n_shots)

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
        near = nearest_shots(points, n_shots, K)  # [NP, K]
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


# Camera parameters of each projection type for the synthetic scenes, in
# `cameras.PARAMS` order, every distortion term away from zero.
MODEL_PARAMS = {
    "perspective": CAMERA,
    "brown": (-0.05, 0.01, 0.001, 0.001, -0.0005, 0.85, 1.0, 0.01, -0.005),
    "fisheye": (-0.02, 0.003, 0.6),
    "fisheye_opencv": (-0.02, 0.003, 0.0005, -0.0001, 0.6, 1.0, 0.005,
                       -0.003),
    "fisheye62": (-0.02, 0.003, 0.0005, -0.0001, 2e-5, -1e-5, 0.0005,
                  -0.0003, 0.6, 1.0, 0.005, -0.003),
    "fisheye624": (-0.02, 0.003, 0.0005, -0.0001, 2e-5, -1e-5, 0.0005,
                   -0.0003, 0.0004, -0.0002, 0.0003, 0.0001, 0.6, 1.0,
                   0.005, -0.003),
    "spherical": (),
    "dual": (0.5, -0.03, 0.002, 0.7),
    "radial": (-0.05, 0.002, 0.85, 1.0, 0.01, -0.005),
    "simple_radial": (-0.05, 0.85, 1.0, 0.01, -0.005),
}
LOG_SCALE_PARAMS = ("focal", "aspect_ratio")  # the builder's log-prior dims


def make_model_problem(n_shots=16, n_points=512, seed=0, track_window=None,
                       camera_types="brown", rig_cameras=1,
                       optimize_rig=False, depth=None) -> BAProblem:
    """A synthetic circle-scene BA problem on any camera models, rigs and
    depth priors: `make_problem`'s shots and points, each shot i seen
    through a camera of type `camera_types[i]` (one string: every shot;
    one camera per distinct type, parameters MODEL_PARAMS, a perturbed
    start and a prior at the truth; observations sorted by type into
    segments when the types mix).

    With `rig_cameras` C > 1 the shots are grouped C by C into rig
    instances: instance j is shot j C's pose, and rig camera k the
    transform from it to shot j C + k (the same for every j on the evenly
    spaced circle), so rig camera 0 is the identity and the others are
    not.  `optimize_rig` optimizes every rig camera from a perturbed start,
    with a prior (sd 0.1) at that start as the builder sets it.  `depth`
    ("radial" or "z") adds a depth prior row to every observation: the true
    depth times (1 + 0.01 N(0, 1)), with that 1 % as its sd."""
    rng = np.random.default_rng(seed)
    types = ([camera_types] * n_shots if isinstance(camera_types, str)
             else list(camera_types))
    if len(types) != n_shots or n_shots % rig_cameras:
        raise ValueError("one camera type per shot, whole rig instances")
    kinds = sorted(set(types))
    pmax = max(max(len(cl.PARAMS[t]) for t in kinds), 1)
    nc = len(kinds)
    cam = np.zeros((nc, pmax))
    opt_cam = np.zeros((nc, pmax), bool)
    log_mask = np.zeros((nc, pmax), bool)
    for c, t in enumerate(kinds):
        n = len(cl.PARAMS[t])
        cam[c, :n] = MODEL_PARAMS[t]
        opt_cam[c, :n] = True
        log_mask[c, :n] = [name in LOG_SCALE_PARAMS for name in cl.PARAMS[t]]
    shot_cam = np.array([kinds.index(t) for t in types])

    points = rng.uniform(-4, 4, (n_points, 3))
    shots = circle_shots(n_shots)
    K = n_shots if track_window is None else int(track_window)
    near = (np.tile(np.arange(n_shots), (n_points, 1)) if track_window is None
            else nearest_shots(points, n_shots, K))
    obs_point = np.repeat(np.arange(n_points, dtype=np.int64), K)
    obs_shot = near.reshape(-1).astype(np.int64)
    Rm = np.stack([Pose(s[:3], s[3:]).get_rotation_matrix() for s in shots])
    pc = np.einsum("oij,oj->oi", Rm[obs_shot], points[obs_point]) \
        + shots[obs_shot, 3:]
    obs_cam = shot_cam[obs_shot]
    obs_uv = np.zeros((len(obs_point), 2))
    for c, t in enumerate(kinds):
        sel = obs_cam == c
        obs_uv[sel] = cl.project(t, pc[sel], cam[c], xp=np)
    obs_uv = obs_uv + rng.normal(0, NOISE, obs_uv.shape)
    if depth is not None:
        true_d = (np.linalg.norm(pc, axis=1) if depth == "radial"
                  else pc[:, 2])
        obs_depth = true_d * (1.0 + 0.01 * rng.normal(size=len(true_d)))

    # Rig instances: the first shot of each group, and the rig cameras.
    C = rig_cameras
    n_inst = n_shots // C
    inst = shots[::C].copy()
    base = Pose(shots[0, :3], shots[0, 3:])
    rigcam = np.zeros((C, 6))
    for k in range(1, C):
        rel = Pose(shots[k, :3], shots[k, 3:]).compose(base.inverse())
        rigcam[k] = np.concatenate([rel.rotation, rel.translation])
    cam_start = cam + rng.normal(0, 0.002, cam.shape) * opt_cam
    inst_start = inst + rng.normal(0, 0.01, inst.shape)
    rig_start = rigcam.copy()
    if optimize_rig:
        rig_start[1:] += rng.normal(0, 0.005, (C - 1, 6))
    points_start = points + rng.normal(0, 0.05, points.shape)

    O = len(obs_point)
    order = np.argsort(obs_cam, kind="stable") if nc > 1 else np.arange(O)
    segments = []
    for c, t in enumerate(kinds):
        idx = np.flatnonzero(obs_cam[order] == c)
        if len(idx):
            segments.append((t, int(idx[0]), int(idx[-1]) + 1))
    point_obs = np.empty((n_points, K), dtype=np.int64)
    rank = np.empty(O, dtype=np.int64)
    rank[order] = np.arange(O)
    point_obs[:] = rank.reshape(n_points, K)
    gps = np.array([Pose(s[:3], s[3:]).get_origin() for s in inst])

    def sorted_(x):
        return np.asarray(x)[order]

    extra = {}
    if depth is not None:
        extra = dict(obs_depth=sorted_(obs_depth),
                     obs_depth_inv_sd=sorted_(1.0 / (0.01 * true_d)),
                     obs_depth_radial=np.full(O, depth == "radial"))
    return BAProblem(
        inst=inst_start, rigcam=rig_start, cam=cam_start,
        points=points_start, obs_uv=sorted_(obs_uv),
        obs_inv_sd=np.full(O, 250.0), obs_point=sorted_(obs_point),
        obs_inst=sorted_(obs_shot // C), obs_rigcam=sorted_(obs_shot % C),
        obs_cam=sorted_(obs_cam), point_obs=point_obs,
        gps_pos=gps, gps_inv_sd=np.full(n_inst, 1.0),
        cam_prior=cam.copy(), cam_prior_inv_sd=np.full((nc, pmax), 100.0)
        * opt_cam, cam_log_mask=log_mask,
        rigcam_prior=rig_start.copy(),
        rigcam_prior_inv_sd=np.full((C, 6), 10.0 if optimize_rig else 0.0),
        point_prior=np.zeros((n_points, 3)),
        point_prior_inv_sd=np.zeros((n_points, 3)),
        opt_inst=np.ones(n_inst, bool), opt_rigcam=np.full(C, optimize_rig),
        opt_cam=opt_cam, opt_points=np.ones(n_points, bool),
        ptype=kinds[0] if nc == 1 else tuple(segments),
        loss="SoftLOneLoss", loss_threshold=1.0, **extra,
    )


def add_pose_graph(problem: BAProblem, seed: int = 0) -> BAProblem:
    """`problem` with every pose-graph family of `ba/lm.py` and three scale
    variables (the first fixed; instances of the first half take the
    second, the rest the third): relative motions and rotations between
    consecutive instances (random observations), common positions and
    linear motions on the first instances, two heatmap priors on a 16 x 16
    grid (one sampled at an integer, border coordinate) and a gauge fix.
    Needs at least 6 instances."""
    rng = np.random.default_rng(seed)
    ni = len(problem.inst)
    K = ni - 1
    ii = np.arange(K)
    jj = ii + 1
    zk = np.zeros(K, np.int64)
    origin3 = Pose(problem.inst[3, :3], problem.inst[3, 3:]).get_origin()
    return dataclasses.replace(
        problem,
        scales=np.array([1.0, 1.2, 0.9]),
        opt_scales=np.array([False, True, True]),
        rm_i=ii, rm_j=jj, rm_si=np.where(ii < ni // 2, 1, 2),
        rm_sj=np.where(jj < ni // 2, 1, 2),
        rm_rvec=rng.normal(size=(K, 3)) * 0.01,
        rm_tvec=rng.normal(size=(K, 3)), rm_scale=np.full(K, 1.1),
        rm_inv_sd=np.ones((K, 7)), rm_obs_scale=ii % 2 == 0,
        rm_loss_c=np.full(K, 1.5),
        rr_i=ii, rr_j=jj, rr_ri=zk, rr_rj=zk,
        rr_rvec=rng.normal(size=(K, 3)) * 0.01, rr_inv_sd=np.ones((K, 3)),
        rr_loss_c=np.ones(K),
        cp_i=ii[:3], cp_j=jj[:3], cp_ri=zk[:3], cp_rj=zk[:3],
        cp_margin=np.full(3, 0.1), cp_inv_sd=np.ones(3),
        lin_i0=ii[:K - 1], lin_i1=ii[:K - 1] + 1, lin_i2=ii[:K - 1] + 2,
        lin_r0=zk[:K - 1], lin_r1=zk[:K - 1], lin_r2=zk[:K - 1],
        lin_alpha=np.full(K - 1, 0.5), lin_pos_inv_sd=np.ones(K - 1),
        lin_rot_inv_sd=np.ones(K - 1),
        hm_inst=np.array([0, 3]), hm_rigcam=np.zeros(2, np.int64),
        hm_map=np.array([0, 0]),
        hm_offset=np.array([[0.0, 0.0],
                            [origin3[0] + 8.0, origin3[1] - 3.0]]),
        hm_inv_sd=np.ones(2), heatmaps=rng.random((1, 16, 16)),
        hm_res=np.array([1.0]),
        gauge_i=np.array([0]), gauge_j=np.array([5]),
        gauge_norm=np.array([3.0]))


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
                     tracks: pymap.TracksManager,
                     max_error: float = np.inf) -> float:
    """RMS over observations and both coordinates of (projection - uv), over
    the track observations of the reconstructed points whose error is at
    most `max_error` (a saved reconstruction does not record which
    observations its outlier removal dropped)."""
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
        err = err[np.linalg.norm(err, axis=1) <= max_error]
        sq += float(np.sum(err * err))
        n += err.size
    return float(np.sqrt(sq / max(n, 1)))


# A GPS origin for the synthetic scenes (any place works; topocentric
# metres around it are what the pair selection reads).
GPS_ORIGIN = (52.519, 13.401, 30.0)
DESCRIPTOR_NOISE = 3  # per byte of an observed descriptor, uniform integers
WORDS_VOCABULARY = 4096  # words of the synthetic vocabulary


def matching_scene(n_shots: int, n_points: int, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The true (shots [n_shots, 6] as `circle_shots`, points [n_points, 3])
    of `write_matching_dataset` with the same arguments: the points are
    its generator's first draw."""
    rng = np.random.default_rng(seed)
    return circle_shots(n_shots), rng.uniform(-4, 4, (n_points, 3))


def write_matching_dataset(path: str, n_shots: int = 32,
                           n_points: int = 16384, track_window: int = 8,
                           features_per_image: int = 8192, seed: int = 0,
                           undistorted: bool = False, words: bool = False,
                           config: Optional[Dict[str, Any]] = None,
                           camera_types: Optional[List[str]] = None
                           ) -> Dict[str, np.ndarray]:
    """Write the input of `match_features` as a dataset directory and return
    {image: [features] id of the 3D point each feature observes, -1 for a
    distractor}.

    Shots and points as `make_problem` places them (the circle of radius 10,
    points uniform in [-4, 4]^3, each seen from its `track_window`
    angularly-nearest shots), the camera (k1, k2, focal) = CAMERA, or
    k1 = k2 = 0 with `undistorted`.  Every point has a random uint8
    descriptor of 128 bytes; an observation is that descriptor plus integer
    noise in [-DESCRIPTOR_NOISE, DESCRIPTOR_NOISE], clipped, at the
    projected position plus NOISE.  Each image is padded with random
    distractor features up to `features_per_image` and its features are
    shuffled.  Writes `features/*.features.npz` (normalized x, y, size,
    angle; uint8 descriptors), `exif/*.exif` with GPS, `camera_models.json`,
    `image_list.txt`, `config.yaml` and, with `words`, `*.words.npz`
    holding 20 words per feature, the first one shared by all observations
    of a point (out of WORDS_VOCABULARY words).  With `camera_types` (one
    projection type per image) image i is seen through a camera of type
    `camera_types[i]`, one camera per type (id `synthetic_<type>`,
    parameters MODEL_PARAMS), and the draws are those of the default."""
    from opensfm_tpu_torch import geo
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.features import FeaturesData

    rng = np.random.default_rng(seed)
    points = rng.uniform(-4, 4, (n_points, 3))
    insts = circle_shots(n_shots)
    k1, k2, focal = CAMERA
    if undistorted:
        k1 = k2 = 0.0
    near = nearest_shots(points, n_shots, track_window)
    point_desc = rng.integers(0, 256, (n_points, 128), dtype=np.uint8)
    point_word = rng.integers(0, WORDS_VOCABULARY, n_points)

    os.makedirs(path, exist_ok=True)
    cfg = {"feature_type": "HAHOG", "hahog_normalize_to_uchar": True}
    cfg.update(config or {})
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    images = [shot_id(i) for i in range(n_shots)]
    with open(os.path.join(path, "image_list.txt"), "w") as f:
        f.write("".join(f"images/{im}\n" for im in images))
    data = DataSet(path)
    if camera_types is None:
        camera = cl.Camera.create_perspective(focal, k1, k2)
        camera.id = "synthetic_camera"
        image_cameras = [camera] * n_shots
    else:
        by_type = {}
        for t in camera_types:
            if t not in by_type:
                by_type[t] = cl.Camera(t, MODEL_PARAMS[t])
                by_type[t].id = f"synthetic_{t}"
        image_cameras = [by_type[t] for t in camera_types]
    for camera in image_cameras:
        camera.width = camera.height = 1000
    data.save_camera_models({c.id: c for c in image_cameras})
    ref = geo.TopocentricConverter(*GPS_ORIGIN)

    tracks = {}
    for i, image in enumerate(images):
        pose = Pose(insts[i, :3], insts[i, 3:])
        seen = np.flatnonzero((near == i).any(axis=1))
        pc = points[seen] @ pose.get_rotation_matrix().T + pose.translation
        camera = image_cameras[i]
        uv = cl.project(camera.projection_type, pc, camera.parameters, xp=np)
        uv = uv + rng.normal(0, NOISE, uv.shape)
        noise = rng.integers(-DESCRIPTOR_NOISE, DESCRIPTOR_NOISE + 1,
                             (len(seen), 128))
        desc = np.clip(point_desc[seen].astype(np.int64) + noise, 0, 255)
        n_extra = max(0, features_per_image - len(seen))
        desc = np.concatenate([
            desc.astype(np.uint8),
            rng.integers(0, 256, (n_extra, 128), dtype=np.uint8)])
        uv = np.concatenate([uv, rng.uniform(-0.5, 0.5, (n_extra, 2))])
        ids = np.concatenate([seen, np.full(n_extra, -1)])
        order = rng.permutation(len(ids))
        n_feat = len(ids)
        pts = np.column_stack([
            uv, rng.uniform(0.002, 0.02, n_feat),
            rng.uniform(0.0, 360.0, n_feat)])[order]
        data.save_features(image, FeaturesData(
            pts, desc[order], np.full((n_feat, 3), 128, dtype=np.uint8)))
        tracks[image] = ids[order]
        if words:
            w = rng.integers(0, WORDS_VOCABULARY, (n_feat, 20))
            true = ids >= 0
            w[true, 0] = point_word[ids[true]]
            data.save_words(image, w[order])
        lat, lon, alt = ref.to_lla(*pose.get_origin())
        data.save_exif(image, {
            "camera": camera.id, "width": 1000, "height": 1000,
            "projection_type": camera.projection_type,
            "focal_ratio": getattr(camera, "focal", 0.0),
            "orientation": 1, "capture_time": float(i),
            "gps": {"latitude": lat, "longitude": lon, "altitude": alt,
                    "dop": 5.0},
        })
    return tracks


def subset_dataset(path: str, out: str, images: List[str],
                   config: Optional[Dict[str, Any]] = None,
                   matches: bool = False) -> None:
    """A copy of the matching dataset at `path` restricted to `images`,
    with `config` over its config.yaml; with `matches`, also the written
    matches among those images."""
    shutil.rmtree(out, ignore_errors=True)
    for sub in ("exif", "features"):
        os.makedirs(os.path.join(out, sub))
    with open(os.path.join(path, "config.yaml")) as f:
        cfg = yaml.safe_load(f) or {}
    cfg.update(config or {})
    with open(os.path.join(out, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    shutil.copy(os.path.join(path, "camera_models.json"), out)
    with open(os.path.join(out, "image_list.txt"), "w") as f:
        f.write("".join(f"images/{im}\n" for im in images))
    for im in images:
        shutil.copy(os.path.join(path, "exif", im + ".exif"),
                    os.path.join(out, "exif"))
        for suffix in (".features.npz", ".words.npz"):
            src = os.path.join(path, "features", im + suffix)
            if os.path.isfile(src):
                shutil.copy(src, os.path.join(out, "features"))
    if matches:
        from opensfm_tpu_torch.dataset import DataSet

        src, dst = DataSet(path), DataSet(out)
        keep = set(images)
        for im in images:
            if src.matches_exists(im):
                dst.save_matches(im, {other: m for other, m in
                                      src.load_matches(im).items()
                                      if other in keep})


def match_scores(data, tracks: Dict[str, np.ndarray]
                 ) -> Tuple[float, float, int]:
    """(precision, recall, matches) of the matches written in dataset
    `data`: a match is right when both features observe one point; recall
    counts right matches over the points each matched pair shares."""
    right = total = shared = 0
    for im1 in data.images():
        if not data.matches_exists(im1):
            continue
        for im2, m in data.load_matches(im1).items():
            m = np.asarray(m, dtype=np.int64).reshape(-1, 2)
            a, b = tracks[im1][m[:, 0]], tracks[im2][m[:, 1]]
            right += int(np.sum((a >= 0) & (a == b)))
            total += len(m)
            common = np.intersect1d(tracks[im1][tracks[im1] >= 0],
                                    tracks[im2][tracks[im2] >= 0])
            shared += len(common)
    return right / max(total, 1), right / max(shared, 1), total


def grade_reconstruction(reconstructions: List[types.Reconstruction],
                         tracks_manager: pymap.TracksManager,
                         feature_points: Dict[str, np.ndarray],
                         shots: np.ndarray, points: np.ndarray,
                         max_error: float = 0.006) -> Dict[str, Any]:
    """Grade the reconstructions of a `write_matching_dataset` dataset
    against its truth (`matching_scene`): the shots of the largest one out
    of all, the RMS of its camera centres after the similarity (Umeyama)
    that best maps them onto the true centres, the RMS over its points of
    the same similarity's error against the true point each track observes
    (tracks whose observations disagree on the point are counted as
    mismatched and left out), and the reprojection RMS of the observations
    it keeps (`reprojection_rms` within the default outlier threshold,
    normalized image units, beside NOISE)."""
    rec = max(reconstructions, key=lambda r: len(r.shots))
    ids = sorted(rec.shots)
    idx = [int(s.split("_")[1].split(".")[0]) for s in ids]
    true_c = np.array([Pose(shots[i, :3], shots[i, 3:]).get_origin()
                       for i in idx])
    est_c = np.array([rec.shots[s].pose.get_origin() for s in ids])
    # Umeyama: true ~ scale * R @ est + t.
    mu_e, mu_t = est_c.mean(0), true_c.mean(0)
    e, t = est_c - mu_e, true_c - mu_t
    U, S, Vt = np.linalg.svd(t.T @ e / len(ids))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / np.mean(np.sum(e * e, axis=1))

    def to_true(X):
        return scale * (X - mu_e) @ R.T + mu_t

    centre_err = to_true(est_c) - true_c
    sq, matched, mismatched = 0.0, 0, 0
    for tid, lm in rec.points.items():
        pids = {int(feature_points[sid][obs.id])
                for sid, obs in tracks_manager.get_track_observations(
                    tid).items()}
        if len(pids) != 1 or -1 in pids:
            mismatched += 1
            continue
        d = to_true(np.asarray(lm.coordinates)) - points[pids.pop()]
        sq += float(d @ d)
        matched += 1
    return {
        "shots": len(rec.shots),
        "reconstructions": len(reconstructions),
        "points": len(rec.points),
        "centre_rms": float(np.sqrt(np.mean(np.sum(centre_err ** 2, axis=1)))),
        "point_rms": float(np.sqrt(sq / max(matched, 1))),
        "points_matched": matched,
        "points_mismatched": mismatched,
        "reprojection_rms": reprojection_rms(rec, tracks_manager, max_error),
        "scale": float(scale),
    }
