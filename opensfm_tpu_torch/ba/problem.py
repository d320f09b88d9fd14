"""BA problem builder: Reconstruction <-> flat BAProblem arrays + writeback.

Port of `opensfm_tpu.ba.problem` (the reference's `pysfm.BAHelpers`,
sfm/src/ba_helpers.cc): `bundle` (:581-763, with `AddGCPToBundle`
:349-406), `bundle_local` (:117-311), `bundle_shot_poses` (:408-579) and
`shot_neighborhood` (:47-115).  The host side extracts columnar arrays from
the Python map, runs the LM core of `ba.lm` on the chosen device, and
writes the results back with NaN guards (BundleToMap :765-819).  Every
bundle, fixed instances and points included, goes through the same
`bundle_adjust` and so the same LM route choice; each report names the
route its solve took.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from opensfm_tpu_torch import align as align_lib
from opensfm_tpu_torch import multiview, pymap, resolve_device, types
from opensfm_tpu_torch.ba.lm import BAProblem, BAResult, bundle_adjust
from opensfm_tpu_torch.geometry import cameras as cam_lib
from opensfm_tpu_torch.geometry.pose import Pose

logger = logging.getLogger(__name__)

# Per-parameter prior standard deviations, keyed by config name
# (bundle_adjuster.cc camera priors; log-scale for focal/aspect ratio).
_PARAM_SD_KEY = {
    "focal": "exif_focal_sd",
    "aspect_ratio": "aspect_ratio_sd",
    "cx": "principal_point_sd",
    "cy": "principal_point_sd",
    "k1": "radial_distortion_k1_sd",
    "k2": "radial_distortion_k2_sd",
    "k3": "radial_distortion_k3_sd",
    "k4": "radial_distortion_k4_sd",
    "k5": "radial_distortion_k3_sd",
    "k6": "radial_distortion_k4_sd",
    "p1": "tangential_distortion_p1_sd",
    "p2": "tangential_distortion_p2_sd",
    "s0": "radial_distortion_k1_sd",
    "s1": "radial_distortion_k2_sd",
    "s2": "radial_distortion_k1_sd",
    "s3": "radial_distortion_k2_sd",
    "transition": "radial_distortion_k1_sd",
}
_LOG_SCALE_PARAMS = {"focal", "aspect_ratio"}

_MIN_RIG_INSTANCES_FOR_ADJUST = 10  # ba_helpers.cc:624


def shot_neighborhood(
    reconstruction: types.Reconstruction,
    central_shot_id: str,
    radius: int,
    min_common_points: int,
    max_interior_size: int,
) -> Tuple[Set[str], Set[str]]:
    """Interior/boundary split by covisibility BFS (ba_helpers.cc:47-70)."""
    central = reconstruction.shots[central_shot_id]
    interior: Set[str] = set(central.rig_instance.shots.keys())
    interior.add(central_shot_id)
    for _distance in range(1, radius):
        if len(interior) >= max_interior_size:
            break
        remaining = max_interior_size - len(interior)
        neighbors = direct_shot_neighbors(
            reconstruction, interior, min_common_points, remaining
        )
        interior |= neighbors
    boundary = direct_shot_neighbors(reconstruction, interior, 1, 1000000)
    return interior, boundary


def direct_shot_neighbors(
    reconstruction: types.Reconstruction,
    shot_ids: Set[str],
    min_common_points: int,
    max_neighbors: int,
) -> Set[str]:
    """Shots sharing >= min_common_points landmarks with the set
    (ba_helpers.cc:72-115), expanded to full rig instances."""
    points: Set[str] = set()
    for sid in shot_ids:
        points.update(reconstruction.shots[sid].get_landmark_observations().keys())
    common: Dict[str, int] = {}
    for pid in points:
        lm = reconstruction.points.get(pid)
        if lm is None:
            continue
        for sid in lm.get_observations():
            if sid not in shot_ids and sid in reconstruction.shots:
                common[sid] = common.get(sid, 0) + 1
    pairs = sorted(common.items(), key=lambda kv: -kv[1])
    neighbors: Set[str] = set()
    for idx, (sid, num) in enumerate(pairs):
        if num < min_common_points or idx >= max_neighbors:
            break
        neighbors.update(reconstruction.shots[sid].rig_instance.shots.keys())
    return neighbors


class _Builder:
    """Accumulates the flat BA arrays from a reconstruction subset."""

    def __init__(self, reconstruction: types.Reconstruction, config: Dict[str, Any]):
        self.rec = reconstruction
        self.config = config
        self.inst_ids: List[str] = []
        self.inst_index: Dict[str, int] = {}
        self.rigcam_ids: List[str] = []
        self.rigcam_index: Dict[str, int] = {}
        self.cam_ids: List[str] = []
        self.cam_index: Dict[str, int] = {}
        self.point_ids: List[str] = []
        self.point_index: Dict[str, int] = {}
        self.obs: List[Tuple] = []  # (uv, inv_sd, point, inst, rigcam, cam, ptype, depth)
        self.up_rows: List[Tuple[int, int, np.ndarray, float]] = []
        self.opt_inst: List[bool] = []
        self.opt_rigcam: List[bool] = []
        self.opt_cam_blocks: List[bool] = []
        self.opt_points: List[bool] = []
        self.gps: Dict[int, Tuple[np.ndarray, float]] = {}
        self.point_priors: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        self.cam_priors: Dict[int, Any] = {}

    # -- registration -------------------------------------------------------
    def add_camera(self, camera, prior, fixed: bool) -> int:
        if camera.id in self.cam_index:
            return self.cam_index[camera.id]
        idx = len(self.cam_ids)
        self.cam_ids.append(camera.id)
        self.cam_index[camera.id] = idx
        self.opt_cam_blocks.append(not fixed)
        self.cam_priors[idx] = prior
        return idx

    def add_rig_camera(self, rig_camera, fixed: bool) -> int:
        if rig_camera.id in self.rigcam_index:
            return self.rigcam_index[rig_camera.id]
        idx = len(self.rigcam_ids)
        self.rigcam_ids.append(rig_camera.id)
        self.rigcam_index[rig_camera.id] = idx
        self.opt_rigcam.append(not fixed)
        return idx

    def add_instance(self, instance, fixed: bool) -> int:
        if instance.id in self.inst_index:
            return self.inst_index[instance.id]
        idx = len(self.inst_ids)
        self.inst_ids.append(instance.id)
        self.inst_index[instance.id] = idx
        self.opt_inst.append(not fixed)
        return idx

    def add_point(self, point_id: str, fixed: bool) -> int:
        if point_id in self.point_index:
            return self.point_index[point_id]
        idx = len(self.point_ids)
        self.point_ids.append(point_id)
        self.point_index[point_id] = idx
        self.opt_points.append(not fixed)
        return idx

    def add_obs(self, uv, std_dev, p_idx, i_idx, r_idx, c_idx, ptype,
                depth_prior=None):
        self.obs.append(
            (np.asarray(uv, dtype=np.float64), 1.0 / max(std_dev, 1e-12),
             p_idx, i_idx, r_idx, c_idx, ptype, depth_prior)
        )

    def add_up_vector(self, i_idx: int, r_idx: int, up_vec, std: float) -> None:
        """AddAbsoluteUpVector (bundle_adjuster.h:236)."""
        self.up_rows.append(
            (i_idx, r_idx, np.asarray(up_vec, dtype=np.float64), float(std))
        )

    def add_gps(self, inst_idx: int, position, std: float) -> None:
        self.gps[inst_idx] = (np.asarray(position, dtype=np.float64), std)

    def add_point_prior(
        self, p_idx: int, position, inv_sd3, loss_threshold: float = 0.0
    ) -> None:
        """Position prior rows; loss_threshold > 0 robustifies them with a
        Cauchy of that scale (in weighted-residual units).  The reference's
        AddPointPrior is always quadratic; the robust option protects GCP
        priors (whose std is divided by the gcp global weight, far below
        the survey noise) from deforming the model on bad draws."""
        self.point_priors[p_idx] = (
            np.asarray(position, dtype=np.float64),
            np.asarray(inv_sd3, dtype=np.float64),
            float(loss_threshold),
        )

    # -- finalize -----------------------------------------------------------
    def build(self, extra_point_coords: Dict[str, np.ndarray]) -> BAProblem:
        # All dimensions are padded to power-of-two buckets, as the JAX
        # package pads them to share compiled programs across the growth
        # loop: the port builds the same arrays (padding routes to the trash
        # column / zero-weight rows).
        def p2(n: int, floor: int = 1) -> int:
            return max(floor, 1 << int(max(n, 1) - 1).bit_length())

        cfg = self.config
        rec = self.rec
        # Floors collapse the early-growth bucket spectrum (a 2-shot problem
        # pads to 8 instance slots).
        ni = p2(len(self.inst_ids), floor=8)
        nr = p2(len(self.rigcam_ids))
        nc = p2(len(self.cam_ids))
        npts = p2(len(self.point_ids), floor=512)

        used_types = sorted(
            {rec.cameras[cid].projection_type for cid in self.cam_ids} or
            {"perspective"}
        )
        pmax = max(max(len(cam_lib.PARAMS[t]) for t in used_types), 1)

        inst = np.zeros((ni, 6))
        for i, iid in enumerate(self.inst_ids):
            pose = rec.rig_instances[iid].pose
            inst[i, :3] = pose.rotation
            inst[i, 3:] = pose.translation
        rigcam = np.zeros((nr, 6))
        for i, rid in enumerate(self.rigcam_ids):
            pose = rec.rig_cameras[rid].pose
            rigcam[i, :3] = pose.rotation
            rigcam[i, 3:] = pose.translation

        cam = np.zeros((nc, pmax))
        cam_prior = np.zeros((nc, pmax))
        cam_prior_inv_sd = np.zeros((nc, pmax))
        cam_log_mask = np.zeros((nc, pmax), dtype=bool)
        opt_cam = np.zeros((nc, pmax), dtype=bool)
        for i, cid in enumerate(self.cam_ids):
            camera = rec.cameras[cid]
            layout = cam_lib.PARAMS[camera.projection_type]
            cam[i, : len(layout)] = camera.parameters
            prior_cam = self.cam_priors.get(i) or camera
            cam_prior[i, : len(layout)] = prior_cam.parameters
            for j, name in enumerate(layout):
                sd = float(cfg.get(_PARAM_SD_KEY.get(name, ""), 0.01) or 0.01)
                cam_prior_inv_sd[i, j] = 1.0 / max(sd, 1e-12)
                cam_log_mask[i, j] = name in _LOG_SCALE_PARAMS
            opt_cam[i, : len(layout)] = self.opt_cam_blocks[i]

        points = np.zeros((npts, 3))
        for i, pid in enumerate(self.point_ids):
            if pid in extra_point_coords:
                points[i] = extra_point_coords[pid]
            else:
                points[i] = rec.points[pid].coordinates

        # Observations, grouped by projection type for static segments.
        # Vectorized assembly: the round-3 per-observation Python loops
        # cost ~65 s at the 10.5M-observation scale lane; columnar
        # fromiter + argsort brings that to a few seconds.
        obs_list = self.obs
        n_obs = len(obs_list)
        O = p2(n_obs, floor=2048)
        obs_uv = np.zeros((O, 2))
        obs_inv_sd = np.zeros(O)
        obs_point = np.zeros(O, dtype=np.int64)
        obs_inst = np.zeros(O, dtype=np.int64)
        obs_rigcam = np.zeros(O, dtype=np.int64)
        obs_cam = np.zeros(O, dtype=np.int64)
        obs_depth = np.zeros(O)
        obs_depth_inv_sd = np.zeros(O)
        obs_depth_radial = np.zeros(O, dtype=bool)
        segments: List[Tuple[str, int, int]] = []
        if n_obs:
            type_code = {t: k for k, t in enumerate(
                sorted({o[6] for o in obs_list})
            )}
            codes = np.fromiter(
                (type_code[o[6]] for o in obs_list), np.int64, n_obs
            )
            order = np.argsort(codes, kind="stable")
            obs_uv[:n_obs] = np.array(
                [o[0] for o in obs_list], dtype=np.float64
            )[order]
            obs_inv_sd[:n_obs] = np.fromiter(
                (o[1] for o in obs_list), np.float64, n_obs
            )[order]
            obs_point[:n_obs] = np.fromiter(
                (o[2] for o in obs_list), np.int64, n_obs
            )[order]
            obs_inst[:n_obs] = np.fromiter(
                (o[3] for o in obs_list), np.int64, n_obs
            )[order]
            obs_rigcam[:n_obs] = np.fromiter(
                (o[4] for o in obs_list), np.int64, n_obs
            )[order]
            obs_cam[:n_obs] = np.fromiter(
                (o[5] for o in obs_list), np.int64, n_obs
            )[order]
            # Depth priors are sparse: touch only the rows that carry one.
            rank_of = np.empty(n_obs, dtype=np.int64)
            rank_of[order] = np.arange(n_obs)
            for k, o in enumerate(obs_list):
                depth = o[7]
                if depth is not None and np.isfinite(depth.value):
                    rank = rank_of[k]
                    obs_depth[rank] = depth.value
                    obs_depth_inv_sd[rank] = 1.0 / max(
                        depth.std_deviation, 1e-12
                    )
                    obs_depth_radial[rank] = bool(depth.is_radial)
            codes_sorted = codes[order]
            by_code = sorted(type_code.items(), key=lambda kv: kv[1])
            for pt, code in by_code:
                lo = int(np.searchsorted(codes_sorted, code, side="left"))
                hi = int(np.searchsorted(codes_sorted, code, side="right"))
                if hi > lo:
                    segments.append((pt, lo, hi))
        if not segments:
            segments = [(used_types[0], 0, O)]
        else:
            # Zero-weight padding rides in the last type segment.
            segments[-1] = (segments[-1][0], segments[-1][1], O)

        # CSR point -> obs (padded with the trash slot O).
        if n_obs:
            pts_used = obs_point[:n_obs]
            track_lens = np.bincount(pts_used, minlength=npts)
            T = p2(int(track_lens.max(initial=1)), floor=8)
            point_obs = np.full((npts, T), O, dtype=np.int64)
            order_p = np.argsort(pts_used, kind="stable")
            starts = np.concatenate([[0], np.cumsum(track_lens)[:-1]])
            slot_in_point = np.arange(n_obs) - starts[pts_used[order_p]]
            point_obs[pts_used[order_p], slot_in_point] = order_p
        else:
            T = p2(1, floor=8)
            point_obs = np.full((npts, T), O, dtype=np.int64)

        gps_pos = np.zeros((ni, 3))
        gps_inv_sd = np.zeros(ni)
        for i, (pos, std) in self.gps.items():
            gps_pos[i] = pos
            gps_inv_sd[i] = 1.0 / max(std, 1e-12)

        point_prior = np.zeros((npts, 3))
        point_prior_inv_sd = np.zeros((npts, 3))
        point_prior_loss = np.zeros(npts)
        for i, (pos, inv_sd, loss_c) in self.point_priors.items():
            point_prior[i] = pos
            point_prior_inv_sd[i] = inv_sd
            point_prior_loss[i] = loss_c

        # Rig camera priors: current values with rig sd (DataPriorError).
        rigcam_prior = rigcam.copy()
        rigcam_prior_inv_sd = np.zeros((nr, 6))
        rot_sd = float(cfg.get("rig_rotation_sd", 0.1))
        trans_sd = float(cfg.get("rig_translation_sd", 0.1))
        for i in range(len(self.rigcam_ids)):
            if self.opt_rigcam[i]:
                rigcam_prior_inv_sd[i, :3] = 1.0 / max(rot_sd, 1e-12)
                rigcam_prior_inv_sd[i, 3:] = 1.0 / max(trans_sd, 1e-12)

        return BAProblem(
            inst=inst, rigcam=rigcam, cam=cam, points=points,
            obs_uv=obs_uv, obs_inv_sd=obs_inv_sd, obs_point=obs_point,
            obs_inst=obs_inst, obs_rigcam=obs_rigcam, obs_cam=obs_cam,
            point_obs=point_obs,
            gps_pos=gps_pos, gps_inv_sd=gps_inv_sd,
            cam_prior=cam_prior, cam_prior_inv_sd=cam_prior_inv_sd,
            cam_log_mask=cam_log_mask,
            rigcam_prior=rigcam_prior, rigcam_prior_inv_sd=rigcam_prior_inv_sd,
            point_prior=point_prior, point_prior_inv_sd=point_prior_inv_sd,
            point_prior_loss=point_prior_loss,
            opt_inst=np.asarray(self.opt_inst + [False] * (ni - len(self.opt_inst)), bool),
            opt_rigcam=np.asarray(
                self.opt_rigcam + [False] * (nr - len(self.opt_rigcam)), bool
            ),
            opt_cam=opt_cam,
            opt_points=np.asarray(
                self.opt_points + [False] * (npts - len(self.opt_points)), bool
            ),
            ptype=tuple(segments),
            loss=str(self.config.get("loss_function", "SoftLOneLoss")),
            loss_threshold=float(self.config.get("loss_function_threshold", 1.0)),
            up_inst=np.asarray([u[0] for u in self.up_rows], dtype=np.int32),
            up_rigcam=np.asarray([u[1] for u in self.up_rows], dtype=np.int32),
            up_vec=(
                np.asarray([u[2] for u in self.up_rows])
                if self.up_rows else np.zeros((0, 3))
            ),
            up_inv_sd=np.asarray(
                [1.0 / max(u[3], 1e-12) for u in self.up_rows]
            ),
            obs_depth=obs_depth,
            obs_depth_inv_sd=obs_depth_inv_sd,
            obs_depth_radial=obs_depth_radial,
        )

    def writeback(self, result: BAResult) -> None:
        """Write optimized values back into the reconstruction with NaN
        guards (BundleToMap, ba_helpers.cc:765-819)."""
        rec = self.rec
        if not (
            np.all(np.isfinite(result.inst))
            and np.all(np.isfinite(result.points))
            and np.all(np.isfinite(result.cam))
        ):
            raise RuntimeError("Bundle adjustment produced non-finite values")
        for i, iid in enumerate(self.inst_ids):
            if self.opt_inst[i]:
                rec.rig_instances[iid].pose = Pose(result.inst[i, :3], result.inst[i, 3:])
        for i, rid in enumerate(self.rigcam_ids):
            if self.opt_rigcam[i]:
                rec.rig_cameras[rid].pose = Pose(result.rigcam[i, :3], result.rigcam[i, 3:])
        for i, cid in enumerate(self.cam_ids):
            if self.opt_cam_blocks[i]:
                camera = rec.cameras[cid]
                nparams = len(cam_lib.PARAMS[camera.projection_type])
                camera.set_parameters_values(result.cam[i, :nparams])
        for i, pid in enumerate(self.point_ids):
            if self.opt_points[i] and pid in rec.points:
                rec.points[pid].coordinates = result.points[i].copy()


def _setup_cameras(builder: _Builder, camera_priors, config) -> None:
    fix_cameras = not config["optimize_camera_parameters"]
    for cam_id, camera in builder.rec.cameras.items():
        prior = camera_priors.get(cam_id, camera) if camera_priors else camera
        fixed = fix_cameras or camera.projection_type in ("spherical",)
        builder.add_camera(camera, prior, fixed)


def _lock_rig_cameras(rec: types.Reconstruction) -> bool:
    """Rig cameras are locked unless there are enough instances per rig
    camera (ba_helpers.cc:623-638)."""
    n_rigcams = len(rec.rig_cameras)
    shots_per_rigcam = len(rec.shots) / n_rigcams if n_rigcams else 1
    return shots_per_rigcam <= _MIN_RIG_INSTANCES_FOR_ADJUST


def _setup_instance(
    builder: _Builder, instance, config, fixed: bool, use_gps: bool = True
) -> int:
    """Register one rig instance + averaged GPS prior (ba_helpers.cc:643-683)."""
    i_idx = builder.add_instance(instance, fixed)
    if config["bundle_use_gps"] and use_gps and not fixed:
        positions, stds = [], []
        bias = None
        for shot in instance.shots.values():
            m = shot.metadata
            if bias is None:
                bias = builder.rec.biases.get(shot.camera.id)
            if m.gps_position.has_value and m.gps_accuracy.has_value:
                positions.append(np.asarray(m.gps_position.value, dtype=np.float64))
                stds.append(float(m.gps_accuracy.value))
        if positions:
            mean_pos = np.mean(positions, axis=0)
            # GPS priors live in the GPS frame; the per-camera bias similarity
            # maps them into the model frame (SimilarityPriorTransform,
            # bundle_adjuster.cc:745-778).
            if bias is not None:
                mean_pos = bias.transform(mean_pos)
            builder.add_gps(i_idx, mean_pos, float(np.mean(stds)))
    return i_idx


def _add_shot_obs(builder: _Builder, shot, i_idx, r_idx, c_idx, points_filter=None):
    ptype = shot.camera.projection_type
    count = 0
    for lm_id, obs in shot.get_landmark_observations().items():
        if points_filter is not None and lm_id not in points_filter:
            continue
        p_idx = builder.point_index.get(lm_id)
        if p_idx is None:
            continue
        builder.add_obs(
            obs.point, obs.scale, p_idx, i_idx, r_idx, c_idx, ptype,
            depth_prior=getattr(obs, "depth_prior", None),
        )
        count += 1
    return count


def triangulate_gcp(point, shots: Dict[str, pymap.Shot],
                    device=None) -> Optional[np.ndarray]:
    """Triangulate a GCP from its image observations with the BA-side
    thresholds (TriangulateGCP, ba_helpers.cc:313-346)."""
    return multiview.triangulate_gcp(
        point, shots, reproj_threshold=1.0, min_ray_angle_degrees=0.1,
        min_depth=1e-3, device=device,
    )


def _add_gcp(builder: _Builder, gcp, config, dominant_terms: int,
             device=None):
    """GCPs as triangulated points with position priors + projections
    (AddGCPToBundle, ba_helpers.cc:349-406)."""
    rec = builder.rec
    extra_coords: Dict[str, np.ndarray] = {}
    total_terms = 0
    for point in gcp:
        coords = triangulate_gcp(point, rec.shots, device=device)
        if coords is not None or point.lla:
            total_terms += 1
        total_terms += sum(1 for o in point.observations if o.shot_id in rec.shots)

    global_weight = (
        float(config["gcp_global_weight"]) * dominant_terms / max(1, total_terms)
    )

    for point in gcp:
        point_id = "gcp-" + point.id
        coords = triangulate_gcp(point, rec.shots, device=device)
        if coords is None:
            if point.lla:
                coords = np.asarray(
                    rec.reference.to_topocentric(*point.lla_vec)
                )
            else:
                continue
        p_idx = builder.add_point(point_id, fixed=False)
        extra_coords[point_id] = coords
        if point.lla:
            hor = float(config["gcp_horizontal_sd"]) / global_weight
            vert = float(config["gcp_vertical_sd"]) / global_weight
            prior_pos = np.asarray(rec.reference.to_topocentric(*point.lla_vec))
            inv = np.array(
                [1.0 / hor, 1.0 / hor, (1.0 / vert) if point.has_altitude else 0.0]
            )
            # Cauchy at ~2 true survey sigmas (the effective residual is
            # global_weight-scaled): bounds the influence of a bad GCP draw
            # while leaving nominal GCPs effectively quadratic.  An extension
            # (shared with the JAX package) over OpenSfM's always-quadratic
            # AddPointPrior;
            # disable with gcp_robust_prior: no for exact reference behavior.
            robust = bool(config.get("gcp_robust_prior", True))
            builder.add_point_prior(
                p_idx, prior_pos, inv,
                loss_threshold=(2.0 * global_weight) if robust else 0.0,
            )
        for obs in point.observations:
            shot = rec.shots.get(obs.shot_id)
            if shot is None:
                continue
            i_idx = builder.inst_index.get(shot.rig_instance.id)
            r_idx = builder.rigcam_index.get(shot.rig_camera.id)
            c_idx = builder.cam_index.get(shot.camera.id)
            if i_idx is None or r_idx is None or c_idx is None:
                continue
            builder.add_obs(
                obs.projection, 0.001 / global_weight, p_idx, i_idx, r_idx,
                c_idx, shot.camera.projection_type,
            )
    return extra_coords


def _solve_full_bundle(problem, config: Dict[str, Any], n_shots: int,
                       device=None):
    """Route a full-map bundle to the sharded solver when configured and
    profitable, else to the single-device solver on `device`.

    `bundle_distributed: auto` takes the sharded solver once the map has
    `bundle_distributed_min_shots` shots and the mesh (`default_mesh`:
    every visible CUDA device) has more than one shard; `yes` takes it
    whatever the map's size.  `bundle_distributed_solver` picks the solver
    (auto, dense, schur, cg) and `bundle_distributed_cg_iters` CG's
    iterations.  A problem the sharded solver cannot take (no observations,
    or pose-graph rows with solver cg) is logged and solved on one
    device, as the JAX package does."""
    device = resolve_device(device)
    max_iterations = int(config["bundle_max_iterations"])
    mode = str(config.get("bundle_distributed", "auto")).lower()
    if mode in ("yes", "true", "1", "auto"):
        from opensfm_tpu_torch.parallel import distributed_ba
        from opensfm_tpu_torch.parallel import mesh as mesh_lib

        mesh = mesh_lib.default_mesh(device)
        min_shots = int(config.get("bundle_distributed_min_shots", 100))
        wanted = mode != "auto" or n_shots >= min_shots
        if mesh.n_shards > 1 and wanted:
            reason = distributed_ba.check_cg_compatible(problem)
            solver_cfg = str(
                config.get("bundle_distributed_solver", "auto")).lower()
            # Pose-graph rows ride the assembled-Schur solver: only a
            # pinned solver=cg (or no observations) falls back.
            routable = reason is None or (
                reason != "no observations" and solver_cfg != "cg")
            if routable:
                logger.info("Distributed BA over %d shards (%d shots)",
                            mesh.n_shards, n_shots)
                return distributed_ba.bundle_adjust_sharded(
                    problem, max_iterations=max_iterations,
                    cg_iters=int(config.get("bundle_distributed_cg_iters",
                                            100)),
                    solver=solver_cfg, mesh=mesh,
                )
            logger.info("Distributed BA unavailable (%s); using the "
                        "single-device solver", reason)
    return bundle_adjust(problem, max_iterations=max_iterations, device=device)


def bundle(
    reconstruction: types.Reconstruction,
    camera_priors: Dict[str, Any],
    rig_camera_priors: Dict[str, Any],
    gcp: Optional[List[Any]],
    config: Dict[str, Any],
    device=None,
) -> Dict[str, Any]:
    """Full-map bundle adjustment (BAHelpers::Bundle, ba_helpers.cc:581-763)
    on `device` (CUDA unless told otherwise)."""
    start = time.time()
    builder = _Builder(reconstruction, config)
    _setup_cameras(builder, camera_priors, config)

    lock_rigcam = _lock_rig_cameras(reconstruction)
    for rig_camera in reconstruction.rig_cameras.values():
        is_leverarm = rig_camera.id in reconstruction.cameras
        builder.add_rig_camera(rig_camera, fixed=lock_rigcam or is_leverarm)

    for instance in reconstruction.rig_instances.values():
        _setup_instance(builder, instance, config, fixed=False)

    for point in reconstruction.points.values():
        builder.add_point(point.id, fixed=False)

    # Up-vector alignment rows when align_method resolves to
    # orientation_prior (ba_helpers.cc:604-620, 688-691).
    align_method = str(config.get("align_method", "auto"))
    if align_method == "auto":
        align_method = align_lib.detect_alignment_constraints(
            config, reconstruction, gcp or [],
            use_gps=bool(config.get("bundle_use_gps", True)), device=device,
        )
    up_vector = None
    if align_method == "orientation_prior":
        prior = str(config.get("align_orientation_prior", "horizontal"))
        if prior == "vertical":
            up_vector = np.array([0.0, 0.0, -1.0])
        elif prior == "horizontal":
            up_vector = np.array([0.0, -1.0, 0.0])

    num_projections = 0
    for shot in reconstruction.shots.values():
        i_idx = builder.inst_index[shot.rig_instance.id]
        r_idx = builder.rigcam_index[shot.rig_camera.id]
        c_idx = builder.cam_index[shot.camera.id]
        if up_vector is not None:
            builder.add_up_vector(i_idx, r_idx, up_vector, 1e-3)
        num_projections += _add_shot_obs(builder, shot, i_idx, r_idx, c_idx)

    extra_coords: Dict[str, np.ndarray] = {}
    if config["bundle_use_gcp"] and gcp:
        dominant = len(reconstruction.rig_instances) + num_projections
        extra_coords = _add_gcp(builder, gcp, config, dominant, device=device)

    problem = builder.build(extra_coords)
    setup_time = time.time() - start
    result = _solve_full_bundle(
        problem, config, n_shots=len(builder.inst_ids), device=device
    )
    run_time = time.time() - start - setup_time
    builder.writeback(result)

    return {
        "brief_report": (
            f"cost {result.initial_cost:.3g} -> {result.final_cost:.3g} "
            f"in {result.iterations} iterations"
        ),
        "wall_times": {
            "setup": setup_time,
            "run": run_time,
            "teardown": time.time() - start - setup_time - run_time,
        },
        "num_parameters": int(
            6 * len(builder.inst_ids) + 3 * len(builder.point_ids)
        ),
        "num_residuals": len(builder.obs) * 2,
        "initial_cost": result.initial_cost,
        "final_cost": result.final_cost,
        "iterations": result.iterations,
        "route": result.route,
    }


def bundle_local(
    reconstruction: types.Reconstruction,
    camera_priors: Dict[str, Any],
    rig_camera_priors: Dict[str, Any],
    central_shot_id: str,
    gcp: Optional[List[Any]],
    config: Dict[str, Any],
    device=None,
) -> Tuple[Dict[str, Any], Set[str]]:
    """Local BA around a shot: interior optimized, boundary fixed
    (BundleLocal, ba_helpers.cc:117-311), on `device` (CUDA unless told
    otherwise).  Returns (report, the interior and boundary shots)."""
    start = time.time()
    interior, boundary = shot_neighborhood(
        reconstruction,
        central_shot_id,
        int(config["local_bundle_radius"]),
        int(config["local_bundle_min_common_points"]),
        int(config["local_bundle_max_shots"]),
    )

    builder = _Builder(reconstruction, config)
    _setup_cameras(builder, camera_priors, config)
    lock_rigcam = _lock_rig_cameras(reconstruction)
    for rig_camera in reconstruction.rig_cameras.values():
        is_leverarm = rig_camera.id in reconstruction.cameras
        builder.add_rig_camera(rig_camera, fixed=lock_rigcam or is_leverarm)

    # Interior instances float; boundary instances are fixed.
    for sid in interior:
        shot = reconstruction.shots[sid]
        _setup_instance(builder, shot.rig_instance, config, fixed=False)
    for sid in boundary:
        shot = reconstruction.shots[sid]
        _setup_instance(builder, shot.rig_instance, config, fixed=True)

    # Points seen from the interior float; add interior + boundary
    # projections of those points.
    interior_points: Set[str] = set()
    for sid in interior:
        shot = reconstruction.shots[sid]
        for lm_id in shot.get_landmark_observations():
            if lm_id in reconstruction.points and lm_id not in interior_points:
                interior_points.add(lm_id)
                builder.add_point(lm_id, fixed=False)

    num_projections = 0
    for sid in list(interior) + list(boundary):
        shot = reconstruction.shots[sid]
        i_idx = builder.inst_index[shot.rig_instance.id]
        r_idx = builder.rigcam_index[shot.rig_camera.id]
        c_idx = builder.cam_index[shot.camera.id]
        num_projections += _add_shot_obs(
            builder, shot, i_idx, r_idx, c_idx, points_filter=interior_points
        )

    extra_coords: Dict[str, np.ndarray] = {}
    if config["bundle_use_gcp"] and gcp:
        dominant = len(interior) + len(boundary) + num_projections
        extra_coords = _add_gcp(builder, gcp, config, dominant, device=device)

    problem = builder.build(extra_coords)
    setup = time.time() - start
    result = bundle_adjust(problem, max_iterations=10,  # ba_helpers.cc:265
                           device=device)
    builder.writeback(result)

    return (
        {
            "brief_report": (
                f"local({central_shot_id}): cost {result.initial_cost:.3g} -> "
                f"{result.final_cost:.3g}, interior {len(interior)}, "
                f"boundary {len(boundary)}"
            ),
            "wall_times": {
                "setup": setup,
                "run": time.time() - start - setup,
                "teardown": 0.0,
            },
            "initial_cost": result.initial_cost,
            "final_cost": result.final_cost,
            "iterations": result.iterations,
            "route": result.route,
        },
        interior | boundary,
    )


def bundle_shot_poses(
    reconstruction: types.Reconstruction,
    shot_ids: Set[str],
    camera_priors: Dict[str, Any],
    rig_camera_priors: Dict[str, Any],
    config: Dict[str, Any],
    device=None,
) -> Dict[str, Any]:
    """Pose-only refinement: cameras, rig cameras and points fixed
    (BundleShotPoses, ba_helpers.cc:408-579), on `device` (CUDA unless told
    otherwise)."""
    start = time.time()
    builder = _Builder(reconstruction, config)
    # Cameras always fixed here.
    for cam_id, camera in reconstruction.cameras.items():
        prior = camera_priors.get(cam_id, camera) if camera_priors else camera
        builder.add_camera(camera, prior, fixed=True)
    for rig_camera in reconstruction.rig_cameras.values():
        builder.add_rig_camera(rig_camera, fixed=True)

    instances = {}
    for sid in shot_ids:
        shot = reconstruction.shots[sid]
        instances[shot.rig_instance.id] = shot.rig_instance
    for instance in instances.values():
        _setup_instance(builder, instance, config, fixed=False)

    # All points observed from these instances, fixed.
    for instance in instances.values():
        for shot in instance.shots.values():
            for lm_id in shot.get_landmark_observations():
                if lm_id in reconstruction.points:
                    builder.add_point(lm_id, fixed=True)

    for instance in instances.values():
        for shot in instance.shots.values():
            i_idx = builder.inst_index[shot.rig_instance.id]
            r_idx = builder.rigcam_index[shot.rig_camera.id]
            c_idx = builder.cam_index[shot.camera.id]
            _add_shot_obs(builder, shot, i_idx, r_idx, c_idx)

    problem = builder.build({})
    setup = time.time() - start
    result = bundle_adjust(problem, max_iterations=10, device=device)
    builder.writeback(result)
    return {
        "brief_report": (
            f"shot_poses: cost {result.initial_cost:.3g} -> {result.final_cost:.3g}"
        ),
        "wall_times": {"setup": setup, "run": time.time() - start - setup,
                       "teardown": 0.0},
        "initial_cost": result.initial_cost,
        "final_cost": result.final_cost,
        "iterations": result.iterations,
        "route": result.route,
    }
