"""pybundle-compatible BundleAdjuster facade over the LM core.

Port of `opensfm_tpu.ba.adjuster` (the reference's `pybundle.BundleAdjuster`,
bundle/bundle_adjuster.h:178-374) with the cluster-SfM constraint families:
relative motion and rotation, common position, heatmap position priors,
linear motion, reconstruction scales with scale sharing and the gauge fix.
Poses go in and out as world-to-camera `Pose` objects and constraints use
the reference's cam-to-world observation convention.  `run` lowers the
problem (`build_problem`) to `opensfm_tpu_torch.ba.lm.bundle_adjust` on
the facade's device, where the constraint rows fold into the reduced system
(`lm._fold_graph_rows`); a mono perspective problem takes the CUDA kernels
there, as any other problem of that kind does.

The full-map path (`opensfm_tpu_torch.ba.problem.bundle`) bypasses this
facade; it serves code written against `pybundle` and pose-graph-sized
problems.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from opensfm_tpu_torch.ba import lm
from opensfm_tpu_torch.geometry import cameras as cam_lib
from opensfm_tpu_torch.geometry.pose import Pose, _rotvec_to_matrix_np


@dataclass
class RelativeMotion:
    """Mirror of pybundle.RelativeMotion (bundle_adjuster.h:80-109):
    observed similarity between two rig instances, in the reference's
    cam-to-world parametrization."""

    rig_instance_i: str
    rig_instance_j: str
    rotation: np.ndarray
    translation: np.ndarray
    scale: float = 1.0
    robust_multiplier: float = 1.0
    observed_scale: bool = False
    scale_matrix: Optional[np.ndarray] = None  # [7] diagonal

    def set_scale_matrix(self, m) -> None:
        m = np.asarray(m, dtype=np.float64)
        self.scale_matrix = np.diagonal(m).copy() if m.ndim == 2 else m


@dataclass
class RelativeRotation:
    """Mirror of pybundle.RelativeRotation (bundle_adjuster.h:111-127)."""

    shot_i: str
    shot_j: str
    rotation: np.ndarray
    scale_matrix: Optional[np.ndarray] = None  # [3] diagonal

    def set_scale_matrix(self, m) -> None:
        m = np.asarray(m, dtype=np.float64)
        self.scale_matrix = np.diagonal(m).copy() if m.ndim == 2 else m


@dataclass
class _Reconstruction:
    """Cluster-SfM scale container (bundle_adjuster.h:25-80)."""

    id: str
    constant: bool = False
    shared: bool = True
    scales: Dict[str, float] = field(default_factory=dict)

    def get_scale(self, instance_id: str) -> float:
        if self.shared:
            return next(iter(self.scales.values()), 1.0)
        return self.scales[instance_id]

    def set_scale(self, instance_id: str, v: float) -> None:
        if self.shared:
            for k in self.scales:
                self.scales[k] = v
        else:
            self.scales[instance_id] = v


@dataclass
class _Point:
    id: str
    p: np.ndarray
    constant: bool = False
    prior: Optional[Tuple[np.ndarray, np.ndarray, bool]] = None


class BundleAdjuster:
    """API-parity bundle adjuster (see module docstring) solving on `device`
    (CUDA unless told otherwise)."""

    def __init__(self, device=None) -> None:
        self._device = device
        self._cameras: Dict[str, tuple] = {}  # id -> (camera, prior, const)
        self._rig_cameras: Dict[str, tuple] = {}  # id -> (pose6, prior6, const)
        self._instances: Dict[str, dict] = {}  # id -> {pose6, fixed, shots}
        self._shots: Dict[str, tuple] = {}  # shot -> (inst, cam, rigcam)
        self._points: Dict[str, _Point] = {}
        self._reconstructions: Dict[str, _Reconstruction] = {}
        self._rec_of_instance: Dict[str, str] = {}
        self._position_priors: Dict[str, tuple] = {}  # inst -> (pos, std3)
        self._projections: List[tuple] = []
        self._relative_motions: List[RelativeMotion] = []
        self._relative_rotations: List[RelativeRotation] = []
        self._common_positions: List[tuple] = []
        self._linear_motions: List[tuple] = []
        self._heatmaps: Dict[str, tuple] = {}  # id -> (grid, resolution)
        self._position_heatmaps: List[tuple] = []
        self._up_vectors: List[tuple] = []
        self._gauge: Optional[Tuple[str, str]] = None
        self._rm_loss = ("CauchyLoss", 1.0)
        self._proj_loss = ("CauchyLoss", 1.0)
        self._max_iterations = 50

    # -- data blocks --------------------------------------------------------
    def add_camera(self, cam_id, camera, prior, constant: bool) -> None:
        self._cameras[cam_id] = (camera, prior, constant)

    def add_rig_camera(self, rc_id, pose: Pose, prior: Pose, fixed: bool) -> None:
        p6 = np.concatenate([pose.rotation, pose.translation])
        pr6 = np.concatenate([prior.rotation, prior.translation])
        self._rig_cameras[rc_id] = (p6, pr6, fixed)

    def add_rig_instance(self, inst_id, pose: Pose, shot_cameras,
                         shot_rig_cameras, fixed: bool) -> None:
        self._instances[inst_id] = {
            "pose": np.concatenate([pose.rotation, pose.translation]),
            "fixed": fixed,
            "shots": list(shot_cameras.keys()),
        }
        for shot_id, cam_id in shot_cameras.items():
            self._shots[shot_id] = (inst_id, cam_id, shot_rig_cameras[shot_id])

    def add_rig_instance_position_prior(self, inst_id, position,
                                        std_deviation, scale_group: str = "") -> None:
        self._position_priors[inst_id] = (
            np.asarray(position, np.float64),
            np.asarray(std_deviation, np.float64),
        )

    def add_point(self, point_id, position, constant: bool) -> None:
        self._points[point_id] = _Point(
            point_id, np.asarray(position, np.float64), constant
        )

    def add_point_prior(self, point_id, position, std_deviation,
                        has_altitude_prior: bool) -> None:
        self._points[point_id].prior = (
            np.asarray(position, np.float64),
            np.asarray(std_deviation, np.float64),
            has_altitude_prior,
        )

    def add_point_projection_observation(self, shot_id, point_id, observation,
                                         std_deviation: float) -> None:
        self._projections.append(
            (shot_id, point_id, np.asarray(observation, np.float64),
             float(std_deviation))
        )

    # -- cluster-SfM --------------------------------------------------------
    def add_reconstruction(self, rec_id, constant: bool) -> None:
        self._reconstructions[rec_id] = _Reconstruction(rec_id, constant)

    def add_reconstruction_instance(self, rec_id, scale: float, inst_id) -> None:
        self._reconstructions[rec_id].scales[inst_id] = float(scale)
        self._rec_of_instance[inst_id] = rec_id

    def set_scale_sharing(self, rec_id, share: bool) -> None:
        self._reconstructions[rec_id].shared = share

    def get_reconstruction(self, rec_id) -> _Reconstruction:
        if rec_id not in self._reconstructions:
            # operator[]-style default (the reference's map access).
            self._reconstructions[rec_id] = _Reconstruction(rec_id)
        return self._reconstructions[rec_id]

    # -- constraints --------------------------------------------------------
    def add_relative_motion(self, rm: RelativeMotion) -> None:
        self._relative_motions.append(rm)

    def add_relative_rotation(self, rr: RelativeRotation) -> None:
        self._relative_rotations.append(rr)

    def add_common_position(self, shot_i, shot_j, margin: float,
                            std_deviation: float) -> None:
        self._common_positions.append((shot_i, shot_j, margin, std_deviation))

    def add_linear_motion(self, shot0, shot1, shot2, alpha: float,
                          position_std: float, orientation_std: float) -> None:
        self._linear_motions.append(
            (shot0, shot1, shot2, alpha, position_std, orientation_std)
        )

    def add_heatmap(self, heatmap_id, in_heatmap, in_width: int,
                    resolution: float) -> None:
        flat = np.asarray(in_heatmap, np.float64)
        grid = flat.reshape(-1, int(in_width))
        self._heatmaps[heatmap_id] = (grid, float(resolution))

    def add_absolute_position_heatmap(self, shot_id, heatmap_id, x_offset,
                                      y_offset, std_deviation: float) -> None:
        self._position_heatmaps.append(
            (shot_id, heatmap_id, float(x_offset), float(y_offset),
             float(std_deviation))
        )

    def add_absolute_up_vector(self, shot_id, up_vector, std_deviation: float) -> None:
        self._up_vectors.append(
            (shot_id, np.asarray(up_vector, np.float64), float(std_deviation))
        )

    def set_gauge_fix_shots(self, shot_origin, shot_scale) -> None:
        self._gauge = (shot_origin, shot_scale)

    # -- minimization setup -------------------------------------------------
    def set_point_projection_loss_function(self, name, threshold) -> None:
        self._proj_loss = (name, float(threshold))

    def set_relative_motion_loss_function(self, name, threshold) -> None:
        self._rm_loss = (name, float(threshold))

    def set_max_num_iterations(self, n: int) -> None:
        self._max_iterations = int(n)

    # -- solve --------------------------------------------------------------
    def run(self) -> None:
        """Solve and write the poses, points and scales back."""
        problem = self.build_problem()
        self._write_back(lm.bundle_adjust(
            problem, max_iterations=self._max_iterations,
            device=self._device))

    def build_problem(self) -> lm.BAProblem:
        """The facade's blocks and constraints as one `lm.BAProblem` (what
        `run` solves), keeping the index maps the write-back needs."""
        inst_ids = list(self._instances)
        inst_index = {k: i for i, k in enumerate(inst_ids)}
        rc_ids = list(self._rig_cameras)
        rc_index = {k: i for i, k in enumerate(rc_ids)}
        cam_ids = list(self._cameras) or ["_none"]
        cam_index = {k: i for i, k in enumerate(cam_ids)}

        ni, nr, nc = len(inst_ids), max(len(rc_ids), 1), len(cam_ids)
        inst = np.stack([self._instances[k]["pose"] for k in inst_ids])
        rigcam = (
            np.stack([self._rig_cameras[k][0] for k in rc_ids])
            if rc_ids else np.zeros((1, 6))
        )

        # Scale variables: one per (reconstruction, instance), collapsed to
        # one per reconstruction under scale sharing; index 0 is a fixed
        # unit scale for unassigned instances.
        scale_vals: List[float] = [1.0]
        opt_scales: List[bool] = [False]
        scale_index: Dict[str, int] = {}  # instance -> scale var
        scale_key_of_var: List[Optional[Tuple[str, str]]] = [None]
        for rec in self._reconstructions.values():
            if rec.shared:
                idx = len(scale_vals)
                scale_vals.append(next(iter(rec.scales.values()), 1.0))
                opt_scales.append(not rec.constant)
                scale_key_of_var.append((rec.id, "*"))
                for inst_id in rec.scales:
                    scale_index[inst_id] = idx
            else:
                for inst_id, s in rec.scales.items():
                    idx = len(scale_vals)
                    scale_vals.append(s)
                    opt_scales.append(not rec.constant)
                    scale_key_of_var.append((rec.id, inst_id))
                    scale_index[inst_id] = idx

        # Cameras: padded parameter table (unused unless projections exist).
        used_types = sorted(
            {c[0].projection_type for c in self._cameras.values()}
            or {"perspective"}
        )
        pmax = max(max(len(cam_lib.PARAMS[t]) for t in used_types), 3)
        cam = np.zeros((nc, pmax))
        opt_cam = np.zeros((nc, pmax), bool)
        for cid in self._cameras:
            c, _, const = self._cameras[cid]
            vals = np.asarray(c.get_parameters_values(), np.float64)
            cam[cam_index[cid], : len(vals)] = vals
            if not const:
                opt_cam[cam_index[cid], : len(vals)] = True

        # Points, plus one fixed sentinel the zero-weight padding obs can
        # project safely (z = 5 in front of every identity camera).
        pt_ids = list(self._points) + ["_sentinel"]
        pt_index = {k: i for i, k in enumerate(pt_ids)}
        npts = len(pt_ids)
        points = np.zeros((npts, 3))
        points[-1] = [0.0, 0.0, 5.0]
        opt_points = np.zeros(npts, bool)
        point_prior = np.zeros((npts, 3))
        point_prior_inv_sd = np.zeros((npts, 3))
        for pid, pt in self._points.items():
            i = pt_index[pid]
            points[i] = pt.p
            opt_points[i] = not pt.constant
            if pt.prior is not None:
                pos, sd, has_alt = pt.prior
                point_prior[i] = pos
                inv = 1.0 / np.maximum(sd, 1e-12)
                if not has_alt:
                    inv[2] = 0.0
                point_prior_inv_sd[i] = inv

        # Projections.
        obs = self._projections
        O = len(obs)
        obs_uv = np.zeros((O, 2))
        obs_inv_sd = np.zeros(O)
        obs_point = np.zeros(O, np.int64)
        obs_inst = np.zeros(O, np.int64)
        obs_rigcam = np.zeros(O, np.int64)
        obs_cam = np.zeros(O, np.int64)
        per_point_obs: Dict[int, List[int]] = {}
        for k, (shot_id, point_id, uv, sd) in enumerate(obs):
            i_id, c_id, r_id = self._shots[shot_id]
            obs_uv[k] = uv
            obs_inv_sd[k] = 1.0 / max(sd, 1e-12)
            obs_point[k] = pt_index[point_id]
            obs_inst[k] = inst_index[i_id]
            obs_rigcam[k] = rc_index.get(r_id, 0)
            obs_cam[k] = cam_index[c_id]
            per_point_obs.setdefault(pt_index[point_id], []).append(k)
        if O == 0:
            O = 1
            obs_uv = np.zeros((1, 2))
            obs_inv_sd = np.zeros(1)
            obs_point = np.full(1, npts - 1, np.int64)
            obs_inst = np.zeros(1, np.int64)
            obs_rigcam = np.zeros(1, np.int64)
            obs_cam = np.zeros(1, np.int64)
        T = max((len(v) for v in per_point_obs.values()), default=1)
        point_obs = np.full((npts, T), O, np.int64)
        for p, ks in per_point_obs.items():
            point_obs[p, : len(ks)] = ks

        # GPS (position) priors on instance origins.
        gps_pos = np.zeros((ni, 3))
        gps_inv_sd = np.zeros(ni)
        for inst_id, (pos, sd) in self._position_priors.items():
            gps_pos[inst_index[inst_id]] = pos
            gps_inv_sd[inst_index[inst_id]] = 1.0 / max(float(np.mean(sd)), 1e-12)

        # Constraint families.
        def shot_refs(shot_id):
            i_id, _, r_id = self._shots[shot_id]
            return inst_index[i_id], rc_index.get(r_id, 0)

        kw = {}
        if self._relative_motions:
            loss_c = self._rm_loss[1]
            kw.update(
                rm_i=np.array([inst_index[m.rig_instance_i]
                               for m in self._relative_motions]),
                rm_j=np.array([inst_index[m.rig_instance_j]
                               for m in self._relative_motions]),
                rm_si=np.array([scale_index.get(m.rig_instance_i, 0)
                                for m in self._relative_motions]),
                rm_sj=np.array([scale_index.get(m.rig_instance_j, 0)
                                for m in self._relative_motions]),
                rm_rvec=np.stack([np.asarray(m.rotation, np.float64)
                                  for m in self._relative_motions]),
                rm_tvec=np.stack([np.asarray(m.translation, np.float64)
                                  for m in self._relative_motions]),
                rm_scale=np.array([m.scale for m in self._relative_motions]),
                rm_inv_sd=np.stack([
                    (m.scale_matrix if m.scale_matrix is not None
                     else np.ones(7)) for m in self._relative_motions]),
                rm_obs_scale=np.array([m.observed_scale
                                       for m in self._relative_motions]),
                rm_loss_c=np.array([loss_c * m.robust_multiplier
                                    for m in self._relative_motions]),
            )
        if self._relative_rotations:
            refs = [(shot_refs(r.shot_i), shot_refs(r.shot_j))
                    for r in self._relative_rotations]
            kw.update(
                rr_i=np.array([a[0] for a, _ in refs]),
                rr_j=np.array([b[0] for _, b in refs]),
                rr_ri=np.array([a[1] for a, _ in refs]),
                rr_rj=np.array([b[1] for _, b in refs]),
                rr_rvec=np.stack([np.asarray(r.rotation, np.float64)
                                  for r in self._relative_rotations]),
                rr_inv_sd=np.stack([
                    (r.scale_matrix if r.scale_matrix is not None
                     else np.ones(3)) for r in self._relative_rotations]),
                rr_loss_c=np.full(len(refs), self._rm_loss[1]),
            )
        if self._common_positions:
            refs = [(shot_refs(i), shot_refs(j))
                    for i, j, _, _ in self._common_positions]
            kw.update(
                cp_i=np.array([a[0] for a, _ in refs]),
                cp_j=np.array([b[0] for _, b in refs]),
                cp_ri=np.array([a[1] for a, _ in refs]),
                cp_rj=np.array([b[1] for _, b in refs]),
                cp_margin=np.array([m for _, _, m, _ in self._common_positions]),
                cp_inv_sd=np.array([1.0 / max(s, 1e-12)
                                    for _, _, _, s in self._common_positions]),
            )
        if self._linear_motions:
            refs = [(shot_refs(a), shot_refs(b), shot_refs(c))
                    for a, b, c, _, _, _ in self._linear_motions]
            kw.update(
                lin_i0=np.array([r[0][0] for r in refs]),
                lin_i1=np.array([r[1][0] for r in refs]),
                lin_i2=np.array([r[2][0] for r in refs]),
                lin_r0=np.array([r[0][1] for r in refs]),
                lin_r1=np.array([r[1][1] for r in refs]),
                lin_r2=np.array([r[2][1] for r in refs]),
                lin_alpha=np.array([a for *_, a, _, _ in self._linear_motions]),
                lin_pos_inv_sd=np.array([
                    1.0 / max(p, 1e-12) for *_, p, _ in self._linear_motions]),
                lin_rot_inv_sd=np.array([
                    1.0 / max(o, 1e-12) for *_, o in self._linear_motions]),
            )
        if self._position_heatmaps:
            hm_ids = list(self._heatmaps)
            hm_idx = {k: i for i, k in enumerate(hm_ids)}
            hmax = max(g.shape[0] for g, _ in self._heatmaps.values())
            wmax = max(g.shape[1] for g, _ in self._heatmaps.values())
            grids = np.zeros((len(hm_ids), hmax, wmax))
            # Edge-pad so clamped bicubic taps read border values.
            for k, hid in enumerate(hm_ids):
                g, _ = self._heatmaps[hid]
                grids[k] = np.pad(
                    g, ((0, hmax - g.shape[0]), (0, wmax - g.shape[1])),
                    mode="edge",
                )
            refs = [shot_refs(s) for s, *_ in self._position_heatmaps]
            kw.update(
                hm_inst=np.array([r[0] for r in refs]),
                hm_rigcam=np.array([r[1] for r in refs]),
                hm_map=np.array([hm_idx[h]
                                 for _, h, *_ in self._position_heatmaps]),
                hm_offset=np.array([[x, y]
                                    for _, _, x, y, _ in self._position_heatmaps]),
                hm_inv_sd=np.array([1.0 / max(s, 1e-12)
                                    for *_, s in self._position_heatmaps]),
                heatmaps=grids,
                hm_res=np.array([self._heatmaps[h][1] for h in hm_ids]),
            )
        if self._gauge is not None:
            def origin_of(inst6):
                return -_rotvec_to_matrix_np(inst6[:3]).T @ inst6[3:]

            a, b = self._gauge
            ia, _ = shot_refs(a)
            ib, _ = shot_refs(b)
            norm = float(np.linalg.norm(origin_of(inst[ia]) - origin_of(inst[ib])))
            kw.update(
                gauge_i=np.array([ia]), gauge_j=np.array([ib]),
                gauge_norm=np.array([max(norm, 1e-10)]),
            )
        if self._up_vectors:
            refs = [shot_refs(s) for s, _, _ in self._up_vectors]
            kw.update(
                up_inst=np.array([r[0] for r in refs], np.int32),
                up_rigcam=np.array([r[1] for r in refs], np.int32),
                up_vec=np.stack([
                    v / max(np.linalg.norm(v), 1e-12)
                    for _, v, _ in self._up_vectors]),
                up_inv_sd=np.array([1.0 / max(s, 1e-12)
                                    for _, _, s in self._up_vectors]),
            )

        problem = lm.BAProblem(
            inst=inst, rigcam=rigcam, cam=cam, points=points,
            obs_uv=obs_uv, obs_inv_sd=obs_inv_sd, obs_point=obs_point,
            obs_inst=obs_inst, obs_rigcam=obs_rigcam, obs_cam=obs_cam,
            point_obs=point_obs,
            gps_pos=gps_pos, gps_inv_sd=gps_inv_sd,
            cam_prior=cam.copy(), cam_prior_inv_sd=np.zeros((nc, pmax)),
            cam_log_mask=np.zeros((nc, pmax), bool),
            rigcam_prior=rigcam.copy(),
            rigcam_prior_inv_sd=np.zeros((max(len(rc_ids), 1), 6)),
            point_prior=point_prior, point_prior_inv_sd=point_prior_inv_sd,
            opt_inst=np.array([not self._instances[k]["fixed"]
                               for k in inst_ids], bool),
            opt_rigcam=np.array(
                [not self._rig_cameras[k][2] for k in rc_ids] or [False], bool
            ),
            opt_cam=opt_cam,
            opt_points=opt_points,
            ptype="perspective",
            loss=self._proj_loss[0], loss_threshold=self._proj_loss[1],
            scales=np.asarray(scale_vals),
            opt_scales=np.asarray(opt_scales, bool),
            **kw,
        )
        self._layout = (inst_ids, rc_ids, pt_index, scale_key_of_var)
        return problem

    def _write_back(self, result: lm.BAResult) -> None:
        inst_ids, rc_ids, pt_index, scale_key_of_var = self._layout
        for k, iid in enumerate(inst_ids):
            self._instances[iid]["pose"] = result.inst[k].copy()
        for k, rid in enumerate(rc_ids):
            pose6, prior6, const = self._rig_cameras[rid]
            self._rig_cameras[rid] = (result.rigcam[k].copy(), prior6, const)
        for pid, pt in self._points.items():
            pt.p = result.points[pt_index[pid]].copy()
        if result.scales is not None:
            for idx, key in enumerate(scale_key_of_var):
                if key is None:
                    continue
                rec_id, inst_id = key
                rec = self._reconstructions[rec_id]
                if inst_id == "*":
                    for i_id in rec.scales:
                        rec.scales[i_id] = float(result.scales[idx])
                else:
                    rec.scales[inst_id] = float(result.scales[idx])
        self._last_result = result

    # -- getters ------------------------------------------------------------
    def get_rig_instance_pose(self, inst_id) -> Pose:
        p6 = self._instances[inst_id]["pose"]
        return Pose(p6[:3], p6[3:])

    def get_rig_camera_pose(self, rc_id) -> Pose:
        p6 = self._rig_cameras[rc_id][0]
        return Pose(p6[:3], p6[3:])

    def get_point(self, point_id) -> _Point:
        return self._points[point_id]
