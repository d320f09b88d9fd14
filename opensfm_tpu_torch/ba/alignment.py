"""Submodel pose-graph alignment (the ReconstructionAlignment problem).

Port of `opensfm_tpu.ba.alignment` (reference
`bundle/reconstruction_alignment.h:30-460`): per-submodel similarities
(rx, ry, rz, tx, ty, tz, scale) and per-shot poses, tied by relative
motion, absolute GPS position, common-camera and common-point constraints.
The solve is a small dense Levenberg-Marquardt on the device in f64: the
four residual families are batched torch functions over the constraint
arrays, the Jacobian is `torch.func.jacfwd` of them masked for constant
entities, and the damped normal equations are solved by Cholesky
(`ops/linalg.solve_spd`); the damping loop runs on the host.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.geometry import rotation as rot
from opensfm_tpu_torch.ops import linalg

logger = logging.getLogger(__name__)


class RARelativeMotionConstraint:
    """Observed pose of a shot in a reconstruction's frame
    (reconstruction_alignment.h:70-120)."""

    def __init__(self, reconstruction, shot, rx, ry, rz, tx, ty, tz):
        self.reconstruction_id = reconstruction
        self.shot_id = shot
        self.parameters = np.array([rx, ry, rz, tx, ty, tz], dtype=np.float64)
        self.scale_matrix = np.eye(6)

    def set_scale_matrix(self, i, j, value) -> None:
        self.scale_matrix[i, j] = value


class _RAEntity:
    def __init__(self, id_, parameters, constant):
        self.id = id_
        self.parameters = np.asarray(parameters, dtype=np.float64)
        self.constant = constant


class _RAResult:
    """Attribute view over optimized parameters (rx...scale / rx...tz)."""

    def __init__(self, params):
        self.rx, self.ry, self.rz = params[0:3]
        self.tx, self.ty, self.tz = params[3:6]
        if len(params) > 6:
            self.scale = params[6]


def _compose_rotvec(ra, rb):
    """Rotation vectors [K, 3] of R(ra) R(rb)."""
    return rot.matrix_to_rotvec(rot.rotvec_to_matrix(ra)
                                @ rot.rotvec_to_matrix(rb))


def _origin(shot):
    """Shot centres [K, 3] of world-to-camera poses [K, 6]: -R^T t."""
    return -rot.rotate(-shot[:, 0:3], shot[:, 3:6])


def _to_world(rec, p):
    """R^T ((p - t) / s) of points p [K, 3] through similarities [K, 7]
    (reconstruction_alignment.h:226-236)."""
    return rot.rotate(-rec[:, 0:3], (p - rec[:, 3:6]) / rec[:, 6:7])


def _residuals(theta, nr, ns, c):
    """Every constraint's weighted rows of the parameters theta = [nr x 7
    similarities | ns x 6 shot poses], family by family, each row-major
    over its constraints (the reference's vmap(...).reshape(-1))."""
    recs = theta[:nr * 7].reshape(nr, 7)
    shots = theta[nr * 7:].reshape(ns, 6)
    out = []
    if len(c["rm_rec"]):
        rec, shot, prm = recs[c["rm_rec"]], shots[c["rm_shot"]], c["rm_params"]
        Ra, ta, sa = rec[:, 0:3], rec[:, 3:6], rec[:, 6:7]
        Ri, ti = shot[:, 0:3], shot[:, 3:6]
        Rai, tai = prm[:, 0:3], prm[:, 3:6]
        # rotation: log(Rai Ra Ri^T); centre: Rai^T tai - sa Ra Ri^T ti + ta
        r_rot = _compose_rotvec(Rai, _compose_rotvec(Ra, -Ri))
        r_t = (rot.rotate(-Rai, tai)
               - sa * rot.rotate(Ra, rot.rotate(-Ri, ti)) + ta)
        r6 = torch.cat([r_rot, r_t], dim=1)
        out.append((c["rm_scale"] @ r6[:, :, None]).reshape(-1))
    if len(c["ap_shot"]):
        out.append(((c["ap_pos"] - _origin(shots[c["ap_shot"]]))
                    * c["ap_inv"][:, None]).reshape(-1))
    if len(c["cp_rec1"]):
        out.append(((_to_world(recs[c["cp_rec1"]], c["cp_p1"])
                     - _to_world(recs[c["cp_rec2"]], c["cp_p2"]))
                    * c["cp_inv"][:, None]).reshape(-1))
    if len(c["cc_rec1"]):
        # Common camera: the shots' world centres through each submodel's
        # similarity must agree.
        out.append(((_to_world(recs[c["cc_rec1"]],
                               _origin(shots[c["cc_shot1"]]))
                     - _to_world(recs[c["cc_rec2"]],
                                 _origin(shots[c["cc_shot2"]])))
                    * c["cc_inv"][:, None]).reshape(-1))
    if not out:
        return torch.zeros(1, dtype=theta.dtype, device=theta.device)
    return torch.cat(out)


class ReconstructionAlignment:
    """Pose-graph problem builder and solver (reconstruction_alignment.h:369)
    on `device` (CUDA unless told otherwise).  After `run`, `iterations`
    counts the accepted steps, `trials` every step, `jacobian_shape` is the
    Jacobian's [rows, parameters] and `initial_cost` / `final_cost` the
    objective before and after."""

    def __init__(self, device=None) -> None:
        self._device = device
        self._recs: Dict[str, _RAEntity] = {}
        self._shots: Dict[str, _RAEntity] = {}
        self._relative_motions: List[RARelativeMotionConstraint] = []
        self._absolute_positions: List[Tuple[str, np.ndarray, float]] = []
        self._common_points: List[Tuple[str, np.ndarray, str, np.ndarray, float]] = []
        self._common_cameras: List[Tuple[str, str, str, str, float]] = []
        self._report = ""
        self.iterations = 0
        self.trials = 0
        self.jacobian_shape = (0, 0)
        self.initial_cost = self.final_cost = 0.0

    # -- construction API (pybundle names) ----------------------------------
    def add_reconstruction(self, id_, rx, ry, rz, tx, ty, tz, scale, constant):
        self._recs[id_] = _RAEntity(
            id_, [rx, ry, rz, tx, ty, tz, scale], constant
        )

    def add_shot(self, id_, rx, ry, rz, tx, ty, tz, constant):
        self._shots[id_] = _RAEntity(id_, [rx, ry, rz, tx, ty, tz], constant)

    def add_relative_motion_constraint(self, rm: RARelativeMotionConstraint):
        self._relative_motions.append(rm)

    def add_absolute_position_constraint(self, shot_id, x, y, z, std_deviation):
        self._absolute_positions.append(
            (shot_id, np.array([x, y, z], dtype=np.float64), float(std_deviation))
        )

    def add_common_point_constraint(self, rec1, x1, y1, z1, rec2, x2, y2, z2, std):
        self._common_points.append(
            (
                rec1, np.array([x1, y1, z1], dtype=np.float64),
                rec2, np.array([x2, y2, z2], dtype=np.float64), float(std),
            )
        )

    def add_common_camera_constraint(
        self, rec1, shot1, rec2, shot2, std_deviation
    ):
        self._common_cameras.append((rec1, shot1, rec2, shot2, float(std_deviation)))

    def get_reconstruction(self, id_) -> _RAResult:
        return _RAResult(self._recs[id_].parameters)

    def get_shot(self, id_) -> _RAResult:
        return _RAResult(self._shots[id_].parameters)

    def brief_report(self) -> str:
        return self._report

    # -- solve ---------------------------------------------------------------
    def _constraints(self, rec_index, shot_index, device):
        """The constraint arrays on `device`: indices int64, values f64."""
        rm, ap = self._relative_motions, self._absolute_positions
        cp, cc = self._common_points, self._common_cameras
        arrays = dict(
            rm_rec=[rec_index[c.reconstruction_id] for c in rm],
            rm_shot=[shot_index[c.shot_id] for c in rm],
            ap_shot=[shot_index[s] for s, _, _ in ap],
            cp_rec1=[rec_index[a] for a, _, _, _, _ in cp],
            cp_rec2=[rec_index[b] for _, _, b, _, _ in cp],
            cc_rec1=[rec_index[a] for a, _, _, _, _ in cc],
            cc_shot1=[shot_index[s] for _, s, _, _, _ in cc],
            cc_rec2=[rec_index[b] for _, _, b, _, _ in cc],
            cc_shot2=[shot_index[s] for _, _, _, s, _ in cc],
        )
        out = {k: torch.as_tensor(np.asarray(v, dtype=np.int64),
                                  device=device) for k, v in arrays.items()}

        def f64(x, shape):
            return torch.as_tensor(np.asarray(x, dtype=np.float64)
                                   .reshape(shape), device=device)

        out.update(
            rm_params=f64([c.parameters for c in rm], (-1, 6)),
            rm_scale=f64([c.scale_matrix for c in rm], (-1, 6, 6)),
            ap_pos=f64([p for _, p, _ in ap], (-1, 3)),
            ap_inv=f64([1.0 / s for _, _, s in ap], (-1,)),
            cp_p1=f64([p for _, p, _, _, _ in cp], (-1, 3)),
            cp_p2=f64([p for _, _, _, p, _ in cp], (-1, 3)),
            cp_inv=f64([1.0 / s for _, _, _, _, s in cp], (-1,)),
            cc_inv=f64([1.0 / s for _, _, _, _, s in cc], (-1,)),
        )
        return out

    def run(self, max_iterations: int = 50) -> None:
        """Solve, then write the parameters back: lam from 1e-4, /3 (floored
        at 1e-12) on an accepted step, stopping when the relative decrease
        is below 1e-12; x10 on a rejected one, stopping at 1e8; at most
        `max_iterations` steps (the reference's host loop exactly)."""
        device = resolve_device(self._device)
        rec_ids = list(self._recs)
        shot_ids = list(self._shots)
        nr, ns = len(rec_ids), len(shot_ids)
        if nr == 0 and ns == 0:
            return
        c = self._constraints({r: i for i, r in enumerate(rec_ids)},
                              {s: i for i, s in enumerate(shot_ids)}, device)

        # Parameters and the mask of constant entities.
        rec0 = np.array([self._recs[r].parameters for r in rec_ids]).reshape(-1)
        shot0 = np.array([self._shots[s].parameters for s in shot_ids]).reshape(-1)
        mask = np.ones(nr * 7 + ns * 6)
        for i, rid in enumerate(rec_ids):
            if self._recs[rid].constant:
                mask[i * 7:(i + 1) * 7] = 0.0
        for i, sid in enumerate(shot_ids):
            if self._shots[sid].constant:
                mask[nr * 7 + i * 6:nr * 7 + (i + 1) * 6] = 0.0
        mask_t = torch.as_tensor(mask, device=device)
        theta = torch.as_tensor(np.concatenate([rec0, shot0]), device=device)

        def residuals(th):
            return _residuals(th, nr, ns, c)

        def cost_of(th):
            r = residuals(th)
            return float(0.5 * torch.sum(r * r))

        def lm_step(th, lam):
            r = residuals(th)
            J = torch.func.jacfwd(residuals)(th) * mask_t[None, :]
            self.jacobian_shape = tuple(J.shape)
            H = J.T @ J
            g = J.T @ r
            H = (H + lam * torch.diag(torch.diagonal(H))
                 + 1e-9 * torch.eye(H.shape[0], dtype=H.dtype, device=device))
            return th - linalg.solve_spd(H, g) * mask_t

        cost = cost_of(theta)
        initial_cost = cost
        lam = 1e-4
        self.iterations = self.trials = 0
        for _ in range(max_iterations):
            new_theta = lm_step(theta, lam)
            new_cost = cost_of(new_theta)
            self.trials += 1
            if np.isfinite(new_cost) and new_cost < cost:
                rel = (cost - new_cost) / max(cost, 1e-30)
                theta, cost = new_theta, new_cost
                self.iterations += 1
                lam = max(lam / 3, 1e-12)
                if rel < 1e-12:
                    break
            else:
                lam = min(lam * 10, 1e8)
                if lam >= 1e8:
                    break

        theta = theta.cpu().numpy()
        for i, rid in enumerate(rec_ids):
            self._recs[rid].parameters = theta[i * 7:(i + 1) * 7]
        for i, sid in enumerate(shot_ids):
            self._shots[sid].parameters = theta[nr * 7 + i * 6:nr * 7 + (i + 1) * 6]
        self.initial_cost, self.final_cost = initial_cost, cost
        self._report = (
            f"ReconstructionAlignment: cost {initial_cost:.4g} -> {cost:.4g}"
        )
