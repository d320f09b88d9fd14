"""Schur-complement Levenberg-Marquardt bundle adjustment core (PyTorch).

Port of `opensfm_tpu.ba.lm` for the mono perspective configuration: rig
instances with identity rig cameras, perspective cameras [k1, k2, focal],
GPS / camera / point priors and up-vector / pan / tilt / roll shot priors.

Parameters: rig instance poses inst[NI, 6] (angle-axis + translation,
world-to-instance), rig camera poses rigcam[NR, 6], camera intrinsics
cam[NC, Pmax] and points points[NP, 3].  The points are eliminated with an
explicit batched Schur complement; the reduced camera system is dense and
solved by Cholesky.  The residuals, Jacobians and the cost come from the
hand-written CUDA kernels of `ops/kernels/ba_resjac.py`; on the dense
instance-slot layout's fast path (`_fused_dense`) the whole assembly, the
back-substitution and the cost come from those of `ops/kernels/ba_assemble.py`.
The kernels run when the tensors lie on a CUDA device (f32 or f64), their
plain PyTorch versions when they lie on the CPU; the route through the solver
depends on the problem alone.

Not in this slice of the port, and raising NotImplementedError when a
problem needs them: non-perspective and mixed projection types, rig chains
(a non-identity or optimized rig camera), depth prior rows, pose-graph
constraint families with scale variables, and covariances.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from opensfm_tpu_torch import context, resolve_device
from opensfm_tpu_torch.geometry import rotation as rot
from opensfm_tpu_torch.ops import linalg
from opensfm_tpu_torch.ops.kernels.ba_assemble import (
    fused_back_substitute,
    fused_cost_dense,
    fused_schur_assembly,
)
from opensfm_tpu_torch.ops.kernels.ba_resjac import (
    fused_cost,
    fused_residual_jacobian,
)

# ---------------------------------------------------------------------------
# Robust losses (Ceres semantics: rho(s) on squared norm s, scale a applies
# as a^2 * rho(s / a^2)).  IRLS weight = rho'(s).
# ---------------------------------------------------------------------------


def _huber_rho(u):
    return torch.where(u <= 1.0, u, 2.0 * torch.sqrt(torch.clamp_min(u, 1.0)) - 1.0)


def _huber_drho(u):
    return torch.where(
        u <= 1.0, torch.ones_like(u), 1.0 / torch.sqrt(torch.clamp_min(u, 1.0))
    )


LOSSES = {
    "TrivialLoss": (lambda u: u, lambda u: torch.ones_like(u)),
    "SoftLOneLoss": (
        lambda u: 2.0 * (torch.sqrt(1.0 + u) - 1.0),
        lambda u: 1.0 / torch.sqrt(1.0 + u),
    ),
    "CauchyLoss": (lambda u: torch.log1p(u), lambda u: 1.0 / (1.0 + u)),
    "HuberLoss": (_huber_rho, _huber_drho),
    "TukeyLoss": (
        lambda u: torch.where(u <= 1.0, (1.0 - (1.0 - u) ** 3) / 3.0, 1.0 / 3.0),
        lambda u: torch.where(u <= 1.0, (1.0 - u) ** 2, 0.0),
    ),
}


@dataclass
class BAProblem:
    """Flat BA problem as numpy arrays (the reference's field names and
    layouts).  Build via `opensfm_tpu_torch.ba.problem` or
    `problem_from_numpy`."""

    # Parameters
    inst: np.ndarray  # [NI, 6]
    rigcam: np.ndarray  # [NR, 6]
    cam: np.ndarray  # [NC, Pmax]
    points: np.ndarray  # [NP, 3]

    # Observations
    obs_uv: np.ndarray  # [O, 2]
    obs_inv_sd: np.ndarray  # [O] 1/std_deviation (0 disables)
    obs_point: np.ndarray  # [O] int
    obs_inst: np.ndarray  # [O] int
    obs_rigcam: np.ndarray  # [O] int
    obs_cam: np.ndarray  # [O] int

    # Point -> observation CSR (padded with O = trash slot)
    point_obs: np.ndarray  # [NP, T] int

    # Priors (inv_sd == 0 disables a row/dim)
    gps_pos: np.ndarray  # [NI, 3]
    gps_inv_sd: np.ndarray  # [NI]
    cam_prior: np.ndarray  # [NC, Pmax]
    cam_prior_inv_sd: np.ndarray  # [NC, Pmax]
    cam_log_mask: np.ndarray  # [NC, Pmax] bool (log-scale prior dims: focal)
    rigcam_prior: np.ndarray  # [NR, 6]
    rigcam_prior_inv_sd: np.ndarray  # [NR, 6]
    point_prior: np.ndarray  # [NP, 3]
    point_prior_inv_sd: np.ndarray  # [NP, 3]

    # Optimization masks
    opt_inst: np.ndarray  # [NI] bool
    opt_rigcam: np.ndarray  # [NR] bool
    opt_cam: np.ndarray  # [NC, Pmax] bool (padding dims False)
    opt_points: np.ndarray  # [NP] bool

    # Static config
    ptype: Union[str, tuple] = "perspective"
    loss: str = "SoftLOneLoss"
    loss_threshold: float = 1.0

    # Up-vector priors: residual (R_cam_to_world(shot) @ up_vec - z_world)
    # / sd, Cauchy(1).
    up_inst: Optional[np.ndarray] = None  # [KU] int
    up_rigcam: Optional[np.ndarray] = None  # [KU] int
    up_vec: Optional[np.ndarray] = None  # [KU, 3] unit, camera frame
    up_inv_sd: Optional[np.ndarray] = None  # [KU]

    # Absolute pan/tilt/roll priors: angle of the shot's world-frame viewing
    # direction, Cauchy(1).
    ang_kind: Optional[np.ndarray] = None  # [KA] int: 0 pan, 1 tilt, 2 roll
    ang_inst: Optional[np.ndarray] = None  # [KA] int
    ang_rigcam: Optional[np.ndarray] = None  # [KA] int
    ang_value: Optional[np.ndarray] = None  # [KA] radians
    ang_inv_sd: Optional[np.ndarray] = None  # [KA]

    # Per-observation depth priors (not in this slice: must stay disabled).
    obs_depth: Optional[np.ndarray] = None  # [O]
    obs_depth_inv_sd: Optional[np.ndarray] = None  # [O]
    obs_depth_radial: Optional[np.ndarray] = None  # [O] bool

    # Optional per-point Cauchy threshold for the position-prior rows; 0/None
    # = plain quadratic.
    point_prior_loss: Optional[np.ndarray] = None  # [NP]

    # Cluster-SfM scale variables and pose-graph constraint families (not in
    # this slice: must be absent or empty).
    scales: Optional[np.ndarray] = None
    opt_scales: Optional[np.ndarray] = None
    rm_i: Optional[np.ndarray] = None
    rm_j: Optional[np.ndarray] = None
    rm_si: Optional[np.ndarray] = None
    rm_sj: Optional[np.ndarray] = None
    rm_rvec: Optional[np.ndarray] = None
    rm_tvec: Optional[np.ndarray] = None
    rm_scale: Optional[np.ndarray] = None
    rm_inv_sd: Optional[np.ndarray] = None
    rm_obs_scale: Optional[np.ndarray] = None
    rm_loss_c: Optional[np.ndarray] = None
    rr_i: Optional[np.ndarray] = None
    rr_j: Optional[np.ndarray] = None
    rr_ri: Optional[np.ndarray] = None
    rr_rj: Optional[np.ndarray] = None
    rr_rvec: Optional[np.ndarray] = None
    rr_inv_sd: Optional[np.ndarray] = None
    rr_loss_c: Optional[np.ndarray] = None
    cp_i: Optional[np.ndarray] = None
    cp_j: Optional[np.ndarray] = None
    cp_ri: Optional[np.ndarray] = None
    cp_rj: Optional[np.ndarray] = None
    cp_margin: Optional[np.ndarray] = None
    cp_inv_sd: Optional[np.ndarray] = None
    lin_i0: Optional[np.ndarray] = None
    lin_i1: Optional[np.ndarray] = None
    lin_i2: Optional[np.ndarray] = None
    lin_r0: Optional[np.ndarray] = None
    lin_r1: Optional[np.ndarray] = None
    lin_r2: Optional[np.ndarray] = None
    lin_alpha: Optional[np.ndarray] = None
    lin_pos_inv_sd: Optional[np.ndarray] = None
    lin_rot_inv_sd: Optional[np.ndarray] = None
    hm_inst: Optional[np.ndarray] = None
    hm_rigcam: Optional[np.ndarray] = None
    hm_map: Optional[np.ndarray] = None
    hm_offset: Optional[np.ndarray] = None
    hm_inv_sd: Optional[np.ndarray] = None
    heatmaps: Optional[np.ndarray] = None
    hm_res: Optional[np.ndarray] = None
    gauge_i: Optional[np.ndarray] = None
    gauge_j: Optional[np.ndarray] = None
    gauge_norm: Optional[np.ndarray] = None

    def counts(self):
        return (
            len(self.inst), len(self.rigcam), len(self.cam), len(self.points),
            len(self.obs_uv), self.point_obs.shape[1],
        )


@dataclass
class BAResult:
    inst: np.ndarray
    rigcam: np.ndarray
    cam: np.ndarray
    points: np.ndarray
    scales: Optional[np.ndarray] = None
    initial_cost: float = 0.0
    final_cost: float = 0.0
    iterations: int = 0
    lam: float = 0.0
    covariances: Optional[np.ndarray] = None
    covariance_valid: bool = False


def problem_from_numpy(src) -> BAProblem:
    """A BAProblem from any object with the BAProblem fields (the reference's
    `opensfm_tpu.ba.lm.BAProblem` included): the arrays are taken as they
    are."""
    return BAProblem(
        **{f.name: getattr(src, f.name) for f in dataclasses.fields(BAProblem)}
    )


# ---------------------------------------------------------------------------
# Residual rows
# ---------------------------------------------------------------------------


def _origin(pose6):
    """Camera/instance center: -R^T t."""
    return -rot.rotate(-pose6[..., :3], pose6[..., 3:6])


def _residual_data(state, data, loss, loss_threshold):
    """Per-observation weighted residuals r[O, 2], Jacobians Jc[O, 2, 9]
    (6 instance pose + [k1, k2, focal]) and Jp[O, 2, 3], already scaled by
    sqrt(rho'), and the per-observation robust cost.  Every layout (dense
    instance-slot, canonical (point, slot)) reaches the kernel through its
    index arrays."""
    inst, _, cam, points = state[:4]
    d = data
    return fused_residual_jacobian(
        inst, cam, points, d["obs_inst"], d["obs_cam"], d["obs_point"],
        d["obs_uv"], d["obs_inv_sd"], loss=loss,
        loss_threshold=loss_threshold,
    )


def _row_jacobian(fn, args, argnum):
    """J[K, M, D] of a row-batched residual fn(*args) -> [K, M] with respect
    to args[argnum] [K, D]: the rows are independent, so one forward-mode
    push per tangent direction gives column d of every row's Jacobian (the
    reference's jacfwd)."""
    x = args[argnum]
    cols = []
    with fwAD.dual_level():
        for k in range(x.shape[-1]):
            tangent = torch.zeros_like(x)
            tangent[:, k] = 1.0
            dual = list(args)
            dual[argnum] = fwAD.make_dual(x, tangent)
            primal, col = fwAD.unpack_dual(fn(*dual))
            cols.append(torch.zeros_like(primal) if col is None else col)
    return torch.stack(cols, dim=-1)


def _prior_residuals(state, data, with_jac=True):
    """Prior residual blocks (quadratic loss): list of (r[N, K], J[N, K, D],
    family) for the GPS, camera and rig-camera families (J None without
    `with_jac`).  The Jacobians are closed forms of the reference's jacfwd."""
    inst, rigcam, cam, points = state[:4]
    d = data
    out = []

    # GPS on instance origins (AddRigInstancePositionPrior semantics):
    # origin = -R(w)^T t = -rotate(-w, t).
    w, t = inst[:, :3], inst[:, 3:6]
    inv_sd = d["gps_inv_sd"][:, None]
    r = (_origin(inst) - d["gps_pos"]) * inv_sd
    J = None
    if with_jac:
        J = torch.cat([rot.rotate_jacobian(-w, t),
                       -rot.rotvec_to_matrix(-w)], dim=-1) * inv_sd[..., None]
    out.append((r, J, "inst"))

    # Camera parameter priors, log-scale for focal (bundle_adjuster.cc:568).
    c, prior, log_mask = cam, d["cam_prior"], d["cam_log_mask"]
    safe = torch.clamp_min(torch.abs(c), 1e-12)
    safe_prior = torch.clamp_min(torch.abs(prior), 1e-12)
    rlog = torch.log(safe) - torch.log(safe_prior)
    r = torch.where(log_mask, rlog, c - prior) * d["cam_prior_inv_sd"]
    J = None
    if with_jac:
        dlog = torch.where(torch.abs(c) > 1e-12, torch.sign(c) / safe,
                           torch.zeros_like(c))
        J = torch.diag_embed(
            torch.where(log_mask, dlog, torch.ones_like(c))
            * d["cam_prior_inv_sd"])
    out.append((r, J, "cam"))

    r = (rigcam - d["rigcam_prior"]) * d["rigcam_prior_inv_sd"]
    J = torch.diag_embed(d["rigcam_prior_inv_sd"]) if with_jac else None
    out.append((r, J, "rigcam"))
    return out


_inv3x3 = linalg.inv3  # closed-form batched 3x3 inverse (adjugate / det)


def _point_prior_sqrt_weight(points, data):
    """Per-point sqrt(Cauchy IRLS weight) for the position-prior rows, or
    None when every prior is quadratic (`point_prior_loss` absent)."""
    c = data.get("point_prior_loss")
    if c is None:
        return None
    pp_r = (points - data["point_prior"]) * data["point_prior_inv_sd"]
    s = torch.sum(pp_r * pp_r, dim=-1, keepdim=True)
    pos = c[:, None] > 0
    c2 = torch.where(pos, c[:, None] * c[:, None], torch.ones_like(s))
    w = torch.where(pos, 1.0 / (1.0 + s / c2), torch.ones_like(s))
    return torch.sqrt(w)


def _point_prior_cost(points, data):
    """Total point-prior objective (quadratic or per-point Cauchy)."""
    pp_r = (points - data["point_prior"]) * data["point_prior_inv_sd"]
    s = torch.sum(pp_r * pp_r, dim=-1)
    c = data.get("point_prior_loss")
    if c is None:
        return 0.5 * torch.sum(s)
    c2 = torch.where(c > 0, c * c, torch.ones_like(c))
    per = torch.where(c > 0, 0.5 * c2 * torch.log1p(s / c2), 0.5 * s)
    return torch.sum(per)


def _wrap_angle(a):
    """Wrap to (-pi, pi] (DiffBetweenAngles, error_utils.h)."""
    return a - 2.0 * np.pi * torch.round(a / (2.0 * np.pi))


def _cam_to_world(i6, r6, v):
    return rot.rotate(-i6[..., :3], rot.rotate(-r6[..., :3], v))


def _axis(i6, k):
    """Unit vector e_k broadcast to the rows of i6 [K, 6]."""
    e = torch.zeros(3, dtype=i6.dtype, device=i6.device)
    e[k] = 1.0
    return e.expand(i6.shape[0], 3)


def _up_res(i6, r6, vec, inv_sd):
    """Up-vector rows: (R_cam_to_world(shot) @ up_vec - z_world) / sd."""
    return (_cam_to_world(i6, r6, vec) - _axis(i6, 2)) * inv_sd


def _ang_res(i6, r6, kind, value, inv_sd):
    """Pan/tilt/roll rows (PanAngleError, TiltAngleError, RollAngleError in
    the world-to-camera parametrization): [K, 1]."""
    zw = _cam_to_world(i6, r6, _axis(i6, 2))
    horiz = torch.sqrt(zw[:, 0] ** 2 + zw[:, 1] ** 2)
    pan_pred = torch.atan2(zw[:, 0], zw[:, 1])
    pan = torch.where(horiz < 1e-8, torch.zeros_like(horiz),
                      _wrap_angle(pan_pred - value))
    tilt_pred = -torch.atan2(zw[:, 2], horiz)
    tilt = _wrap_angle(tilt_pred - value)
    xw = _cam_to_world(i6, r6, _axis(i6, 0))
    a = torch.stack([zw[:, 1], -zw[:, 0], 0.0 * zw[:, 0]], dim=-1)
    la = torch.sqrt(a[:, 0] ** 2 + a[:, 1] ** 2)
    a = a / torch.clamp_min(la, 1e-12)[:, None]
    b = torch.linalg.cross(xw, a, dim=-1)
    sin_roll = torch.clamp(torch.sum(zw * b, dim=-1), -1.0 + 1e-9, 1.0 - 1e-9)
    roll_pred = torch.asin(sin_roll)
    roll = torch.where(
        (la < 1e-5) | (sin_roll <= -(1.0 - 1e-5)),
        torch.zeros_like(la), _wrap_angle(roll_pred - value),
    )
    res = torch.where(kind == 0, pan, torch.where(kind == 1, tilt, roll))
    return (res * inv_sd)[:, None]


def _shot_prior_residuals(state, data, raw=False):
    """Up-vector and pan/tilt/roll rows on (instance, rig camera) pairs, with
    Cauchy(1) sqrt-IRLS weights: list of (r[K, M], Ji[K, M, 6], idx_inst)
    (rig cameras are fixed in this slice, so no rig-camera Jacobian); with
    raw=True just the unweighted residuals."""
    inst, rigcam = state[0], state[1]
    d = data
    out = []
    cauchy_w = LOSSES["CauchyLoss"][1]
    rows = []
    if d["up_vec"].shape[0] > 0:
        rows.append((_up_res, (inst[d["up_inst"]], rigcam[d["up_rigcam"]],
                               d["up_vec"], d["up_inv_sd"][:, None]),
                     d["up_inst"]))
    if d["ang_value"].shape[0] > 0:
        rows.append((_ang_res, (inst[d["ang_inst"]], rigcam[d["ang_rigcam"]],
                                d["ang_kind"], d["ang_value"],
                                d["ang_inv_sd"]),
                     d["ang_inst"]))
    for fn, args, idx_i in rows:
        r = fn(*args)
        if raw:
            out.append(r)
            continue
        Ji = _row_jacobian(fn, args, 0)
        s = torch.sum(r * r, dim=-1, keepdim=True)
        sw = torch.sqrt(torch.clamp_min(cauchy_w(s), 1e-12))
        out.append((r * sw, Ji * sw[..., None], idx_i))
    return out


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def canonicalize_problem(problem: BAProblem) -> BAProblem:
    """Reorder observations into the padded (point, slot) flat layout.

    After this, `point_obs[p, t] == p*T + t` and every obs array has length
    NP*T (pad slots carry obs_inv_sd == 0, which zeroes their residual and
    Jacobian rows), so per-point structure is a reshape instead of a gather
    through the CSR index.  Idempotent."""
    if not isinstance(problem.ptype, str):
        return problem
    NP, T = problem.point_obs.shape
    O = len(problem.obs_uv)
    po = np.asarray(problem.point_obs)
    if O == NP * T and np.array_equal(
        po, np.arange(NP * T, dtype=po.dtype).reshape(NP, T)
    ):
        return problem
    valid = po < O
    idx = np.where(valid, po, 0)

    def take(x, fill=0):
        out = np.asarray(x)[idx]
        out[~valid] = fill
        return out.reshape((NP * T,) + x.shape[1:])

    repl = dict(
        obs_uv=take(problem.obs_uv, 0.0),
        obs_inv_sd=take(problem.obs_inv_sd, 0.0),
        obs_point=np.repeat(np.arange(NP, dtype=problem.obs_point.dtype), T),
        obs_inst=take(problem.obs_inst, 0),
        obs_rigcam=take(problem.obs_rigcam, 0),
        obs_cam=take(problem.obs_cam, 0),
        point_obs=np.arange(NP * T, dtype=po.dtype).reshape(NP, T),
    )
    if problem.obs_depth is not None:
        repl["obs_depth"] = take(problem.obs_depth, 0.0)
    if problem.obs_depth_inv_sd is not None:
        repl["obs_depth_inv_sd"] = take(problem.obs_depth_inv_sd, 0.0)
    if problem.obs_depth_radial is not None:
        repl["obs_depth_radial"] = take(problem.obs_depth_radial, False)
    return dataclasses.replace(problem, **repl)


def canonicalize_problem_dense(problem: BAProblem, max_waste: int = 8,
                               max_slots: int = 1 << 22):
    """Re-layout observations on the dense [NP, NI] instance-slot grid.

    Slot index == rig-instance index, so `obs_inst == tile(arange(NI), NP)`
    and `obs_point == repeat(arange(NP), NI)`: every one-hot selector of the
    reduced-system assembly is the identity.  Dead (point, instance) slots
    carry obs_inv_sd == 0.  Applies only to mono single-camera problems whose
    densified size stays within `max_waste` x the observation count (or
    `max_slots` slots); anything else falls back to `canonicalize_problem`.
    Returns (problem, dense_flag)."""
    if not isinstance(problem.ptype, str):
        return canonicalize_problem(problem), False
    ni = len(problem.inst)
    np_pts = len(problem.points)
    O = len(problem.obs_uv)
    dense_O = np_pts * ni
    mono = (
        len(problem.cam) == 1
        and not bool(np.asarray(problem.opt_rigcam).any())
        and float(np.abs(np.asarray(problem.rigcam)).max(initial=0.0)) <= 1e-12
    )
    if not mono or O == 0 or (dense_O > max_waste * O
                              and dense_O > max_slots):
        return canonicalize_problem(problem), False
    o_new = (
        np.asarray(problem.obs_point, dtype=np.int64) * ni
        + np.asarray(problem.obs_inst, dtype=np.int64)
    )
    if np.unique(o_new).size != O:  # duplicate (point, instance) pair
        return canonicalize_problem(problem), False

    def scatter(x, fill=0.0):
        x = np.asarray(x)
        out = np.full((dense_O,) + x.shape[1:], fill, dtype=x.dtype)
        out[o_new] = x
        return out

    repl = dict(
        obs_uv=scatter(problem.obs_uv),
        obs_inv_sd=scatter(problem.obs_inv_sd),
        obs_point=np.repeat(
            np.arange(np_pts, dtype=np.int64), ni
        ).astype(np.asarray(problem.obs_point).dtype),
        obs_inst=np.tile(
            np.arange(ni, dtype=np.int64), np_pts
        ).astype(np.asarray(problem.obs_inst).dtype),
        obs_rigcam=np.zeros(dense_O, dtype=np.asarray(problem.obs_rigcam).dtype),
        obs_cam=np.zeros(dense_O, dtype=np.asarray(problem.obs_cam).dtype),
        point_obs=np.arange(dense_O, dtype=np.int64).reshape(np_pts, ni),
    )
    if problem.obs_depth is not None:
        repl["obs_depth"] = scatter(problem.obs_depth)
    if problem.obs_depth_inv_sd is not None:
        repl["obs_depth_inv_sd"] = scatter(problem.obs_depth_inv_sd)
    if problem.obs_depth_radial is not None:
        repl["obs_depth_radial"] = scatter(problem.obs_depth_radial, False)
    return dataclasses.replace(problem, **repl), True


# ---------------------------------------------------------------------------
# Reduced camera system
# ---------------------------------------------------------------------------


def _expand_diag(D, n_blk):
    """[n, b, c] block diagonal -> [n, b, n, c]."""
    eye_n = torch.eye(n_blk, dtype=D.dtype, device=D.device)
    return torch.einsum("axy,ab->axby", D, eye_n)


def _one_hot(idx, n, dtype):
    # Working dtype: 0/1 selectors are exact in any float type.
    return torch.nn.functional.one_hot(idx.long(), n).to(dtype)


def _schur(Ua, Vb):
    """sum_{p,k} Ua[p, a, x, k] Vb[p, b, y, k] -> [a, x, b, y] as one
    [na*x, NP*3] @ [NP*3, nb*y] product."""
    NP, na, x, K = Ua.shape
    nb, y = Vb.shape[1], Vb.shape[2]
    A = Ua.permute(1, 2, 0, 3).reshape(na * x, NP * K)
    B = Vb.permute(0, 3, 1, 2).reshape(NP * K, nb * y)
    return (A @ B).reshape(na, x, nb, y)


def _fused_dense(points, ni, pmax, dense):
    """The reference's conditions for its dense fast path (one fused
    assembly, back-substitution and cost kernel): the dense layout, a
    [k1, k2, focal] camera, at most 256 instances and a point count that is
    a multiple of 128, in f32 or f64.  The projection type, the identity rig
    and the absence of depth rows hold for every problem this slice
    solves."""
    return (dense and pmax == 3 and ni <= 256
            and points.shape[0] % 128 == 0
            and points.dtype in (torch.float32, torch.float64))


def _build_reduced_system_fused(state, data, lam, loss, loss_threshold, ni,
                                nr, nc, pmax):
    """(S, b, back) from the fused assembly's raw outputs: reorder the
    [6 NI]^2 Schur product and the per-instance partials into the blocks of
    the reduced system, then add the priors, identity rows and damping
    (`_assemble_S`)."""
    inst, rigcam, cam, points = state[:4]
    np_pts, dtype = points.shape[0], points.dtype
    pp_sw = _point_prior_sqrt_weight(points, data)
    pp_inv = (
        data["point_prior_inv_sd"]
        if pp_sw is None
        else data["point_prior_inv_sd"] * pp_sw
    )
    out_pt, sII_xa, aux = fused_schur_assembly(
        inst, cam, points, data["obs_uv"], data["obs_inv_sd"],
        data["opt_inst"], data["opt_cam"], data["opt_points"],
        data["point_prior"], pp_inv, lam, loss=loss,
        loss_threshold=loss_threshold,
    )
    # S_II rows and columns are (x, a): reorder to (a, x).
    schur_II = sII_xa.reshape(6, ni, 6, ni).permute(1, 0, 3, 2)
    direct_II = aux[0:36].reshape(6, 6, ni).permute(2, 0, 1)  # [ni, 6, 6]
    direct_IC = aux[36:54].reshape(6, 3, ni).permute(2, 0, 1)  # [ni, 6, 3]
    schur_IC = aux[60:78].reshape(6, 3, ni).permute(2, 0, 1)
    S_II = _expand_diag(direct_II, ni) - schur_II
    S_IC = (direct_IC - schur_IC)[:, :, None, :]  # [ni, 6, 1, 3]
    upper = torch.sum(aux[54:60], dim=1) - aux[90:96, 0]  # S_CC upper triangle
    iu, ju = [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]
    S_CC = torch.zeros((3, 3), dtype=dtype, device=points.device)
    S_CC[iu, ju] = upper
    S_CC[ju, iu] = upper
    S_CC = S_CC[None, :, None, :]
    b_i = aux[78:84].T.reshape(ni * 6)  # (a, x) order
    b_c = torch.sum(aux[84:87], dim=1) - aux[87:90, 0]
    zeros = dict(dtype=dtype, device=points.device)
    S_RR = torch.zeros((nr, 6, nr, 6), **zeros)
    S_IR = torch.zeros((ni, 6, nr, 6), **zeros)
    S_RC = torch.zeros((nr, 6, nc, pmax), **zeros)
    b_r = torch.zeros(nr * 6, **zeros)

    back = dict(
        fused=dict(inst=inst, cam=cam, points=points, obs_uv=data["obs_uv"],
                   obs_inv_sd=data["obs_inv_sd"], out_pt=out_pt, loss=loss,
                   loss_threshold=loss_threshold),
        dense=True,
    )
    S, b = _assemble_S(
        state, data, lam, S_II, S_RR, S_IR, S_RC, S_IC, S_CC, b_i, b_r, b_c,
        ni, nr, nc, pmax,
    )
    return S, b, back


def _build_reduced_system(state, data, lam, loss, loss_threshold, pmax, ni,
                          nr, nc, dense=False):
    """Assemble the Schur-reduced camera system in the canonical (point,
    slot) layout, or the dense instance-slot layout when `dense`
    (`canonicalize_problem_dense`: slot == instance, T == NI, nc == 1, where
    every one-hot selector is the identity and disappears).

    Returns (S, b, back) where `back` carries what back-substitution
    needs."""
    inst, rigcam, cam, points = state[:4]
    np_pts = points.shape[0]
    dtype = points.dtype
    if dense and nc != 1:
        raise ValueError("the dense instance-slot layout has one camera")
    if _fused_dense(points, ni, pmax, dense):
        return _build_reduced_system_fused(
            state, data, lam, loss, loss_threshold, ni, nr, nc, pmax)

    r, Jc, Jp, _ = _residual_data(state, data, loss, loss_threshold)
    num_obs = r.shape[0]

    # Mask Jacobians of fixed parameters (zero rows instead of index games).
    opt_p = data["opt_points"].to(dtype).repeat_interleave(num_obs // np_pts)
    Jp = Jp * opt_p[:, None, None]
    if dense:
        opt_i_o = data["opt_inst"].to(dtype)[None].expand(np_pts, ni) \
            .reshape(num_obs)
        opt_c_o = data["opt_cam"].to(dtype).expand(num_obs, pmax)
    else:
        opt_i_o = data["opt_inst"][data["obs_inst"]].to(dtype)
        opt_c_o = data["opt_cam"][data["obs_cam"]].to(dtype)  # [O, pmax]
    Ji = Jc[:, :, 0:6] * opt_i_o[:, None, None]
    Jcam = Jc[:, :, 6:] * opt_c_o[:, None, :]

    def padded(x):  # [O, ...] -> [NP, T, ...]
        return x.reshape((np_pts, -1) + x.shape[1:])

    r_pt = padded(r)  # [NP,T,2]
    Ji_pt = padded(Ji)  # [NP,T,2,6]
    Jc_pt = padded(Jcam)  # [NP,T,2,pmax]
    Jp_pt = padded(Jp)  # [NP,T,2,3]

    if dense:
        Ei_f = Ec_f = E_i = E_c = None
    else:
        Ei_f = _one_hot(data["obs_inst"], ni, dtype)  # [O, NI]
        Ec_f = _one_hot(data["obs_cam"], nc, dtype)
        E_i = padded(Ei_f)  # [NP,T,NI]
        E_c = padded(Ec_f)

    # --- point system --------------------------------------------------------
    Hpp = torch.einsum("ptkx,ptky->pxy", Jp_pt, Jp_pt)  # [NP,3,3]
    bp = torch.einsum("ptkx,ptk->px", Jp_pt, r_pt)  # [NP,3]
    pp_sw = _point_prior_sqrt_weight(points, data)
    pp_inv = (
        data["point_prior_inv_sd"]
        if pp_sw is None
        else data["point_prior_inv_sd"] * pp_sw
    )
    pp_r = (points - data["point_prior"]) * pp_inv
    Hpp = Hpp + torch.diag_embed(pp_inv ** 2)
    bp = bp + pp_r * pp_inv
    eyep = torch.eye(3, dtype=dtype, device=points.device)
    Hpp = Hpp + lam * torch.diag_embed(torch.diagonal(Hpp, dim1=1, dim2=2)) \
        + 1e-12 * eyep
    opt_p_pts = data["opt_points"].to(dtype)[:, None, None]
    Hpp_inv = _inv3x3(Hpp) * opt_p_pts

    # --- camera-point couplings and Schur factors ----------------------------
    blocks = [("i", Ji_pt, E_i, ni), ("c", Jc_pt, E_c, nc)]
    G, U, V = {}, {}, {}
    for name, J_pt, E, n_blk in blocks:
        if n_blk == 1:
            # Single block: the selector is identically 1, so the T axis
            # collapses into the contraction.
            Vg = torch.einsum("ptkx,ptkj->pxj", J_pt, Jp_pt)  # [NP,bdim,3]
            Ug = torch.einsum("pxk,pkj->pxj", Vg, Hpp_inv)
            G[name] = None
            U[name] = Ug[:, None]  # [NP,1,bdim,3]
            V[name] = Vg[:, None]
            continue
        Ga = torch.einsum("ptkx,ptkj->ptxj", J_pt, Jp_pt)  # [NP,T,bdim,3]
        Aa = torch.einsum("ptxk,pkj->ptxj", Ga, Hpp_inv)
        G[name] = Ga
        if dense:
            U[name] = Aa  # slot t IS block index a
            V[name] = Ga
            continue
        U[name] = torch.einsum("pta,ptxk->paxk", E, Aa)  # [NP,n,bdim,3]
        V[name] = torch.einsum("pta,ptxk->paxk", E, Ga)

    # --- block families of S and b -------------------------------------------
    flat = {"i": (Ei_f, Ji), "c": (Ec_f, Jcam)}
    pt_of = {"i": Ji_pt, "c": Jc_pt}
    n_of = {"i": ni, "c": nc}

    def direct_diag(name):
        # Same-obs block-diagonal contributions (one block per obs).
        E, Jf = flat[name]
        x = Jf.shape[2]
        if n_of[name] == 1:
            J2 = Jf.reshape(-1, x)
            return (J2.T @ J2)[None]
        if dense:
            J4 = pt_of[name]
            return torch.einsum("pakx,paky->axy", J4, J4)
        M = torch.einsum("okx,oky->oxy", Jf, Jf)
        return (E.T @ M.reshape(num_obs, x * x)).reshape(-1, x, x)

    def direct_cross(a, b_):
        """Cross block; family b_ is the small side."""
        E_a, J_a = flat[a]
        E_b, J_b = flat[b_]
        xa, yb = J_a.shape[2], J_b.shape[2]
        na, nb = n_of[a], n_of[b_]
        if na == 1 and nb == 1:
            return (J_a.reshape(-1, xa).T @ J_b.reshape(-1, yb))[None, :, None, :]
        if dense and nb == 1:
            out = torch.einsum("pakx,paky->axy", pt_of[a], pt_of[b_])
            return out[:, :, None, :]
        M = torch.einsum("okx,oky->oxy", J_a, J_b)  # [O, xa, yb]
        if nb == 1:
            out = E_a.T @ M.reshape(num_obs, xa * yb)
            return out.reshape(-1, xa, yb)[:, :, None, :]
        T1 = M[:, None, :, :] * E_b[:, :, None, None]  # [O, nb, xa, yb]
        out = E_a.T @ T1.reshape(num_obs, nb * xa * yb)
        return out.reshape(-1, nb, xa, yb).permute(0, 2, 1, 3)

    S_II = _expand_diag(direct_diag("i"), ni) - _schur(U["i"], V["i"])
    S_CC = _expand_diag(direct_diag("c"), nc) - _schur(U["c"], V["c"])
    S_IC = direct_cross("i", "c") - _schur(U["i"], V["c"])
    # Rig cameras are all fixed in this slice: their rows come only from the
    # identity padding in _assemble_S; every coupling block is zero.
    zeros = dict(dtype=dtype, device=points.device)
    S_RR = torch.zeros((nr, 6, nr, 6), **zeros)
    S_IR = torch.zeros((ni, 6, nr, 6), **zeros)
    S_RC = torch.zeros((nr, 6, nc, pmax), **zeros)

    Hib = torch.einsum("pkj,pj->pk", Hpp_inv, bp)  # [NP,3]

    def rhs(name, E_pt):
        E_f, J_f = flat[name]
        n_blk = n_of[name]
        if n_blk == 1:
            direct = torch.einsum("okx,ok->x", J_f, r)[None]
            gschur = torch.einsum("pxk,pk->x", V[name][:, 0], Hib)[None]
        elif dense:
            direct = torch.einsum("pakx,pak->ax", pt_of[name], r_pt)
            gschur = torch.einsum("ptxk,pk->tx", G[name], Hib)
        else:
            JTr = torch.einsum("okx,ok->ox", J_f, r)  # [O, bdim]
            direct = E_f.T @ JTr  # [n, bdim]
            GH = torch.einsum("ptxk,pk->ptx", G[name], Hib)  # [NP,T,bdim]
            gschur = torch.einsum("pta,ptx->ax", E_pt, GH)
        return (direct - gschur).reshape(-1)

    b_i = rhs("i", E_i)
    b_r = torch.zeros(nr * 6, **zeros)
    b_c = rhs("c", E_c)

    back = dict(
        Ji=Ji, Jcam=Jcam, Jp_pt=Jp_pt, Hpp_inv=Hpp_inv, bp=bp,
        obs_inst=data["obs_inst"], obs_cam=data["obs_cam"], padded=padded,
        dense=dense,
    )
    S, b = _assemble_S(
        state, data, lam, S_II, S_RR, S_IR, S_RC, S_IC, S_CC, b_i, b_r, b_c,
        ni, nr, nc, pmax,
    )
    return S, b, back


def _assemble_S(state, data, lam, S_II, S_RR, S_IR, S_RC, S_IC, S_CC,
                b_i, b_r, b_c, ni, nr, nc, pmax):
    """Epilogue: prior families + block assembly + identity rows for fixed
    parameters + Marquardt damping + symmetrization."""
    dtype = state[3].dtype

    for pr, pJ, kind in _prior_residuals(state, data):
        if kind == "inst":
            mask = data["opt_inst"].to(dtype)[:, None, None]
            D = torch.einsum("nki,nkj->nij", pJ, pJ) * mask
            S_II = S_II + _expand_diag(D, ni)
            b_i = b_i + (
                torch.einsum("nki,nk->ni", pJ, pr) * mask[:, :, 0]
            ).reshape(ni * 6)
        elif kind == "cam":  # per-dim masks
            mask = data["opt_cam"].to(dtype)
            pJm = pJ * mask[:, None, :]
            D = torch.einsum("nki,nkj->nij", pJm, pJm)
            S_CC = S_CC + _expand_diag(D, nc)
            b_c = b_c + torch.einsum("nki,nk->ni", pJm, pr).reshape(nc * pmax)
        # rigcam: every rig camera is fixed, its prior rows are masked out.

    # Shot priors (up-vector / pan / tilt / roll) on the instance side.
    for pr, Ji_u, idx_i in _shot_prior_residuals(state, data):
        mi = data["opt_inst"][idx_i].to(dtype)[:, None, None]
        Ji_u = Ji_u * mi
        Ei_u = _one_hot(idx_i, ni, dtype)  # [K, NI]
        S_II = S_II + _expand_diag(
            torch.einsum("ka,kxi,kxj->aij", Ei_u, Ji_u, Ji_u), ni
        )
        b_i = b_i + torch.einsum(
            "ka,kxi,kx->ai", Ei_u, Ji_u, pr
        ).reshape(ni * 6)

    di, dr, dcam = ni * 6, nr * 6, nc * pmax
    S = torch.cat(
        [
            torch.cat([S_II.reshape(di, di), S_IR.reshape(di, dr),
                       S_IC.reshape(di, dcam)], dim=1),
            torch.cat([S_IR.reshape(di, dr).T, S_RR.reshape(dr, dr),
                       S_RC.reshape(dr, dcam)], dim=1),
            torch.cat([S_IC.reshape(di, dcam).T, S_RC.reshape(dr, dcam).T,
                       S_CC.reshape(dcam, dcam)], dim=1),
        ],
        dim=0,
    )
    b = torch.cat([b_i, b_r, b_c])

    # Identity rows for fixed/padded parameters keep S nonsingular.
    fixed_dims = torch.cat([
        (~data["opt_inst"]).repeat_interleave(6),
        (~data["opt_rigcam"]).repeat_interleave(6),
        (~data["opt_cam"]).reshape(-1),
    ]).to(dtype)
    S = S + torch.diag(fixed_dims)

    # Marquardt scaling with the Ceres diagonal clamp
    # (levenberg_marquardt_strategy.cc min_diagonal = 1e-6).
    diag_S = torch.clamp(torch.diagonal(S), 1e-6, 1e32)
    S = S + torch.diag(lam * diag_S + 1e-12)
    S = 0.5 * (S + S.T)
    return S, b


def _back_substitute(back, dx_i, dx_cam, ni, pmax):
    """Recover the point updates dx_p from the reduced-system solution:
    u_p = sum_{o in p} Jp_o' (J_o dx_o), dx_p = Hpp_inv (bp - u_p).  After
    the fused assembly the kernel recomputes the Jacobians instead."""
    fused = back.get("fused")
    if fused is not None:
        return fused_back_substitute(
            fused["inst"], fused["cam"], fused["points"], fused["obs_uv"],
            fused["obs_inv_sd"], fused["out_pt"], dx_i.contiguous(),
            dx_cam.contiguous(), loss=fused["loss"],
            loss_threshold=fused["loss_threshold"],
        )
    Hpp_inv, bp = back["Hpp_inv"], back["bp"]
    num_obs = back["Ji"].shape[0]
    if back["dense"]:
        # slot == instance: the per-obs dx rows are a pure broadcast.
        dxi_o = dx_i[None].expand(num_obs // ni, ni, 6).reshape(num_obs, 6)
        dxc_o = dx_cam.expand(num_obs, pmax)
    else:
        dxi_o = dx_i[back["obs_inst"]]
        dxc_o = dx_cam[back["obs_cam"]]
    tmp = (
        torch.einsum("okx,ox->ok", back["Ji"], dxi_o)
        + torch.einsum("okx,ox->ok", back["Jcam"], dxc_o)
    )  # [O, K]
    tmp_pt = back["padded"](tmp)  # [NP, T, K]
    u = torch.einsum("ptkx,ptk->px", back["Jp_pt"], tmp_pt)  # [NP, 3]
    return torch.einsum("pkj,pj->pk", Hpp_inv, bp - u)


def _lm_step(state, data, lam, loss, loss_threshold, pmax, ni, nr, nc,
             dense=False):
    """One damped LM step: assemble, Schur-eliminate points, solve, update."""
    inst, rigcam, cam, points = state[:4]
    S, b, back = _build_reduced_system(
        state, data, lam, loss, loss_threshold, pmax, ni, nr, nc, dense,
    )
    # S is SPD after damping + identity rows.
    dx_c = linalg.solve_spd(S, b)
    di, dr, dcam = ni * 6, nr * 6, nc * pmax
    dx_i = dx_c[:di].reshape(ni, 6)
    dx_r = dx_c[di:di + dr].reshape(nr, 6)
    dx_cam = dx_c[di + dr:di + dr + dcam].reshape(nc, pmax)
    dx_p = _back_substitute(back, dx_i, dx_cam, ni, pmax)
    return (inst - dx_i, rigcam - dx_r, cam - dx_cam, points - dx_p)


def _total_cost(state, data, loss, loss_threshold, dense=False):
    """Objective only (the accept/reject trial): the reprojection cost from
    a cost kernel plus every prior family.  The dense layout with one camera
    and a point count that is a multiple of 128 takes the dense cost kernel,
    which reads no index arrays (the reference's condition)."""
    inst, rigcam, cam, points = state[:4]
    d = data
    if dense and cam.shape[0] == 1 and points.shape[0] % 128 == 0:
        total = fused_cost_dense(
            inst, cam, points, d["obs_uv"], d["obs_inv_sd"], loss=loss,
            loss_threshold=loss_threshold,
        )
    else:
        total = fused_cost(
            inst, cam, points, d["obs_inst"], d["obs_cam"], d["obs_point"],
            d["obs_uv"], d["obs_inv_sd"], loss=loss,
            loss_threshold=loss_threshold,
        )
    for pr, _, _ in _prior_residuals(state, data, with_jac=False):
        total = total + 0.5 * torch.sum(pr * pr)
    rho_c = LOSSES["CauchyLoss"][0]  # shot priors carry Cauchy(1)
    for pr in _shot_prior_residuals(state, data, raw=True):
        s = torch.sum(pr * pr, dim=-1)
        total = total + torch.sum(0.5 * rho_c(s))
    return total + _point_prior_cost(points, data)


def _lm_solve(state, data, lam0, tol, max_iterations, loss, loss_threshold,
              pmax, ni, nr, nc, dense=False):
    """The damping loop on the host, with the reference's exact policy:
    accept only a finite drop in cost; lam / 3 (floored at 1e-12) on accept,
    lam * 10 (capped at 1e8) on reject; stop after 16 consecutive rejects,
    on an accepted step with rel < tol, or at `max_iterations` accepted
    steps; at most 16 * max_iterations trials.  The scalars follow the
    working dtype, as in the reference's device loop."""
    sdt = np.float32 if state[3].dtype == torch.float32 else np.float64
    kw = dict(loss=loss, loss_threshold=loss_threshold)
    cost0 = sdt(_total_cost(state, data, dense=dense, **kw).item())
    cost, lam, tol = cost0, sdt(lam0), sdt(tol)
    rejects = accepted = trials = 0
    while trials < 16 * max_iterations:
        new_st = _lm_step(state, data, float(lam), pmax=pmax, ni=ni, nr=nr,
                          nc=nc, dense=dense, **kw)
        new_cost = sdt(_total_cost(new_st, data, dense=dense, **kw).item())
        accept = bool(np.isfinite(new_cost) and new_cost < cost)
        rel = (cost - new_cost) / max(cost, sdt(1e-30))
        trials += 1
        if accept:
            state, cost = new_st, new_cost
            lam = max(lam / sdt(3.0), sdt(1e-12))
            rejects = 0
            accepted += 1
        else:
            lam = min(lam * sdt(10.0), sdt(1e8))
            rejects += 1
        if (accept and rel < tol) or rejects >= 16 \
                or accepted >= max_iterations:
            break
    return state, cost0, cost, lam, accepted


_GRAPH_KEYS = ("rm_i", "rr_i", "cp_i", "lin_i0", "hm_inst", "gauge_i")


def _single_ptype(ptype):
    """A ptype tuple of one segment is that type: the builder tags even a
    one-type problem with its segment list."""
    if not isinstance(ptype, str) and len(ptype) == 1:
        return ptype[0][0]
    return ptype


def _check_supported(problem: BAProblem) -> None:
    """Raise NotImplementedError for what this slice does not port."""
    if not isinstance(problem.ptype, str):
        raise NotImplementedError(
            "mixed projection types are not ported yet"
        )
    if problem.ptype != "perspective":
        raise NotImplementedError(
            f"projection type {problem.ptype!r} is not ported yet"
        )
    if problem.cam.shape[1] != 3:
        raise NotImplementedError(
            "camera tables wider than [k1, k2, focal] are not ported yet"
        )
    if bool(np.asarray(problem.opt_rigcam).any()) or float(
        np.abs(np.asarray(problem.rigcam)).max(initial=0.0)
    ) > 1e-12:
        raise NotImplementedError("rig chains are not ported yet")
    if problem.obs_depth_inv_sd is not None and bool(
        np.any(np.asarray(problem.obs_depth_inv_sd) > 0)
    ):
        raise NotImplementedError("depth prior rows are not ported yet")
    if problem.scales is not None and len(problem.scales) > 0:
        raise NotImplementedError("scale variables are not ported yet")
    for key in _GRAPH_KEYS:
        arr = getattr(problem, key)
        if arr is not None and np.asarray(arr).shape[0] > 0:
            raise NotImplementedError(
                "pose-graph constraint families are not ported yet"
            )


def device_problem(problem: BAProblem, dtype: torch.dtype,
                   device: torch.device):
    """Lay `problem` out for the solver (dense instance-slot grid when it
    fits, else the canonical (point, slot) layout) and move it to `device`.
    Returns (laid-out problem, dense flag, state tuple, data dict)."""
    problem = dataclasses.replace(problem, ptype=_single_ptype(problem.ptype))
    _check_supported(problem)
    problem, dense = canonicalize_problem_dense(problem)

    def opt(x, default):
        return np.asarray(x) if x is not None else default

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)

    def b8(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.bool, device=device)

    state = (f(problem.inst), f(problem.rigcam), f(problem.cam),
             f(problem.points))
    data = {
        "obs_uv": f(problem.obs_uv),
        "obs_inv_sd": f(problem.obs_inv_sd),
        "obs_point": i32(problem.obs_point),
        "obs_inst": i32(problem.obs_inst),
        "obs_cam": i32(problem.obs_cam),
        "gps_pos": f(problem.gps_pos),
        "gps_inv_sd": f(problem.gps_inv_sd),
        "cam_prior": f(problem.cam_prior),
        "cam_prior_inv_sd": f(problem.cam_prior_inv_sd),
        "cam_log_mask": b8(problem.cam_log_mask),
        "rigcam_prior": f(problem.rigcam_prior),
        "rigcam_prior_inv_sd": f(problem.rigcam_prior_inv_sd),
        "point_prior": f(problem.point_prior),
        "point_prior_inv_sd": f(problem.point_prior_inv_sd),
        "opt_inst": b8(problem.opt_inst),
        "opt_rigcam": b8(problem.opt_rigcam),
        "opt_cam": b8(problem.opt_cam),
        "opt_points": b8(problem.opt_points),
        "up_inst": i32(opt(problem.up_inst, np.zeros(0))),
        "up_rigcam": i32(opt(problem.up_rigcam, np.zeros(0))),
        "up_vec": f(opt(problem.up_vec, np.zeros((0, 3)))),
        "up_inv_sd": f(opt(problem.up_inv_sd, np.zeros(0))),
        "ang_kind": i32(opt(problem.ang_kind, np.zeros(0))),
        "ang_inst": i32(opt(problem.ang_inst, np.zeros(0))),
        "ang_rigcam": i32(opt(problem.ang_rigcam, np.zeros(0))),
        "ang_value": f(opt(problem.ang_value, np.zeros(0))),
        "ang_inv_sd": f(opt(problem.ang_inv_sd, np.zeros(0))),
    }
    if problem.point_prior_loss is not None and bool(
        np.any(np.asarray(problem.point_prior_loss) > 0)
    ):
        data["point_prior_loss"] = f(problem.point_prior_loss)
    return problem, dense, state, data


def bundle_adjust(
    problem: BAProblem,
    max_iterations: int = 50,
    initial_lambda: float = 1e-4,
    tol: float = 1e-10,
    dtype: torch.dtype = torch.float64,
    compute_covariances: bool = False,
    device=None,
) -> BAResult:
    """Run LM to convergence on `device` (CUDA unless told otherwise)."""
    if compute_covariances:
        raise NotImplementedError("covariances are not ported yet")
    device = resolve_device(device)
    if device.type == "cuda":
        # Full-precision f32 products, as the reference's HIGHEST.
        torch.backends.cuda.matmul.allow_tf32 = False
    problem, dense, state, data = device_problem(problem, dtype, device)
    ni, nr, nc = len(problem.inst), len(problem.rigcam), len(problem.cam)

    context.record_dispatch("bundle_lm_solve")
    state, cost0, cost1, lam1, accepted = _lm_solve(
        state, data, initial_lambda, tol, int(max_iterations),
        loss=problem.loss, loss_threshold=float(problem.loss_threshold),
        pmax=problem.cam.shape[1], ni=ni, nr=nr, nc=nc, dense=dense,
    )
    return BAResult(
        inst=state[0].cpu().numpy(),
        rigcam=state[1].cpu().numpy(),
        cam=state[2].cpu().numpy(),
        points=state[3].cpu().numpy(),
        initial_cost=float(cost0),
        final_cost=float(cost1),
        iterations=int(accepted),
        lam=float(lam1),
    )
