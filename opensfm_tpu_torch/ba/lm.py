"""Schur-complement Levenberg-Marquardt bundle adjustment core (PyTorch).

Port of `opensfm_tpu.ba.lm`: rig instances and rig cameras (fixed,
non-identity or optimized), every projection type of
`geometry/cameras.py` and maps that mix them (type-sorted observation
segments), GPS / camera / rig-camera / point priors, up-vector / pan /
tilt / roll shot priors and per-observation depth priors.

Parameters: rig instance poses inst[NI, 6] (angle-axis + translation,
world-to-instance), rig camera poses rigcam[NR, 6], camera intrinsics
cam[NC, Pmax] and points points[NP, 3].  The points are eliminated with an
explicit batched Schur complement; the reduced camera system is dense and
solved by Cholesky.

Two routes, chosen by the problem alone as the reference chooses its
Pallas path: a mono perspective [k1, k2, focal] map with identity rig
cameras and no depth rows takes the hand-written CUDA kernels (residuals,
Jacobians and cost from `ops/kernels/ba_resjac.py`; on the dense
instance-slot layout's fast path, `_fused_dense`, the whole assembly, the
back-substitution and the cost from `ops/kernels/ba_assemble.py`).  Every
other problem takes the generic route, the reference's XLA route: the
residuals of each type segment and their Jacobians from one batched
forward-mode push (`torch.func.vmap` over `torch.func.jvp`) over the
segment's tangent directions.  The kernels run when the tensors lie on a
CUDA device (f32 or f64), their plain PyTorch versions when they lie on the
CPU; a kernel that fails raises, it never gives way to the generic route.

Cluster-SfM scale variables and the pose-graph constraint families
(relative motion and rotation, common position, linear motion, heatmap
position priors, the gauge fix) fold into the reduced system after its
assembly on every route (`_fold_graph_rows`); `compute_covariances` gives
the rig instances' marginal 6 x 6 covariances (`_instance_covariances`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from opensfm_tpu_torch import context, resolve_device
from opensfm_tpu_torch.geometry import cameras as cam_lib
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

    # Per-observation depth priors (RelativeDepthError): (depth(Xc) - depth)
    # / sd with the projection robust loss; inv_sd == 0 disables a row.
    obs_depth: Optional[np.ndarray] = None  # [O]
    obs_depth_inv_sd: Optional[np.ndarray] = None  # [O]
    obs_depth_radial: Optional[np.ndarray] = None  # [O] bool

    # Optional per-point Cauchy threshold for the position-prior rows; 0/None
    # = plain quadratic.
    point_prior_loss: Optional[np.ndarray] = None  # [NP]

    # Cluster-SfM scale variables: one per (reconstruction, instance), or
    # one per reconstruction under scale sharing; instances reference them
    # through rm_si / rm_sj.
    scales: Optional[np.ndarray] = None
    opt_scales: Optional[np.ndarray] = None
    # Relative motions (7 rows: rotation log, scaled translation, scale
    # ratio; Cauchy(loss_threshold * robust_multiplier)).
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
    # Relative rotations (3 rows between two shots, Cauchy(threshold)).
    rr_i: Optional[np.ndarray] = None
    rr_j: Optional[np.ndarray] = None
    rr_ri: Optional[np.ndarray] = None
    rr_rj: Optional[np.ndarray] = None
    rr_rvec: Optional[np.ndarray] = None
    rr_inv_sd: Optional[np.ndarray] = None
    rr_loss_c: Optional[np.ndarray] = None
    # Common positions (3 rows, xy clamped by a margin, Tukey(1)).
    cp_i: Optional[np.ndarray] = None
    cp_j: Optional[np.ndarray] = None
    cp_ri: Optional[np.ndarray] = None
    cp_rj: Optional[np.ndarray] = None
    cp_margin: Optional[np.ndarray] = None
    cp_inv_sd: Optional[np.ndarray] = None
    # Linear motions (6 rows over three shots, Cauchy(1)).
    lin_i0: Optional[np.ndarray] = None
    lin_i1: Optional[np.ndarray] = None
    lin_i2: Optional[np.ndarray] = None
    lin_r0: Optional[np.ndarray] = None
    lin_r1: Optional[np.ndarray] = None
    lin_r2: Optional[np.ndarray] = None
    lin_alpha: Optional[np.ndarray] = None
    lin_pos_inv_sd: Optional[np.ndarray] = None
    lin_rot_inv_sd: Optional[np.ndarray] = None
    # Heatmap position priors (1 row, a bicubic lookup, no loss).
    hm_inst: Optional[np.ndarray] = None
    hm_rigcam: Optional[np.ndarray] = None
    hm_map: Optional[np.ndarray] = None
    hm_offset: Optional[np.ndarray] = None
    hm_inv_sd: Optional[np.ndarray] = None
    heatmaps: Optional[np.ndarray] = None
    hm_res: Optional[np.ndarray] = None
    # Gauge fix (1 row, log(|o_i - o_j| / norm), no loss).
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
    route: str = "canonical"  # canonical, dense, fused_dense or generic


def problem_from_numpy(src) -> BAProblem:
    """A BAProblem from any object with the BAProblem fields (the reference's
    `opensfm_tpu.ba.lm.BAProblem` included): the arrays are taken as they
    are, the rig cameras, their masks and priors, the depth rows and the
    type segments (`ptype`, a string or a tuple of (type, start, end))
    with them."""
    return BAProblem(
        **{f.name: getattr(src, f.name) for f in dataclasses.fields(BAProblem)}
    )


# ---------------------------------------------------------------------------
# Residual rows
# ---------------------------------------------------------------------------


def _transform_rig(inst6, rigcam6, X):
    """World -> camera through the rig: Xc = R_rc (R_i X + t_i) + t_rc."""
    Xi = rot.rotate(inst6[..., :3], X) + inst6[..., 3:6]
    return rot.rotate(rigcam6[..., :3], Xi) + rigcam6[..., 3:6]


def _origin(pose6):
    """Camera/instance center: -R^T t."""
    return -rot.rotate(-pose6[..., :3], pose6[..., 3:6])


def kernel_route(ptype, pmax, with_depth=False, rig_transform=False,
                 rig_jac=False) -> bool:
    """The reference's condition for its Pallas path, and so the port's for
    its CUDA kernels: a perspective [k1, k2, focal] map, identity rig
    cameras, no depth rows.  Every other problem takes the generic route."""
    return (ptype == "perspective" and pmax == 3 and not with_depth
            and not rig_transform and not rig_jac)


def _segment_rows(pt, rig_transform, pmax, uv, inv_sd, dep):
    """res(combo [O, roff + pmax], X [O, 3]) -> [O, K] of one type segment
    (the reference's `make_batched`): the pose chain through the instance
    (and the rig camera with `rig_transform`), the projection, the
    spherical seam wrap, and with `dep` the depth row (radial or z)."""
    roff = 12 if rig_transform else 6

    def res(combo, X):
        Xc = rot.rotate(combo[:, 0:3], X) + combo[:, 3:6]
        if rig_transform:
            Xc = rot.rotate(combo[:, 6:9], Xc) + combo[:, 9:12]
        diff = cam_lib.project_torch(pt, Xc, combo[:, roff:roff + pmax]) - uv
        if pt == "spherical":
            # Wrap the panorama seam, as the JAX package does (OpenSfM's
            # own residual is a 3D bearing, ErrorTraits
            # bundle_adjuster.cc:446).
            diff = diff - torch.round(diff)
        out = diff * inv_sd[:, None]
        if dep is None:
            return out
        depth, depth_inv_sd, radial = dep
        norm = torch.sqrt(torch.sum(Xc * Xc, dim=-1) + 1e-30)
        r_d = (torch.where(radial, norm, Xc[:, 2]) - depth) * depth_inv_sd
        return torch.cat([out, r_d[:, None]], dim=1)

    return res


def _push_directions(res, combo, X, dirs):
    """(r [O, K], J [O, K, len(dirs)]) of res(combo, X): one forward-mode
    push of all tangent directions `dirs` (indices into the D + 3 columns
    of [combo, X]) at once, batched by `torch.func.vmap` over `jvp`, so a
    segment's Jacobian is one launch chain however many directions it
    has."""
    D = combo.shape[1]
    basis = torch.eye(D + 3, dtype=combo.dtype, device=combo.device)[dirs]

    def push(e):
        return torch.func.jvp(
            res, (combo, X), (e[:D].expand_as(combo), e[D:].expand_as(X)))

    r, J = torch.func.vmap(push)(basis)
    return r[0], J.permute(1, 2, 0)


def _obs_combo(state, data, sl, rig_transform):
    """[inst | rig camera | camera] rows and points of the observations
    `sl`, gathered through their index arrays."""
    inst, rigcam, cam, points = state[:4]
    parts = [inst[data["obs_inst"][sl]]]
    if rig_transform:
        parts.append(rigcam[data["obs_rigcam"][sl]])
    parts.append(cam[data["obs_cam"][sl]])
    return torch.cat(parts, dim=1), points[data["obs_point"][sl]]


def _depth_rows(data, sl, with_depth):
    if not with_depth:
        return None
    return (data["obs_depth"][sl], data["obs_depth_inv_sd"][sl],
            data["obs_depth_radial"][sl])


def _generic_segments(state, data, ptype, pmax, with_depth, rig_transform):
    """(res, combo, X) of each (type, start, end) segment of `ptype` (a
    type names one segment over every observation) on the generic route:
    its rows' function (`_segment_rows`) and its gathered arguments."""
    segments = (((ptype, 0, data["obs_uv"].shape[0]),)
                if isinstance(ptype, str) else ptype)
    for pt, start, end in segments:
        sl = slice(start, end)
        combo, X = _obs_combo(state, data, sl, rig_transform)
        yield (_segment_rows(pt, rig_transform, pmax, data["obs_uv"][sl],
                             data["obs_inv_sd"][sl],
                             _depth_rows(data, sl, with_depth)), combo, X)


def _robust_args(r, loss_threshold, with_depth):
    """The robust loss's arguments of weighted rows r [O, K]: the
    projection's squared norm and, with the depth row, its square (its own
    IRLS weight), each over the threshold squared."""
    a2 = loss_threshold * loss_threshold
    u = [torch.sum(r[:, :2] * r[:, :2], dim=-1) / a2]
    if with_depth:
        u.append(r[:, 2] * r[:, 2] / a2)
    return u


def _residual_data(state, data, loss, loss_threshold, ptype="perspective",
                   pmax=3, with_depth=False, rig_transform=False,
                   rig_jac=False, generic=False):
    """Per-observation weighted residuals r[O, K], Jacobians Jc[O, K, Dc]
    and Jp[O, K, 3], already scaled by sqrt(rho'), and the per-observation
    robust cost.  K = 2, or 3 with the depth row (its own IRLS weight, as
    the reference's RelativeDepthError block sharing the projection loss).
    Dc = 6 instance pose + [6 rig camera with `rig_jac`] + pmax.

    On the kernel route (not `generic`, see `solver_statics`) the CUDA
    kernel computes them; every layout reaches it through its index arrays.
    The generic route pushes each type segment's tangent directions in one
    batched forward-mode pass (`_push_directions`), skipping the rig
    camera's six when it is fixed."""
    inst, _, cam, points = state[:4]
    d = data
    if not generic:
        return fused_residual_jacobian(
            inst, cam, points, d["obs_inst"], d["obs_cam"], d["obs_point"],
            d["obs_uv"], d["obs_inv_sd"], loss=loss,
            loss_threshold=loss_threshold,
        )
    roff = 12 if rig_transform else 6
    D = roff + pmax
    if rig_transform and not rig_jac:
        dirs = list(range(0, 6)) + list(range(12, D + 3))
    else:
        dirs = list(range(D + 3))
    n_cam_dirs = len(dirs) - 3
    rs, Jcs, Jps = [], [], []
    for res, combo, X in _generic_segments(state, d, ptype, pmax, with_depth,
                                           rig_transform):
        r_, J_ = _push_directions(res, combo, X, dirs)
        rs.append(r_)
        Jcs.append(J_[..., :n_cam_dirs])
        Jps.append(J_[..., n_cam_dirs:])
    r, Jc, Jp = (torch.cat(x) if len(x) > 1 else x[0] for x in (rs, Jcs, Jps))

    rho, drho = LOSSES[loss]
    a2 = loss_threshold * loss_threshold
    u = _robust_args(r, loss_threshold, with_depth)
    cost = 0.5 * a2 * rho(u[0])
    w = drho(u[0])[:, None].expand(r.shape[0], 2)
    if with_depth:
        cost = cost + 0.5 * a2 * rho(u[1])
        w = torch.cat([w, drho(u[1])[:, None]], dim=1)
    sw = torch.sqrt(torch.clamp_min(w, 1e-12))
    return r * sw, Jc * sw[..., None], Jp * sw[..., None], cost


def _push_rows(fn, diff, const):
    """(r [K, M], [J_a [K, M, d_a] for each of `diff`]) of the row-batched
    fn(*diff, *const): every tangent direction of the differentiated
    arguments ([K, d_a], or [K] as d_a = 1) pushed at once by
    `torch.func.vmap` over `torch.func.jvp`, the reference's jacfwd in one
    launch chain."""
    widths = [x.shape[1] if x.dim() > 1 else 1 for x in diff]
    ref = diff[0]
    basis = torch.eye(sum(widths), dtype=ref.dtype, device=ref.device)
    starts = np.cumsum([0] + widths[:-1]).tolist()

    def push(e):
        tangents = tuple(
            (e[o:o + w] if x.dim() > 1 else e[o]).expand_as(x)
            for x, o, w in zip(diff, starts, widths))
        return torch.func.jvp(lambda *a: fn(*a, *const), tuple(diff),
                              tangents)

    r, J = torch.func.vmap(push)(basis)  # [D, K, M]
    J = J.permute(1, 2, 0)
    return r[0], [J[..., o:o + w] for o, w in zip(starts, widths)]


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


def _shot_prior_residuals(state, data, raw=False, rig_jac=False):
    """Up-vector and pan/tilt/roll rows on (instance, rig camera) pairs, with
    Cauchy(1) sqrt-IRLS weights: list of (r[K, M], Ji[K, M, 6], Jr[K, M, 6]
    or None, idx_inst, idx_rigcam), the rig-camera Jacobian only with
    `rig_jac`; with raw=True just the unweighted residuals."""
    inst, rigcam = state[0], state[1]
    d = data
    out = []
    cauchy_w = LOSSES["CauchyLoss"][1]
    rows = []
    if d["up_vec"].shape[0] > 0:
        rows.append((_up_res, (inst[d["up_inst"]], rigcam[d["up_rigcam"]]),
                     (d["up_vec"], d["up_inv_sd"][:, None]),
                     d["up_inst"], d["up_rigcam"]))
    if d["ang_value"].shape[0] > 0:
        rows.append((_ang_res, (inst[d["ang_inst"]], rigcam[d["ang_rigcam"]]),
                     (d["ang_kind"], d["ang_value"], d["ang_inv_sd"]),
                     d["ang_inst"], d["ang_rigcam"]))
    for fn, diff, const, idx_i, idx_r in rows:
        if raw:
            out.append(fn(*diff, *const))
            continue
        r, (Ji, Jr) = _push_rows(fn, diff, const)
        Jr = Jr if rig_jac else None
        s = torch.sum(r * r, dim=-1, keepdim=True)
        sw = torch.sqrt(torch.clamp_min(cauchy_w(s), 1e-12))
        out.append((r * sw, Ji * sw[..., None],
                    None if Jr is None else Jr * sw[..., None], idx_i, idx_r))
    return out


# ---------------------------------------------------------------------------
# Pose-graph constraint rows (relative motion and rotation, common position,
# linear motion, heatmaps, gauge fix).  They couple two or three rig
# instances (and scale variables), so they fold into the reduced system as
# J^T J rows after its assembly; their counts are pose-graph sized, never
# observation sized.
# ---------------------------------------------------------------------------


def _rotmat_c2w(rvec_w2c):
    """Cam-to-world rotation matrices [K, 3, 3] from world-to-cam angle-axis
    rows [K, 3]."""
    return rot.rotvec_to_matrix(-rvec_w2c)


def _shot_pos(i6, r6):
    """Shot origins [K, 3] in world coordinates through the rig camera."""
    return _origin(i6) + rot.rotate(-i6[:, :3], _origin(r6))


def _shot_rot_c2w(i6, r6):
    """Shot cam-to-world rotations [K, 3, 3] through the rig camera."""
    return _rotmat_c2w(i6[:, :3]) @ _rotmat_c2w(r6[:, :3])


def _bicubic(grid, row, col):
    """Catmull-Rom bicubic interpolation of grids [K, H, W] at fractional
    (row[K], col[K]) with the borders clamped (ceres::BiCubicInterpolator
    over Grid2D, as the reference's heatmap cost)."""
    H, W = grid.shape[1], grid.shape[2]
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    tr = row - r0
    tc = col - c0

    def weights(t):  # [K, 4]
        return torch.stack([
            ((-0.5 * t + 1.0) * t - 0.5) * t,
            (1.5 * t - 2.5) * t * t + 1.0,
            ((-1.5 * t + 2.0) * t + 0.5) * t,
            (0.5 * t - 0.5) * t * t,
        ], dim=-1)

    wr, wc = weights(tr), weights(tc)
    offs = torch.arange(-1, 3, device=grid.device)
    ri = torch.clamp(r0.long()[:, None] + offs, 0, H - 1)
    ci = torch.clamp(c0.long()[:, None] + offs, 0, W - 1)
    k = torch.arange(grid.shape[0], device=grid.device)[:, None, None]
    patch = grid[k, ri[:, :, None], ci[:, None, :]]  # [K, 4, 4]
    return ((wr[:, None, :] @ patch) @ wc[:, :, None])[:, 0, 0]


def _rm_res(i6a, i6b, sa, sb, rvec, tvec, s_obs, inv_sd, obs_scale):
    """Relative motion rows [K, 7] (RelativeMotionError)."""
    rres = rot.matrix_to_rotvec(
        rot.rotvec_to_matrix(rvec) @ _rotmat_c2w(i6a[:, :3]).transpose(1, 2)
        @ _rotmat_c2w(i6b[:, :3]))
    tres = tvec - sb[:, None] * rot.rotate(i6b[:, :3],
                                           _origin(i6a) - _origin(i6b))
    safe_sa = torch.where(torch.abs(sa) < 1e-30, 1e-30, sa)
    sres = torch.where(obs_scale, s_obs - sb / safe_sa, 0.0)
    return torch.cat([rres, tres, sres[:, None]], dim=-1) * inv_sd


def _rr_res(i6a, i6b, r6a, r6b, rvec, inv_sd):
    """Relative rotation rows [K, 3]."""
    Ra = _shot_rot_c2w(i6a, r6a)
    Rb = _shot_rot_c2w(i6b, r6b)
    return rot.matrix_to_rotvec(
        rot.rotvec_to_matrix(rvec) @ Ra.transpose(1, 2) @ Rb) * inv_sd


def _cp_res(i6a, i6b, r6a, r6b, margin, inv_sd):
    """Common position rows [K, 3]: xy beyond the margin, z."""
    e = _shot_pos(i6a, r6a) - _shot_pos(i6b, r6b)
    exy = torch.clamp_min(torch.abs(e[:, :2]) - margin[:, None], 0.0)
    return torch.cat([exy, e[:, 2:3]], dim=-1) * inv_sd


def _lin_res(i60, i61, i62, r60, r61, r62, alpha, pos_inv, rot_inv):
    """Linear motion rows [K, 6] (LinearMotionError)."""
    t0 = _shot_pos(i60, r60)
    t1 = _shot_pos(i61, r61)
    t2 = _shot_pos(i62, r62)
    t20 = t2 - t0
    t10 = t1 - t0
    n20sq = torch.sum(t20 * t20, dim=-1)
    n10sq = torch.sum(t10 * t10, dim=-1)
    big = n20sq > 1e-15 * 1e-15
    safe20 = torch.sqrt(torch.where(big, n20sq, 1.0))
    safe10 = torch.sqrt(torch.clamp_min(n10sq, 1e-30))
    ratio_form = (alpha - safe10 / safe20)[:, None].expand(-1, 3)
    diff_form = alpha[:, None] * t20 - t10
    pos = pos_inv[:, None] * torch.where(big[:, None], ratio_form, diff_form)
    R0 = _shot_rot_c2w(i60, r60)
    R1 = _shot_rot_c2w(i61, r61)
    R2 = _shot_rot_c2w(i62, r62)
    r20 = alpha[:, None] * rot.matrix_to_rotvec(R2 @ R0.transpose(1, 2))
    r01 = rot.matrix_to_rotvec(R0 @ R1.transpose(1, 2))
    rres = rot_inv[:, None] * rot.matrix_to_rotvec(
        rot.rotvec_to_matrix(r20) @ rot.rotvec_to_matrix(r01))
    return torch.cat([pos, rres], dim=-1)


def _hm_res(i6, r6, hmap, res, off, inv_sd):
    """Heatmap rows [K, 1]: the grid's bicubic value at the shot's xy."""
    H, W = hmap.shape[1], hmap.shape[2]
    pos = _shot_pos(i6, r6)
    row = H / 2.0 - (pos[:, 1] - off[:, 1]) / res
    col = W / 2.0 + (pos[:, 0] - off[:, 0]) / res
    return (_bicubic(hmap, row, col) * inv_sd)[:, None]


def _gauge_res(i6a, i6b, norm):
    """Gauge rows [K, 1]: log(|o_a - o_b| / norm)."""
    e = _origin(i6a) - _origin(i6b)
    return torch.log(torch.sqrt(torch.sum(e * e, dim=-1) + 1e-20)
                     / norm)[:, None]


_GRAPH_KEYS = ("rm_i", "rr_i", "cp_i", "lin_i0", "hm_inst", "gauge_i")


def _has_graph(data) -> bool:
    return any(data.get(k) is not None and data[k].shape[0] > 0
               for k in _GRAPH_KEYS)


def _graph_blocks(state, data):
    """(fn, diff args, const args, Jacobian slots, loss) of each family
    present: slots are (argnum, family, index) with family "i" (instances),
    "r" (rig cameras) or "s" (scales); loss is (kind, c[K]) or None."""
    inst, rigcam, scales = state[0], state[1], state[4]
    d = data
    out = []
    if d.get("rm_i") is not None and d["rm_i"].shape[0] > 0:
        out.append((
            _rm_res,
            (inst[d["rm_i"]], inst[d["rm_j"]], scales[d["rm_si"]],
             scales[d["rm_sj"]]),
            (d["rm_rvec"], d["rm_tvec"], d["rm_scale"], d["rm_inv_sd"],
             d["rm_obs_scale"]),
            [(0, "i", d["rm_i"]), (1, "i", d["rm_j"]),
             (2, "s", d["rm_si"]), (3, "s", d["rm_sj"])],
            ("CauchyLoss", d["rm_loss_c"])))
    if d.get("rr_i") is not None and d["rr_i"].shape[0] > 0:
        out.append((
            _rr_res,
            (inst[d["rr_i"]], inst[d["rr_j"]], rigcam[d["rr_ri"]],
             rigcam[d["rr_rj"]]),
            (d["rr_rvec"], d["rr_inv_sd"]),
            [(0, "i", d["rr_i"]), (1, "i", d["rr_j"]),
             (2, "r", d["rr_ri"]), (3, "r", d["rr_rj"])],
            ("CauchyLoss", d["rr_loss_c"])))
    if d.get("cp_i") is not None and d["cp_i"].shape[0] > 0:
        out.append((
            _cp_res,
            (inst[d["cp_i"]], inst[d["cp_j"]], rigcam[d["cp_ri"]],
             rigcam[d["cp_rj"]]),
            (d["cp_margin"], d["cp_inv_sd"][:, None]),
            [(0, "i", d["cp_i"]), (1, "i", d["cp_j"]),
             (2, "r", d["cp_ri"]), (3, "r", d["cp_rj"])],
            ("TukeyLoss", torch.ones_like(d["cp_inv_sd"]))))
    if d.get("lin_i0") is not None and d["lin_i0"].shape[0] > 0:
        out.append((
            _lin_res,
            (inst[d["lin_i0"]], inst[d["lin_i1"]], inst[d["lin_i2"]],
             rigcam[d["lin_r0"]], rigcam[d["lin_r1"]], rigcam[d["lin_r2"]]),
            (d["lin_alpha"], d["lin_pos_inv_sd"], d["lin_rot_inv_sd"]),
            [(0, "i", d["lin_i0"]), (1, "i", d["lin_i1"]),
             (2, "i", d["lin_i2"]), (3, "r", d["lin_r0"]),
             (4, "r", d["lin_r1"]), (5, "r", d["lin_r2"])],
            ("CauchyLoss", torch.ones_like(d["lin_alpha"]))))
    if d.get("hm_inst") is not None and d["hm_inst"].shape[0] > 0:
        out.append((
            _hm_res,
            (inst[d["hm_inst"]], rigcam[d["hm_rigcam"]]),
            (d["heatmaps"][d["hm_map"]], d["hm_res"][d["hm_map"]],
             d["hm_offset"], d["hm_inv_sd"]),
            [(0, "i", d["hm_inst"]), (1, "r", d["hm_rigcam"])],
            None))
    if d.get("gauge_i") is not None and d["gauge_i"].shape[0] > 0:
        out.append((
            _gauge_res,
            (inst[d["gauge_i"]], inst[d["gauge_j"]]),
            (d["gauge_norm"],),
            [(0, "i", d["gauge_i"]), (1, "i", d["gauge_j"])],
            None))
    return out


def _graph_residuals(state, data, raw=False):
    """Every pose-graph family's rows.  With `raw`, a list of (r [K, M],
    loss); otherwise of (r_w [K, M], slots), r_w the sqrt-IRLS-weighted rows
    and slots (family, idx [K], J_w [K, M, bdim]) their Jacobian blocks by
    forward mode (`_push_rows`, the reference's jacfwd).  Losses as
    bundle_adjuster.cc: Cauchy(threshold * robust_multiplier) for relative
    motions, Cauchy(threshold) for relative rotations, Tukey(1) for common
    positions, Cauchy(1) for linear motions, none for heatmaps and the
    gauge."""
    out = []
    for fn, diff, const, slots, loss in _graph_blocks(state, data):
        if raw:
            out.append((fn(*diff, *const), loss))
            continue
        r, Js = _push_rows(fn, diff, const)
        if loss is None:
            sw = torch.ones((r.shape[0], 1), dtype=r.dtype, device=r.device)
        else:
            kind, c = loss
            s = torch.sum(r * r, dim=-1, keepdim=True)
            pos = c[:, None] > 0
            c2 = torch.where(pos, c[:, None] * c[:, None], 1.0)
            w = torch.where(pos, LOSSES[kind][1](s / c2), 1.0)
            sw = torch.sqrt(torch.clamp_min(w, 1e-12))
        blocks = [(family, idx, Js[argnum] * sw[..., None])
                  for argnum, family, idx in slots]
        out.append((r * sw, blocks))
    return out


def _graph_cost(state, data):
    """Total pose-graph objective (the accept/reject trial)."""
    total = torch.zeros((), dtype=state[3].dtype, device=state[3].device)
    for r, loss in _graph_residuals(state, data, raw=True):
        s = torch.sum(r * r, dim=-1)
        if loss is None:
            total = total + 0.5 * torch.sum(s)
            continue
        kind, c = loss
        c2 = torch.where(c > 0, c * c, 1.0)
        per = torch.where(c > 0, 0.5 * c2 * LOSSES[kind][0](s / c2), 0.5 * s)
        total = total + torch.sum(per)
    return total


def _fold_graph_rows(S, b, state, data, ni, nr, nc, pmax, ns):
    """Add the pose-graph rows' J^T J and J^T r to the reduced system
    (S over [instances | rig cameras | cameras | scales]).

    Each family's Jacobian is laid out dense over S's columns, [K * M, D],
    with every slot's block placed by a 0/1 one-hot product (exact, as the
    reference's `_fold_graph_rows`), and the products are two matmuls.  No
    float scatter-add: the placement is exact and the sums run in the
    matmul's fixed order, so S has the same bits on every run."""
    dtype = state[3].dtype
    di, dr, dcam = ni * 6, nr * 6, nc * pmax
    D = di + dr + dcam + ns
    offs = {"i": 0, "r": di, "s": di + dr + dcam}
    n_of = {"i": ni, "r": nr, "s": ns}
    opt_of = {"i": data["opt_inst"], "r": data["opt_rigcam"],
              "s": data.get("opt_scales")}
    for r_w, blocks in _graph_residuals(state, data):
        K, M = r_w.shape
        Jd = torch.zeros((K, M, D), dtype=dtype, device=S.device)
        for family, idx, J in blocks:
            opt = opt_of[family]
            if opt is not None:
                J = J * opt[idx].to(dtype)[:, None, None]
            E = _one_hot(idx, n_of[family], dtype)  # [K, n]
            o, width = offs[family], n_of[family] * J.shape[2]
            Jd[:, :, o:o + width] += (
                E[:, None, :, None] * J[:, :, None, :]).reshape(K, M, width)
        Jf = Jd.reshape(K * M, D)
        S = S + Jf.T @ Jf
        b = b + Jf.T @ r_w.reshape(K * M)
    return S, b


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


def _fused_dense(points, ni, pmax, dense, kernels=True):
    """The reference's conditions for its dense fast path (one fused
    assembly, back-substitution and cost kernel): the kernel route
    (`kernels`, see `kernel_route`), the dense layout, a [k1, k2, focal]
    camera, at most 256 instances and a point count that is a multiple of
    128, in f32 or f64."""
    return (kernels and dense and pmax == 3 and ni <= 256
            and points.shape[0] % 128 == 0
            and points.dtype in (torch.float32, torch.float64))


def _build_reduced_system_fused(state, data, lam, loss, loss_threshold, ni,
                                nr, nc, pmax, raw_blocks=False):
    """(S, b, back) from the fused assembly's raw outputs: reorder the
    [6 NI]^2 Schur product and the per-instance partials into the blocks of
    the reduced system, then add the priors, identity rows and damping
    (`_assemble_S`).  With `raw_blocks`, (blocks, back) before that
    epilogue, as `_build_reduced_system`."""
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
    blocks = (S_II, S_RR, S_IR, S_RC, S_IC, S_CC, b_i, b_r, b_c)
    if raw_blocks:
        return blocks, back
    S, b = _assemble_S(state, data, lam, *blocks, ni, nr, nc, pmax)
    return S, b, back


def _build_reduced_system(state, data, lam, loss, loss_threshold, pmax, ni,
                          nr, nc, dense=False, ptype="perspective",
                          with_depth=False, rig_transform=False,
                          rig_jac=False, canonical=True, generic=False,
                          raw_blocks=False):
    """Assemble the Schur-reduced camera system.

    Per-point structure comes from the padded (point, slot) layout: a free
    reshape when `canonical` (`canonicalize_problem`), a gather through the
    point -> observation CSR otherwise (mixed-type maps keep their
    type-sorted observations; the trash slot O reads a zero row).  With
    `dense` (`canonicalize_problem_dense`: slot == instance, T == NI,
    nc == 1) every one-hot selector is the identity and disappears.  The
    rig-camera family "r" (S_RR, S_IR, S_RC, b_r) joins the instance and
    camera families when a rig camera is optimized (`rig_jac`).

    Returns (S, b, back) where `back` carries what back-substitution
    needs.  With `raw_blocks`, (blocks, back) instead, blocks the families
    (S_II, S_RR, S_IR, S_RC, S_IC, S_CC, b_i, b_r, b_c) before
    `_assemble_S`'s epilogue: the sharded bundle sums them over its shards
    first (`parallel.distributed_ba`)."""
    inst, rigcam, cam, points = state[:4]
    np_pts = points.shape[0]
    dtype = points.dtype
    if dense and (nc != 1 or rig_jac or not canonical):
        raise ValueError("the dense instance-slot layout is mono")
    if _fused_dense(points, ni, pmax, dense, not generic):
        return _build_reduced_system_fused(
            state, data, lam, loss, loss_threshold, ni, nr, nc, pmax,
            raw_blocks=raw_blocks)

    r, Jc, Jp, _ = _residual_data(
        state, data, loss, loss_threshold, ptype=ptype, pmax=pmax,
        with_depth=with_depth, rig_transform=rig_transform, rig_jac=rig_jac,
        generic=generic)
    num_obs = r.shape[0]

    # Mask Jacobians of fixed parameters (zero rows instead of index games).
    if canonical:
        opt_p = data["opt_points"].to(dtype).repeat_interleave(
            num_obs // np_pts)
    else:
        opt_p = data["opt_points"][data["obs_point"]].to(dtype)
    Jp = Jp * opt_p[:, None, None]
    if dense:
        opt_i_o = data["opt_inst"].to(dtype)[None].expand(np_pts, ni) \
            .reshape(num_obs)
        opt_c_o = data["opt_cam"].to(dtype).expand(num_obs, pmax)
    else:
        opt_i_o = data["opt_inst"][data["obs_inst"]].to(dtype)
        opt_c_o = data["opt_cam"][data["obs_cam"]].to(dtype)  # [O, pmax]
    Ji = Jc[:, :, 0:6] * opt_i_o[:, None, None]
    if rig_jac:
        opt_r_o = data["opt_rigcam"][data["obs_rigcam"]].to(dtype)
        Jr = Jc[:, :, 6:12] * opt_r_o[:, None, None]
        Jcam = Jc[:, :, 12:] * opt_c_o[:, None, :]
    else:
        Jr = None
        Jcam = Jc[:, :, 6:] * opt_c_o[:, None, :]

    if canonical:
        def padded(x):  # [O, ...] -> [NP, T, ...]
            return x.reshape((np_pts, -1) + x.shape[1:])
    else:
        po = data["point_obs"].long()  # [NP, T], padded with O

        def padded(x):
            pad = torch.zeros((1,) + x.shape[1:], dtype=x.dtype,
                              device=x.device)
            return torch.cat([x, pad])[po]

    r_pt = padded(r)  # [NP,T,K]
    Jp_pt = padded(Jp)  # [NP,T,K,3]
    fams = [("i", Ji, "obs_inst", ni), ("c", Jcam, "obs_cam", nc)]
    if rig_jac:
        fams.append(("r", Jr, "obs_rigcam", nr))
    flat, pt_of, E_pt, n_of = {}, {}, {}, {}
    for name, J, idx, n_blk in fams:
        # Flat one-hots feed the direct terms as [O, n] products; their
        # point-layout views feed the Schur factors (a trash slot becomes an
        # all-zero selector row).
        E_f = None if dense else _one_hot(data[idx], n_blk, dtype)
        flat[name] = (E_f, J)
        pt_of[name] = padded(J)
        E_pt[name] = None if dense else padded(E_f)
        n_of[name] = n_blk

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
    G, U, V = {}, {}, {}
    for name, J_pt in pt_of.items():
        if n_of[name] == 1:
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
        E = E_pt[name]
        U[name] = torch.einsum("pta,ptxk->paxk", E, Aa)  # [NP,n,bdim,3]
        V[name] = torch.einsum("pta,ptxk->paxk", E, Ga)

    # --- block families of S and b -------------------------------------------
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
    zeros = dict(dtype=dtype, device=points.device)
    if rig_jac:
        S_RR = _expand_diag(direct_diag("r"), nr) - _schur(U["r"], V["r"])
        S_IR = direct_cross("i", "r") - _schur(U["i"], V["r"])
        S_RC = direct_cross("r", "c") - _schur(U["r"], V["c"])
    else:
        # Rig cameras all fixed: their rows come only from the identity
        # padding in _assemble_S; every coupling block is zero.
        S_RR = torch.zeros((nr, 6, nr, 6), **zeros)
        S_IR = torch.zeros((ni, 6, nr, 6), **zeros)
        S_RC = torch.zeros((nr, 6, nc, pmax), **zeros)

    Hib = torch.einsum("pkj,pj->pk", Hpp_inv, bp)  # [NP,3]

    def rhs(name):
        E_f, J_f = flat[name]
        if n_of[name] == 1:
            direct = torch.einsum("okx,ok->x", J_f, r)[None]
            gschur = torch.einsum("pxk,pk->x", V[name][:, 0], Hib)[None]
        elif dense:
            direct = torch.einsum("pakx,pak->ax", pt_of[name], r_pt)
            gschur = torch.einsum("ptxk,pk->tx", G[name], Hib)
        else:
            JTr = torch.einsum("okx,ok->ox", J_f, r)  # [O, bdim]
            direct = E_f.T @ JTr  # [n, bdim]
            GH = torch.einsum("ptxk,pk->ptx", G[name], Hib)  # [NP,T,bdim]
            gschur = torch.einsum("pta,ptx->ax", E_pt[name], GH)
        return (direct - gschur).reshape(-1)

    b_i = rhs("i")
    b_r = rhs("r") if rig_jac else torch.zeros(nr * 6, **zeros)
    b_c = rhs("c")

    back = dict(
        Ji=Ji, Jr=Jr, Jcam=Jcam, Jp_pt=Jp_pt, Hpp_inv=Hpp_inv, bp=bp,
        obs_inst=data["obs_inst"], obs_rigcam=data["obs_rigcam"],
        obs_cam=data["obs_cam"], padded=padded, dense=dense,
    )
    blocks = (S_II, S_RR, S_IR, S_RC, S_IC, S_CC, b_i, b_r, b_c)
    if raw_blocks:
        return blocks, back
    S, b = _assemble_S(state, data, lam, *blocks, ni, nr, nc, pmax,
                       rig_jac=rig_jac)
    return S, b, back


def _assemble_S(state, data, lam, S_II, S_RR, S_IR, S_RC, S_IC, S_CC,
                b_i, b_r, b_c, ni, nr, nc, pmax, rig_jac=False):
    """Epilogue: prior families + block assembly + scale variables and
    pose-graph rows + identity rows for fixed parameters + Marquardt
    damping + symmetrization.  The rig-camera priors and the shot priors'
    rig-camera rows enter with `rig_jac`.  Every route (kernel assembly,
    fused dense assembly, generic) ends here, so every route folds the
    pose-graph rows."""
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
        elif rig_jac:  # rigcam; with every rig camera fixed, masked out
            mask = data["opt_rigcam"].to(dtype)[:, None, None]
            D = torch.einsum("nki,nkj->nij", pJ, pJ) * mask
            S_RR = S_RR + _expand_diag(D, nr)
            b_r = b_r + (
                torch.einsum("nki,nk->ni", pJ, pr) * mask[:, :, 0]
            ).reshape(nr * 6)

    # Shot priors (up-vector / pan / tilt / roll): instance side, and the
    # rig-camera side with `rig_jac`.
    for pr, Ji_u, Jr_u, idx_i, idx_r in _shot_prior_residuals(
            state, data, rig_jac=rig_jac):
        mi = data["opt_inst"][idx_i].to(dtype)[:, None, None]
        Ji_u = Ji_u * mi
        Ei_u = _one_hot(idx_i, ni, dtype)  # [K, NI]
        S_II = S_II + _expand_diag(
            torch.einsum("ka,kxi,kxj->aij", Ei_u, Ji_u, Ji_u), ni
        )
        b_i = b_i + torch.einsum(
            "ka,kxi,kx->ai", Ei_u, Ji_u, pr
        ).reshape(ni * 6)
        if rig_jac:
            mr = data["opt_rigcam"][idx_r].to(dtype)[:, None, None]
            Jr_u = Jr_u * mr
            Er_u = _one_hot(idx_r, nr, dtype)
            S_RR = S_RR + _expand_diag(
                torch.einsum("ka,kxi,kxj->aij", Er_u, Jr_u, Jr_u), nr
            )
            S_IR = S_IR + torch.einsum(
                "ka,kxi,kxj,kb->aibj", Ei_u, Ji_u, Jr_u, Er_u
            )
            b_r = b_r + torch.einsum(
                "ka,kxi,kx->ai", Er_u, Jr_u, pr
            ).reshape(nr * 6)

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

    # Scale variables (a fifth state entry) and the pose-graph rows.
    ns = state[4].shape[0] if len(state) > 4 else 0
    if ns:
        S = torch.nn.functional.pad(S, (0, ns, 0, ns))
        b = torch.nn.functional.pad(b, (0, ns))
    if _has_graph(data):
        S, b = _fold_graph_rows(S, b, state, data, ni, nr, nc, pmax, ns)

    # Identity rows for fixed/padded parameters keep S nonsingular.
    fixed = [
        (~data["opt_inst"]).repeat_interleave(6),
        (~data["opt_rigcam"]).repeat_interleave(6),
        (~data["opt_cam"]).reshape(-1),
    ]
    if ns:
        opt_s = data.get("opt_scales")
        fixed.append(~opt_s if opt_s is not None else torch.zeros(
            ns, dtype=torch.bool, device=S.device))
    fixed_dims = torch.cat(fixed).to(dtype)
    S = S + torch.diag(fixed_dims)

    # Marquardt scaling with the Ceres diagonal clamp
    # (levenberg_marquardt_strategy.cc min_diagonal = 1e-6).
    diag_S = torch.clamp(torch.diagonal(S), 1e-6, 1e32)
    S = S + torch.diag(lam * diag_S + 1e-12)
    S = 0.5 * (S + S.T)
    return S, b


def _back_substitute(back, dx_i, dx_cam, ni, pmax, dx_r=None):
    """Recover the point updates dx_p from the reduced-system solution:
    u_p = sum_{o in p} Jp_o' (J_o dx_o), dx_p = Hpp_inv (bp - u_p), the rig
    cameras' dx_r included when they are optimized.  After the fused
    assembly the kernel recomputes the Jacobians instead."""
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
    if back["Jr"] is not None:
        tmp = tmp + torch.einsum("okx,ox->ok", back["Jr"],
                                 dx_r[back["obs_rigcam"]])
    tmp_pt = back["padded"](tmp)  # [NP, T, K]
    u = torch.einsum("ptkx,ptk->px", back["Jp_pt"], tmp_pt)  # [NP, 3]
    return torch.einsum("pkj,pj->pk", Hpp_inv, bp - u)


def _lm_step(state, data, lam, loss, loss_threshold, pmax, ni, nr, nc,
             dense=False, **statics):
    """One damped LM step: assemble, Schur-eliminate points, solve, update.
    `statics` are `solver_statics`' (ptype, depth, rig and layout flags);
    without them, the mono perspective kernel route."""
    inst, rigcam, cam, points = state[:4]
    S, b, back = _build_reduced_system(
        state, data, lam, loss, loss_threshold, pmax, ni, nr, nc, dense,
        **statics,
    )
    # S is SPD after damping + identity rows.
    dx_c = linalg.solve_spd(S, b)
    di, dr, dcam = ni * 6, nr * 6, nc * pmax
    dx_i = dx_c[:di].reshape(ni, 6)
    dx_r = dx_c[di:di + dr].reshape(nr, 6)
    dx_cam = dx_c[di + dr:di + dr + dcam].reshape(nc, pmax)
    dx_p = _back_substitute(back, dx_i, dx_cam, ni, pmax, dx_r=dx_r)
    new_state = (inst - dx_i, rigcam - dx_r, cam - dx_cam, points - dx_p)
    if len(state) > 4:
        new_state = new_state + (state[4] - dx_c[di + dr + dcam:],)
    return new_state


def _total_cost(state, data, loss, loss_threshold, dense=False,
                ptype="perspective", pmax=3, with_depth=False,
                rig_transform=False, rig_jac=False, canonical=True,
                generic=False):
    """Objective only (the accept/reject trial): the reprojection cost plus
    every prior family and the pose-graph rows.  On the kernel route the cost comes from a cost
    kernel: the dense layout with one camera and a point count that is a
    multiple of 128 takes the dense cost kernel, which reads no index
    arrays (the reference's condition).  The generic route evaluates each
    type segment's rows (`_segment_rows`) with no Jacobian."""
    inst, rigcam, cam, points = state[:4]
    d = data
    if not generic:
        if dense and cam.shape[0] == 1 and points.shape[0] % 128 == 0:
            total = fused_cost_dense(
                inst, cam, points, d["obs_uv"], d["obs_inv_sd"], loss=loss,
                loss_threshold=loss_threshold,
            )
        else:
            total = fused_cost(
                inst, cam, points, d["obs_inst"], d["obs_cam"],
                d["obs_point"], d["obs_uv"], d["obs_inv_sd"], loss=loss,
                loss_threshold=loss_threshold,
            )
    else:
        rho, _ = LOSSES[loss]
        a2 = loss_threshold * loss_threshold
        total = torch.zeros((), dtype=points.dtype, device=points.device)
        for res, combo, X in _generic_segments(state, d, ptype, pmax,
                                               with_depth, rig_transform):
            for u in _robust_args(res(combo, X), loss_threshold, with_depth):
                total = total + torch.sum(0.5 * a2 * rho(u))
    for pr, _, _ in _prior_residuals(state, data, with_jac=False):
        total = total + 0.5 * torch.sum(pr * pr)
    rho_c = LOSSES["CauchyLoss"][0]  # shot priors carry Cauchy(1)
    for pr in _shot_prior_residuals(state, data, raw=True):
        s = torch.sum(pr * pr, dim=-1)
        total = total + torch.sum(0.5 * rho_c(s))
    if _has_graph(data):
        total = total + _graph_cost(state, data)
    return total + _point_prior_cost(points, data)


def _lm_solve(state, data, lam0, tol, max_iterations, loss, loss_threshold,
              pmax, ni, nr, nc, dense=False, **statics):
    """The damping loop on the host, with the reference's exact policy:
    accept only a finite drop in cost; lam / 3 (floored at 1e-12) on accept,
    lam * 10 (capped at 1e8) on reject; stop after 16 consecutive rejects,
    on an accepted step with rel < tol, or at `max_iterations` accepted
    steps; at most 16 * max_iterations trials.  The scalars follow the
    working dtype, as in the reference's device loop."""
    sdt = np.float32 if state[3].dtype == torch.float32 else np.float64
    kw = dict(loss=loss, loss_threshold=loss_threshold)
    ckw = dict(kw, dense=dense, pmax=pmax, **statics)
    cost0 = sdt(_total_cost(state, data, **ckw).item())
    cost, lam, tol = cost0, sdt(lam0), sdt(tol)
    rejects = accepted = trials = 0
    while trials < 16 * max_iterations:
        new_st = _lm_step(state, data, float(lam), pmax=pmax, ni=ni, nr=nr,
                          nc=nc, dense=dense, **kw, **statics)
        new_cost = sdt(_total_cost(new_st, data, **ckw).item())
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


def _instance_covariances(state, data, loss, loss_threshold, pmax, ni, nr,
                          nc, dense=False, **statics):
    """Marginal 6 x 6 covariances [NI, 6, 6] of the rig-instance poses
    (ComputeCovariances, bundle_adjuster.cc:1123-1194) and whether they are
    valid: the points are Schur-marginalized, so the inverse of the
    undamped reduced system restricted to an instance's diagonal block is
    that pose's marginal covariance (in the world-to-camera tangent
    parametrization).  Valid when the inverse is finite and every diagonal
    entry is non-negative, as the reference's rule."""
    S, _, _ = _build_reduced_system(state, data, 0.0, loss, loss_threshold,
                                    pmax, ni, nr, nc, dense, **statics)
    Sinv = linalg.inv_spd(S)
    blocks = Sinv[:ni * 6, :ni * 6].reshape(ni, 6, ni, 6)
    cov = torch.einsum("aiaj->aij", blocks)
    valid = torch.all(torch.isfinite(Sinv)) & torch.all(
        torch.einsum("aii->ai", cov) >= 0)
    return cov, valid


def _single_ptype(ptype):
    """A ptype tuple of one segment is that type: the builder tags even a
    one-type problem with its segment list."""
    if not isinstance(ptype, str) and len(ptype) == 1:
        return ptype[0][0]
    return ptype


def solver_statics(problem: BAProblem, dense: bool) -> dict:
    """The static configuration of a laid-out problem's solve, as the
    reference derives it (`bundle_adjust`): the type segments, the depth
    rows, the rig chain (`rig_jac` when a rig camera is optimized, then its
    six Jacobian columns; `rig_transform` when one is not the identity,
    then the second rotation), the layout (canonical unless the types
    mix), and the route: `generic` unless `kernel_route` holds.  The dense
    layout takes mono problems only (`canonicalize_problem_dense`)."""
    rig_jac = bool(np.asarray(problem.opt_rigcam).any())
    rig_transform = rig_jac or float(
        np.abs(np.asarray(problem.rigcam)).max(initial=0.0)) > 1e-12
    depth_inv_sd = problem.obs_depth_inv_sd
    with_depth = depth_inv_sd is not None and bool(
        np.any(np.asarray(depth_inv_sd) > 0))
    pmax = problem.cam.shape[1]
    return dict(
        ptype=problem.ptype, pmax=pmax, with_depth=with_depth,
        rig_transform=rig_transform, rig_jac=rig_jac,
        canonical=isinstance(problem.ptype, str),
        generic=not kernel_route(problem.ptype, pmax, with_depth,
                                 rig_transform, rig_jac),
    )


# Each pose-graph family's fields ("name:kind", kind i(nt), f(loat) or
# b(ool)), the first naming the family's constraint count.
_GRAPH_FIELDS = (
    ("rm_i:i", "rm_j:i", "rm_si:i", "rm_sj:i", "rm_rvec:f", "rm_tvec:f",
     "rm_scale:f", "rm_inv_sd:f", "rm_obs_scale:b", "rm_loss_c:f"),
    ("rr_i:i", "rr_j:i", "rr_ri:i", "rr_rj:i", "rr_rvec:f", "rr_inv_sd:f",
     "rr_loss_c:f"),
    ("cp_i:i", "cp_j:i", "cp_ri:i", "cp_rj:i", "cp_margin:f", "cp_inv_sd:f"),
    ("lin_i0:i", "lin_i1:i", "lin_i2:i", "lin_r0:i", "lin_r1:i", "lin_r2:i",
     "lin_alpha:f", "lin_pos_inv_sd:f", "lin_rot_inv_sd:f"),
    ("hm_inst:i", "hm_rigcam:i", "hm_map:i", "hm_offset:f", "hm_inv_sd:f",
     "heatmaps:f", "hm_res:f"),
    ("gauge_i:i", "gauge_j:i", "gauge_norm:f"),
)


def device_problem(problem: BAProblem, dtype: torch.dtype,
                   device: torch.device):
    """Lay `problem` out for the solver (dense instance-slot grid when it
    fits, else the canonical (point, slot) layout; a map that mixes types
    keeps its type-sorted observations) and move it to `device`.
    Returns (laid-out problem, dense flag, state tuple (inst, rigcam, cam,
    points, scales), data dict);
    `solver_statics(problem, dense)` gives the rest of the solve's
    configuration."""
    problem = dataclasses.replace(problem, ptype=_single_ptype(problem.ptype))
    problem, dense = canonicalize_problem_dense(problem)

    def opt(x, default):
        return np.asarray(x) if x is not None else default

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)

    def b8(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.bool, device=device)

    num_obs = len(problem.obs_uv)
    state = (f(problem.inst), f(problem.rigcam), f(problem.cam),
             f(problem.points), f(opt(problem.scales, np.zeros(0))))
    data = {
        "obs_uv": f(problem.obs_uv),
        "obs_inv_sd": f(problem.obs_inv_sd),
        "obs_point": i32(problem.obs_point),
        "obs_inst": i32(problem.obs_inst),
        "obs_rigcam": i32(problem.obs_rigcam),
        "obs_cam": i32(problem.obs_cam),
        "point_obs": i32(problem.point_obs),
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
        "obs_depth": f(opt(problem.obs_depth, np.zeros(num_obs))),
        "obs_depth_inv_sd": f(opt(problem.obs_depth_inv_sd,
                                  np.zeros(num_obs))),
        "obs_depth_radial": b8(opt(problem.obs_depth_radial,
                                   np.zeros(num_obs, bool))),
    }
    if problem.point_prior_loss is not None and bool(
        np.any(np.asarray(problem.point_prior_loss) > 0)
    ):
        data["point_prior_loss"] = f(problem.point_prior_loss)
    if problem.opt_scales is not None:
        data["opt_scales"] = b8(problem.opt_scales)
    cast = {"i": i32, "f": f, "b": b8}
    for fields in _GRAPH_FIELDS:
        head = getattr(problem, fields[0].split(":")[0])
        if head is None or np.asarray(head).shape[0] == 0:
            continue
        for spec in fields:
            name, kind = spec.split(":")
            data[name] = cast[kind](getattr(problem, name))
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
    """Run LM to convergence on `device` (CUDA unless told otherwise).  The
    result names the route its solve took: `fused_dense`, `dense` or
    `canonical` on the kernel route, `generic` otherwise.  With
    `compute_covariances` it carries the rig instances' marginal
    covariances (`_instance_covariances`)."""
    device = resolve_device(device)
    if device.type == "cuda":
        # Full-precision f32 products, as the reference's HIGHEST.
        torch.backends.cuda.matmul.allow_tf32 = False
    problem, dense, state, data = device_problem(problem, dtype, device)
    ni, nr, nc = len(problem.inst), len(problem.rigcam), len(problem.cam)
    statics = solver_statics(problem, dense)
    pmax = statics.pop("pmax")
    if statics["generic"]:
        route = "generic"
    elif _fused_dense(state[3], ni, pmax, dense):
        route = "fused_dense"
    else:
        route = "dense" if dense else "canonical"

    context.record_dispatch("bundle_lm_solve")
    state, cost0, cost1, lam1, accepted = _lm_solve(
        state, data, initial_lambda, tol, int(max_iterations),
        loss=problem.loss, loss_threshold=float(problem.loss_threshold),
        pmax=pmax, ni=ni, nr=nr, nc=nc, dense=dense, **statics,
    )
    covariances, covariance_valid = None, False
    if compute_covariances:
        cov, valid = _instance_covariances(
            state, data, loss=problem.loss,
            loss_threshold=float(problem.loss_threshold), pmax=pmax, ni=ni,
            nr=nr, nc=nc, dense=dense, **statics)
        covariances, covariance_valid = cov.cpu().numpy(), bool(valid)
    return BAResult(
        inst=state[0].cpu().numpy(),
        rigcam=state[1].cpu().numpy(),
        cam=state[2].cpu().numpy(),
        points=state[3].cpu().numpy(),
        scales=state[4].cpu().numpy(),
        initial_cost=float(cost0),
        final_cost=float(cost1),
        iterations=int(accepted),
        lam=float(lam1),
        covariances=covariances,
        covariance_valid=covariance_valid,
        route=route,
    )
