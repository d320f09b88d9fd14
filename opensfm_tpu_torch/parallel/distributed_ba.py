"""Distributed Schur-complement bundle adjustment over a mesh of shards.

Port of `opensfm_tpu.parallel.distributed_ba`.  Points (and their
observations) are partitioned across the shards of a `Mesh`; camera-side
parameters are replicated.  Each shard:

1. computes residuals and Jacobians for its observations;
2. assembles its local point systems Hpp, bp (a point's observations all
   live on one shard);
3. reduces its contribution to the Schur camera system S and RHS b;
4. sums (S, b) over the mesh (`Mesh.psum`, the only collective);
5. solves the replicated reduced system and back-substitutes its points.

The JAX package runs one program per device under `shard_map`; here each
function body runs once per local shard, one shard after another on its
device's stream (a virtual mesh puts several shards on one card), with
`Mesh.psum` at the points where the JAX package calls `jax.lax.psum`.  The
replicated work after a sum runs once on the mesh's first device and is
handed to every shard (`Mesh.replicate`).  So the cost kernels' per-device
ticket counter (`ops/kernels/ba_resjac._ticket`) never sees two cost calls
at once on one device.

The solvers, chosen as the JAX package chooses them
(`bundle_adjust_sharded`):
- "dense": mono perspective maps on the zero-padded [NP, NI] instance-slot
  grid; per shard, the fused assembly (`fused_schur_assembly`), the
  back-substitution (`fused_back_substitute`) and the cost
  (`fused_cost_dense`) kernels of the single-device fast path;
- "schur": the reduced system assembled per shard from the shared
  linearization (`_linearize_local`), summed once per trial, solved by
  Cholesky; with the pose-graph families and scale variables;
- "cg": matrix-free block-Jacobi PCG on the Schur complement, one sum of
  the camera-side vectors per iteration;
- `make_sharded_lm_step`: the original replicated-dense step.
The sparse routes' accept/reject cost (`make_sharded_cost`) runs the
`fused_cost` kernel per shard on mono perspective maps.

The `make_*` functions keep the JAX package's signatures, `axis` (the
mesh axis name; a `Mesh` has one) and the sizes a body does not need
included, so that a caller of one package calls the other alike.  Each
returns a callable taking the global arrays in its `names` order, as the
JAX package's `shard_map`-ed functions do; the damping loop runs one
trial a host step (`_Damping`) where the JAX package runs a block of
trials in a device `while_loop`, with the same policy and trajectory.

The per-observation Jacobians are the JAX package's `jacfwd`: one batched
forward-mode push (`torch.func`) over every tangent direction, as the
single-device generic route does.  Where the JAX package branches on the
TPU (one-hot products on the MXU), the plain branch is taken: gathers and
`index_add_`.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from opensfm_tpu_torch import context
from opensfm_tpu_torch.ba import lm as _lm
from opensfm_tpu_torch.ba.lm import BAProblem, BAResult, LOSSES
from opensfm_tpu_torch.geometry import cameras as cam_lib
from opensfm_tpu_torch.geometry import rotation as rot
from opensfm_tpu_torch.ops import linalg
from opensfm_tpu_torch.ops.kernels.ba_resjac import fused_cost
from opensfm_tpu_torch.parallel.mesh import Mesh, default_mesh

# f64 accumulation islands for the objective sums and CG dot products (the
# JAX package's `_acc_dtype` under x64).
_ACC = torch.float64


def _p2(n: int, floor: int = 1) -> int:
    return max(floor, 1 << int(max(n, 1) - 1).bit_length())


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.float32 if np.dtype(dtype) == np.float32 else torch.float64


def _segsum(x, idx, n):
    """segment_sum: rows of x summed into n segments by idx."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, idx, x)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def shard_problem(problem: BAProblem, n_shards: int) -> BAProblem:
    """Re-layout a BAProblem so points (and their observations) shard
    contiguously: points in n equal groups, each group's observations one
    contiguous, equally sized block (padded with zero-weight rows), sizes in
    power-of-two buckets.

    When the track lengths allow it (<= 1.6x observation inflation), the
    observations land in uniform per-point windows of `cg_window` slots
    (long tracks spill into consecutive windows) and `cg_virt2real` maps
    each window to its point; the layout stays sorted by point.  Mixed
    projection types carry a per-observation type index (`obs_ptype`,
    `cg_ptypes`).  The same layout as the JAX package's, element for
    element."""
    npts = len(problem.points)
    pts_per_shard = _p2(-(-npts // n_shards), floor=64)
    np_pad = pts_per_shard * n_shards

    valid = np.asarray(problem.obs_inv_sd) > 0
    o_idx = np.flatnonzero(valid)
    pts = np.asarray(problem.obs_point)[o_idx]
    order = np.argsort(pts, kind="stable")
    o_idx = o_idx[order]
    pts = pts[order]

    counts = np.bincount(pts, minlength=np_pad)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_in_point = np.arange(len(pts)) - starts[pts]
    T = max(int(counts.max(initial=1)), 1)

    shard_of_point = np.arange(np_pad) // pts_per_shard
    shard_point0 = np.arange(n_shards) * pts_per_shard
    pos_counts = counts[counts > 0]
    med = int(np.median(pos_counts)) if len(pos_counts) else 1
    T_w = int(min(64, max(4, _p2(med))))
    n_win = -(-counts // T_w)
    inflation = float((n_win * T_w).sum()) / max(len(pts), 1)
    use_windows = inflation <= 1.6

    shard_of = pts // pts_per_shard
    if use_windows:
        wins_per_shard = np.bincount(
            shard_of_point, weights=n_win, minlength=n_shards
        ).astype(np.int64)
        win_per_shard = _p2(
            int(wins_per_shard.max(initial=1)), floor=max(1, 256 // T_w)
        )
        obs_per_shard = win_per_shard * T_w
        O_new = obs_per_shard * n_shards
        prefix_all = np.concatenate([[0], np.cumsum(n_win)[:-1]])
        win_in_shard = prefix_all - prefix_all[shard_point0][shard_of_point]
        new_pos = (
            shard_of * obs_per_shard
            + (win_in_shard[pts] + slot_in_point // T_w) * T_w
            + slot_in_point % T_w
        )
        # Padding windows point at the shard's last point, so each shard's
        # window -> point map stays non-decreasing.
        virt2real = np.repeat(shard_point0 + pts_per_shard - 1,
                              win_per_shard)
        p_nz = np.flatnonzero(n_win > 0)
        if len(p_nz):
            rep_pts = np.repeat(p_nz, n_win[p_nz])
            within = np.arange(len(rep_pts)) - np.repeat(
                np.concatenate([[0], np.cumsum(n_win[p_nz])[:-1]]),
                n_win[p_nz],
            )
            vrows = (shard_of_point[rep_pts] * win_per_shard
                     + win_in_shard[rep_pts] + within)
            virt2real[vrows] = rep_pts
    else:
        T_w = 0
        virt2real = None
        obs_count_per_shard = np.bincount(shard_of, minlength=n_shards)
        obs_per_shard = _p2(int(obs_count_per_shard.max(initial=0)),
                            floor=256)
        O_new = obs_per_shard * n_shards
        shard_starts = np.concatenate(
            [[0], np.cumsum(obs_count_per_shard)[:-1]])
        rank_in_shard = np.arange(len(pts)) - shard_starts[shard_of]
        new_pos = shard_of * obs_per_shard + rank_in_shard

    # Padding rows keep obs_point on a shard-local point, non-decreasing
    # within each shard.
    if use_windows:
        obs_point = np.repeat(virt2real, T_w)
    else:
        obs_point = np.repeat(
            np.arange(1, n_shards + 1, dtype=np.int64) * pts_per_shard - 1,
            obs_per_shard,
        )
    obs_uv = np.zeros((O_new, 2))
    obs_inv_sd = np.zeros(O_new)
    obs_inst = np.zeros(O_new, np.int64)
    obs_rigcam = np.zeros(O_new, np.int64)
    obs_cam = np.zeros(O_new, np.int64)
    point_obs = np.full((np_pad, T), O_new, dtype=np.int64)

    obs_uv[new_pos] = np.asarray(problem.obs_uv)[o_idx]
    obs_inv_sd[new_pos] = np.asarray(problem.obs_inv_sd)[o_idx]
    obs_point[new_pos] = pts
    obs_inst[new_pos] = np.asarray(problem.obs_inst)[o_idx]
    obs_rigcam[new_pos] = np.asarray(problem.obs_rigcam)[o_idx]
    obs_cam[new_pos] = np.asarray(problem.obs_cam)[o_idx]
    point_obs[pts, slot_in_point] = new_pos

    def relayout_obs(arr, fill=0.0):
        if arr is None:
            return None
        arr = np.asarray(arr)
        out = np.full((O_new,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[new_pos] = arr[o_idx]
        return out

    def pad_points(arr, fill=0.0):
        out = np.full((np_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[: len(arr)] = arr
        return out

    sharded = BAProblem(
        inst=problem.inst, rigcam=problem.rigcam, cam=problem.cam,
        points=pad_points(np.asarray(problem.points)),
        obs_uv=obs_uv, obs_inv_sd=obs_inv_sd, obs_point=obs_point,
        obs_inst=obs_inst, obs_rigcam=obs_rigcam, obs_cam=obs_cam,
        point_obs=point_obs,
        gps_pos=problem.gps_pos, gps_inv_sd=problem.gps_inv_sd,
        cam_prior=problem.cam_prior, cam_prior_inv_sd=problem.cam_prior_inv_sd,
        cam_log_mask=problem.cam_log_mask,
        rigcam_prior=problem.rigcam_prior,
        rigcam_prior_inv_sd=problem.rigcam_prior_inv_sd,
        point_prior=pad_points(np.asarray(problem.point_prior)),
        point_prior_inv_sd=pad_points(np.asarray(problem.point_prior_inv_sd)),
        point_prior_loss=(
            pad_points(np.asarray(problem.point_prior_loss))
            if problem.point_prior_loss is not None else None
        ),
        opt_inst=problem.opt_inst, opt_rigcam=problem.opt_rigcam,
        opt_cam=problem.opt_cam,
        opt_points=pad_points(np.asarray(problem.opt_points)),
        ptype=problem.ptype if isinstance(problem.ptype, str)
        else problem.ptype[0][0],
        loss=problem.loss, loss_threshold=problem.loss_threshold,
        obs_depth=relayout_obs(problem.obs_depth),
        obs_depth_inv_sd=relayout_obs(problem.obs_depth_inv_sd),
        obs_depth_radial=relayout_obs(problem.obs_depth_radial, False),
        up_inst=problem.up_inst, up_rigcam=problem.up_rigcam,
        up_vec=problem.up_vec, up_inv_sd=problem.up_inv_sd,
        ang_kind=problem.ang_kind, ang_inst=problem.ang_inst,
        ang_rigcam=problem.ang_rigcam, ang_value=problem.ang_value,
        ang_inv_sd=problem.ang_inv_sd,
    )
    sharded.cg_window = T_w
    sharded.cg_virt2real = virt2real
    for f in _GRAPH_PASSTHROUGH:
        setattr(sharded, f, getattr(problem, f, None))
    if not isinstance(problem.ptype, str):
        types = tuple(sorted({t for t, _, _ in problem.ptype}))
        per_obs = np.zeros(len(problem.obs_uv), np.int32)
        for t, s_, e_ in problem.ptype:
            per_obs[s_:e_] = types.index(t)
        sharded.obs_ptype = relayout_obs(per_obs)
        sharded.cg_ptypes = types
    else:
        sharded.obs_ptype = None
        sharded.cg_ptypes = (problem.ptype,)
    return sharded


def shard_problem_dense(problem: BAProblem, n_shards: int,
                        max_waste: int = 8, max_slots: int = 1 << 22):
    """Densify (slot == instance) and pad the points so each shard holds an
    equal, 128-multiple block of points (the dense kernels' tile condition
    holds per shard).  Returns (problem, per_shard_points)."""
    problem, dense = _lm.canonicalize_problem_dense(
        problem, max_waste=max_waste, max_slots=max_slots)
    if not dense:
        raise ValueError("problem is not densifiable (mono single-camera)")
    ni = len(problem.inst)
    npts = len(problem.points)
    per_shard = -(-npts // n_shards)
    per_shard = ((per_shard + 127) // 128) * 128
    np_pad = per_shard * n_shards
    if np_pad != npts:
        def pad_pts(a, fill=0.0):
            a = np.asarray(a)
            out = np.full((np_pad,) + a.shape[1:], fill, dtype=a.dtype)
            out[:npts] = a
            return out

        def pad_obs(a, fill=0.0):
            a = np.asarray(a)
            out = np.full((np_pad * ni,) + a.shape[1:], fill, dtype=a.dtype)
            out[: npts * ni] = a
            return out

        problem = dataclasses.replace(
            problem,
            points=pad_pts(problem.points),
            point_prior=pad_pts(problem.point_prior),
            point_prior_inv_sd=pad_pts(problem.point_prior_inv_sd),
            point_prior_loss=(
                pad_pts(problem.point_prior_loss)
                if problem.point_prior_loss is not None else None
            ),
            opt_points=pad_pts(problem.opt_points, False),
            obs_uv=pad_obs(problem.obs_uv),
            obs_inv_sd=pad_obs(problem.obs_inv_sd),
            obs_point=np.repeat(np.arange(np_pad, dtype=np.int64), ni),
            obs_inst=np.tile(np.arange(ni, dtype=np.int64), np_pad),
            obs_rigcam=np.zeros(np_pad * ni, dtype=np.int64),
            obs_cam=np.zeros(np_pad * ni, dtype=np.int64),
            point_obs=np.arange(np_pad * ni, dtype=np.int64).reshape(
                np_pad, ni),
        )
    return problem, per_shard


# ---------------------------------------------------------------------------
# Running a function over the shards
# ---------------------------------------------------------------------------


def _split(mesh: Mesh, a: dict, sharded) -> list:
    """One dict per local shard: the names in `sharded` cut into the mesh's
    equal blocks along their first axis (the shard's global block), every
    other array whole; each on its shard's device."""
    shards = []
    for j, sid in enumerate(mesh.shard_ids):
        dev = mesh.devices[j]
        d = {}
        for k, v in a.items():
            v = torch.as_tensor(v)
            if k in sharded:
                n = v.shape[0] // mesh.n_shards
                v = v[sid * n:(sid + 1) * n]
            d[k] = v.to(dev)
        shards.append(d)
    return shards


def _replicated(mesh: Mesh, tensors) -> list:
    """Per-output lists (one entry per local shard) of replicated
    tensors."""
    return [list(x) for x in zip(*mesh.replicate(tuple(tensors)))]


class _ShardedFn:
    """A function over the mesh, called with global arrays in `names`
    order as the JAX package's `shard_map`-ed functions are: the arrays in
    `sharded` are cut per shard, `local(shards)` returns one list (a value
    per local shard) per output, and `out_sharded[k]` says whether output k
    is sharded (gathered over the mesh) or replicated (shard 0's value)."""

    def __init__(self, mesh, names, sharded, local, out_sharded):
        self.mesh = mesh
        self.names = tuple(names)
        self.sharded = frozenset(sharded)
        self.local = local
        self.out_sharded = tuple(out_sharded)

    def __call__(self, *args):
        if len(args) != len(self.names):
            raise TypeError(f"expected {len(self.names)} arguments "
                            f"({', '.join(self.names)}), got {len(args)}")
        shards = _split(self.mesh, dict(zip(self.names, args)), self.sharded)
        return self.join(self.local(shards))

    def join(self, outs):
        res = tuple(self.mesh.allgather(o) if sh else o[0]
                    for o, sh in zip(outs, self.out_sharded))
        return res[0] if len(res) == 1 else res


# ---------------------------------------------------------------------------
# The replicated-dense sharded step
# ---------------------------------------------------------------------------

_LM_STEP_NAMES = (
    "inst", "rigcam", "cam", "points", "obs_uv", "obs_inv_sd", "obs_point",
    "obs_inst", "obs_rigcam", "obs_cam", "point_obs", "gps_pos",
    "gps_inv_sd", "opt_inst", "opt_cam", "opt_points", "lam", "point_base",
)
_LM_STEP_SHARDED = frozenset((
    "points", "obs_uv", "obs_inv_sd", "obs_point", "obs_inst", "obs_rigcam",
    "obs_cam", "point_obs", "opt_points", "point_base",
))


def _gps_rows(inst, gps_pos, gps_inv_sd):
    """GPS rows on the instance origins and their Jacobian [NI, 3, 6]."""
    r, (J,) = _lm._push_rows(
        lambda i6, pos, inv: (_lm._origin(i6) - pos) * inv,
        (inst,), (gps_pos, gps_inv_sd[:, None]))
    return r, J


def make_sharded_lm_step(mesh: Mesh, axis: str, ptype: str, pmax: int,
                         ni: int, nr: int, nc: int,
                         loss: str = "SoftLOneLoss",
                         loss_threshold: float = 1.0):
    """The replicated-dense sharded LM step: step(inst, rigcam, cam, points,
    obs_uv, obs_inv_sd, obs_point, obs_inst, obs_rigcam, obs_cam, point_obs,
    gps_pos, gps_inv_sd, opt_inst, opt_cam, opt_points, lam, point_base) ->
    (new_inst, new_cam, new_points).  Each shard reduces its part of the
    dense [D, D] camera system (rig cameras fixed), the parts are summed,
    and the replicated system is solved by QR.  `axis` names the mesh axis
    (the port's mesh has one)."""
    dc = ni * 6 + nr * 6 + nc * pmax
    n_dev = float(mesh.n_shards)
    rho_drho = LOSSES[loss]
    a2 = loss_threshold * loss_threshold

    def local(shards):
        parts, keep = [], []
        for a in shards:
            inst, rigcam, cam, points = (a["inst"], a["rigcam"], a["cam"],
                                         a["points"])
            dtype, dev, lam = points.dtype, points.device, a["lam"]
            np_local = points.shape[0]
            oi, orc, oc = (a["obs_inst"].long(), a["obs_rigcam"].long(),
                           a["obs_cam"].long())
            lp = (a["obs_point"] - a["point_base"][0]).long()
            uv, inv_sd = a["obs_uv"], a["obs_inv_sd"]

            def res(combo, X):
                Xc = _lm._transform_rig(combo[:, 0:6], combo[:, 6:12], X)
                pred = cam_lib.project_torch(ptype, Xc,
                                             combo[:, 12:12 + pmax])
                return (pred - uv) * inv_sd[:, None]

            combo = torch.cat([inst[oi], rigcam[orc], cam[oc]], dim=1)
            D = combo.shape[1]
            r, J = _lm._push_directions(res, combo, points[lp],
                                        list(range(D + 3)))
            Jc, Jp = J[..., :D], J[..., D:]
            s = torch.sum(r * r, dim=-1)
            sw = torch.sqrt(torch.clamp_min(rho_drho[1](s / a2), 1e-12))
            r = r * sw[:, None]
            Jc = Jc * sw[:, None, None]
            opt_p = a["opt_points"]
            Jp = Jp * sw[:, None, None] * opt_p[lp].to(dtype)[:, None, None]

            O = r.shape[0]
            ar6 = torch.arange(6, device=dev)
            arp = torch.arange(pmax, device=dev)
            cols_i = torch.where(a["opt_inst"][oi][:, None],
                                 oi[:, None] * 6 + ar6[None, :], dc)
            cols_r = torch.full((O, 6), dc, device=dev)
            cols_c = torch.where(a["opt_cam"][oc],
                                 ni * 6 + nr * 6 + oc[:, None] * pmax
                                 + arp[None, :], dc)
            cols = torch.cat([cols_i, cols_r, cols_c], dim=1)

            S = torch.zeros((dc + 1, dc + 1), dtype=dtype, device=dev)
            b = torch.zeros(dc + 1, dtype=dtype, device=dev)
            S.index_put_((cols[:, :, None], cols[:, None, :]),
                         torch.einsum("oki,okj->oij", Jc, Jc),
                         accumulate=True)
            b.index_put_((cols,), torch.einsum("oki,ok->oi", Jc, r),
                         accumulate=True)
            Hpp = _segsum(torch.einsum("oki,okj->oij", Jp, Jp), lp, np_local)
            bp = _segsum(torch.einsum("oki,ok->oi", Jp, r), lp, np_local)
            eye3 = torch.eye(3, dtype=dtype, device=dev)
            Hpp = Hpp + lam * torch.diag_embed(
                torch.diagonal(Hpp, dim1=1, dim2=2)) + 1e-12 * eye3
            Hpp_inv = linalg.inv3(Hpp) * opt_p.to(dtype)[:, None, None]

            G = torch.einsum("oki,okj->oij", Jc, Jp)
            W = torch.zeros((dc + 1, np_local, 3), dtype=dtype, device=dev)
            W.index_put_((cols[:, :, None], lp[:, None, None],
                          torch.arange(3, device=dev)[None, None, :]),
                         G, accumulate=True)
            Hib = torch.einsum("pij,pj->pi", Hpp_inv, bp)
            b = b - torch.einsum("dpk,pk->d", W, Hib)
            WH = torch.einsum("dpk,pkl->dpl", W, Hpp_inv)
            S = S - WH.reshape(dc + 1, -1) @ W.reshape(dc + 1, -1).T

            # GPS rows: identical on every shard, divided by the shard count
            # so that the sum restores their weight.
            gr, gJ = _gps_rows(inst, a["gps_pos"], a["gps_inv_sd"])
            base = (torch.arange(ni, device=dev)[:, None] * 6
                    + torch.arange(6, device=dev)[None, :])
            pcols = torch.where(a["opt_inst"][:, None], base, dc)
            S.index_put_((pcols[:, :, None], pcols[:, None, :]),
                         torch.einsum("nki,nkj->nij", gJ, gJ) / n_dev,
                         accumulate=True)
            b.index_put_((pcols,),
                         torch.einsum("nki,nk->ni", gJ, gr) / n_dev,
                         accumulate=True)
            parts.append((S, b))
            keep.append((W, Hpp_inv, bp))

        S, b = mesh.psum(parts)[0]
        lam = shards[0]["lam"]
        S = S + torch.diag(lam * torch.diagonal(S) + 1e-10)
        S = 0.5 * (S + S.T)
        S[dc, :] = 0.0
        S[:, dc] = 0.0
        S[dc, dc] = 1.0
        b = b.clone()
        b[dc] = 0.0
        dx_c = linalg.solve_qr(S, b)
        dxc = dx_c[:dc]
        d_inst = dxc[: ni * 6].reshape(ni, 6)
        d_cam = dxc[ni * 6 + nr * 6:].reshape(nc, pmax)
        new_inst, new_cam = _replicated(
            mesh, (shards[0]["inst"] - d_inst, shards[0]["cam"] - d_cam))
        points = []
        for a, (W, Hpp_inv, bp), (dx,) in zip(shards, keep,
                                              mesh.replicate((dx_c,))):
            u = torch.einsum("dpk,d->pk", W, dx)
            points.append(a["points"]
                          - torch.einsum("pij,pj->pi", Hpp_inv, bp - u))
        return new_inst, new_cam, points

    return _ShardedFn(mesh, _LM_STEP_NAMES, _LM_STEP_SHARDED, local,
                      (False, False, True))


# ---------------------------------------------------------------------------
# The dense-grid route: the single-device fused assembly per shard, one sum
# of the block families, the replicated epilogue and solve, shard-local
# back-substitution.
# ---------------------------------------------------------------------------

_SHOT_ROW_KEYS = ("up_inst", "up_rigcam", "up_vec", "up_inv_sd", "ang_kind",
                  "ang_inst", "ang_rigcam", "ang_value", "ang_inv_sd")


def _dense_grid_data(a, ni, with_pp_loss=False):
    """The `ba/lm.py` data dict for a shard's dense [np_local, NI] grid,
    with the index arrays rebuilt shard-locally.  The shot-row arrays
    (up-vector, pan/tilt/roll) are required: a caller with none passes empty
    ones."""
    points = a["points"]
    np_local = points.shape[0]
    num_obs = np_local * ni
    dev = points.device
    izeros = torch.zeros(num_obs, dtype=torch.int32, device=dev)
    data = dict(
        obs_uv=a["obs_uv"], obs_inv_sd=a["obs_inv_sd"],
        obs_point=torch.arange(np_local, dtype=torch.int32,
                               device=dev).repeat_interleave(ni),
        obs_inst=torch.arange(ni, dtype=torch.int32,
                              device=dev).repeat(np_local),
        obs_rigcam=izeros, obs_cam=izeros,
        point_obs=torch.arange(num_obs, dtype=torch.int32,
                               device=dev).reshape(np_local, ni),
        obs_depth=torch.zeros(num_obs, dtype=points.dtype, device=dev),
        obs_depth_inv_sd=torch.zeros(num_obs, dtype=points.dtype,
                                     device=dev),
        obs_depth_radial=torch.zeros(num_obs, dtype=torch.bool, device=dev),
    )
    for k in ("gps_pos", "gps_inv_sd", "cam_prior", "cam_prior_inv_sd",
              "cam_log_mask", "rigcam_prior", "rigcam_prior_inv_sd",
              "point_prior", "point_prior_inv_sd", "opt_inst", "opt_rigcam",
              "opt_cam", "opt_points") + _SHOT_ROW_KEYS:
        data[k] = a[k]
    if with_pp_loss:
        data["point_prior_loss"] = a["point_prior_loss"]
    return data


def _dense_grid_step(mesh, states, datas, lam, ni, nr, nc, pmax, loss,
                     loss_threshold):
    """One dense-grid LM step over the local shards: per shard the reduced
    system's block families (`lm._build_reduced_system(..., raw_blocks=
    True)`: the fused assembly kernel on the card), ONE sum of the
    families, the replicated priors/damping epilogue and QR solve, and the
    shard-local back-substitution (the back-substitution kernel).  Returns
    (inst, cam, points) as per-shard lists."""
    built = [
        _lm._build_reduced_system(st, d, lam, loss, loss_threshold, pmax, ni,
                                  nr, nc, dense=True, raw_blocks=True)
        for st, d in zip(states, datas)
    ]
    blocks = mesh.psum([blk for blk, _ in built])[0]
    S, b = _lm._assemble_S(states[0], datas[0], lam, *blocks, ni, nr, nc,
                           pmax)
    # QR: the f32 sum of the shards' Schur complements can be indefinite at
    # roundoff scale, which NaNs a Cholesky factor.
    dx_c = linalg.solve_qr(S, b)
    di, dr = ni * 6, nr * 6
    dx_i = dx_c[:di].reshape(ni, 6)
    dx_r = dx_c[di:di + dr].reshape(nr, 6)
    dx_cam = dx_c[di + dr:].reshape(nc, pmax)
    inst, cam = _replicated(mesh, (states[0][0] - dx_i,
                                   states[0][2] - dx_cam))
    points = []
    for st, (_, back), (di_, dr_, dc_) in zip(
            states, built, mesh.replicate((dx_i, dx_r, dx_cam))):
        points.append(st[3] - _lm._back_substitute(back, di_, dc_, ni, pmax,
                                                   dx_r=dr_))
    return inst, cam, points


def _replicated_prior_cost(inst, rigcam, cam, data):
    """The replicated prior families' objective (GPS, camera and rig-camera
    priors, the Cauchy(1) shot rows) in the accumulation dtype."""
    total = torch.zeros((), dtype=_ACC, device=inst.device)
    for pr, _, _ in _lm._prior_residuals((inst, rigcam, cam, None), data,
                                         with_jac=False):
        total = total + 0.5 * torch.sum((pr * pr).to(_ACC))
    rho_c = LOSSES["CauchyLoss"][0]
    for pr in _lm._shot_prior_residuals((inst, rigcam), data, raw=True):
        s = torch.sum((pr * pr).to(_ACC), dim=-1)
        total = total + torch.sum(0.5 * rho_c(s))
    return total


def _dense_grid_cost(mesh, states, datas, loss, loss_threshold):
    """Total objective over the dense-grid layout: each shard's observation
    and point-prior cost (`lm._total_cost` with the replicated families'
    inv_sd zeroed, so they add exactly 0; the dense cost kernel on the
    card), summed, plus the replicated families added once.  A replicated
    0-d tensor per shard."""
    local = []
    for st, d in zip(states, datas):
        zeroed = dict(d)
        for k in ("gps_inv_sd", "cam_prior_inv_sd", "rigcam_prior_inv_sd",
                  "up_inv_sd", "ang_inv_sd"):
            zeroed[k] = torch.zeros_like(d[k])
        c = _lm._total_cost(st, zeroed, loss, loss_threshold, dense=True)
        local.append((c.to(_ACC),))
    (total,) = mesh.psum(local)[0]
    inst, rigcam, cam, _ = states[0]
    total = total + _replicated_prior_cost(inst, rigcam, cam, datas[0])
    return [x for (x,) in mesh.replicate((total,))]


_DENSE_STEP_NAMES = (
    "inst", "rigcam", "cam", "points", "obs_uv", "obs_inv_sd",
    "point_prior", "point_prior_inv_sd", "opt_points",
    "gps_pos", "gps_inv_sd", "cam_prior", "cam_prior_inv_sd",
    "cam_log_mask", "rigcam_prior", "rigcam_prior_inv_sd",
    "opt_inst", "opt_rigcam", "opt_cam", "lam",
)


def _no_shot_rows(a):
    """Empty up-vector and pan/tilt/roll arrays, for a signature that
    carries none."""
    dt, dev = a["points"].dtype, a["points"].device
    i0 = torch.zeros(0, dtype=torch.int32, device=dev)
    f0 = torch.zeros(0, dtype=dt, device=dev)
    return dict(up_inst=i0, up_rigcam=i0,
                up_vec=torch.zeros((0, 3), dtype=dt, device=dev),
                up_inv_sd=f0, ang_kind=i0, ang_inst=i0, ang_rigcam=i0,
                ang_value=f0, ang_inv_sd=f0)


def make_sharded_lm_step_dense(mesh: Mesh, axis: str, ni: int, nr: int,
                               nc: int, pmax: int,
                               loss: str = "SoftLOneLoss",
                               loss_threshold: float = 1.0):
    """One distributed LM step over the dense instance-slot layout
    (`shard_problem_dense`): per shard the single-device fast path's
    assembly (`_build_reduced_system(..., raw_blocks=True)`: the fused
    assembly kernel on the card), ONE sum of the block families, the
    replicated epilogue and solve, the shard-local back-substitution.

    step(inst, rigcam, cam, points, obs_uv, obs_inv_sd, point_prior,
    point_prior_inv_sd, opt_points, gps_pos, gps_inv_sd, cam_prior,
    cam_prior_inv_sd, cam_log_mask, rigcam_prior, rigcam_prior_inv_sd,
    opt_inst, opt_rigcam, opt_cam, lam) -> (inst, cam, points)."""

    def local(shards):
        states, datas = [], []
        for a in shards:
            datas.append(_dense_grid_data(dict(a, **_no_shot_rows(a)), ni))
            states.append((a["inst"], a["rigcam"], a["cam"], a["points"]))
        return _dense_grid_step(mesh, states, datas,
                                float(shards[0]["lam"]), ni, nr, nc, pmax,
                                loss, loss_threshold)

    return _ShardedFn(mesh, _DENSE_STEP_NAMES, _DENSE_SHARDED, local,
                      (False, False, True))


# ---------------------------------------------------------------------------
# The shared linearization of the CG and assembled-Schur steps
# ---------------------------------------------------------------------------


def _cam_prior_residual(cam, cam_prior, cam_prior_inv_sd, cam_log_mask):
    """Camera parameter prior rows (log-scale for focal and aspect,
    bundle_adjuster.cc:568-593)."""
    safe = torch.clamp_min(torch.abs(cam), 1e-12)
    safe_prior = torch.clamp_min(torch.abs(cam_prior), 1e-12)
    rlog = torch.log(safe) - torch.log(safe_prior)
    return torch.where(cam_log_mask, rlog, cam - cam_prior) * cam_prior_inv_sd


def _point_prior_terms(points, point_prior, point_prior_inv_sd,
                       point_prior_loss):
    """Per-point position-prior (GCP) contributions with the optional
    per-point Cauchy IRLS weight: (H_diag [NP, 3], rhs [NP, 3])."""
    pp_r = (points - point_prior) * point_prior_inv_sd
    s = torch.sum(pp_r * pp_r, dim=-1, keepdim=True)
    c = point_prior_loss[:, None]
    c2 = torch.where(c > 0, c * c, 1.0)
    w = torch.where(c > 0, 1.0 / (1.0 + s / c2), 1.0)
    return (w * point_prior_inv_sd * point_prior_inv_sd,
            w * point_prior_inv_sd * pp_r)


# Arrays sharded over the point axis (everything else replicates).
_CG_SHARDED = frozenset((
    "obs_ptype",
    "points", "obs_uv", "obs_inv_sd", "obs_point", "obs_inst", "obs_rigcam",
    "obs_cam", "obs_depth", "obs_depth_inv_sd", "obs_depth_radial",
    "point_prior", "point_prior_inv_sd", "point_prior_loss", "opt_points",
    "point_base", "virt2real",
))

# Pose-graph constraint families (bundle_adjuster.h:220-252), grouped by
# their gating field; a group's arrays join the step's signature when its
# gate is non-empty.
_GRAPH_GROUPS = (
    ("rm_i", ("rm_i", "rm_j", "rm_si", "rm_sj", "rm_rvec", "rm_tvec",
              "rm_scale", "rm_inv_sd", "rm_obs_scale", "rm_loss_c")),
    ("rr_i", ("rr_i", "rr_j", "rr_ri", "rr_rj", "rr_rvec", "rr_inv_sd",
              "rr_loss_c")),
    ("cp_i", ("cp_i", "cp_j", "cp_ri", "cp_rj", "cp_margin", "cp_inv_sd")),
    ("lin_i0", ("lin_i0", "lin_i1", "lin_i2", "lin_r0", "lin_r1", "lin_r2",
                "lin_alpha", "lin_pos_inv_sd", "lin_rot_inv_sd")),
    ("hm_inst", ("hm_inst", "hm_rigcam", "hm_map", "hm_offset", "hm_inv_sd",
                 "heatmaps", "hm_res")),
    ("gauge_i", ("gauge_i", "gauge_j", "gauge_norm")),
)
_GRAPH_INT_FIELDS = frozenset((
    "rm_i", "rm_j", "rm_si", "rm_sj", "rr_i", "rr_j", "rr_ri", "rr_rj",
    "cp_i", "cp_j", "cp_ri", "cp_rj", "lin_i0", "lin_i1", "lin_i2",
    "lin_r0", "lin_r1", "lin_r2", "hm_inst", "hm_rigcam", "hm_map",
    "gauge_i", "gauge_j",
))
_GRAPH_BOOL_FIELDS = frozenset(("rm_obs_scale",))
_GRAPH_PASSTHROUGH = tuple(
    f for _, fields in _GRAPH_GROUPS for f in fields
) + ("scales", "opt_scales")


def _graph_fields(problem) -> tuple:
    """The pose-graph field names present on this problem (the Schur
    step's signature descriptor)."""
    out = []
    for gate, fields in _GRAPH_GROUPS:
        arr = getattr(problem, gate, None)
        if arr is not None and np.asarray(arr).shape[0] > 0:
            out.extend(fields)
    return tuple(out)


def _cg_step_names(rig_mode: str, with_depth: bool, has_up: bool,
                   has_ang: bool, win: bool = False, mixed: bool = False,
                   graph: tuple = (), has_scales: bool = False):
    """Argument order of the CG and Schur steps.  With every feature off
    this is the 21-argument mono signature; `win` appends the window ->
    point map, `mixed` the per-observation type index, `graph` and
    `has_scales` the pose-graph arrays and scale variables."""
    names = ["inst"]
    if rig_mode != "none":
        names.append("rigcam")
    names += ["cam", "points", "obs_uv", "obs_inv_sd", "obs_point",
              "obs_inst"]
    if rig_mode != "none":
        names.append("obs_rigcam")
    names.append("obs_cam")
    if with_depth:
        names += ["obs_depth", "obs_depth_inv_sd", "obs_depth_radial"]
    names += ["gps_pos", "gps_inv_sd", "cam_prior", "cam_prior_inv_sd",
              "cam_log_mask"]
    if rig_mode == "opt":
        names += ["rigcam_prior", "rigcam_prior_inv_sd"]
    names += ["point_prior", "point_prior_inv_sd", "point_prior_loss"]
    if has_up:
        names += ["up_inst", "up_rigcam", "up_vec", "up_inv_sd"]
    if has_ang:
        names += ["ang_kind", "ang_inst", "ang_rigcam", "ang_value",
                  "ang_inv_sd"]
    names.append("opt_inst")
    if rig_mode == "opt":
        names.append("opt_rigcam")
    names += ["opt_cam", "opt_points", "lam", "point_base"]
    if win:
        names.append("virt2real")
    if mixed:
        names.append("obs_ptype")
    if has_scales:
        names += ["scales", "opt_scales"]
    names += list(graph)
    return tuple(names)


def _cg_cost_names(rig_mode: str, with_depth: bool, has_up: bool,
                   has_ang: bool, mixed: bool = False, graph: tuple = (),
                   has_scales: bool = False):
    drop = {"opt_inst", "opt_rigcam", "opt_cam", "opt_points", "lam",
            "opt_scales"}
    return tuple(
        n for n in _cg_step_names(rig_mode, with_depth, has_up, has_ang,
                                  mixed=mixed, graph=graph,
                                  has_scales=has_scales)
        if n not in drop
    )


def _shot_row_data(a):
    """The shot-row arrays of a shard dict, empty where the signature
    carries none."""
    out = _no_shot_rows(a)
    out.update({k: a[k] for k in _SHOT_ROW_KEYS if k in a})
    return out


def _obs_rows(ptype, pmax, rig_mode, with_depth, uv, inv_sd, rc6, dep,
              pto):
    """res(combo [O, D], X [O, 3]) -> [O, K]: the reprojection rows of the
    local observations through the rig chain (`rig_mode` "none", "fixed"
    with the constant rig cameras `rc6`, or "opt" with them in `combo`),
    every projection type of a mixed map selected per observation, the
    spherical seam wrapped, and with `dep` the depth row."""
    rig_opt = rig_mode == "opt"
    mixed = isinstance(ptype, tuple)

    def res(combo, X):
        Xi = rot.rotate(combo[:, 0:3], X) + combo[:, 3:6]
        if rig_opt:
            Xc = rot.rotate(combo[:, 6:9], Xi) + combo[:, 9:12]
            cp = combo[:, 12:12 + pmax]
        elif rig_mode == "fixed":
            Xc = rot.rotate(rc6[:, :3], Xi) + rc6[:, 3:6]
            cp = combo[:, 6:6 + pmax]
        else:
            Xc = Xi
            cp = combo[:, 6:6 + pmax]
        if mixed:
            pred = cam_lib.project_torch(ptype[0], Xc, cp)
            for ti, t in enumerate(ptype[1:], start=1):
                pred = torch.where((pto == ti)[:, None],
                                   cam_lib.project_torch(t, Xc, cp), pred)
            diff = pred - uv
            if "spherical" in ptype:
                sph = (pto == ptype.index("spherical"))[:, None]
                diff = torch.where(sph, diff - torch.round(diff), diff)
        else:
            diff = cam_lib.project_torch(ptype, Xc, cp) - uv
            if ptype == "spherical":
                diff = diff - torch.round(diff)
        out = diff * inv_sd[:, None]
        if with_depth:
            dval, dinv, drad = dep
            norm = torch.sqrt(torch.sum(Xc * Xc, dim=-1) + 1e-30)
            pd = torch.where(drad, norm, Xc[:, 2])
            out = torch.cat([out, ((pd - dval) * dinv)[:, None]], dim=1)
        return out

    return res


def _linearize_local(a, *, ptype, pmax, ni, nc, nr, loss, loss_threshold,
                     rig_mode, with_depth, has_up, has_ang, win, n_dev):
    """The shared per-shard linearization of the sharded CG and
    assembled-Schur steps: robust-whitened residuals and Jacobians over the
    shard's observations, its point systems (damped Hpp, bp, Hpp_inv), the
    replicated prior families (GPS, camera and rig-camera priors, the
    up-vector and pan/tilt/roll shot rows) divided by the shard count
    `n_dev` for the sum, the Schur RHS b (before the sum), and the point
    reductions (`preduce`, `pgather`: window reshape-sums or segment sums).
    Returns a SimpleNamespace."""
    rig_opt = rig_mode == "opt"
    inst, cam, points = a["inst"], a["cam"], a["points"]
    lam = a["lam"]
    dtype, dev = points.dtype, points.device
    rigcam = a.get("rigcam")
    if rigcam is None:
        rigcam = torch.zeros((1, 6), dtype=dtype, device=dev)
    obs_inst, obs_cam = a["obs_inst"].long(), a["obs_cam"].long()
    obs_rigcam = a.get("obs_rigcam")
    obs_rigcam = (torch.zeros_like(obs_inst) if obs_rigcam is None
                  else obs_rigcam.long())
    opt_inst, opt_cam_mask = a["opt_inst"], a["opt_cam"]
    opt_points, opt_rigcam = a["opt_points"], a.get("opt_rigcam")
    np_local = points.shape[0]
    local_point = (a["obs_point"] - a["point_base"][0]).long()

    # --- residuals + Jacobians over the local shard -----------------------
    if rig_opt:
        combo = torch.cat([inst[obs_inst], rigcam[obs_rigcam],
                           cam[obs_cam]], dim=1)
    else:
        combo = torch.cat([inst[obs_inst], cam[obs_cam]], dim=1)
    dep = ((a["obs_depth"], a["obs_depth_inv_sd"], a["obs_depth_radial"])
           if with_depth else None)
    res = _obs_rows(ptype, pmax, rig_mode, with_depth, a["obs_uv"],
                    a["obs_inv_sd"], rigcam[obs_rigcam], dep,
                    a.get("obs_ptype"))
    D = combo.shape[1]
    r, J = _lm._push_directions(res, combo, points[local_point],
                                list(range(D + 3)))
    Jc_all, Jp = J[..., :D], J[..., D:]
    # Robust IRLS weights: the projection rows share one weight; the depth
    # row carries its own.
    drho = LOSSES[loss][1]
    a2 = loss_threshold * loss_threshold
    w_proj = drho(torch.sum(r[:, :2] * r[:, :2], dim=-1) / a2)
    if with_depth:
        w = torch.stack([w_proj, w_proj, drho(r[:, 2] * r[:, 2] / a2)],
                        dim=1)
    else:
        w = w_proj[:, None].expand(r.shape)
    sw = torch.sqrt(torch.clamp_min(w, 1e-12))
    r = r * sw
    Jc_all = Jc_all * sw[..., None]
    Jp = Jp * sw[..., None]

    # Fixed-parameter masking (identity rows become dx == 0).
    opt_i6 = opt_inst[:, None].to(dtype) * torch.ones((1, 6), dtype=dtype,
                                                      device=dev)
    opt_cp = opt_cam_mask.to(dtype)
    Ji = Jc_all[:, :, 0:6] * opt_i6[obs_inst][:, None, :]
    if rig_opt:
        opt_r6 = opt_rigcam[:, None].to(dtype) * torch.ones(
            (1, 6), dtype=dtype, device=dev)
        Jr = Jc_all[:, :, 6:12] * opt_r6[obs_rigcam][:, None, :]
        Jcam = Jc_all[:, :, 12:12 + pmax] * opt_cp[obs_cam][:, None, :]
    else:
        opt_r6 = torch.zeros((0, 6), dtype=dtype, device=dev)
        Jr = None
        Jcam = Jc_all[:, :, 6:6 + pmax] * opt_cp[obs_cam][:, None, :]
    Jp = Jp * opt_points[local_point].to(dtype)[:, None, None]

    def sel_i(v):
        return v[obs_inst]

    def sel_c(v):
        return v[obs_cam]

    def sel_r(v):
        return v[obs_rigcam]

    def red_i(s):
        return _segsum(s, obs_inst, ni)

    def red_c(s):
        return _segsum(s, obs_cam, nc)

    def red_r(s):
        return _segsum(s, obs_rigcam, nr)

    # --- point-side reductions --------------------------------------------
    O_local = obs_inst.shape[0]
    if win > 0:
        n_win_local = O_local // win
        v2r_local = (a["virt2real"] - a["point_base"][0]).long()

        def preduce(s):
            sw_ = s.reshape((n_win_local, win) + tuple(s.shape[1:])).sum(1)
            return _segsum(sw_, v2r_local, np_local)

        def pgather(w_):
            wv = w_[v2r_local]
            return wv[:, None].expand(
                (n_win_local, win) + tuple(w_.shape[1:])
            ).reshape((O_local,) + tuple(w_.shape[1:]))
    else:
        n_win_local = 0
        v2r_local = None

        def preduce(s):
            return _segsum(s, local_point, np_local)

        def pgather(w_):
            return w_[local_point]

    # --- point system -----------------------------------------------------
    Hpp = preduce(torch.einsum("oki,okj->oij", Jp, Jp))
    bp = preduce(torch.einsum("oki,ok->oi", Jp, r))
    pp_H, pp_rhs = _point_prior_terms(points, a["point_prior"],
                                      a["point_prior_inv_sd"],
                                      a["point_prior_loss"])
    Hpp = Hpp + torch.diag_embed(pp_H)
    bp = bp + pp_rhs
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    # Floor scaled to the working precision (1e-12 is below f32 eps at the
    # typical Hpp diagonal).
    floor = 1e-12 if dtype == torch.float64 else 1e-6
    Hpp = Hpp + lam * torch.diag_embed(
        torch.diagonal(Hpp, dim1=1, dim2=2)) + floor * eye3
    Hpp_inv = linalg.inv3(Hpp) * opt_points.to(dtype)[:, None, None]

    # --- replicated prior families, divided for the sum ---------------------
    gr, gJ = _gps_rows(inst, a["gps_pos"], a["gps_inv_sd"])
    gJ = gJ * opt_i6[:, None, :]
    gps_blocks = torch.einsum("nki,nkj->nij", gJ, gJ) / n_dev
    gps_rhs = torch.einsum("nki,nk->ni", gJ, gr) / n_dev

    cp_r, (cp_J,) = _lm._push_rows(
        _cam_prior_residual, (cam,),
        (a["cam_prior"], a["cam_prior_inv_sd"], a["cam_log_mask"]))
    cp_J = cp_J * opt_cp[:, None, :]
    cprior_blocks = torch.einsum("nki,nkj->nij", cp_J, cp_J) / n_dev
    cprior_rhs = torch.einsum("nki,nk->ni", cp_J, cp_r) / n_dev

    if rig_opt:
        rc_r, (rc_J,) = _lm._push_rows(
            lambda x, prior, inv: (x - prior) * inv, (rigcam,),
            (a["rigcam_prior"], a["rigcam_prior_inv_sd"]))
        rc_J = rc_J * opt_r6[:, None, :]
        rcprior_blocks = torch.einsum("nki,nkj->nij", rc_J, rc_J) / n_dev
        rcprior_rhs = torch.einsum("nki,nk->ni", rc_J, rc_r) / n_dev
    else:
        rcprior_blocks = rcprior_rhs = None

    # Shot rows couple ONE instance and ONE rig camera: their exact
    # Gauss-Newton action factors through per-row blocks.
    shot_rows = []
    if has_up or has_ang:
        for r_u, Ji_u, Jr_u, idx_i, idx_r in _lm._shot_prior_residuals(
                (inst, rigcam), _shot_row_data(a), rig_jac=rig_opt):
            idx_i, idx_r = idx_i.long(), idx_r.long()
            Ji_u = Ji_u * opt_inst[idx_i].to(dtype)[:, None, None]
            Jr_m = (Jr_u * opt_rigcam[idx_r].to(dtype)[:, None, None]
                    if rig_opt else None)
            shot_rows.append((r_u, Ji_u, Jr_m, idx_i, idx_r))

    # --- RHS: b = Jc^T r - Gamma Hpp^-1 bp ------------------------------------
    Hib = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    t_rhs = r - torch.einsum("okj,oj->ok", Jp, pgather(Hib))
    b_i = _segsum(torch.einsum("oki,ok->oi", Ji, t_rhs), obs_inst, ni) \
        + gps_rhs
    b_c = _segsum(torch.einsum("oki,ok->oi", Jcam, t_rhs), obs_cam, nc) \
        + cprior_rhs
    if rig_opt:
        b_r = _segsum(torch.einsum("oki,ok->oi", Jr, t_rhs), obs_rigcam,
                      nr) + rcprior_rhs
    else:
        b_r = torch.zeros((0, 6), dtype=dtype, device=dev)
    for r_u, Ji_u, Jr_m, idx_i, idx_r in shot_rows:
        b_i = b_i + _segsum(torch.einsum("kmi,km->ki", Ji_u, r_u), idx_i,
                            ni) / n_dev
        if Jr_m is not None:
            b_r = b_r + _segsum(torch.einsum("kmi,km->ki", Jr_m, r_u),
                                idx_r, nr) / n_dev

    return SimpleNamespace(
        inst=inst, rigcam=rigcam, cam=cam, points=points, lam=lam,
        dtype=dtype, rig_opt=rig_opt,
        opt_inst=opt_inst, opt_rigcam=opt_rigcam,
        opt_cam_mask=opt_cam_mask, opt_points=opt_points,
        opt_i6=opt_i6, opt_cp=opt_cp, opt_r6=opt_r6,
        obs_inst=obs_inst, obs_rigcam=obs_rigcam, obs_cam=obs_cam,
        local_point=local_point, np_local=np_local,
        n_win_local=n_win_local, v2r_local=v2r_local,
        r=r, Ji=Ji, Jr=Jr, Jcam=Jcam, Jp=Jp,
        Hpp=Hpp, Hpp_inv=Hpp_inv, bp=bp,
        preduce=preduce, pgather=pgather,
        sel_i=sel_i, sel_c=sel_c, sel_r=sel_r,
        red_i=red_i, red_c=red_c, red_r=red_r,
        n_dev=n_dev,
        gps_blocks=gps_blocks, cprior_blocks=cprior_blocks,
        rcprior_blocks=rcprior_blocks, shot_rows=shot_rows,
        b_i=b_i, b_c=b_c, b_r=b_r,
    )


def _back_substitute_local(L, dx_i, dx_r, dx_c):
    """dx_p of a shard's points from the camera-side update."""
    t = torch.einsum("oki,oi->ok", L.Ji, L.sel_i(dx_i)) + torch.einsum(
        "oki,oi->ok", L.Jcam, L.sel_c(dx_c))
    if L.rig_opt:
        t = t + torch.einsum("oki,oi->ok", L.Jr, L.sel_r(dx_r))
    u = L.preduce(torch.einsum("okj,ok->oj", L.Jp, t))
    return torch.einsum("pij,pj->pi", L.Hpp_inv, L.bp - u)


def _step_statics(mesh, ptype, pmax, ni, nc, loss, loss_threshold, nr,
                  rig_mode, with_depth, has_up, has_ang, win):
    return dict(ptype=ptype, pmax=pmax, ni=ni, nc=nc, nr=nr, loss=loss,
                loss_threshold=loss_threshold, rig_mode=rig_mode,
                with_depth=with_depth, has_up=has_up, has_ang=has_ang,
                win=win, n_dev=float(mesh.n_shards))


def _step_outputs(mesh, Ls, rep, dx_p, rig_opt):
    """(inst, [rigcam,] cam, points[, scales]) as per-shard lists."""
    outs = _replicated(mesh, rep)
    points = [L.points - d for L, d in zip(Ls, dx_p)]
    n_front = 3 if rig_opt else 2
    return tuple(outs[:n_front]) + (points,) + tuple(outs[n_front:])


def make_sharded_cg_lm_step(mesh: Mesh, axis: str, ptype, pmax: int,
                            ni: int, nc: int, loss: str = "SoftLOneLoss",
                            loss_threshold: float = 1.0, cg_iters: int = 100,
                            cg_tol: float = 1e-8, nr: int = 1,
                            rig_mode: str = "none", with_depth: bool = False,
                            has_up: bool = False, has_ang: bool = False,
                            win: int = 0):
    """The camera-block-sparse LM step: block-Jacobi preconditioned CG on the
    Schur complement, the reduced system never formed; each CG iteration
    applies S v = Jc^T Jc v - Jc^T Jp Hpp^-1 Jp^T Jc v over each shard's
    observations and sums only the camera-side vectors (one `psum` per
    iteration).

    step(*args) -> (new_inst, [new_rigcam,] new_cam, new_points), args in
    `_cg_step_names(rig_mode, with_depth, has_up, has_ang)` order
    (obs_point carries GLOBAL point indices, point_base each point's shard
    base).  Residual families: robust reprojection through the rig chain
    (`rig_mode` "none", "fixed" or "opt"), depth rows (`with_depth`), GPS,
    camera and rig-camera priors, point priors (optional Cauchy), and the
    Cauchy(1) up-vector (`has_up`) and pan/tilt/roll (`has_ang`) rows."""
    step_names = _cg_step_names(rig_mode, with_depth, has_up, has_ang,
                                win=win > 0, mixed=isinstance(ptype, tuple))
    statics = _step_statics(mesh, ptype, pmax, ni, nc, loss, loss_threshold,
                            nr, rig_mode, with_depth, has_up, has_ang, win)
    rig_opt = rig_mode == "opt"

    def local(shards):
        Ls = [_linearize_local(a, **statics) for a in shards]
        L0 = Ls[0]
        dtype, lam, n_dev = L0.dtype, L0.lam, L0.n_dev

        # --- block-Jacobi preconditioner + damping diagonals --------------
        parts = []
        for L in Ls:
            G_i = torch.einsum("oki,okj->oij", L.Ji, L.Jp)
            direct_i = _segsum(torch.einsum("oki,okj->oij", L.Ji, L.Ji),
                               L.obs_inst, ni)
            schur_i = _segsum(
                torch.einsum("oij,ojk,olk->oil", G_i, L.pgather(L.Hpp_inv),
                             G_i), L.obs_inst, ni)
            extra_i = L.gps_blocks
            for r_u, Ji_u, Jr_m, idx_i, idx_r in L.shot_rows:
                extra_i = extra_i + _segsum(
                    torch.einsum("kmi,kmj->kij", Ji_u, Ji_u), idx_i,
                    ni) / n_dev
            M_i = direct_i - schur_i + extra_i
            # A camera sees a point through many observations: the exact
            # diagonal block needs the per-(point, camera) aggregate first.
            G_c = torch.einsum("oki,okj->oij", L.Jcam, L.Jp)
            direct_c = _segsum(torch.einsum("oki,okj->oij", L.Jcam, L.Jcam),
                               L.obs_cam, nc)
            W_c = _segsum(G_c, L.local_point * nc + L.obs_cam,
                          L.np_local * nc).reshape(L.np_local, nc, pmax, 3)
            schur_c = torch.einsum("pcij,pjk,pclk->cil", W_c, L.Hpp_inv, W_c)
            M_c = direct_c - schur_c + L.cprior_blocks
            if rig_opt:
                G_r = torch.einsum("oki,okj->oij", L.Jr, L.Jp)
                direct_r = _segsum(torch.einsum("oki,okj->oij", L.Jr, L.Jr),
                                   L.obs_rigcam, nr)
                W_r = _segsum(G_r, L.local_point * nr + L.obs_rigcam,
                              L.np_local * nr).reshape(L.np_local, nr, 6, 3)
                schur_r = torch.einsum("prij,pjk,prlk->ril", W_r, L.Hpp_inv,
                                       W_r)
                extra_r = L.rcprior_blocks
                for r_u, Ji_u, Jr_m, idx_i, idx_r in L.shot_rows:
                    if Jr_m is not None:
                        extra_r = extra_r + _segsum(
                            torch.einsum("kmi,kmj->kij", Jr_m, Jr_m), idx_r,
                            nr) / n_dev
                M_r = direct_r - schur_r + extra_r
                parts.append((L.b_i, L.b_c, L.b_r, M_i, M_c, M_r))
            else:
                parts.append((L.b_i, L.b_c, M_i, M_c))
        summed = mesh.psum(parts)[0]
        if rig_opt:
            b_i, b_c, b_r, M_i, M_c, M_r = summed
        else:
            b_i, b_c, M_i, M_c = summed
            b_r = L0.b_r

        # Marquardt damping on the (clamped) diagonal, Ceres-style.
        diag_i = torch.clamp(torch.einsum("nii->ni", M_i), 1e-6, 1e32)
        diag_c = torch.clamp(torch.einsum("nii->ni", M_c), 1e-6, 1e32)
        eye6 = torch.eye(6, dtype=dtype, device=M_i.device)
        eyep = torch.eye(pmax, dtype=dtype, device=M_i.device)
        M_i = M_i + lam * torch.diag_embed(diag_i) + 1e-10 * eye6
        M_c = M_c + lam * torch.diag_embed(diag_c) + 1e-10 * eyep
        M_i = torch.where(L0.opt_inst[:, None, None], M_i, eye6)
        M_c_any = torch.any(L0.opt_cam_mask, dim=1)
        M_c = torch.where(M_c_any[:, None, None], M_c, eyep)
        Mi_inv = torch.linalg.inv(M_i) * L0.opt_inst.to(dtype)[:, None, None]
        Mc_inv = torch.linalg.inv(M_c) * M_c_any.to(dtype)[:, None, None]
        if rig_opt:
            diag_r = torch.clamp(torch.einsum("nii->ni", M_r), 1e-6, 1e32)
            M_r = M_r + lam * torch.diag_embed(diag_r) + 1e-10 * eye6
            M_r = torch.where(L0.opt_rigcam[:, None, None], M_r, eye6)
            Mr_inv = torch.linalg.inv(M_r) * L0.opt_rigcam.to(
                dtype)[:, None, None]
        else:
            diag_r = torch.zeros((0, 6), dtype=dtype, device=M_i.device)
            Mr_inv = torch.zeros((0, 6, 6), dtype=dtype, device=M_i.device)
        opt_i6, opt_cp, opt_r6 = L0.opt_i6, L0.opt_cp, L0.opt_r6

        # --- matrix-free damped Schur matvec --------------------------------
        def matvec(v_i, v_r, v_c):
            v_i = v_i * opt_i6
            v_c = v_c * opt_cp
            if rig_opt:
                v_r = v_r * opt_r6
            parts = []
            for L, (vi, vr, vc) in zip(Ls, mesh.replicate((v_i, v_r, v_c))):
                t = torch.einsum("oki,oi->ok", L.Ji, L.sel_i(vi)) \
                    + torch.einsum("oki,oi->ok", L.Jcam, L.sel_c(vc))
                if rig_opt:
                    t = t + torch.einsum("oki,oi->ok", L.Jr, L.sel_r(vr))
                u = L.preduce(torch.einsum("okj,ok->oj", L.Jp, t))
                w = torch.einsum("pij,pj->pi", L.Hpp_inv, u)
                y = torch.einsum("okj,oj->ok", L.Jp, L.pgather(w))
                o_i = L.red_i(torch.einsum("oki,ok->oi", L.Ji, t - y)) \
                    + torch.einsum("nij,nj->ni", L.gps_blocks, vi)
                o_c = L.red_c(torch.einsum("oki,ok->oi", L.Jcam, t - y)) \
                    + torch.einsum("nij,nj->ni", L.cprior_blocks, vc)
                o_r = (L.red_r(torch.einsum("oki,ok->oi", L.Jr, t - y))
                       + torch.einsum("nij,nj->ni", L.rcprior_blocks, vr)
                       if rig_opt else vr)
                for r_u, Ji_u, Jr_m, idx_i, idx_r in L.shot_rows:
                    t_u = torch.einsum("kmi,ki->km", Ji_u, vi[idx_i])
                    if Jr_m is not None:
                        t_u = t_u + torch.einsum("kmi,ki->km", Jr_m,
                                                 vr[idx_r])
                    o_i = o_i + _segsum(torch.einsum("kmi,km->ki", Ji_u, t_u),
                                        idx_i, ni) / n_dev
                    if Jr_m is not None:
                        o_r = o_r + _segsum(
                            torch.einsum("kmi,km->ki", Jr_m, t_u), idx_r,
                            nr) / n_dev
                parts.append((o_i, o_c, o_r) if rig_opt else (o_i, o_c))
            # ONE collective for every family.
            summed = mesh.psum(parts)[0]
            if rig_opt:
                o_i, o_c, o_r = summed
                o_r = (o_r + lam * diag_r * v_r) * opt_r6
            else:
                o_i, o_c = summed
                o_r = v_r
            o_i = o_i + lam * diag_i * v_i
            o_c = o_c + lam * diag_c * v_c
            return o_i * opt_i6, o_r, o_c * opt_cp

        def precond(v_i, v_r, v_c):
            return (torch.einsum("nij,nj->ni", Mi_inv, v_i),
                    torch.einsum("nij,nj->ni", Mr_inv, v_r),
                    torch.einsum("nij,nj->ni", Mc_inv, v_c))

        def dot(x, y):
            # f64 accumulation island: CG's alpha/beta ratios are the
            # fragile part of the f32 path.
            return sum(torch.sum((xa * ya).to(_ACC))
                       for xa, ya in zip(x, y)).to(dtype)

        # --- preconditioned CG (the JAX package's device while_loop, one
        # host test of its condition per iteration) -------------------------
        b = (b_i * opt_i6, b_r * opt_r6 if rig_opt else b_r, b_c * opt_cp)
        x = tuple(torch.zeros_like(v) for v in b)
        rr = b
        z = precond(*rr)
        p = z
        rz = dot(rr, z)
        b_norm2 = dot(b, b)
        k = 0
        while k < cg_iters and bool(dot(rr, rr) > cg_tol * cg_tol * b_norm2):
            Ap = matvec(*p)
            alpha = rz / torch.clamp_min(dot(p, Ap), 1e-30)
            x = tuple(xa + alpha * pa for xa, pa in zip(x, p))
            rr = tuple(ra - alpha * Aa for ra, Aa in zip(rr, Ap))
            z = precond(*rr)
            rz_new = dot(rr, z)
            beta = rz_new / torch.clamp_min(rz, 1e-30)
            p = tuple(za + beta * pa for za, pa in zip(z, p))
            rz = rz_new
            k += 1
        dx_i, dx_r, dx_c = x

        dx_p = [_back_substitute_local(L, *d) for L, d in
                zip(Ls, mesh.replicate((dx_i, dx_r, dx_c)))]
        rep = (L0.inst - dx_i,) + ((L0.rigcam - dx_r,) if rig_opt else ()) \
            + (L0.cam - dx_c,)
        return _step_outputs(mesh, Ls, rep, dx_p, rig_opt)

    out_sharded = (False,) * (3 if rig_opt else 2) + (True,)
    return _ShardedFn(mesh, step_names, _CG_SHARDED, local, out_sharded)


def _chol3(A):
    """Closed-form lower Cholesky factor of [..., 3, 3] SPD (or zero)
    matrices; zero blocks (masked points) factor to ~zero through the eps
    floor instead of NaN."""
    eps = 1e-30
    a11 = torch.clamp_min(A[..., 0, 0], eps)
    l11 = torch.sqrt(a11)
    l21 = A[..., 1, 0] / l11
    l31 = A[..., 2, 0] / l11
    l22 = torch.sqrt(torch.clamp_min(A[..., 1, 1] - l21 * l21, eps))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp_min(A[..., 2, 2] - l31 * l31 - l32 * l32,
                                     eps))
    z = torch.zeros_like(l11)
    return torch.stack([
        torch.stack([l11, z, z], dim=-1),
        torch.stack([l21, l22, z], dim=-1),
        torch.stack([l31, l32, l33], dim=-1),
    ], dim=-2)


def make_sharded_schur_lm_step(mesh: Mesh, axis: str, ptype, pmax: int,
                               ni: int, nc: int, loss: str = "SoftLOneLoss",
                               loss_threshold: float = 1.0, nr: int = 1,
                               rig_mode: str = "none",
                               with_depth: bool = False,
                               has_up: bool = False, has_ang: bool = False,
                               win: int = 0, graph: tuple = (), ns: int = 0):
    """The assembled-Schur sharded LM step: each shard assembles its part of
    the reduced camera system S = H_cc - H_cp Hpp^-1 H_pc (dense [D, D],
    D = 6 NI [+ 6 NR] + P NC [+ NS]), (S, b) are summed once, and the
    replicated system is solved by Cholesky.  The same argument order and
    residual families as `make_sharded_cg_lm_step`, plus the pose-graph
    families (`graph`) and scale variables (`ns`) as replicated dense blocks.

    The Schur correction contracts the per-family [NL, d_f, 3] whitened
    point-coupling tensors V_f[p, col, b] = (W_pf U_p)[col, b] (Hpp^-1 =
    U U^T) over the (point, Cholesky column) axes, family pair by family
    pair."""
    step_names = _cg_step_names(rig_mode, with_depth, has_up, has_ang,
                                win=win > 0, mixed=isinstance(ptype, tuple),
                                graph=graph, has_scales=ns > 0)
    statics = _step_statics(mesh, ptype, pmax, ni, nc, loss, loss_threshold,
                            nr, rig_mode, with_depth, has_up, has_ang, win)
    rig_opt = rig_mode == "opt"
    off_r = 6 * ni
    off_c = off_r + 6 * (nr if rig_opt else 0)
    off_s = off_c + pmax * nc
    D = off_s + ns

    def local_system(a, L):
        """The shard's (S, b) before the sum, and its family mask m."""
        dtype, dev = L.dtype, L.points.device
        NL = L.np_local
        O_local = L.obs_inst.shape[0]

        # --- whitened point-coupling columns ---------------------------------
        U = _chol3(L.Hpp_inv)
        JpU = torch.einsum("okj,ojb->okb", L.Jp, L.pgather(U))
        Fi = torch.einsum("oki,okb->oib", L.Ji, JpU)
        Fc = torch.einsum("oki,okb->oib", L.Jcam, JpU)
        Vi = _segsum(Fi.reshape(O_local, 18), L.local_point * ni + L.obs_inst,
                     NL * ni).reshape(NL, ni, 6, 3)
        if nc == 1:
            # One camera: the (point, camera) key is the point.
            Vc = L.preduce(Fc.reshape(O_local, pmax * 3)).reshape(
                NL, nc, pmax, 3)
        else:
            Vc = _segsum(Fc.reshape(O_local, pmax * 3),
                         L.local_point * nc + L.obs_cam,
                         NL * nc).reshape(NL, nc, pmax, 3)
        fams = [(Vi.reshape(NL, ni * 6, 3), 0)]
        if rig_opt:
            Fr = torch.einsum("oki,okb->oib", L.Jr, JpU)
            Vr = _segsum(Fr.reshape(O_local, 18),
                         L.local_point * nr + L.obs_rigcam,
                         NL * nr).reshape(NL, nr, 6, 3)
            fams.append((Vr.reshape(NL, nr * 6, 3), off_r))
        fams.append((Vc.reshape(NL, nc * pmax, 3), off_c))

        # --- direct blocks ---------------------------------------------------
        blk_ii = L.red_i(torch.einsum("oki,okj->oij", L.Ji, L.Ji)) \
            + L.gps_blocks
        blk_cc = L.red_c(torch.einsum("oki,okj->oij", L.Jcam, L.Jcam)) \
            + L.cprior_blocks
        if nc == 1:
            X_ic = L.red_i(torch.einsum("oki,okj->oij", L.Ji, L.Jcam))
        else:
            X_ic = _segsum(torch.einsum("oki,okj->oij", L.Ji, L.Jcam),
                           L.obs_inst * nc + L.obs_cam, ni * nc)
        if rig_opt:
            blk_rr = L.red_r(torch.einsum("oki,okj->oij", L.Jr, L.Jr)) \
                + L.rcprior_blocks
            X_ir = _segsum(torch.einsum("oki,okj->oij", L.Ji, L.Jr),
                           L.obs_inst * nr + L.obs_rigcam, ni * nr)
            X_rc = _segsum(torch.einsum("oki,okj->oij", L.Jr, L.Jcam),
                           L.obs_rigcam * nc + L.obs_cam, nr * nc)
        xrow_ir = None
        for r_u, Ji_u, Jr_m, idx_i, idx_r in L.shot_rows:
            blk_ii = blk_ii + _segsum(
                torch.einsum("kmi,kmj->kij", Ji_u, Ji_u), idx_i,
                ni) / L.n_dev
            if Jr_m is not None:
                blk_rr = blk_rr + _segsum(
                    torch.einsum("kmi,kmj->kij", Jr_m, Jr_m), idx_r,
                    nr) / L.n_dev
                add = _segsum(torch.einsum("kmi,kmj->kij", Ji_u, Jr_m),
                              idx_i * nr + idx_r, ni * nr) / L.n_dev
                xrow_ir = add if xrow_ir is None else xrow_ir + add
        if rig_opt and xrow_ir is not None:
            X_ir = X_ir + xrow_ir

        # --- the local dense reduced system ----------------------------------
        S = torch.zeros((D, D), dtype=dtype, device=dev)
        S[:off_r, :off_r] += _lm._expand_diag(blk_ii, ni).reshape(6 * ni,
                                                                  6 * ni)
        S[off_c:off_s, off_c:off_s] += _lm._expand_diag(blk_cc, nc).reshape(
            pmax * nc, pmax * nc)
        Xic = X_ic.reshape(ni, nc, 6, pmax).permute(0, 2, 1, 3).reshape(
            6 * ni, pmax * nc)
        S[:off_r, off_c:off_s] += Xic
        S[off_c:off_s, :off_r] += Xic.T
        if rig_opt:
            S[off_r:off_c, off_r:off_c] += _lm._expand_diag(
                blk_rr, nr).reshape(6 * nr, 6 * nr)
            Xir = X_ir.reshape(ni, nr, 6, 6).permute(0, 2, 1, 3).reshape(
                6 * ni, 6 * nr)
            S[:off_r, off_r:off_c] += Xir
            S[off_r:off_c, :off_r] += Xir.T
            Xrc = X_rc.reshape(nr, nc, 6, pmax).permute(0, 2, 1, 3).reshape(
                6 * nr, pmax * nc)
            S[off_r:off_c, off_c:off_s] += Xrc
            S[off_c:off_s, off_r:off_c] += Xrc.T
        # Points never couple to the scale variables: the Schur correction
        # touches the instance / rig / camera block only.
        for i1, (V1, o1) in enumerate(fams):
            for i2, (V2, o2) in enumerate(fams):
                if i2 < i1:
                    continue
                blk = torch.einsum("pik,pjk->ij", V1, V2)
                d1, d2 = V1.shape[1], V2.shape[1]
                S[o1:o1 + d1, o2:o2 + d2] -= blk
                if i2 > i1:
                    S[o2:o2 + d2, o1:o1 + d1] -= blk.T

        m_parts = [L.opt_i6.reshape(-1)]
        b_parts = [(L.b_i * L.opt_i6).reshape(-1)]
        if rig_opt:
            m_parts.append(L.opt_r6.reshape(-1))
            b_parts.append((L.b_r * L.opt_r6).reshape(-1))
        m_parts.append(L.opt_cp.reshape(-1))
        b_parts.append((L.b_c * L.opt_cp).reshape(-1))
        if ns > 0:
            opt_s = a["opt_scales"].to(dtype)
            scales = a["scales"]
            m_parts.append(opt_s)
            b_parts.append(torch.zeros(ns, dtype=dtype, device=dev))
        else:
            opt_s = None
            scales = torch.zeros(0, dtype=dtype, device=dev)
        m = torch.cat(m_parts)
        b = torch.cat(b_parts)

        # --- pose-graph rows (replicated dense blocks) -----------------------
        if graph:
            fam_off = {"i": (0, 6, L.opt_i6),
                       "r": (off_r, 6, L.opt_r6 if rig_opt else None),
                       "s": (off_s, 1,
                             opt_s[:, None] if opt_s is not None else None)}
            gdata = {k: a[k] for k in graph}
            for r_g, slots in _lm._graph_residuals(
                    (L.inst, L.rigcam, L.cam, L.points, scales), gdata):
                masked = []
                for fam, idx, J in slots:
                    off, bdim, fmask = fam_off[fam]
                    if fmask is None:
                        continue  # the family's parameters are not unknowns
                    idx = idx.long()
                    J = J * fmask[idx][:, None, :]
                    rows = off + idx[:, None] * bdim + torch.arange(
                        bdim, device=dev)
                    masked.append((J, rows))
                for J1, rows1 in masked:
                    b.index_put_(
                        (rows1,),
                        torch.einsum("kmi,km->ki", J1, r_g) / L.n_dev,
                        accumulate=True)
                    for J2, rows2 in masked:
                        S.index_put_(
                            (rows1[:, :, None], rows2[:, None, :]),
                            torch.einsum("kmi,kmj->kij", J1, J2) / L.n_dev,
                            accumulate=True)
        return S, b, m, scales

    def local(shards):
        Ls = [_linearize_local(a, **statics) for a in shards]
        systems = [local_system(a, L) for a, L in zip(shards, Ls)]
        S, b = mesh.psum([(S_, b_) for S_, b_, _, _ in systems])[0]
        _, _, m, scales = systems[0]
        L0 = Ls[0]

        # Damping (Marquardt on the clamped diagonal), identity rows for
        # fixed parameters, the replicated Cholesky solve.
        dg = torch.clamp(torch.diagonal(S), 1e-6, 1e32)
        S = S + torch.diag(L0.lam * dg + 1e-10)
        S = S * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
        dx = linalg.solve_spd(S, b) * m
        dx_i = dx[:off_r].reshape(ni, 6)
        dx_c = dx[off_c:off_s].reshape(nc, pmax)
        dx_r = (dx[off_r:off_c].reshape(nr, 6) if rig_opt
                else torch.zeros((0, 6), dtype=L0.dtype, device=dx.device))

        dx_p = [_back_substitute_local(L, *d) for L, d in
                zip(Ls, mesh.replicate((dx_i, dx_r, dx_c)))]
        rep = (L0.inst - dx_i,) + ((L0.rigcam - dx_r,) if rig_opt else ()) \
            + (L0.cam - dx_c,)
        if ns > 0:
            rep = rep + (scales - dx[off_s:],)
        return _step_outputs(mesh, Ls, rep, dx_p, rig_opt)

    out_sharded = (False,) * (3 if rig_opt else 2) + (True,) + (
        (False,) if ns > 0 else ())
    return _ShardedFn(mesh, step_names, _CG_SHARDED, local, out_sharded)


def _schur_eligible(problem: BAProblem, n_shards: int) -> bool:
    """Whether the assembled-Schur step suits this (already sharded)
    problem: its per-trial assembly is NP_shard * D^2 * 6 flops plus the
    [NL, d_f, 3] family tensors (3 * NP_shard * D floats); gated at <= 2e11
    flops and <= 768 MB a shard, matrix-free CG beyond."""
    ni, nr, nc, npts, O, T = problem.counts()
    rig_opt = bool(np.asarray(problem.opt_rigcam).any())
    D = 6 * ni + (6 * nr if rig_opt else 0) + problem.cam.shape[1] * nc
    np_shard = npts // max(n_shards, 1)
    flops = np_shard * D * D * 6.0
    b_bytes = 3 * np_shard * D * 4.0
    return flops <= 2e11 and b_bytes <= (768 << 20)


def make_sharded_cost(mesh: Mesh, axis: str, ptype, pmax: int, ni: int,
                      nc: int, loss: str = "SoftLOneLoss",
                      loss_threshold: float = 1.0, nr: int = 1,
                      rig_mode: str = "none", with_depth: bool = False,
                      has_up: bool = False, has_ang: bool = False,
                      graph: tuple = (), ns: int = 0):
    """Total objective over the sharded layout (the sparse routes'
    accept/reject metric): robust reprojection through the rig chain, depth
    rows, GPS, camera and rig-camera priors, point priors (optional Cauchy),
    the Cauchy(1) shot rows and the pose-graph families, as
    `lm._total_cost`.  On a mono perspective [k1, k2, focal] map each
    shard's reprojection cost is the `fused_cost` kernel's on the card.

    cost(*args) -> 0-d tensor (replicated), args in
    `_cg_cost_names(rig_mode, with_depth, has_up, has_ang)` order."""
    cost_names = _cg_cost_names(rig_mode, with_depth, has_up, has_ang,
                                mixed=isinstance(ptype, tuple), graph=graph,
                                has_scales=ns > 0)
    n_dev = float(mesh.n_shards)
    kernel = _lm.kernel_route(ptype, pmax, with_depth,
                              rig_transform=rig_mode != "none")

    def local_total(a):
        inst, cam, points = a["inst"], a["cam"], a["points"]
        dtype = points.dtype
        local_point = a["obs_point"] - a["point_base"][0]
        rho, _ = LOSSES[loss]
        a2 = loss_threshold * loss_threshold
        if kernel:
            total = fused_cost(inst, cam, points, a["obs_inst"], a["obs_cam"],
                               local_point, a["obs_uv"], a["obs_inv_sd"],
                               loss=loss, loss_threshold=loss_threshold
                               ).to(_ACC)
        else:
            rigcam = a.get("rigcam")
            oi, oc = a["obs_inst"].long(), a["obs_cam"].long()
            parts = [inst[oi]]
            rc6 = None
            if rig_mode != "none":
                rc6 = rigcam[a["obs_rigcam"].long()]
                if rig_mode == "opt":
                    parts.append(rc6)
            combo = torch.cat(parts + [cam[oc]], dim=1)
            dep = ((a["obs_depth"], a["obs_depth_inv_sd"],
                    a["obs_depth_radial"]) if with_depth else None)
            r = _obs_rows(ptype, pmax, rig_mode, with_depth, a["obs_uv"],
                          a["obs_inv_sd"], rc6, dep, a.get("obs_ptype"))(
                combo, points[local_point.long()])
            s = torch.sum(r[:, :2] * r[:, :2], dim=-1)
            total = torch.sum((0.5 * a2 * rho(s / a2)).to(_ACC))
            if with_depth:
                total = total + torch.sum(
                    (0.5 * a2 * rho(r[:, 2] * r[:, 2] / a2)).to(_ACC))

        # Point priors (shard-local; Cauchy where point_prior_loss > 0).
        pp_r = (points - a["point_prior"]) * a["point_prior_inv_sd"]
        sp = torch.sum(pp_r * pp_r, dim=-1)
        c = a["point_prior_loss"]
        c2 = torch.where(c > 0, c * c, 1.0)
        per = torch.where(c > 0, 0.5 * c2 * torch.log1p(sp / c2), 0.5 * sp)
        total = total + torch.sum(per.to(_ACC))

        # Replicated families: added once over the mesh.
        rigcam = a.get("rigcam")
        if rigcam is None:
            rigcam = torch.zeros((1, 6), dtype=dtype, device=points.device)
        gr = (_lm._origin(inst) - a["gps_pos"]) * a["gps_inv_sd"][:, None]
        cp_r = _cam_prior_residual(cam, a["cam_prior"], a["cam_prior_inv_sd"],
                                   a["cam_log_mask"])
        rep = 0.5 * torch.sum((gr * gr).to(_ACC)) + 0.5 * torch.sum(
            (cp_r * cp_r).to(_ACC))
        if rig_mode == "opt":
            rc_r = (a["rigcam"] - a["rigcam_prior"]) \
                * a["rigcam_prior_inv_sd"]
            rep = rep + 0.5 * torch.sum((rc_r * rc_r).to(_ACC))
        if has_up or has_ang:
            rho_c = LOSSES["CauchyLoss"][0]
            for pr in _lm._shot_prior_residuals((inst, rigcam),
                                                _shot_row_data(a), raw=True):
                su = torch.sum(pr * pr, dim=-1)
                rep = rep + torch.sum((0.5 * rho_c(su)).to(_ACC))
        if graph:
            scales = a.get("scales")
            if scales is None:
                scales = torch.zeros(0, dtype=dtype, device=points.device)
            rep = rep + _lm._graph_cost(
                (inst, rigcam, cam, points, scales),
                {k: a[k] for k in graph}).to(_ACC)
        return total + rep / n_dev

    def local(shards):
        (total,) = mesh.psum([(local_total(a),) for a in shards])[0]
        dtype = shards[0]["points"].dtype
        return ([x for (x,) in mesh.replicate((total.to(dtype),))],)

    return _ShardedFn(mesh, cost_names, _CG_SHARDED, local, (False,))


# ---------------------------------------------------------------------------
# The damping loop
# ---------------------------------------------------------------------------


class _Damping:
    """The JAX package's LM damping policy, one trial per host step, in the
    working dtype's scalars: accept on a finite drop in cost, lam / 3
    (floored at 1e-12) on accept, lam * 10 (capped at 1e8) on reject; a
    block of trials ends at `block_size` trials, at the accept budget, at 16
    consecutive rejects or on an accepted step with rel < tol."""

    def __init__(self, dtype, cost0, lam0, rejects0, budget, tol):
        self.sdt = np.float32 if dtype == torch.float32 else np.float64
        self.cost = self.sdt(cost0)
        self.lam = self.sdt(lam0)
        self.tol = self.sdt(tol)
        self.rejects = int(rejects0)
        self.budget = int(budget)
        self.accepted = self.trials = 0
        self.converged = False

    def running(self, block_size):
        return (self.trials < block_size and self.accepted < self.budget
                and self.rejects < 16 and not self.converged)

    def judge(self, new_cost) -> bool:
        sdt = self.sdt
        new_cost = sdt(new_cost)
        accept = bool(np.isfinite(new_cost) and new_cost < self.cost)
        rel = (self.cost - new_cost) / max(self.cost, sdt(1e-30))
        self.converged = accept and bool(rel < self.tol)
        if accept:
            self.cost = new_cost
            self.lam = max(self.lam / sdt(3.0), sdt(1e-12))
            self.rejects = 0
            self.accepted += 1
        else:
            self.lam = min(self.lam * sdt(10.0), sdt(1e8))
            self.rejects += 1
        self.trials += 1
        return accept

    def stats(self):
        return torch.tensor([float(self.cost), float(self.lam),
                             float(self.rejects), float(self.accepted),
                             float(self.trials), float(self.converged)],
                            dtype=torch.float64)


def make_sharded_lm_block(mesh: Mesh, axis: str, ptype, pmax: int, ni: int,
                          nc: int, solver: str = "cg", block_size: int = 8,
                          tol: float = 1e-10, loss: str = "SoftLOneLoss",
                          loss_threshold: float = 1.0, cg_iters: int = 100,
                          cg_tol: float = 1e-8, nr: int = 1,
                          rig_mode: str = "none", with_depth: bool = False,
                          has_up: bool = False, has_ang: bool = False,
                          win: int = 0, graph: tuple = (), ns: int = 0):
    """Up to `block_size` LM damping trials (step, cost, accept/reject,
    lambda update, stop rules).  The JAX package runs them in one device
    `while_loop`; here one trial is one host step, with the same policy
    (`_Damping`), so trajectories and `iterations` are the same.

    block(cost, lam, rejects, budget, *step_args) -> (state..., stats[6] =
    [cost, lam, rejects, accepted, trials, converged])."""
    kw = dict(loss=loss, loss_threshold=loss_threshold, nr=nr,
              rig_mode=rig_mode, with_depth=with_depth, has_up=has_up,
              has_ang=has_ang)
    if solver == "schur":
        step = make_sharded_schur_lm_step(mesh, axis, ptype, pmax, ni, nc,
                                          win=win, graph=graph, ns=ns, **kw)
    else:
        if graph or ns:
            raise ValueError("pose-graph rows need the assembled-Schur solver")
        step = make_sharded_cg_lm_step(mesh, axis, ptype, pmax, ni, nc,
                                       cg_iters=cg_iters, cg_tol=cg_tol,
                                       win=win, **kw)
    cost_fn = make_sharded_cost(mesh, axis, ptype, pmax, ni, nc, graph=graph,
                                ns=ns, **kw)
    step_names = step.names
    cost_names = cost_fn.names
    out_keys = (
        ("inst", "rigcam", "cam", "points") if rig_mode == "opt"
        else ("inst", "cam", "points")
    ) + (("scales",) if ns > 0 else ())

    def block(cost0, lam0, rejects0, budget, *args):
        shards = _split(mesh, dict(zip(step_names, args)), _CG_SHARDED)
        dtype = shards[0]["points"].dtype
        pol = _Damping(dtype, float(cost0), float(lam0), int(rejects0),
                       int(budget), tol)
        while pol.running(block_size):
            for a in shards:
                a["lam"] = torch.tensor(pol.lam, dtype=dtype,
                                        device=a["points"].device)
            out = step.local(shards)
            trial = [dict(a, **{k: o[j] for k, o in zip(out_keys, out)})
                     for j, a in enumerate(shards)]
            new_cost = float(cost_fn.local(
                [{k: t[k] for k in cost_names} for t in trial])[0][0])
            if pol.judge(new_cost):
                shards = trial
        state = step.join(tuple([a[k] for a in shards] for k in out_keys))
        return tuple(state) + (pol.stats(),)

    block.names = step_names
    return block


# Dense-grid block argument order (camera side replicated, point side
# sharded over the point axis).
_DENSE_BLOCK_NAMES = (
    "inst", "rigcam", "cam", "points", "obs_uv", "obs_inv_sd",
    "point_prior", "point_prior_inv_sd", "point_prior_loss", "opt_points",
    "gps_pos", "gps_inv_sd", "cam_prior", "cam_prior_inv_sd",
    "cam_log_mask", "rigcam_prior", "rigcam_prior_inv_sd",
    "opt_inst", "opt_rigcam", "opt_cam",
    # Shot-prior rows, replicated: they enter through the post-sum
    # `_assemble_S` epilogue and the replicated tail of `_dense_grid_cost`.
    "up_inst", "up_rigcam", "up_vec", "up_inv_sd",
    "ang_kind", "ang_inst", "ang_rigcam", "ang_value", "ang_inv_sd",
)
_DENSE_INT_EMPTY = frozenset((
    "up_inst", "up_rigcam", "ang_kind", "ang_inst", "ang_rigcam",
))
_DENSE_SHARDED = frozenset((
    "points", "obs_uv", "obs_inv_sd", "point_prior", "point_prior_inv_sd",
    "point_prior_loss", "opt_points",
))


def _dense_block_args(dproblem, dtype) -> dict:
    """The `_DENSE_BLOCK_NAMES` tensors of a dense-sharded problem (floats
    cast to `dtype`, masks and indices kept)."""
    dtype = _torch_dtype(dtype)
    a = {}
    for name in _DENSE_BLOCK_NAMES:
        arr = getattr(dproblem, name, None)
        if name == "point_prior_loss" and arr is None:
            arr = np.zeros(len(dproblem.points))
        if arr is None:
            if name in _DENSE_INT_EMPTY:
                arr = np.zeros(0, dtype=np.int32)
            elif name == "up_vec":
                arr = np.zeros((0, 3))
            else:
                arr = np.zeros(0)
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating):
            a[name] = torch.as_tensor(arr, dtype=dtype)
        elif arr.dtype == bool:
            a[name] = torch.as_tensor(arr)
        else:
            a[name] = torch.as_tensor(arr, dtype=torch.int32)
    return a


def _dense_shards(shards, ni):
    states = [(a["inst"], a["rigcam"], a["cam"], a["points"]) for a in shards]
    datas = [_dense_grid_data(a, ni, with_pp_loss=True) for a in shards]
    return states, datas


def make_sharded_lm_block_dense(mesh: Mesh, axis: str, ni: int, nr: int,
                                nc: int, pmax: int, block_size: int = 32,
                                tol: float = 1e-10,
                                loss: str = "SoftLOneLoss",
                                loss_threshold: float = 1.0):
    """Up to `block_size` LM damping trials over the dense [NP, NI]
    instance-slot grid (the `make_sharded_lm_block` policy), each trial's
    step and accept/reject cost on the single-device fast path's kernels
    per shard.

    block(cost0, lam0, rejects0, budget, *_DENSE_BLOCK_NAMES args) ->
    (inst, cam, points, stats[6])."""

    def block(cost0, lam0, rejects0, budget, *args):
        shards = _split(mesh, dict(zip(_DENSE_BLOCK_NAMES, args)),
                        _DENSE_SHARDED)
        dtype = shards[0]["points"].dtype
        pol = _Damping(dtype, float(cost0), float(lam0), int(rejects0),
                       int(budget), tol)
        while pol.running(block_size):
            states, datas = _dense_shards(shards, ni)
            inst, cam, points = _dense_grid_step(
                mesh, states, datas, float(pol.lam), ni, nr, nc, pmax, loss,
                loss_threshold)
            trial = [dict(a, inst=inst[j], cam=cam[j], points=points[j])
                     for j, a in enumerate(shards)]
            states, datas = _dense_shards(trial, ni)
            new_cost = float(_dense_grid_cost(mesh, states, datas, loss,
                                              loss_threshold)[0].to(dtype))
            if pol.judge(new_cost):
                shards = trial
        return (shards[0]["inst"], shards[0]["cam"],
                mesh.allgather([a["points"] for a in shards]), pol.stats())

    return block


def make_sharded_cost_dense(mesh: Mesh, axis: str, ni: int, nc: int,
                            pmax: int, loss: str = "SoftLOneLoss",
                            loss_threshold: float = 1.0):
    """Total objective over the dense-grid layout (the initial cost of
    `_bundle_adjust_sharded_dense`): cost(*_DENSE_BLOCK_NAMES args)."""

    def local(shards):
        states, datas = _dense_shards(shards, ni)
        return (_dense_grid_cost(mesh, states, datas, loss, loss_threshold),)

    return _ShardedFn(mesh, _DENSE_BLOCK_NAMES, _DENSE_SHARDED, local,
                      (False,))


# Grid-size cap of the dense-grid route.
_DENSE_GRID_MAX_SLOTS = 32 << 20


def _dense_grid_normalize(problem: BAProblem):
    """The problem normalized for the dense-grid route, or None where it
    cannot run there: a one-segment perspective `ptype` becomes the string,
    zero-weight padding rows (which would collide on one grid slot) are
    stripped, and so are fixed instances without observations (the size
    buckets' padding of `ba/problem`; `dense_keep` lists the instances
    kept).  Mono single
    camera, identity rig, no depth rows, no pose-graph families, no
    duplicate (point, instance) pair, and a grid within the slot cap;
    up-vector and pan/tilt/roll rows are in-path."""
    pt = problem.ptype
    if isinstance(pt, (tuple, list)):
        if not all(seg[0] == "perspective" for seg in pt):
            return None
        pt = "perspective"
    if pt != "perspective":
        return None
    if len(problem.cam) != 1:
        return None
    if bool(np.asarray(problem.opt_rigcam).any()):
        return None
    if float(np.abs(np.asarray(problem.rigcam)).max(initial=0.0)) > 1e-12:
        return None
    for name in ("rm_i", "rr_i", "cp_i", "lin_i0", "hm_inst", "gauge_i",
                 "scales"):
        arr = getattr(problem, name, None)
        if arr is not None and np.asarray(arr).shape[0] > 0:
            return None
    if problem.obs_depth_inv_sd is not None and bool(
            np.any(np.asarray(problem.obs_depth_inv_sd) > 0)):
        return None
    if len(problem.points) * len(problem.inst) > _DENSE_GRID_MAX_SLOTS:
        return None
    mask = np.asarray(problem.obs_inv_sd) > 0
    if not bool(mask.any()):
        return None
    repl = {"ptype": pt}
    if not bool(mask.all()):
        for name in ("obs_uv", "obs_inv_sd", "obs_point", "obs_inst",
                     "obs_rigcam", "obs_cam", "obs_depth",
                     "obs_depth_inv_sd", "obs_depth_radial"):
            arr = getattr(problem, name, None)
            if arr is not None:
                repl[name] = np.asarray(arr)[mask]
    # A padding instance of `ba/problem`'s size buckets (no observation,
    # fixed, a zero pose) meets the padding points at the origin on the
    # grid, where the projection is 0 / 0: the grid's cost would be NaN
    # and every trial rejected (the JAX package's is).  The grid takes the
    # observed instances; the fixed unobserved ones keep their poses.  An
    # unobserved instance that is optimized, or that a shot row names,
    # keeps the map off the grid.
    ni = len(problem.inst)
    observed = np.zeros(ni, bool)
    observed[np.asarray(repl.get("obs_inst", problem.obs_inst))] = True
    keep = np.flatnonzero(observed)
    if len(keep) < ni:
        rows = [np.asarray(r) for r in (problem.up_inst, problem.ang_inst)
                if r is not None]
        if np.asarray(problem.opt_inst)[~observed].any() or any(
                (~observed[r]).any() for r in rows):
            return None
        index = np.cumsum(observed) - 1
        repl.update(
            inst=np.asarray(problem.inst)[keep],
            gps_pos=np.asarray(problem.gps_pos)[keep],
            gps_inv_sd=np.asarray(problem.gps_inv_sd)[keep],
            opt_inst=np.asarray(problem.opt_inst)[keep],
            obs_inst=index[np.asarray(repl.get("obs_inst",
                                               problem.obs_inst))])
        for name in ("up_inst", "ang_inst"):
            if getattr(problem, name) is not None:
                repl[name] = index[np.asarray(getattr(problem, name))]
    problem = dataclasses.replace(problem, **repl)
    problem.dense_keep = keep
    key = (np.asarray(problem.obs_point, dtype=np.int64) * len(problem.inst)
           + np.asarray(problem.obs_inst, dtype=np.int64))
    if np.unique(key).size != len(problem.obs_uv):
        return None
    return problem


def _dense_grid_eligible(problem: BAProblem) -> bool:
    """Whether the dense-grid block solver can run this problem."""
    return _dense_grid_normalize(problem) is not None


def check_cg_compatible(problem: BAProblem):
    """The reason the matrix-free CG solver cannot run this problem, or
    None where it can.  Rigs (fixed or optimized), up-vector and
    pan/tilt/roll rows, depth rows and mixed projection types are in-path.
    A pose-graph family (or scale variables) is a reason, but not a dead
    end: the assembled-Schur solver carries them, and
    `bundle_adjust_sharded` and `_solve_full_bundle` route them there."""
    for name in ("rm_i", "rr_i", "cp_i", "lin_i0", "hm_inst", "gauge_i",
                 "scales"):
        arr = getattr(problem, name)
        if arr is not None and np.asarray(arr).shape[0] > 0:
            return f"{name} constraints present"
    if len(problem.obs_uv) == 0:
        return "no observations"
    return None


def _cg_modes(problem: BAProblem):
    """(rig_mode, with_depth, has_up, has_ang) of the CG step for this
    problem."""
    if bool(np.asarray(problem.opt_rigcam).any()):
        rig_mode = "opt"
    elif float(np.abs(np.asarray(problem.rigcam)).max(initial=0.0)) > 1e-12:
        rig_mode = "fixed"
    else:
        rig_mode = "none"
    with_depth = problem.obs_depth_inv_sd is not None and bool(
        np.any(np.asarray(problem.obs_depth_inv_sd) > 0))
    has_up = problem.up_inv_sd is not None and (
        np.asarray(problem.up_inv_sd).shape[0] > 0)
    has_ang = problem.ang_inv_sd is not None and (
        np.asarray(problem.ang_inv_sd).shape[0] > 0)
    return rig_mode, with_depth, has_up, has_ang


def _cg_args(problem: BAProblem, n_shards: int, dtype) -> dict:
    """The sparse steps' argument dict (tensors on the host) from a problem
    laid out by `shard_problem`: a superset, each step and cost signature
    takes its names (`_cg_step_names`, `_cg_cost_names`)."""
    dtype = _torch_dtype(dtype)
    npts = len(problem.points)
    num_obs = len(problem.obs_uv)
    pts_per_shard = npts // n_shards
    point_base = (np.arange(npts) // pts_per_shard) * pts_per_shard
    ppl = (np.asarray(problem.point_prior_loss)
           if problem.point_prior_loss is not None else np.zeros(npts))

    def opt(x, default):
        return np.asarray(x) if x is not None else default

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32)

    def b8(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.bool)

    v2r = getattr(problem, "cg_virt2real", None)
    opt_pt = getattr(problem, "obs_ptype", None)
    out = dict(
        virt2real=i32(v2r if v2r is not None else np.zeros(0, np.int64)),
        obs_ptype=i32(opt_pt if opt_pt is not None
                      else np.zeros(num_obs, np.int32)),
        rigcam=f(problem.rigcam),
        obs_rigcam=i32(problem.obs_rigcam),
        obs_depth=f(opt(problem.obs_depth, np.zeros(num_obs))),
        obs_depth_inv_sd=f(opt(problem.obs_depth_inv_sd, np.zeros(num_obs))),
        obs_depth_radial=b8(opt(problem.obs_depth_radial,
                                np.zeros(num_obs, bool))),
        rigcam_prior=f(problem.rigcam_prior),
        rigcam_prior_inv_sd=f(problem.rigcam_prior_inv_sd),
        opt_rigcam=b8(problem.opt_rigcam),
        up_inst=i32(opt(problem.up_inst, np.zeros(0, np.int32))),
        up_rigcam=i32(opt(problem.up_rigcam, np.zeros(0, np.int32))),
        up_vec=f(opt(problem.up_vec, np.zeros((0, 3)))),
        up_inv_sd=f(opt(problem.up_inv_sd, np.zeros(0))),
        ang_kind=i32(opt(problem.ang_kind, np.zeros(0, np.int32))),
        ang_inst=i32(opt(problem.ang_inst, np.zeros(0, np.int32))),
        ang_rigcam=i32(opt(problem.ang_rigcam, np.zeros(0, np.int32))),
        ang_value=f(opt(problem.ang_value, np.zeros(0))),
        ang_inv_sd=f(opt(problem.ang_inv_sd, np.zeros(0))),
    )
    for name in _GRAPH_PASSTHROUGH:
        arr = getattr(problem, name, None)
        if arr is None:
            continue
        if name in _GRAPH_INT_FIELDS:
            out[name] = i32(arr)
        elif name in _GRAPH_BOOL_FIELDS or name == "opt_scales":
            out[name] = b8(arr)
        else:
            out[name] = f(arr)
    out.update(
        inst=f(problem.inst), cam=f(problem.cam), points=f(problem.points),
        obs_uv=f(problem.obs_uv), obs_inv_sd=f(problem.obs_inv_sd),
        obs_point=i32(problem.obs_point), obs_inst=i32(problem.obs_inst),
        obs_cam=i32(problem.obs_cam), gps_pos=f(problem.gps_pos),
        gps_inv_sd=f(problem.gps_inv_sd), cam_prior=f(problem.cam_prior),
        cam_prior_inv_sd=f(problem.cam_prior_inv_sd),
        cam_log_mask=b8(problem.cam_log_mask),
        point_prior=f(problem.point_prior),
        point_prior_inv_sd=f(problem.point_prior_inv_sd),
        point_prior_loss=f(ppl), opt_inst=b8(problem.opt_inst),
        opt_cam=b8(problem.opt_cam), opt_points=b8(problem.opt_points),
        point_base=i32(point_base),
    )
    return out


def _bundle_adjust_sharded_dense(problem, mesh, axis, max_iterations,
                                 initial_lambda, tol, dtype):
    """The dense-grid damping loop: the `shard_problem_dense` layout and the
    `make_sharded_lm_block_dense` block, the host policy of the sparse
    routes."""
    npts_orig = len(problem.points)
    norm = _dense_grid_normalize(problem)
    if norm is None:
        raise ValueError("problem not normalizable for the dense grid")
    dproblem, _ = shard_problem_dense(norm, mesh.n_shards,
                                      max_waste=1 << 30,
                                      max_slots=_DENSE_GRID_MAX_SLOTS)
    keep = norm.dense_keep
    ni, nr, nc = len(dproblem.inst), len(dproblem.rigcam), len(dproblem.cam)
    pmax = dproblem.cam.shape[1]
    loss = problem.loss
    loss_threshold = float(problem.loss_threshold)
    block_fn = make_sharded_lm_block_dense(mesh, axis, ni, nr, nc, pmax,
                                           tol=tol, loss=loss,
                                           loss_threshold=loss_threshold)
    cost_fn = make_sharded_cost_dense(mesh, axis, ni, nc, pmax, loss=loss,
                                      loss_threshold=loss_threshold)
    a = {k: v.to(mesh.device)
         for k, v in _dense_block_args(dproblem, dtype).items()}

    lam = float(initial_lambda)
    cost = float(cost_fn(*(a[k] for k in _DENSE_BLOCK_NAMES)))
    initial_cost = cost
    accepted = rejects = trials = 0
    while accepted < max_iterations and trials < 16 * max_iterations:
        context.record_dispatch("cg_trial")
        out = block_fn(cost, lam, rejects, max_iterations - accepted,
                       *(a[k] for k in _DENSE_BLOCK_NAMES))
        stats = out[-1].numpy()
        a["inst"], a["cam"], a["points"] = out[0], out[1], out[2]
        cost, lam = float(stats[0]), float(stats[1])
        rejects = int(stats[2])
        accepted += int(stats[3])
        trials += int(stats[4])
        context.record_dispatch("sharded_trial", int(stats[4]))
        if bool(stats[5]) or rejects >= 16 or int(stats[4]) == 0:
            break

    solved = a["inst"].cpu().numpy()[:ni]
    inst = np.asarray(problem.inst).astype(solved.dtype)
    inst[keep] = solved
    return BAResult(
        inst=inst,
        rigcam=np.asarray(problem.rigcam),
        cam=a["cam"].cpu().numpy(),
        points=a["points"].cpu().numpy()[:npts_orig],
        scales=problem.scales,
        initial_cost=initial_cost,
        final_cost=cost,
        iterations=accepted,
        lam=lam,
        route="sharded_dense",
    )


def bundle_adjust_sharded(problem: BAProblem, max_iterations: int = 50,
                          initial_lambda: float = 1e-4, tol: float = 1e-10,
                          dtype=np.float32, mesh: Optional[Mesh] = None,
                          axis: str = "points", cg_iters: int = 100,
                          cg_tol: float = 1e-8, solver: str = "auto"):
    """LM to convergence with a sharded Schur step over `mesh`
    (`default_mesh()`, every visible CUDA device, when None).

    `solver`: "dense" = the dense-grid block solver (mono single-camera
    maps on the zero-padded [NP, NI] grid; the fused assembly,
    back-substitution and cost kernels per shard), "schur" = the
    assembled-Schur step (one [D, D] sum per trial; pose-graph families
    and scale variables), "cg" = matrix-free PCG on the Schur complement
    (one sum of camera-side vectors per CG iteration), "auto" = dense where
    `_dense_grid_eligible`, else schur where the problem has pose-graph rows
    or `_schur_eligible`, else cg.

    The damping policy is `lm._lm_solve`'s (accept on a cost drop, lam / 3
    on accept, lam * 10 on reject, stop at 16 consecutive rejects, rel <
    tol or `max_iterations` accepts).  Computes in `dtype` (f32 by default)
    with f64 accumulation for the objective sums and CG dot products.
    Returns a BAResult shaped like `bundle_adjust`'s (rigcam optimized when
    the problem optimizes it, passed through otherwise); its `route` reads
    `sharded_<solver>`."""
    reason = check_cg_compatible(problem)
    if reason == "no observations":
        raise ValueError(
            f"problem incompatible with the sharded path: {reason}")
    if reason is not None and solver == "cg":
        raise ValueError(
            f"pose-graph rows need the assembled-Schur solver: {reason}")

    if mesh is None:
        mesh = default_mesh()
    n_shards = mesh.n_shards
    npts_orig = len(problem.points)

    if solver == "auto" and _dense_grid_eligible(problem):
        solver = "dense"
    if solver == "dense":
        if not _dense_grid_eligible(problem):
            raise ValueError(
                "problem not eligible for the dense-grid sharded solver "
                "(needs mono perspective, identity rig, no depth/"
                "pose-graph rows, grid within the slot cap)")
        return _bundle_adjust_sharded_dense(problem, mesh, axis,
                                            max_iterations, initial_lambda,
                                            tol, dtype)

    sharded = shard_problem(problem, n_shards)
    types = sharded.cg_ptypes
    ptype = types if len(types) > 1 else types[0]
    graph = _graph_fields(sharded)
    ns = len(sharded.scales) if graph and sharded.scales is not None else 0
    rig_mode, with_depth, has_up, has_ang = _cg_modes(sharded)
    ni, nr, nc, npts, O, T = sharded.counts()
    pmax = sharded.cam.shape[1]
    win = int(getattr(sharded, "cg_window", 0) or 0)
    kw = dict(loss=problem.loss, loss_threshold=float(problem.loss_threshold),
              nr=nr, rig_mode=rig_mode, with_depth=with_depth, has_up=has_up,
              has_ang=has_ang)
    if solver == "auto":
        solver = "schur" if (graph or _schur_eligible(sharded, n_shards)) \
            else "cg"
    if graph and solver != "schur":
        raise ValueError("pose-graph rows need the assembled-Schur solver")
    block_fn = make_sharded_lm_block(mesh, axis, ptype, pmax, ni, nc,
                                     solver=solver, tol=tol,
                                     cg_iters=cg_iters, cg_tol=cg_tol,
                                     win=win, graph=graph, ns=ns, **kw)
    cost_fn = make_sharded_cost(mesh, axis, ptype, pmax, ni, nc, graph=graph,
                                ns=ns, **kw)
    a = {k: v.to(mesh.device)
         for k, v in _cg_args(sharded, n_shards, dtype).items()}
    rig_opt = rig_mode == "opt"
    state_keys = (
        ("inst", "rigcam", "cam", "points") if rig_opt
        else ("inst", "cam", "points")
    ) + (("scales",) if ns > 0 else ())

    dt = a["points"].dtype
    lam = float(initial_lambda)
    cost = float(cost_fn(*(a[k] for k in cost_fn.names)))
    initial_cost = cost
    accepted = rejects = trials = 0
    # The block sets lam per trial; the positional slot is filled all the
    # same.
    a["lam"] = torch.tensor(lam, dtype=dt)
    while accepted < max_iterations and trials < 16 * max_iterations:
        context.record_dispatch("cg_trial")
        out = block_fn(cost, lam, rejects, max_iterations - accepted,
                       *(a[k] for k in block_fn.names))
        stats = out[-1].numpy()
        a.update(dict(zip(state_keys, out[:-1])))
        cost, lam = float(stats[0]), float(stats[1])
        rejects = int(stats[2])
        accepted += int(stats[3])
        trials += int(stats[4])
        context.record_dispatch("sharded_trial", int(stats[4]))
        if bool(stats[5]) or rejects >= 16 or int(stats[4]) == 0:
            break

    return BAResult(
        inst=a["inst"].cpu().numpy()[:ni],
        rigcam=(a["rigcam"].cpu().numpy() if rig_opt
                else np.asarray(problem.rigcam)),
        cam=a["cam"].cpu().numpy(),
        points=a["points"].cpu().numpy()[:npts_orig],
        scales=(a["scales"].cpu().numpy() if ns > 0 else problem.scales),
        initial_cost=initial_cost,
        final_cost=cost,
        iterations=accepted,
        lam=lam,
        route=f"sharded_{solver}",
    )
