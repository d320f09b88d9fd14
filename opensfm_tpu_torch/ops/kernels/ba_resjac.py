"""Bundle-adjustment residual/Jacobian and cost: CUDA kernels + plain twins.

Replaces the Pallas kernels of `opensfm_tpu/ops/pallas_kernels/ba_resjac.py`
for the mono perspective configuration (identity rig, camera [k1, k2, f]):

- `fused_residual_jacobian` (Pallas `_make_kernel`, math `chain_fwd_jac`):
  per observation the whitened, sqrt-IRLS-weighted residual r[O, 2], the
  Jacobian columns Jc[O, 2, 9] (6 instance pose, k1, k2, focal) and
  Jp[O, 2, 3] (point), and the robust cost[O].
- `fused_cost` (Pallas `_make_cost_kernel`, math `_chain`): the total robust
  cost only, for the LM accept/reject trial.

Both read 36 B per f64 observation (the residual/Jacobian kernel writes
216 B more).  The CUDA source (`csrc/ba_resjac.cu`) gathers each
observation's table rows through the index arrays, so any layout (gathered,
canonical (point, slot), dense instance-slot) is served by the same kernels.
The residual/Jacobian kernel runs one thread per observation.  The cost
kernel runs `cost_plan(O)`'s grid, several observations a thread, with the
instances' rotation coefficients computed once per block into a table in
shared memory (`cost_table_rows`; a larger map in tiles), and sums in one
pass: the last block to finish adds the
block sums in block order, elected by a per-device ticket counter
(`_ticket`), so the sum is deterministic.

Each wrapper runs the plain PyTorch version when its tensors lie on the CPU
and launches the CUDA kernel when they lie on a CUDA device; it never falls
back from one to the other.  `<wrapper>.launches` counts the wrapper's calls
that launched its kernels: one call of either launches one CUDA kernel
(`KERNELS_PER_CALL`).  Two cost calls on one device (`fused_cost`, and
`fused_cost_dense` of `ba_assemble`) must not run at once on two streams:
they share the device's ticket counter.
"""

from __future__ import annotations

import ctypes

import torch

from opensfm_tpu_torch.geometry.rotation import rodrigues_coeffs
from opensfm_tpu_torch.ops.kernels import _build

SOURCE = "ba_resjac.cu"
LOSS_IDS = {
    "TrivialLoss": 0, "SoftLOneLoss": 1, "CauchyLoss": 2, "HuberLoss": 3,
    "TukeyLoss": 4,
}
COST_BLOCK = 256  # threads per block of the cost kernels (kCostBlock)
SMS = 132  # streaming multiprocessors of an H100 SXM
COST_BLOCKS_PER_SM = 2  # resident cost blocks per SM (kCostMinBlocks)
COST_BATCH = 4  # fused_cost: observations in flight per thread (kCostBatch)
INST_COLS = 9  # values of a cost block's instance table row (kInstCols)
INST_TABLE_BYTES = 96 * 1024  # its cap on a block's table (kInstTableBytes)
KERNELS_PER_CALL = {"fused_residual_jacobian": 1, "fused_cost": 1}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the same arithmetic as the kernels)
# ---------------------------------------------------------------------------


def chain_fwd(vals):
    """pred = perspective(distort(R(w) x + t)), componentwise over [O]."""
    w0, w1, w2, t0, t1, t2, k1, k2, f, x0, x1, x2 = vals
    cos_t, sinc, ccos = rodrigues_coeffs(w0 * w0 + w1 * w1 + w2 * w2)
    cxx = w1 * x2 - w2 * x1
    cyy = w2 * x0 - w0 * x2
    czz = w0 * x1 - w1 * x0
    rdx = w0 * x0 + w1 * x1 + w2 * x2
    X0 = x0 * cos_t + cxx * sinc + w0 * rdx * ccos + t0
    X1 = x1 * cos_t + cyy * sinc + w1 * rdx * ccos + t1
    X2 = x2 * cos_t + czz * sinc + w2 * rdx * ccos + t2
    iz = 1.0 / X2
    u = X0 * iz
    v = X1 * iz
    r2 = u * u + v * v
    d = 1.0 + r2 * (k1 + k2 * r2)
    return f * d * u, f * d * v


def chain_fwd_jac(vals):
    """Forward projection + the 12 Jacobian columns in closed form.

    Returns ((p0, p1), J0, J1) with J0/J1 12-lists of the two residual
    components' derivatives in direction order (w0..w2, t0..t2, k1, k2, f,
    x0..x2): the Rodrigues derivative d(Rx)/dw_i = w_i V + sinc (e_i x x) +
    ccos (rdx e_i + x_i w) composed with the 2x3 projection Jacobian."""
    w0, w1, w2, t0, t1, t2, k1, k2, f, x0, x1, x2 = vals
    cos_t, sinc, ccos, sp, gp = rodrigues_coeffs(
        w0 * w0 + w1 * w1 + w2 * w2, derivs=True)
    cxx = w1 * x2 - w2 * x1
    cyy = w2 * x0 - w0 * x2
    czz = w0 * x1 - w1 * x0
    rdx = w0 * x0 + w1 * x1 + w2 * x2
    X0 = x0 * cos_t + cxx * sinc + w0 * rdx * ccos + t0
    X1 = x1 * cos_t + cyy * sinc + w1 * rdx * ccos + t1
    X2 = x2 * cos_t + czz * sinc + w2 * rdx * ccos + t2

    iz = 1.0 / X2
    u = X0 * iz
    v = X1 * iz
    r2 = u * u + v * v
    d = 1.0 + r2 * (k1 + k2 * r2)
    p0 = f * d * u
    p1 = f * d * v

    # P = d(pred)/d(u, v); A = P @ [[1, 0, -u], [0, 1, -v]] / z  (2x3).
    fdd = 2.0 * f * (k1 + 2.0 * k2 * r2)
    fd = f * d
    P00 = fd + fdd * u * u
    P01 = fdd * u * v
    P11 = fd + fdd * v * v
    A00 = P00 * iz
    A01 = P01 * iz
    A02 = -(P00 * u + P01 * v) * iz
    A10 = P01 * iz
    A11 = P11 * iz
    A12 = -(P01 * u + P11 * v) * iz

    # R = cos I + sinc [w]x + ccos w w^T (its columns are dX/dx).
    R00 = cos_t + ccos * w0 * w0
    R01 = ccos * w0 * w1 - sinc * w2
    R02 = ccos * w0 * w2 + sinc * w1
    R10 = ccos * w0 * w1 + sinc * w2
    R11 = cos_t + ccos * w1 * w1
    R12 = ccos * w1 * w2 - sinc * w0
    R20 = ccos * w0 * w2 - sinc * w1
    R21 = ccos * w1 * w2 + sinc * w0
    R22 = cos_t + ccos * w2 * w2

    V0 = -sinc * x0 + sp * cxx + gp * rdx * w0
    V1 = -sinc * x1 + sp * cyy + gp * rdx * w1
    V2 = -sinc * x2 + sp * czz + gp * rdx * w2
    Dw = (
        (w0 * V0 + ccos * (rdx + x0 * w0),
         w0 * V1 - sinc * x2 + ccos * x0 * w1,
         w0 * V2 + sinc * x1 + ccos * x0 * w2),
        (w1 * V0 + sinc * x2 + ccos * x1 * w0,
         w1 * V1 + ccos * (rdx + x1 * w1),
         w1 * V2 - sinc * x0 + ccos * x1 * w2),
        (w2 * V0 - sinc * x1 + ccos * x2 * w0,
         w2 * V1 + sinc * x0 + ccos * x2 * w1,
         w2 * V2 + ccos * (rdx + x2 * w2)),
    )

    J0 = [None] * 12
    J1 = [None] * 12
    for i in range(3):  # w directions
        D0, D1, D2 = Dw[i]
        J0[i] = A00 * D0 + A01 * D1 + A02 * D2
        J1[i] = A10 * D0 + A11 * D1 + A12 * D2
    J0[3], J0[4], J0[5] = A00, A01, A02  # t directions
    J1[3], J1[4], J1[5] = A10, A11, A12
    fu = f * u
    fv = f * v
    J0[6], J1[6] = fu * r2, fv * r2               # k1
    J0[7], J1[7] = fu * r2 * r2, fv * r2 * r2     # k2
    J0[8], J1[8] = d * u, d * v                   # f
    Rcols = ((R00, R10, R20), (R01, R11, R21), (R02, R12, R22))
    for j in range(3):  # x directions: A @ R[:, j]
        Rj0, Rj1, Rj2 = Rcols[j]
        J0[9 + j] = A00 * Rj0 + A01 * Rj1 + A02 * Rj2
        J1[9 + j] = A10 * Rj0 + A11 * Rj1 + A12 * Rj2
    return (p0, p1), J0, J1


def _gather(inst, cam, points, obs_inst, obs_cam, obs_point):
    gi = inst[obs_inst]
    gc = cam[obs_cam, :3]
    gx = points[obs_point]
    return (
        tuple(gi.unbind(-1)) + tuple(gc.unbind(-1)) + tuple(gx.unbind(-1))
    )


def _loss(loss: str):
    from opensfm_tpu_torch.ba.lm import LOSSES

    return LOSSES[loss]


def fused_residual_jacobian_plain(inst, cam, points, obs_inst, obs_cam,
                                  obs_point, obs_uv, obs_inv_sd, loss: str,
                                  loss_threshold: float):
    """Plain PyTorch version of `fused_residual_jacobian`."""
    rho, drho = _loss(loss)
    a2 = float(loss_threshold) ** 2
    (p0, p1), J0, J1 = chain_fwd_jac(
        _gather(inst, cam, points, obs_inst, obs_cam, obs_point)
    )
    isd = obs_inv_sd
    e0 = (p0 - obs_uv[:, 0]) * isd
    e1 = (p1 - obs_uv[:, 1]) * isd
    s = e0 * e0 + e1 * e1
    cost = 0.5 * a2 * rho(s / a2)
    sw = torch.sqrt(torch.clamp_min(drho(s / a2), 1e-12))
    r = torch.stack([e0 * sw, e1 * sw], dim=-1)
    scale = (isd * sw)[:, None, None]
    J = torch.stack([torch.stack(J0, -1), torch.stack(J1, -1)], dim=1) * scale
    return r, J[:, :, :9], J[:, :, 9:], cost


def fused_cost_plain(inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
                     obs_inv_sd, loss: str, loss_threshold: float):
    """Plain PyTorch version of `fused_cost`: a 0-d tensor."""
    rho, _ = _loss(loss)
    a2 = float(loss_threshold) ** 2
    p0, p1 = chain_fwd(
        _gather(inst, cam, points, obs_inst, obs_cam, obs_point)
    )
    e0 = (p0 - obs_uv[:, 0]) * obs_inv_sd
    e1 = (p1 - obs_uv[:, 1]) * obs_inv_sd
    return torch.sum(0.5 * a2 * rho((e0 * e0 + e1 * e1) / a2))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double


def _bind(lib: ctypes.CDLL) -> None:
    head = [_P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _LL, _I, _D]
    for name in ("ba_resjac_f32", "ba_resjac_f64"):
        fn = getattr(lib, name)
        fn.argtypes = head + [_P, _P, _P, _P, _P]
        fn.restype = _I
    for name in ("ba_cost_f32", "ba_cost_f64"):
        fn = getattr(lib, name)
        fn.argtypes = head + [_I, _I, _I, _P, _P, _P, _P]
        fn.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check_cuda(inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
                obs_inv_sd, loss):
    """Validates what the kernels take; returns (dtype suffix, loss id)."""
    floats = (inst, cam, points, obs_uv, obs_inv_sd)
    ints = (obs_inst, obs_cam, obs_point)
    dev = obs_uv.device
    for t in floats + ints:
        if t.device != dev:
            raise ValueError("all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    dtype = obs_uv.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32 or float64, not {dtype}")
    if any(t.dtype != dtype for t in floats):
        raise TypeError("all floating tensors must share one dtype")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("observation indices must be int32")
    n = obs_uv.shape[0]
    if (inst.dim() != 2 or inst.shape[1] != 6 or cam.dim() != 2
            or cam.shape[1] < 3 or points.dim() != 2 or points.shape[1] != 3
            or obs_uv.shape != (n, 2) or obs_inv_sd.shape != (n,)
            or any(t.shape != (n,) for t in ints)):
        raise ValueError("bad shapes for the residual/Jacobian kernels")
    if obs_uv.data_ptr() % (2 * obs_uv.element_size()):
        raise ValueError("the kernels read each obs_uv row as one aligned "
                         "vector: obs_uv must start on a row boundary")
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}")
    return ("f32" if dtype == torch.float32 else "f64"), LOSS_IDS[loss]


def _table_args(inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
                obs_inv_sd, loss_id, loss_threshold):
    return [
        inst.data_ptr(), inst.shape[0], cam.data_ptr(), cam.shape[0],
        cam.shape[1], points.data_ptr(), points.shape[0],
        obs_inst.data_ptr(), obs_cam.data_ptr(), obs_point.data_ptr(),
        obs_uv.data_ptr(), obs_inv_sd.data_ptr(), obs_uv.shape[0], loss_id,
        float(loss_threshold),
    ]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cuda error {err})")


def fused_residual_jacobian(inst, cam, points, obs_inst, obs_cam, obs_point,
                            obs_uv, obs_inv_sd, loss: str,
                            loss_threshold: float):
    """(r[O, 2], Jc[O, 2, 9], Jp[O, 2, 3], cost[O]): whitened residuals and
    Jacobians scaled by sqrt(rho'), and the per-observation robust cost, for
    observation o of instance obs_inst[o], camera obs_cam[o] (its first three
    parameters, [k1, k2, focal]) and point obs_point[o]."""
    if obs_uv.device.type == "cpu":
        return fused_residual_jacobian_plain(
            inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
            obs_inv_sd, loss, loss_threshold,
        )
    if obs_uv.device.type != "cuda":
        raise ValueError(f"unsupported device {obs_uv.device}")
    suffix, loss_id = _check_cuda(inst, cam, points, obs_inst, obs_cam,
                                  obs_point, obs_uv, obs_inv_sd, loss)
    n = obs_uv.shape[0]
    new = dict(dtype=obs_uv.dtype, device=obs_uv.device)
    r = torch.empty((n, 2), **new)
    Jc = torch.empty((n, 2, 9), **new)
    Jp = torch.empty((n, 2, 3), **new)
    cost = torch.empty((n,), **new)
    if n:
        fn = getattr(_lib(), f"ba_resjac_{suffix}")
        with torch.cuda.device(obs_uv.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*_table_args(inst, cam, points, obs_inst, obs_cam,
                                  obs_point, obs_uv, obs_inv_sd, loss_id,
                                  loss_threshold),
                     r.data_ptr(), Jc.data_ptr(), Jp.data_ptr(),
                     cost.data_ptr(), stream)
        _raise_on(err, "fused_residual_jacobian")
        fused_residual_jacobian.launches += 1
    return r, Jc, Jp, cost


fused_residual_jacobian.launches = 0


def cost_plan(n_obs: int):
    """(blocks, observations per thread) of `fused_cost`: block b sums
    observations [b * span, (b + 1) * span), span = per_thread * COST_BLOCK,
    thread t those at t + COST_BLOCK * k, k < per_thread.  No more blocks
    than COST_BLOCKS_PER_SM on each SM (one wave), so up to 270,336
    observations a thread's COST_BATCH loads are all in flight at once.  A
    function of O alone, so the sum's order, and its bits, are the same on
    every call."""
    per_thread = max(1, -(-n_obs // (COST_BLOCK * SMS * COST_BLOCKS_PER_SM)))
    return max(1, -(-n_obs // (COST_BLOCK * per_thread))), per_thread


_tickets = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The device's ticket counter of the one-pass sum: allocated (zero) at
    its first use, set back to zero by every launch that uses it."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    t = _tickets.get(index)
    if t is None:
        t = _tickets[index] = torch.zeros(
            (1,), dtype=torch.int32, device=torch.device("cuda", index))
    return t


def cost_table_rows(n_inst: int, itemsize: int) -> int:
    """Instances in a cost block's table (a tile; `fused_cost` and
    `fused_cost_dense`): all n_inst when
    their rows fit INST_TABLE_BYTES (1,365 in f64, 2,730 in f32), else as
    many as fit, the kernel then walking the instances in tiles of that
    many.  A function of the shapes alone."""
    return max(1, min(n_inst, INST_TABLE_BYTES // (INST_COLS * itemsize)))


def _launch_cost(args, loss_id, loss_threshold, suffix, plan, tile_rows):
    """Launches the cost kernel on `args` (the eight tensors of `fused_cost`,
    checked, O > 0) with the grid `plan` = (blocks, per_thread) and tables
    of `tile_rows` instances, counts the launch in `fused_cost.launches` and
    returns the 0-d result.  `fused_cost` passes cost_plan(O) and
    cost_table_rows; other values serve the card's checks and sweeps."""
    obs_uv = args[6]
    new = dict(dtype=obs_uv.dtype, device=obs_uv.device)
    n_blocks, per_thread = plan
    partials = torch.empty((n_blocks,), **new)
    out = torch.empty((), **new)
    fn = getattr(_lib(), f"ba_cost_{suffix}")
    with torch.cuda.device(obs_uv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*_table_args(*args, loss_id, loss_threshold), n_blocks,
                 per_thread, tile_rows, partials.data_ptr(),
                 _ticket(obs_uv.device).data_ptr(), out.data_ptr(), stream)
    _raise_on(err, "fused_cost")
    fused_cost.launches += 1
    return out


def fused_cost(inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
               obs_inv_sd, loss: str, loss_threshold: float):
    """Total robust reprojection cost (a 0-d tensor): the forward chain only.
    An empty problem costs 0."""
    if obs_uv.device.type == "cpu":
        return fused_cost_plain(
            inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
            obs_inv_sd, loss, loss_threshold,
        )
    if obs_uv.device.type != "cuda":
        raise ValueError(f"unsupported device {obs_uv.device}")
    args = (inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
            obs_inv_sd)
    suffix, loss_id = _check_cuda(*args, loss)
    n = obs_uv.shape[0]
    if n == 0:
        return torch.zeros((), dtype=obs_uv.dtype, device=obs_uv.device)
    return _launch_cost(args, loss_id, loss_threshold, suffix, cost_plan(n),
                        cost_table_rows(inst.shape[0], obs_uv.element_size()))


fused_cost.launches = 0
