"""Dense-layout Schur assembly, back-substitution and cost: CUDA kernels +
plain twins.

Replaces the Pallas kernels of `opensfm_tpu/ops/pallas_kernels/ba_assemble.py`,
the LM bundle adjuster's dense mono fast path (the layout of
`canonicalize_problem_dense`: slot == instance, observations on the [NP, NI]
grid with dead slots at inv_sd == 0, one perspective camera [k1, k2, f],
identity rig):

- `fused_schur_assembly` (Pallas `_make_kernel`): from the raw inputs, per
  point the damped 3x3 Hessian's inverse, bp and Hinv bp (out_pt [NP, 16]:
  Hinv xx xy xz yy yz zz, bp, Hinv bp, 4 zeros); the Schur product
  S_II = sum_p Ga_p Hinv_p Ga_p^T as a symmetric [6 NI, 6 NI] matrix in
  (x, a) order (row x * NI + a); and the per-instance direct blocks and
  right-hand sides (aux [96, NI], the Pallas kernel's rows: 0-35 direct_II,
  36-53 direct_IC, 54-59 direct_CC upper triangle, 60-77 schur_IC, 78-83
  b_i, 84-86 b_c direct; 87-89 b_c schur and 90-95 schur_CC upper triangle
  in lane 0).
- `fused_back_substitute` (Pallas `_make_backsub_kernel`): the point updates
  dx_p = Hinv (bp - sum_a Jp^T (J_pose dx_a + J_cam dx_cam)), recomputing the
  Jacobian chain instead of keeping it: one block per chunk of points
  (`backsub_plan`), one thread per slot with its rotation and update
  computed once, the Jacobian contracted as it forms.
- `fused_cost_dense` (Pallas `_make_cost_kernel_dense`): the total robust
  cost over the grid, the slot number giving the indices.

The CUDA source (`csrc/ba_assemble.cu`) says what bounds each kernel and how
it is split into passes; every sum is taken in a fixed order (no atomics), so
the same inputs give the same bits on every run.

Each wrapper runs the plain PyTorch version when its tensors lie on the CPU
and launches the CUDA kernels when they lie on a CUDA device; it never falls
back from one to the other.  `<wrapper>.launches` counts the wrapper's calls
that launched its kernels: one call of `fused_schur_assembly` launches four
or five CUDA kernels (assembly, a one- or two-level chunk sum, product,
product sum; the f64 product on the f64 tensor cores), one of
`fused_cost_dense` two (partials, final sum), one of `fused_back_substitute`
one (`KERNELS_PER_CALL`).
"""

from __future__ import annotations

import ctypes

import torch

from opensfm_tpu_torch.ops.kernels import _build
from opensfm_tpu_torch.ops.kernels.ba_resjac import (
    LOSS_IDS,
    SMS,
    _loss,
    _raise_on,
    chain_fwd,
    chain_fwd_jac,
    cost_blocks,
)

SOURCE = "ba_assemble.cu"
PT_COLS = 16  # out_pt columns (kPt)
AUX_ROWS = 96  # aux rows (kAuxRows)
MAX_NI = 256  # one thread per instance slot (kMaxThreads)
KERNELS_PER_CALL = {"fused_back_substitute": 1}
BACKSUB_WARPS_PER_SM = 32  # the back-substitution plan's warps per SM
BACKSUB_SMEM = 48 * 1024  # its cap on a block's shared memory
BACKSUB_PT_STAGE = 12  # kPtStage: values staged per point (x, Hinv, bp)
SYRK_TILE = 64  # kTile: the product's output tile
SYRK_TILE_K = 16  # kTileK (f32) = kDmmaK (f64): k rows per stage
REDUCE_TILE = 16  # kRedTile: the split sum's tile
CHUNK_GROUP = 32  # kChunkGroup: chunk partials per first-level sum

_UPPER = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])  # 3x3 upper triangle
_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]  # upper triangle -> row-major 3x3


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the same arithmetic as the kernels)
# ---------------------------------------------------------------------------


def _dense_vals(inst, cam, points):
    """The chain's 12 inputs on the [NP, NI] grid: [1, NI] instance rows,
    the camera's first three parameters and [NP, 1] point columns, which the
    chain's arithmetic broadcasts."""
    return (tuple(inst[:, k][None] for k in range(6))
            + tuple(cam[0, k] for k in range(3))
            + tuple(points[:, k][:, None] for k in range(3)))


def _weighted(inst, cam, points, obs_uv, obs_inv_sd, loss, loss_threshold):
    """(r [NP, NI, 2], J [NP, NI, 2, 12]): sqrt-IRLS-weighted residuals and
    the 12 Jacobian columns scaled by inv_sd * sqrt(rho')."""
    ni, n_p = inst.shape[0], points.shape[0]
    _, drho = _loss(loss)
    a2 = float(loss_threshold) ** 2
    (p0, p1), J0, J1 = chain_fwd_jac(_dense_vals(inst, cam, points))
    uv = obs_uv.reshape(n_p, ni, 2)
    isd = obs_inv_sd.reshape(n_p, ni)
    e0 = (p0 - uv[..., 0]) * isd
    e1 = (p1 - uv[..., 1]) * isd
    s = e0 * e0 + e1 * e1
    sw = torch.sqrt(torch.clamp_min(drho(s / a2), 1e-12))
    scale = (isd * sw)[..., None, None]
    J = torch.stack([torch.stack(J0, -1), torch.stack(J1, -1)], dim=2) * scale
    return torch.stack([e0 * sw, e1 * sw], dim=-1), J


def _sym3_inv(H):
    """Closed-form inverse of symmetric [N, 3, 3] blocks as their upper
    triangles [N, 6]; a block with |det| < 1e-30 inverts to 0."""
    h = [H[:, i, j] for i, j in zip(*_UPPER)]
    c_xx = h[3] * h[5] - h[4] * h[4]
    c_xy = h[2] * h[4] - h[1] * h[5]
    c_xz = h[1] * h[4] - h[2] * h[3]
    c_yy = h[0] * h[5] - h[2] * h[2]
    c_yz = h[1] * h[2] - h[0] * h[4]
    c_zz = h[0] * h[3] - h[1] * h[1]
    det = h[0] * c_xx + h[1] * c_xy + h[2] * c_xz
    sing = torch.abs(det) < 1e-30
    inv_det = torch.where(sing, torch.zeros_like(det),
                          1.0 / torch.where(sing, torch.ones_like(det), det))
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], -1) * inv_det[:, None]


def _chol_lower(hi):
    """L [N, 3, 3] with L L^T = the symmetric blocks given by their upper
    triangles hi [N, 6] (semi-definite ones included: a zero pivot gives a
    zero column)."""
    tiny = 1e-30
    zero = torch.zeros_like(hi[:, 0])

    def inv(x):
        return torch.where(x > tiny, 1.0 / torch.clamp_min(x, tiny), zero)

    l00 = torch.sqrt(torch.clamp_min(hi[:, 0], 0.0))
    l10 = hi[:, 1] * inv(l00)
    l20 = hi[:, 2] * inv(l00)
    l11 = torch.sqrt(torch.clamp_min(hi[:, 3] - l10 * l10, 0.0))
    l21 = (hi[:, 4] - l20 * l10) * inv(l11)
    l22 = torch.sqrt(torch.clamp_min(hi[:, 5] - l20 * l20 - l21 * l21, 0.0))
    return torch.stack([l00, zero, zero, l10, l11, zero, l20, l21, l22],
                       -1).reshape(-1, 3, 3)


def fused_schur_assembly_plain(inst, cam, points, obs_uv, obs_inv_sd,
                               opt_inst, opt_cam, opt_points, point_prior,
                               point_prior_inv_sd, lam, loss: str,
                               loss_threshold: float):
    """Plain PyTorch version of `fused_schur_assembly`."""
    out_pt, bmat, aux = schur_terms_plain(
        inst, cam, points, obs_uv, obs_inv_sd, opt_inst, opt_cam, opt_points,
        point_prior, point_prior_inv_sd, lam, loss, loss_threshold)
    return out_pt, bmat.T @ bmat, aux


def schur_terms_plain(inst, cam, points, obs_uv, obs_inv_sd, opt_inst,
                      opt_cam, opt_points, point_prior, point_prior_inv_sd,
                      lam, loss: str, loss_threshold: float):
    """(out_pt, bmat, aux) of the dense assembly, the arguments those of
    `fused_schur_assembly`: bmat [3 NP, 6 NI] (rows (p, k), columns (x, a))
    is the Schur factor whose product bmat^T bmat is S_II, as the kernels'
    first pass writes it."""
    ni, n_p, dt = inst.shape[0], points.shape[0], points.dtype
    r, J = _weighted(inst, cam, points, obs_uv, obs_inv_sd, loss,
                     loss_threshold)
    mask = torch.cat([
        opt_inst.to(dt)[None, :, None].expand(n_p, ni, 6),
        opt_cam[0, :3].to(dt).expand(n_p, ni, 3),
        opt_points.to(dt)[:, None, None].expand(n_p, ni, 3),
    ], dim=-1)
    J = J * mask[:, :, None, :]
    Ji, Jc, Jp = J[..., :6], J[..., 6:9], J[..., 9:]

    # Per point: damped Hessian with the point prior, its inverse, bp.
    w = point_prior_inv_sd
    Hpp = torch.einsum("pakx,paky->pxy", Jp, Jp)
    bp = torch.einsum("pakx,pak->px", Jp, r) + (points - point_prior) * w * w
    diag = (torch.diagonal(Hpp, dim1=1, dim2=2) + w * w) * (1.0 + lam) + 1e-12
    eye = torch.eye(3, dtype=torch.bool, device=points.device)
    Hpp = torch.where(eye, torch.diag_embed(diag), Hpp)
    hi = _sym3_inv(Hpp) * opt_points.to(dt)[:, None]
    H = hi[:, _SYM].reshape(n_p, 3, 3)
    hib = torch.einsum("pjk,pk->pj", H, bp)
    L = _chol_lower(hi)

    # Couplings, Schur factor B = Ga L, and the camera-family factors.
    Vg = torch.einsum("paky,pakj->pyj", Jc, Jp)
    Ga = torch.einsum("pakx,pakj->paxj", Ji, Jp)
    B = torch.einsum("paxj,pjk->paxk", Ga, L)
    Bm = B.permute(0, 3, 2, 1).reshape(n_p * 3, 6 * ni)  # rows (p, k), cols (x, a)
    Cg = torch.einsum("pyj,pjk->pyk", Vg, L)
    Ug = torch.einsum("pyj,pjk->pyk", Vg, H)

    def lane0(v):
        out = torch.zeros((v.shape[0], ni), dtype=dt, device=points.device)
        out[:, 0] = v
        return out

    b_i = (torch.einsum("pakx,pak->pax", Ji, r)
           - torch.einsum("paxj,pj->pax", Ga, hib)).sum(0).T
    aux = torch.cat([
        torch.einsum("pakx,paky->xya", Ji, Ji).reshape(36, ni),
        torch.einsum("pakx,paky->xya", Ji, Jc).reshape(18, ni),
        torch.einsum("pakx,paky->xya", Jc, Jc)[_UPPER],
        torch.einsum("paxk,pyk->xya", B, Cg).reshape(18, ni),
        b_i,
        torch.einsum("paky,pak->ya", Jc, r),
        lane0(torch.einsum("pyj,pj->y", Vg, hib)),
        lane0(torch.einsum("pxk,pyk->xy", Ug, Vg)[_UPPER]),
    ])
    out_pt = torch.cat([hi, bp, hib, torch.zeros_like(hi[:, :4])], dim=1)
    return out_pt, Bm, aux


def fused_back_substitute_plain(inst, cam, points, obs_uv, obs_inv_sd, out_pt,
                                dx_i, dx_cam, loss: str,
                                loss_threshold: float):
    """Plain PyTorch version of `fused_back_substitute`."""
    ni = inst.shape[0]
    _, J = _weighted(inst, cam, points, obs_uv, obs_inv_sd, loss,
                     loss_threshold)
    d = torch.cat([dx_i[:, :6], dx_cam[0, :3].expand(ni, 3)], dim=1)  # [NI, 9]
    tmp = torch.einsum("pakx,ax->pak", J[..., :9], d)
    u = torch.einsum("pakj,pak->pj", J[..., 9:], tmp)
    H = out_pt[:, _SYM].reshape(-1, 3, 3)
    return torch.einsum("pjk,pk->pj", H, out_pt[:, 6:9] - u)


def fused_cost_dense_plain(inst, cam, points, obs_uv, obs_inv_sd, loss: str,
                           loss_threshold: float):
    """Plain PyTorch version of `fused_cost_dense`: a 0-d tensor."""
    ni, n_p = inst.shape[0], points.shape[0]
    rho, _ = _loss(loss)
    a2 = float(loss_threshold) ** 2
    p0, p1 = chain_fwd(_dense_vals(inst, cam, points))
    uv = obs_uv.reshape(n_p, ni, 2)
    isd = obs_inv_sd.reshape(n_p, ni)
    e0 = (p0 - uv[..., 0]) * isd
    e1 = (p1 - uv[..., 1]) * isd
    return torch.sum(0.5 * a2 * rho((e0 * e0 + e1 * e1) / a2))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double


def _bind(lib: ctypes.CDLL) -> None:
    for s in ("f32", "f64"):
        fn = getattr(lib, f"ba_schur_assembly_{s}")
        fn.argtypes = ([_P] * 10 + [_D, _I, _I, _I, _D, _I, _I, _I, _LL]
                       + [_P] * 8)
        fn.restype = _I
        fn = getattr(lib, f"ba_back_substitute_{s}")
        fn.argtypes = [_P] * 8 + [_I, _I, _I, _I, _I, _D, _P, _P]
        fn.restype = _I
        fn = getattr(lib, f"ba_cost_dense_{s}")
        fn.argtypes = [_P] * 5 + [_I, _LL, _I, _D, _I, _P, _P, _P]
        fn.restype = _I


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def _check_cuda(inst, cam, points, obs_uv, obs_inv_sd, loss, *more):
    """Validates what the kernels take (`more`: further floating tensors);
    returns (dtype suffix, loss id)."""
    floats = (inst, cam, points, obs_uv, obs_inv_sd) + more
    dev = obs_uv.device
    dtype = obs_uv.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32 or float64, not {dtype}")
    for t in floats:
        if t.device != dev:
            raise ValueError("all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
        if t.dtype != dtype:
            raise TypeError("all floating tensors must share one dtype")
    ni, n_p = inst.shape[0], points.shape[0]
    if (inst.dim() != 2 or inst.shape[1] != 6 or cam.dim() != 2
            or cam.shape[0] < 1 or cam.shape[1] < 3 or points.dim() != 2
            or points.shape[1] != 3 or obs_uv.shape != (n_p * ni, 2)
            or obs_inv_sd.shape != (n_p * ni,)):
        raise ValueError("bad shapes for the dense-layout kernels")
    if loss not in LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}")
    return ("f32" if dtype == torch.float32 else "f64"), LOSS_IDS[loss]


def _check_slots(ni: int) -> None:
    if not 1 <= ni <= MAX_NI:
        raise ValueError(f"the kernel runs one thread per instance slot: "
                         f"1..{MAX_NI} instances, not {ni}")


def assembly_plan(ni: int, n_p: int):
    """(chunk, chunks, splits, split depth) of the assembly: points per block
    of the first pass, its blocks, and the K-splits of the S_II product with
    their depth (a multiple of the product's stage depth).  The product runs
    one block per lower output tile and split, about four per SM: at
    64 x 8,192, 21 tiles x 25 splits = 525 blocks over the 132 SMs, one
    wave.  A function of the shapes alone, so the summation order, and the
    result, are the same on every call."""
    warps = -(-ni // 32)
    chunk = -(-n_p // max(1, SMS * 8 // warps))
    n_chunks = -(-n_p // chunk)
    k = 3 * n_p
    n_split = max(1, min(4 * SMS // len(product_tiles(6 * ni)), k // 512))
    k_split = -(-(-(-k // n_split)) // SYRK_TILE_K) * SYRK_TILE_K
    return chunk, n_chunks, -(-k // k_split), k_split


def backsub_smem(ni: int, chunk: int, itemsize: int = 8) -> int:
    """Shared memory of a back-substitution block: per point of the chunk
    each slot thread's (uv, inv_sd) and three u values, and the point's
    staged x, Hinv and bp."""
    threads = -(-ni // 32) * 32
    return itemsize * chunk * (6 * threads + BACKSUB_PT_STAGE)


def backsub_plan(ni: int, n_p: int):
    """(chunk, chunks) of the back-substitution: points per block and
    blocks, block b taking points [b * chunk, min((b + 1) * chunk, NP)).
    About BACKSUB_WARPS_PER_SM warps of slot threads on each SM, and the
    block's shared memory (f64) within BACKSUB_SMEM.  A function of the
    shapes alone."""
    threads = -(-ni // 32) * 32
    cap = max(1, BACKSUB_SMEM // backsub_smem(ni, 1))
    blocks = max(1, SMS * BACKSUB_WARPS_PER_SM // (threads // 32))
    chunk = max(1, min(cap, -(-n_p // blocks)))
    return chunk, -(-n_p // chunk)


def product_tiles(n: int, tile: int = SYRK_TILE):
    """[(tile row, tile column)] of the product's blocks in blockIdx.x order,
    the tiles on and below the diagonal of an n x n output, row by row (the
    kernels' `lower_tile`; the split sum walks its REDUCE_TILE tiles
    alike)."""
    t = -(-n // tile)
    return [(r, c) for r in range(t) for c in range(r + 1)]


def fused_schur_assembly(inst, cam, points, obs_uv, obs_inv_sd, opt_inst,
                         opt_cam, opt_points, point_prior, point_prior_inv_sd,
                         lam, loss: str, loss_threshold: float):
    """(out_pt [NP, 16], S_II [6 NI, 6 NI], aux [96, NI]) of the dense
    instance-slot layout (see the module docstring); `point_prior_inv_sd`
    [NP, 3] carries any robust point-prior weight already, `lam` is the LM
    damping."""
    if obs_uv.device.type == "cpu":
        return fused_schur_assembly_plain(
            inst, cam, points, obs_uv, obs_inv_sd, opt_inst, opt_cam,
            opt_points, point_prior, point_prior_inv_sd, lam, loss,
            loss_threshold,
        )
    if obs_uv.device.type != "cuda":
        raise ValueError(f"unsupported device {obs_uv.device}")
    suffix, loss_id = _check_cuda(inst, cam, points, obs_uv, obs_inv_sd, loss,
                                  point_prior, point_prior_inv_sd)
    ni, n_p, dt = inst.shape[0], points.shape[0], obs_uv.dtype
    _check_slots(ni)
    if point_prior.shape != (n_p, 3) or point_prior_inv_sd.shape != (n_p, 3) \
            or opt_inst.shape != (ni,) or opt_points.shape != (n_p,) \
            or opt_cam.dim() != 2 or opt_cam.shape[1] < 3:
        raise ValueError("bad shapes for fused_schur_assembly")
    new = dict(dtype=dt, device=obs_uv.device)
    out_pt = torch.empty((n_p, PT_COLS), **new)
    s_ii = torch.empty((6 * ni, 6 * ni), **new)
    aux = torch.empty((AUX_ROWS, ni), **new)
    if n_p == 0:
        return out_pt, s_ii.zero_(), aux.zero_()
    # The masks as bytes (0 or 1): the solver's bool masks need no copy.
    opt_i, opt_c, opt_p = (m.to(torch.bool).contiguous().view(torch.uint8)
                           for m in (opt_inst, opt_cam, opt_points))
    chunk, n_chunks, n_split, k_split = assembly_plan(ni, n_p)
    bmat = torch.empty((3 * n_p, 6 * ni), **new)
    aux_part = torch.empty((n_chunks, AUX_ROWS, ni), **new)
    aux_mid = torch.empty((-(-n_chunks // CHUNK_GROUP), AUX_ROWS, ni), **new)
    syrk_part = torch.empty((n_split, 6 * ni, 6 * ni), **new)
    fn = getattr(_lib(), f"ba_schur_assembly_{suffix}")
    with torch.cuda.device(obs_uv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(inst.data_ptr(), cam.data_ptr(), points.data_ptr(),
                 obs_uv.data_ptr(), obs_inv_sd.data_ptr(), opt_i.data_ptr(),
                 opt_c.data_ptr(), opt_p.data_ptr(), point_prior.data_ptr(),
                 point_prior_inv_sd.data_ptr(), 1.0 + float(lam), ni, n_p,
                 loss_id, float(loss_threshold), chunk, n_chunks, n_split,
                 k_split, out_pt.data_ptr(), bmat.data_ptr(),
                 aux_part.data_ptr(), aux_mid.data_ptr(), aux.data_ptr(),
                 syrk_part.data_ptr(), s_ii.data_ptr(), stream)
    _raise_on(err, "fused_schur_assembly")
    fused_schur_assembly.launches += 1
    return out_pt, s_ii, aux


fused_schur_assembly.launches = 0


def fused_back_substitute(inst, cam, points, obs_uv, obs_inv_sd, out_pt, dx_i,
                          dx_cam, loss: str, loss_threshold: float):
    """dx_p [NP, 3] from the reduced-system solution dx_i [NI, 6] and
    dx_cam [1, >=3], and the assembly's out_pt [NP, 16]."""
    if obs_uv.device.type == "cpu":
        return fused_back_substitute_plain(
            inst, cam, points, obs_uv, obs_inv_sd, out_pt, dx_i, dx_cam, loss,
            loss_threshold,
        )
    if obs_uv.device.type != "cuda":
        raise ValueError(f"unsupported device {obs_uv.device}")
    suffix, loss_id = _check_cuda(inst, cam, points, obs_uv, obs_inv_sd, loss,
                                  out_pt, dx_i, dx_cam)
    ni, n_p = inst.shape[0], points.shape[0]
    _check_slots(ni)
    if out_pt.shape != (n_p, PT_COLS) or dx_i.shape != (ni, 6) \
            or dx_cam.dim() != 2 or dx_cam.shape[1] < 3:
        raise ValueError("bad shapes for fused_back_substitute")
    if obs_uv.data_ptr() % (2 * obs_uv.element_size()):
        raise ValueError("the kernel reads each obs_uv row as one aligned "
                         "vector: obs_uv must start on a row boundary")
    dx_p = torch.empty((n_p, 3), dtype=obs_uv.dtype, device=obs_uv.device)
    if n_p == 0:
        return dx_p
    chunk, n_chunks = backsub_plan(ni, n_p)
    _launch_back_substitute(
        (inst, cam, points, obs_uv, obs_inv_sd, out_pt, dx_i, dx_cam),
        suffix, loss_id, loss_threshold, chunk, n_chunks, dx_p)
    return dx_p


def _launch_back_substitute(args, suffix, loss_id, loss_threshold, chunk,
                            n_chunks, dx_p):
    """Launches the back-substitution on the checked `args` with the plan
    (chunk, n_chunks) into dx_p and counts the launch in
    `fused_back_substitute.launches`.  `fused_back_substitute` passes
    backsub_plan's; other chunks serve the card's sweeps."""
    ni, n_p = args[0].shape[0], args[2].shape[0]
    fn = getattr(_lib(), f"ba_back_substitute_{suffix}")
    with torch.cuda.device(dx_p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in args), ni, n_p, chunk, n_chunks,
                 loss_id, float(loss_threshold), dx_p.data_ptr(), stream)
    _raise_on(err, "fused_back_substitute")
    fused_back_substitute.launches += 1
    return dx_p


fused_back_substitute.launches = 0


def fused_cost_dense(inst, cam, points, obs_uv, obs_inv_sd, loss: str,
                     loss_threshold: float):
    """Total robust reprojection cost (a 0-d tensor) over the dense grid:
    observation p * NI + a is point p seen by instance a."""
    if obs_uv.device.type == "cpu":
        return fused_cost_dense_plain(inst, cam, points, obs_uv, obs_inv_sd,
                                      loss, loss_threshold)
    if obs_uv.device.type != "cuda":
        raise ValueError(f"unsupported device {obs_uv.device}")
    suffix, loss_id = _check_cuda(inst, cam, points, obs_uv, obs_inv_sd, loss)
    n = obs_uv.shape[0]
    new = dict(dtype=obs_uv.dtype, device=obs_uv.device)
    if n == 0:
        return torch.zeros((), **new)
    n_blocks = cost_blocks(n)
    partials = torch.empty((n_blocks,), **new)
    out = torch.empty((), **new)
    fn = getattr(_lib(), f"ba_cost_dense_{suffix}")
    with torch.cuda.device(obs_uv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(inst.data_ptr(), cam.data_ptr(), points.data_ptr(),
                 obs_uv.data_ptr(), obs_inv_sd.data_ptr(), inst.shape[0], n,
                 loss_id, float(loss_threshold), n_blocks, partials.data_ptr(),
                 out.data_ptr(), stream)
    _raise_on(err, "fused_cost_dense")
    fused_cost_dense.launches += 1
    return out


fused_cost_dense.launches = 0
