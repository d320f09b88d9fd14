"""The port's plain dense-layout kernels (the CUDA kernels' twins in
`opensfm_tpu_torch/ops/kernels/ba_assemble.py`) against the JAX reference:
in f32 against the Pallas kernels of `ops/pallas_kernels/ba_assemble.py` in
interpret mode, in f64 against the reference's XLA dense path
(`lm._build_reduced_system(dense=True)`, `lm._back_substitute`,
`lm._total_cost`), for the five losses, with fixed instances and points, point
priors and dead slots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_problem
from opensfm_tpu.ba import lm as ref_lm
from opensfm_tpu.ops.pallas_kernels import ba_assemble as ref_k
from opensfm_tpu_torch.ba import lm as port_lm
from opensfm_tpu_torch.ops.kernels import ba_assemble as port_k

LOSSES = ["TrivialLoss", "SoftLOneLoss", "CauchyLoss", "HuberLoss",
          "TukeyLoss"]
INTS = ("obs_point", "obs_inst", "obs_rigcam", "obs_cam", "point_obs")
BOOLS = ("cam_log_mask", "opt_inst", "opt_rigcam", "opt_cam", "opt_points")
FLOATS = ("obs_uv", "obs_inv_sd", "gps_pos", "gps_inv_sd", "cam_prior",
          "cam_prior_inv_sd", "rigcam_prior", "rigcam_prior_inv_sd",
          "point_prior", "point_prior_inv_sd")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(ni, n_points, seed, loss):
    """A dense mono problem with fixed instances and points, point priors
    and ~10% dead slots (inv_sd = 0)."""
    problem, dense = ref_lm.canonicalize_problem_dense(
        _make_problem(n_shots=ni, n_points=n_points, seed=seed))
    assert dense
    rng = np.random.default_rng(seed)
    problem.opt_inst[0] = False
    problem.opt_points[:7] = False
    problem.point_prior = problem.points + rng.normal(0, 0.02,
                                                      problem.points.shape)
    problem.point_prior_inv_sd[3:9] = 2.0
    dead = rng.random(len(problem.obs_inv_sd)) < 0.1
    problem.obs_inv_sd[dead] = 0.0
    problem.obs_uv[dead] = 0.0
    problem.loss = loss
    return problem


def _ref_state_data(problem, dtype):
    data = {}
    for name in FLOATS + INTS + BOOLS:
        x = getattr(problem, name)
        data[name] = (jnp.asarray(x, jnp.int32) if name in INTS
                      else jnp.asarray(x, bool) if name in BOOLS
                      else jnp.asarray(x, dtype))
    state = tuple(jnp.asarray(getattr(problem, k), dtype)
                  for k in ("inst", "rigcam", "cam", "points"))
    return state + (jnp.zeros(0, dtype),), data


def _port_state_data(problem, dtype):
    p, dense, state, data = port_lm.device_problem(
        port_lm.problem_from_numpy(problem), dtype, torch.device("cpu"))
    assert dense
    return state, data


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("loss", LOSSES)
def test_plain_f32_matches_pallas_interpret(loss):
    """Every output of the three kernels against the Pallas kernels.  f32
    sums over 8 slots and 128 points in another order: S_II, aux and the
    per-point rows within 1e-4 of each output's largest entry (the
    tolerance of tests/test_pallas_kernels.py for the assembled system),
    the point updates within 1e-3 (bp - u cancels), the cost within 1e-5."""
    problem = _problem(8, 128, seed=1, loss=loss)
    ni, lam = 8, 1e-3
    f = lambda k: jnp.asarray(getattr(problem, k), jnp.float32)  # noqa: E731
    jargs = (f("inst"), f("cam"), f("points"), f("obs_uv"), f("obs_inv_sd"))
    _, want_pt, want_sii, want_aux = ref_k.fused_schur_assembly(
        *jargs, jnp.asarray(problem.opt_inst), jnp.asarray(problem.opt_cam),
        jnp.asarray(problem.opt_points), f("point_prior"),
        f("point_prior_inv_sd"), lam, loss=loss, loss_threshold=1.0, ni=ni,
        interpret=True, emit_obs_rows=False)
    rng = np.random.default_rng(2)
    dx_i = 1e-3 * rng.normal(size=(ni, 6))
    dx_cam = 1e-3 * rng.normal(size=(1, 3))
    want_dx = ref_k.fused_back_substitute(
        *jargs, want_pt, jnp.asarray(dx_i, jnp.float32),
        jnp.asarray(dx_cam, jnp.float32), loss=loss, loss_threshold=1.0,
        ni=ni, interpret=True)
    want_cost = float(ref_k.fused_cost_dense(
        *jargs, loss=loss, loss_threshold=1.0, ni=ni, interpret=True))

    t = lambda k: torch.as_tensor(getattr(problem, k), dtype=torch.float32)  # noqa: E731
    targs = (t("inst"), t("cam"), t("points"), t("obs_uv"), t("obs_inv_sd"))
    out_pt, s_ii, aux = port_k.fused_schur_assembly(
        *targs, torch.as_tensor(problem.opt_inst),
        torch.as_tensor(problem.opt_cam), torch.as_tensor(problem.opt_points),
        t("point_prior"), t("point_prior_inv_sd"), lam, loss, 1.0)
    assert _max_rel(out_pt[:, :6], want_pt[:, :6]) < 1e-4
    assert _max_rel(out_pt[:, 6:12], want_pt[:, 6:12]) < 1e-4
    assert _max_rel(s_ii, want_sii) < 1e-4
    assert _max_rel(aux, want_aux) < 1e-4
    dx_p = port_k.fused_back_substitute(
        *targs, torch.as_tensor(np.asarray(want_pt)),
        torch.as_tensor(dx_i, dtype=torch.float32),
        torch.as_tensor(dx_cam, dtype=torch.float32), loss, 1.0)
    assert _max_rel(dx_p, want_dx) < 1e-3
    cost = float(port_k.fused_cost_dense(*targs, loss, 1.0))
    assert abs(cost - want_cost) <= 1e-5 * abs(want_cost)


@pytest.mark.parametrize("loss", LOSSES)
def test_fused_route_f64_matches_xla(loss):
    """The reduced system (S, b), the point updates and the cost of the
    port's fused route (plain versions) against the reference's XLA dense
    path, f64, within 1e-10 of each output's largest entry."""
    problem = _problem(8, 256, seed=3, loss=loss)
    ni, nr, nc, pmax, lam = 8, 1, 1, 3, 1e-3
    state_r, data_r = _ref_state_data(problem, jnp.float64)
    state_p, data_p = _port_state_data(problem, torch.float64)
    assert port_lm._fused_dense(state_p[3], ni, pmax, True)
    S_r, b_r, back_r = ref_lm._build_reduced_system(
        state_r, data_r, jnp.float64(lam), "perspective", loss, 1.0, pmax,
        ni, nr, nc, False, True, False, False, True)
    S_p, b_p, back_p = port_lm._build_reduced_system_fused(
        state_p, data_p, lam, loss, 1.0, ni, nr, nc, pmax)
    assert "fused" in back_p
    assert _max_rel(S_p, S_r) < 1e-10
    assert _max_rel(b_p, b_r) < 1e-10

    dx = np.linalg.solve(np.asarray(S_r), np.asarray(b_r))
    dx_i, dx_r, dx_cam = dx[:6 * ni].reshape(ni, 6), dx[6 * ni:6 * (ni + nr)], \
        dx[6 * (ni + nr):].reshape(nc, pmax)
    want = ref_lm._back_substitute(back_r, jnp.asarray(dx_i),
                                   jnp.asarray(dx_r).reshape(nr, 6),
                                   jnp.asarray(dx_cam), ni, pmax)
    got = port_lm._back_substitute(back_p, torch.as_tensor(dx_i),
                                   torch.as_tensor(dx_cam), ni, pmax)
    assert _max_rel(got, want) < 1e-10

    want_cost = float(ref_lm._total_cost(
        state_r, data_r, "perspective", loss, 1.0, pmax, rig_transform=False,
        rig_jac=False, canonical=True, dense=True))
    got_cost = float(port_lm._total_cost(state_p, data_p, loss, 1.0,
                                         dense=True))
    assert abs(got_cost - want_cost) <= 1e-10 * abs(want_cost)


def test_s_ii_is_symmetric_and_plain_route_agrees():
    """S_II comes out symmetric, and the fused route's (S, b) equal
    those of the canonical (point, slot) route on the same problem within
    1e-12 in f64."""
    problem = _problem(8, 128, seed=5, loss="CauchyLoss")
    state, data = _port_state_data(problem, torch.float64)
    _, s_ii, _ = port_k.fused_schur_assembly(
        state[0], state[2], state[3], data["obs_uv"], data["obs_inv_sd"],
        data["opt_inst"], data["opt_cam"], data["opt_points"],
        data["point_prior"], data["point_prior_inv_sd"], 0.1, "CauchyLoss",
        1.0)
    assert _max_rel(s_ii, s_ii.T) < 1e-14
    S_f, b_f, _ = port_lm._build_reduced_system(
        state, data, 0.1, "CauchyLoss", 1.0, 3, 8, 1, 1, dense=True)
    S_u, b_u, back = port_lm._build_reduced_system(
        state, data, 0.1, "CauchyLoss", 1.0, 3, 8, 1, 1, dense=False)
    assert "fused" not in back
    assert _max_rel(S_f, S_u) < 1e-12
    assert _max_rel(b_f, b_u) < 1e-12


PLAN_SHAPES = [(8, 128), (64, 8192), (256, 16384), (33, 1000), (1, 1),
               (37, 1000), (256, 1280), (1, 128)]


def _kernel_lower_tile(b):
    """The kernels' `lower_tile` decode of a block index, as written in
    csrc/ba_assemble.cu."""
    tr = 0
    while (tr + 1) * (tr + 2) // 2 <= b:
        tr += 1
    return tr, b - tr * (tr + 1) // 2


@pytest.mark.parametrize("ni,n_points", PLAN_SHAPES)
def test_assembly_plan_covers_the_work(ni, n_points):
    """The first pass's chunks cover the points; the product's blocks cover
    every lower output tile exactly once (in the kernels' decode order) and
    its K splits partition 3 NP in order, each a whole number of stages;
    the plan is a function of the shapes alone."""
    plan = port_k.assembly_plan(ni, n_points)
    chunk, n_chunks, n_split, k_split = plan
    assert (n_chunks - 1) * chunk < n_points <= n_chunks * chunk
    k = 3 * n_points
    assert k_split % port_k.SYRK_TILE_K == 0
    assert (n_split - 1) * k_split < k <= n_split * k_split
    bounds = [(s * k_split, min((s + 1) * k_split, k)) for s in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert all(k0 < k1 for k0, k1 in bounds)

    n = 6 * ni
    tiles = port_k.product_tiles(n)
    assert tiles == [_kernel_lower_tile(b) for b in range(len(tiles))]
    t = -(-n // port_k.SYRK_TILE)
    assert sorted(tiles) == [(r, c) for r in range(t) for c in range(t)
                             if c <= r]
    assert (t - 1) * port_k.SYRK_TILE < n <= t * port_k.SYRK_TILE
    assert port_k.assembly_plan(ni, n_points) == plan


@pytest.mark.parametrize("n", [6, 222, 384, 1536])
def test_lower_tiles_and_mirror_cover_every_entry_once(n):
    """The product's 64 x 64 lower tiles hold every (i, j) with i >= j, and
    the reduce's 32 x 32 lower tiles (in-tile lower triangle on the
    diagonal) write every entry of the n x n output exactly once, the ones
    above the diagonal as mirrors: what makes S_II exactly symmetric."""
    lower = np.zeros((n, n), dtype=int)
    for r, c in port_k.product_tiles(n):
        t = port_k.SYRK_TILE
        lower[r * t:(r + 1) * t, c * t:(c + 1) * t] += 1
    assert (lower[np.tril_indices(n)] == 1).all()
    written = np.zeros((n, n), dtype=int)
    t = port_k.REDUCE_TILE
    for r, c in port_k.product_tiles(n, t):
        for i in range(r * t, min((r + 1) * t, n)):
            for j in range(c * t, min((c + 1) * t, n)):
                if r != c or i >= j:
                    written[i, j] += 1
                    if i != j:
                        written[j, i] += 1
    assert (written == 1).all()


def test_product_fills_the_card_at_the_dense_lane():
    """At 64 x 8,192 the product runs more blocks than the H100 has SMs."""
    _, _, n_split, _ = port_k.assembly_plan(64, 8192)
    assert len(port_k.product_tiles(6 * 64)) * n_split >= port_k.SMS


def test_fused_route_conditions():
    x = torch.zeros((256, 3), dtype=torch.float64)
    assert port_lm._fused_dense(x, 8, 3, True)
    assert not port_lm._fused_dense(x, 8, 3, False)
    assert not port_lm._fused_dense(x[:200], 8, 3, True)
    assert not port_lm._fused_dense(x, 257, 3, True)
    assert port_lm._fused_dense(x.float(), 256, 3, True)


def test_cpu_tensors_never_launch():
    problem = _problem(8, 128, seed=6, loss="SoftLOneLoss")
    state, data = _port_state_data(problem, torch.float64)
    kernels = (port_k.fused_schur_assembly, port_k.fused_back_substitute,
               port_k.fused_cost_dense)
    before = [k.launches for k in kernels]
    port_lm.bundle_adjust(port_lm.problem_from_numpy(problem),
                          max_iterations=2, device="cpu")
    assert [k.launches for k in kernels] == before


def test_wrapper_checks_reject_a_misaligned_uv():
    """The dense kernels read each (u, v) row as one aligned vector: the
    checks take obs_uv on a row boundary and refuse one that starts
    mid-row."""
    problem = _problem(8, 128, seed=6, loss="SoftLOneLoss")
    f = lambda k: torch.as_tensor(getattr(problem, k), dtype=torch.float64)  # noqa: E731
    args = (f("inst"), f("cam"), f("points"), f("obs_uv"), f("obs_inv_sd"))
    assert port_k._check_cuda(*args, "SoftLOneLoss") == ("f64", 1)
    flat = torch.cat([torch.zeros(1, dtype=torch.float64),
                      args[3].reshape(-1)])
    shifted = flat[1:].view(-1, 2)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="row boundary"):
        port_k._check_cuda(*args[:3], shifted, args[4], "SoftLOneLoss")


BACKSUB_SHAPES = [(1, 128), (37, 1000), (64, 8192), (256, 1280)]


@pytest.mark.parametrize("ni,n_points", BACKSUB_SHAPES)
def test_backsub_plan_covers_every_point_once(ni, n_points):
    """The back-substitution's blocks, block b taking points
    [b * chunk, min((b + 1) * chunk, NP)) as the kernel does, cover every
    point exactly once, with no empty block; the plan is a function of the
    shapes alone."""
    chunk, n_chunks = port_k.backsub_plan(ni, n_points)
    seen = np.zeros(n_points, dtype=int)
    for b in range(n_chunks):
        p0 = b * chunk
        n_here = min(chunk, n_points - p0)
        assert n_here >= 1
        seen[p0:p0 + n_here] += 1
    assert (seen == 1).all()
    assert port_k.backsub_plan(ni, n_points) == (chunk, n_chunks)


def test_backsub_plan_shared_memory_within_cap():
    """For every NI <= 256 a block's shared memory (per point of the chunk:
    each slot thread's uv, inv_sd and three u values, and the point's 12
    staged values; 8 bytes each in f64) fits the plan's 48 KB cap, and at
    the dense lane the blocks fill the card."""
    for ni in range(1, port_k.MAX_NI + 1):
        threads = -(-ni // 32) * 32
        for n_points in (1, 128, 1000, 8192, 16384, 10 ** 6):
            chunk, n_chunks = port_k.backsub_plan(ni, n_points)
            smem = 8 * chunk * (6 * threads + 12)
            assert port_k.backsub_smem(ni, chunk) == smem
            assert smem <= port_k.BACKSUB_SMEM
            assert (n_chunks - 1) * chunk < n_points <= n_chunks * chunk
    assert port_k.backsub_plan(64, 8192)[1] >= port_k.SMS


def _contracted_back_substitute(inst, cam, points, obs_uv, obs_inv_sd, out_pt,
                                dx_i, dx_cam, loss, loss_threshold):
    """The CUDA back-substitution's arithmetic (csrc/ba_assemble.cu,
    BacksubSlot and backsub_u) in PyTorch: per slot R(w) and its
    derivative along dw, M = dR[dw]; per slot and point
    u = s^2 R^T A^T (A (M x + dt) + (u, v) c) with
    s^2 = inv_sd^2 max(rho', 1e-12)."""
    from opensfm_tpu_torch.ba.lm import LOSSES
    from opensfm_tpu_torch.geometry.rotation import hat, rodrigues_coeffs

    ni, n_p = inst.shape[0], points.shape[0]
    w, t, dw, dt = inst[:, :3], inst[:, 3:], dx_i[:, :3], dx_i[:, 3:]
    cos_t, sinc, ccos, sp, gp = rodrigues_coeffs((w * w).sum(-1), derivs=True)
    wd = (w * dw).sum(-1)
    eye = torch.eye(3, dtype=inst.dtype)
    outer = w[:, :, None] * w[:, None, :]
    R = (cos_t[:, None, None] * eye + sinc[:, None, None] * hat(w)
         + ccos[:, None, None] * outer)
    M = ((-wd * sinc)[:, None, None] * eye + (wd * sp)[:, None, None] * hat(w)
         + (wd * gp)[:, None, None] * outer + sinc[:, None, None] * hat(dw)
         + ccos[:, None, None] * (dw[:, :, None] * w[:, None, :]
                                  + w[:, :, None] * dw[:, None, :]))
    X = torch.einsum("amn,pn->pam", R, points) + t
    dX = torch.einsum("amn,pn->pam", M, points) + dt
    k1, k2, f = cam[0, 0], cam[0, 1], cam[0, 2]
    dk1, dk2, df = dx_cam[0, 0], dx_cam[0, 1], dx_cam[0, 2]
    iz = 1.0 / X[..., 2]
    u, v = X[..., 0] * iz, X[..., 1] * iz
    r2 = u * u + v * v
    d = 1.0 + r2 * (k1 + k2 * r2)
    uv = obs_uv.reshape(n_p, ni, 2)
    isd = obs_inv_sd.reshape(n_p, ni)
    e0 = (f * d * u - uv[..., 0]) * isd
    e1 = (f * d * v - uv[..., 1]) * isd
    inv_a2 = 1.0 / float(loss_threshold) ** 2
    s2 = isd * isd * torch.clamp_min(
        LOSSES[loss][1]((e0 * e0 + e1 * e1) * inv_a2), 1e-12)
    fd, fdd = f * d, 2.0 * f * (k1 + 2.0 * k2 * r2)
    P00, P01, P11 = fd + fdd * u * u, fdd * u * v, fd + fdd * v * v
    A = torch.stack([
        torch.stack([P00, P01, -(P00 * u + P01 * v)], -1),
        torch.stack([P01, P11, -(P01 * u + P11 * v)], -1)], -2) \
        * iz[..., None, None]
    c = f * r2 * (dk1 + dk2 * r2) + df * d
    tk = torch.einsum("pakm,pam->pak", A, dX) + torch.stack([u, v], -1) \
        * c[..., None]
    g = torch.einsum("pakm,pak->pam", A, tk)
    ug = s2[..., None] * torch.einsum("amj,pam->paj", R, g)
    H = out_pt[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(-1, 3, 3)
    return torch.einsum("pjk,pk->pj", H, out_pt[:, 6:9] - ug.sum(1))


@pytest.mark.parametrize("loss", LOSSES)
def test_contracted_back_substitution_matches_twin_and_xla(loss):
    """The kernel's contracted arithmetic (the Jacobian never formed) gives
    the plain twin's point updates within 1e-12 and the reference's XLA
    dense back-substitution within 1e-10 of the largest entry, f64, with a
    near-zero rotation (the small-angle series) among the slots."""
    problem = _problem(8, 256, seed=7, loss=loss)
    problem.inst[2, :3] = 1e-9
    ni, nr, nc, pmax, lam = 8, 1, 1, 3, 1e-3
    state_r, data_r = _ref_state_data(problem, jnp.float64)
    state_p, data_p = _port_state_data(problem, torch.float64)
    S_r, b_r, back_r = ref_lm._build_reduced_system(
        state_r, data_r, jnp.float64(lam), "perspective", loss, 1.0, pmax,
        ni, nr, nc, False, True, False, False, True)
    _, _, back_p = port_lm._build_reduced_system_fused(
        state_p, data_p, lam, loss, 1.0, ni, nr, nc, pmax)
    dx = np.linalg.solve(np.asarray(S_r), np.asarray(b_r))
    dx_i = dx[:6 * ni].reshape(ni, 6)
    dx_cam = dx[6 * (ni + nr):].reshape(nc, pmax)
    want = ref_lm._back_substitute(back_r, jnp.asarray(dx_i),
                                   jnp.asarray(dx[6 * ni:6 * (ni + nr)])
                                   .reshape(nr, 6), jnp.asarray(dx_cam), ni,
                                   pmax)
    fused = back_p["fused"]
    args = (fused["inst"], fused["cam"], fused["points"], fused["obs_uv"],
            fused["obs_inv_sd"], fused["out_pt"], torch.as_tensor(dx_i),
            torch.as_tensor(dx_cam))
    got = _contracted_back_substitute(*args, loss, 1.0)
    twin = port_k.fused_back_substitute_plain(*args, loss, 1.0)
    assert _max_rel(got, twin) < 1e-12
    assert _max_rel(got, want) < 1e-10


COST_DENSE_SHAPES = [(37, 1000, 8), (256, 1280, 8), (1, 128, 8),
                     (64, 8192, 8), (64, 8192, 4), (1500, 128, 8),
                     (3000, 128, 4)]


def _cost_dense_walk(ni, n_points, plan):
    """The slots that csrc/ba_assemble.cu's cost_dense_kernel sums, in its
    order: a list of [blocks, COST_BLOCK] arrays, the slot index (or -1
    where the thread is idle) of each block's thread at each step.  Block b
    owns points [b * pts, min((b + 1) * pts, NP)); per table tile
    [lo, lo + rows) thread t walks the [points, rows] cells t, t + 256, ...,
    carrying (point, instance) by the constant step (256 // rows,
    256 % rows), four cells a batch, as the kernel does."""
    n_blocks, pts, tile = plan
    threads, batch = port_k.COST_BLOCK, 4
    t = np.arange(threads)
    p0 = np.arange(n_blocks) * pts
    n_pts = np.minimum(pts, n_points - p0)
    steps = []
    for lo in range(0, ni, tile):
        rows = min(tile, ni - lo)
        n_cells = (n_pts * rows)[:, None]
        n_batches = max(1, -(-int(n_cells.max()) // (batch * threads)))
        step_p, step_a = divmod(threads, rows)
        pl = np.tile(t // rows, (n_blocks, 1))
        al = np.tile(t % rows, (n_blocks, 1))
        for j in range(n_batches * batch):
            act = j * threads + t[None, :] < n_cells
            steps.append(np.where(act, (p0[:, None] + pl) * ni + lo + al, -1))
            pl, al = pl + step_p, al + step_a
            wrap = al >= rows
            al, pl = np.where(wrap, al - rows, al), np.where(wrap, pl + 1, pl)
    return steps


@pytest.mark.parametrize("ni,n_points,itemsize", COST_DENSE_SHAPES)
def test_cost_dense_plan_covers_every_slot_once(ni, n_points, itemsize):
    """The dense cost's plan: every block owns at least one point, at most
    COST_BLOCK (one staged point a thread); the table tiles cover every
    instance once within the table's byte cap (two tiles past 1,365
    instances in f64, 2,730 in f32); the kernel's walk with its carried
    (point, instance) sums every slot of the [NP, NI] grid exactly once;
    the plan is a function of the shapes alone."""
    plan = port_k.cost_dense_plan(ni, n_points, itemsize)
    n_blocks, pts, tile = plan
    assert 1 <= pts <= port_k.COST_BLOCK
    assert (n_blocks - 1) * pts < n_points <= n_blocks * pts
    assert tile * 9 * itemsize <= 96 * 1024
    tiles = [(lo, min(tile, ni - lo)) for lo in range(0, ni, tile)]
    assert sum(rows for _, rows in tiles) == ni
    assert len(tiles) == (2 if ni in (1500, 3000) else 1)
    seen = np.bincount(np.concatenate([s.ravel() for s in
                                       _cost_dense_walk(ni, n_points, plan)])
                       + 1, minlength=ni * n_points + 1)
    assert (seen[1:] == 1).all()
    assert port_k.cost_dense_plan(ni, n_points, itemsize) == plan


@pytest.mark.parametrize("tile", [None, 3])
def test_cost_dense_walk_sums_to_the_plain_total(tile):
    """The terms summed in cost_dense_kernel's order (each thread's walk in
    order, a shuffle tree per warp, warps in order, then the last block's
    sum of the block partials alike) give the plain version's total within
    1e-12 in f64, with the instance table whole or in tiles of 3 rows, and
    NaN when a NaN point's slots are all dead (dead slots are summed)."""
    problem = _problem(8, 256, seed=9, loss="SoftLOneLoss")
    ni, n_points = 8, 256
    f = lambda k: torch.as_tensor(getattr(problem, k), dtype=torch.float64)  # noqa: E731
    args = (f("inst"), f("cam"), f("points"), f("obs_uv"), f("obs_inv_sd"))
    plan = port_k.cost_dense_plan(ni, n_points, 8)
    if tile is not None:
        plan = plan[:2] + (tile,)

    def kernel_order_sum(args):
        p0, p1 = port_k.chain_fwd(port_k._dense_vals(*args[:3]))
        uv, isd = args[3].reshape(n_points, ni, 2), args[4].reshape(
            n_points, ni)
        e0, e1 = (p0 - uv[..., 0]) * isd, (p1 - uv[..., 1]) * isd
        rho = port_k._loss("SoftLOneLoss")[0]
        terms = np.append((0.5 * rho(e0 * e0 + e1 * e1)).numpy().ravel(), 0.0)

        def block_sums(acc):
            for o in (16, 8, 4, 2, 1):
                w = acc.reshape(acc.shape[0], -1, 32)
                w[:, :, :32 - o] = w[:, :, :32 - o] + w[:, :, o:]
            total = acc[:, 0].copy()
            for w in range(1, acc.shape[1] // 32):
                total = total + acc[:, 32 * w]
            return total

        acc = np.zeros((plan[0], port_k.COST_BLOCK))
        for idx in _cost_dense_walk(ni, n_points, plan):
            acc = acc + terms[idx]  # idle threads add the 0 at index -1
        partials = block_sums(acc)
        last = np.zeros((1, port_k.COST_BLOCK))
        for i in range(0, len(partials), port_k.COST_BLOCK):
            chunk = partials[i:i + port_k.COST_BLOCK]
            last[0, :len(chunk)] = last[0, :len(chunk)] + chunk
        return block_sums(last)[0]

    want = float(port_k.fused_cost_dense_plain(*args, "SoftLOneLoss", 1.0))
    assert abs(kernel_order_sum(args) - want) <= 1e-12 * abs(want)
    pts, isd = args[2].clone(), args[4].clone()
    pts[5], isd[5 * ni:6 * ni] = float("nan"), 0.0
    nan_args = args[:2] + (pts, args[3], isd)
    assert np.isnan(kernel_order_sum(nan_args))
    assert np.isnan(float(port_k.fused_cost_dense_plain(
        *nan_args, "SoftLOneLoss", 1.0)))
