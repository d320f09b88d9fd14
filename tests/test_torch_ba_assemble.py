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
