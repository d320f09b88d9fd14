"""The port's plain residual/Jacobian and cost (the CUDA kernels' twins)
against the JAX reference: in f64 against the XLA branches of
`lm._residual_data` / `lm._total_cost`, in f32 against the Pallas kernels in
interpret mode, for the five losses and the three observation layouts, with
padded slots (inv_sd = 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensfm_tpu.ba import lm as ref_lm
from opensfm_tpu.ops.pallas_kernels import ba_resjac as ref_k
from opensfm_tpu_torch.ops.kernels import ba_resjac as port_k

LOSSES = ["TrivialLoss", "SoftLOneLoss", "CauchyLoss", "HuberLoss",
          "TukeyLoss"]
LAYOUTS = ["gather", "canonical", "dense"]


def _inputs(layout, seed=0):
    """(arrays, point_repeat, dense_inst) for one layout; ~10% of the slots
    padded (inv_sd = 0, uv = 0)."""
    rng = np.random.default_rng(seed)
    ni, npts = 6, 40
    nc = 1 if layout == "dense" else 2
    if layout == "gather":
        O = 300
        obs_inst = rng.integers(0, ni, O)
        obs_point = rng.integers(0, npts, O)
        repeat = 0
    elif layout == "canonical":
        T = 4
        O = npts * T
        obs_inst = rng.integers(0, ni, O)
        obs_point = np.repeat(np.arange(npts), T)
        repeat = T
    else:
        O = npts * ni
        obs_inst = np.tile(np.arange(ni), npts)
        obs_point = np.repeat(np.arange(npts), ni)
        repeat = ni
    inst = np.concatenate(
        [0.3 * rng.normal(size=(ni, 3)),
         rng.normal(size=(ni, 3)) + np.array([0.0, 0.0, 8.0])], axis=1)
    inst[0, :3] = 1e-9  # the small-angle series branch
    cam = np.concatenate(
        [0.05 * rng.normal(size=(nc, 2)), 0.9 + 0.2 * rng.random((nc, 1))],
        axis=1)
    points = 2.0 * rng.normal(size=(npts, 3))
    obs_cam = rng.integers(0, nc, O)
    obs_uv = 0.3 * rng.normal(size=(O, 2))
    obs_inv_sd = 1.0 + rng.random(O)
    pad = rng.random(O) < 0.1
    obs_uv[pad] = 0.0
    obs_inv_sd[pad] = 0.0
    arrays = (inst, cam, points, obs_inst, obs_cam, obs_point, obs_uv,
              obs_inv_sd)
    return arrays, repeat, layout == "dense"


def _torch(arrays, dtype):
    inst, cam, points, oi, oc, op, uv, isd = arrays
    f = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    i = lambda x: torch.as_tensor(x, dtype=torch.int32)  # noqa: E731
    return (f(inst), f(cam), f(points), i(oi), i(oc), i(op), f(uv), f(isd))


def _ref_state_data(arrays, dtype):
    inst, cam, points, oi, oc, op, uv, isd = arrays
    ni, nc, npts = len(inst), len(cam), len(points)
    f = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    state = (f(inst), jnp.zeros((1, 6), dtype), f(cam), f(points))
    data = dict(
        obs_uv=f(uv), obs_inv_sd=f(isd), obs_point=jnp.asarray(op, jnp.int32),
        obs_inst=jnp.asarray(oi, jnp.int32),
        obs_rigcam=jnp.zeros(len(uv), jnp.int32),
        obs_cam=jnp.asarray(oc, jnp.int32),
        # Every prior disabled: _total_cost is then the reprojection cost.
        gps_pos=jnp.zeros((ni, 3), dtype), gps_inv_sd=jnp.zeros(ni, dtype),
        cam_prior=f(cam), cam_prior_inv_sd=jnp.zeros((nc, 3), dtype),
        cam_log_mask=jnp.zeros((nc, 3), bool),
        rigcam_prior=jnp.zeros((1, 6), dtype),
        rigcam_prior_inv_sd=jnp.zeros((1, 6), dtype),
        point_prior=jnp.zeros((npts, 3), dtype),
        point_prior_inv_sd=jnp.zeros((npts, 3), dtype),
    )
    return state, data


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("loss", LOSSES)
def test_plain_f64_matches_xla(loss, layout):
    arrays, repeat, dense = _inputs(layout)
    state, data = _ref_state_data(arrays, jnp.float64)
    r0, Jc0, Jp0, c0 = ref_lm._residual_data(
        state, data, "perspective", loss, 1.5, 3, rig_transform=False,
        rig_jac=False, canonical=bool(repeat), dense=dense,
    )
    total0 = ref_lm._total_cost(
        state, data, "perspective", loss, 1.5, 3, rig_transform=False,
        rig_jac=False, canonical=bool(repeat), dense=dense,
    )
    args = _torch(arrays, torch.float64)
    r, Jc, Jp, c = port_k.fused_residual_jacobian(*args, loss, 1.5)
    total = port_k.fused_cost(*args, loss, 1.5)
    for got, want in ((r, r0), (Jc, Jc0), (Jp, Jp0), (c, c0)):
        want = np.asarray(want)
        assert got.shape == want.shape
        # rtol 1e-10 of each entry, plus 1e-12 of the array's scale for
        # entries that cancel to ~0 (closed form vs forward-mode pushes).
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-10,
            atol=1e-12 * float(np.abs(want).max()))
    assert abs(float(total) - float(total0)) <= 1e-10 * abs(float(total0))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("loss", LOSSES)
def test_plain_f32_matches_pallas_interpret(loss, layout):
    arrays, repeat, dense = _inputs(layout, seed=1)
    ja = [jnp.asarray(a, jnp.int32 if a.dtype.kind == "i" else jnp.float32)
          for a in arrays]
    kw = dict(loss=loss, loss_threshold=1.0, interpret=True,
              point_repeat=repeat, dense_inst=dense)
    want = ref_k.fused_residual_jacobian(*ja, **kw)
    want_total = float(ref_k.fused_cost(*ja, **kw))
    args = _torch(arrays, torch.float32)
    got = port_k.fused_residual_jacobian(*args, loss, 1.0)
    total = float(port_k.fused_cost(*args, loss, 1.0))
    # Tolerances of tests/test_pallas_kernels.py (f32 chain, two codes).
    tols = ((2e-4, 2e-5), (2e-3, 2e-3), (2e-3, 2e-3), (2e-4, 2e-5))
    for g, w, (rtol, atol) in zip(got, want, tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)
    assert abs(total - want_total) <= 1e-5 * abs(want_total)


def test_padded_slots_contribute_exactly_zero():
    arrays, _, _ = _inputs("canonical")
    args = _torch(arrays, torch.float64)
    r, Jc, Jp, c = port_k.fused_residual_jacobian(*args, "CauchyLoss", 1.0)
    pad = args[7] == 0
    assert pad.any()
    for t in (r, Jc, Jp, c):
        assert bool((t[pad] == 0).all())


def test_empty_problem_costs_zero():
    arrays, _, _ = _inputs("gather")
    args = _torch(arrays, torch.float64)
    args = args[:3] + tuple(t[:0] for t in args[3:])
    assert float(port_k.fused_cost(*args, "SoftLOneLoss", 1.0)) == 0.0
    r, Jc, Jp, c = port_k.fused_residual_jacobian(*args, "SoftLOneLoss", 1.0)
    assert r.shape == (0, 2) and Jc.shape == (0, 2, 9) and c.shape == (0,)


def test_wrapper_checks_reject_a_misaligned_uv():
    """The kernel reads each (u, v) row as one aligned vector: the checks
    take obs_uv on a row boundary and refuse one that starts mid-row."""
    arrays, _, _ = _inputs("gather")
    args = _torch(arrays, torch.float64)
    assert port_k._check_cuda(*args, "SoftLOneLoss") == ("f64", 1)
    flat = torch.cat([torch.zeros(1, dtype=torch.float64),
                      args[6].reshape(-1)])
    shifted = flat[1:].view(-1, 2)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="row boundary"):
        port_k._check_cuda(*args[:6], shifted, args[7], "SoftLOneLoss")


def test_cpu_tensors_never_launch():
    arrays, _, _ = _inputs("gather")
    before = (port_k.fused_residual_jacobian.launches,
              port_k.fused_cost.launches)
    args = _torch(arrays, torch.float64)
    port_k.fused_residual_jacobian(*args, "SoftLOneLoss", 1.0)
    port_k.fused_cost(*args, "SoftLOneLoss", 1.0)
    assert (port_k.fused_residual_jacobian.launches,
            port_k.fused_cost.launches) == before


@pytest.mark.parametrize("n_obs", [1, 255, 262_144, 262_147])
def test_cost_plan_covers_each_observation_once(n_obs):
    """The one-pass cost kernel's indexing (block b, thread t, step k:
    o = b * per_thread * 256 + t + 256 k, k < per_thread, o < O, as
    csrc/ba_resjac.cu's cost_kernel computes it) reaches every observation
    exactly once, every block has work, the grid is one wave at the plan's
    residency, and the plan is a function of O alone."""
    n_blocks, per_thread = port_k.cost_plan(n_obs)
    assert per_thread >= 1
    assert n_blocks <= port_k.SMS * port_k.COST_BLOCKS_PER_SM
    b = np.arange(n_blocks)[:, None, None]
    t = np.arange(port_k.COST_BLOCK)[None, :, None]
    k = np.arange(per_thread)[None, None, :]
    o = (b * per_thread * port_k.COST_BLOCK + t + port_k.COST_BLOCK * k)
    o = o[o < n_obs]
    assert np.array_equal(np.sort(o), np.arange(n_obs))
    assert (n_blocks - 1) * per_thread * port_k.COST_BLOCK < n_obs
    assert port_k.cost_plan(n_obs) == (n_blocks, per_thread)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n_inst", [0, 1, 256, 1365, 1366, 2731, 5000])
def test_cost_table_tiles_cover_each_instance_once(n_inst, itemsize):
    """The one-pass cost kernel's instance tiles (lo = 0, rows, 2 rows, ...
    while lo < n_inst, one pass at least, as csrc/ba_resjac.cu's cost_kernel
    walks them) hold every instance exactly once; a tile fits the block's
    table; a map whose rows all fit takes a single tile."""
    rows = port_k.cost_table_rows(n_inst, itemsize)
    assert rows >= 1
    assert rows * port_k.INST_COLS * itemsize <= port_k.INST_TABLE_BYTES
    seen = np.zeros(n_inst, dtype=int)
    tiles, lo = 0, 0
    while lo == 0 or lo < n_inst:
        seen[lo:lo + max(0, min(rows, n_inst - lo))] += 1
        tiles, lo = tiles + 1, lo + rows
    assert (seen == 1).all()
    fits = n_inst * port_k.INST_COLS * itemsize <= port_k.INST_TABLE_BYTES
    assert (tiles == 1) == fits
