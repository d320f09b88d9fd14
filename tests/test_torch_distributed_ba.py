"""The port's sharded bundle (`opensfm_tpu_torch.parallel`) against the JAX
package's `opensfm_tpu.parallel` at the step level, on the CPU.

The same problem (`__graft_entry__._make_problem`, 12 shots x 256 points,
f64) goes through a JAX mesh of 4 virtual CPU devices and the port's
virtual mesh of 4 CPU shards.  Held: `shard_problem`,
`shard_problem_dense` and `_cg_args` equal element for element; the sharded
cost, and one step of each of `make_sharded_lm_step`,
`make_sharded_lm_step_dense`, `make_sharded_cg_lm_step` and
`make_sharded_schur_lm_step`, within rtol 1e-8, atol 1e-9 (the JAX tests'
sharded-vs-single-device tolerance).  Each JAX step is compiled once
(module-scoped fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import opensfm_tpu.parallel.distributed_ba as ref_dba
from __graft_entry__ import _make_problem
from opensfm_tpu_torch.ba.lm import problem_from_numpy
from opensfm_tpu_torch.parallel import distributed_ba as dba
from opensfm_tpu_torch.parallel.mesh import virtual_mesh

N_SHARDS = 4
RTOL, ATOL = 1e-8, 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    return (JaxMesh(np.array(jax.devices()[:N_SHARDS]), ("points",)),
            virtual_mesh("cpu", N_SHARDS))


def _variant(name):
    """The JAX tests' problem, with rig, shot-row and depth variants."""
    p = _make_problem(n_shots=12, n_points=256, seed=3, track_window=5)
    ni, O = len(p.inst), len(p.obs_uv)
    if name == "rich":
        p.rigcam = np.array([[0.0, 0.02, 0.0, 0.1, 0.0, 0.05]])
        p.opt_rigcam = np.ones(1, bool)
        p.rigcam_prior = p.rigcam.copy()
        p.rigcam_prior_inv_sd = np.full((1, 6), 10.0)
        p.up_inst = np.arange(ni, dtype=np.int64)
        p.up_rigcam = np.zeros(ni, dtype=np.int64)
        p.up_vec = np.tile([0.0, 0.0, 1.0], (ni, 1))
        p.up_inv_sd = np.full(ni, 10.0)
        rng = np.random.default_rng(0)
        p.obs_depth = np.full(O, 10.0)
        p.obs_depth_inv_sd = np.where(rng.random(O) < 0.3, 1.0, 0.0)
        p.obs_depth_radial = rng.random(O) < 0.5
        p.point_prior = p.points + 0.01
        p.point_prior_inv_sd = np.full(p.points.shape, 0.5)
        p.point_prior_loss = np.full(len(p.points), 2.0)
    return p


def _args(problem):
    """Both packages' sharded layouts and argument dicts (f64, lam 1e-3)."""
    ref = ref_dba.shard_problem(problem, N_SHARDS)
    ours = dba.shard_problem(problem_from_numpy(problem), N_SHARDS)
    ja = ref_dba._cg_args(ref, N_SHARDS, jnp.float64)
    ta = dba._cg_args(ours, N_SHARDS, np.float64)
    ja["lam"] = jnp.asarray(1e-3)
    ta["lam"] = torch.tensor(1e-3, dtype=torch.float64)
    return ref, ours, ja, ta


@pytest.fixture(scope="module", params=["plain", "rich"])
def case(request):
    return request.param, _args(_variant(request.param))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("track_window", [5, 9, None])
def test_shard_problem_layouts_equal(track_window):
    """Windowed (track_window 5, and the dense map) and plain (9: too much
    window padding) layouts, and the dense-grid layout."""
    p = _make_problem(n_shots=12, n_points=200, seed=1,
                      track_window=track_window)
    ref = ref_dba.shard_problem(p, N_SHARDS)
    ours = dba.shard_problem(problem_from_numpy(p), N_SHARDS)
    assert ours.cg_window == ref.cg_window
    assert (ours.cg_window > 0) == (track_window != 9)
    for f in ("inst", "points", "obs_uv", "obs_inv_sd", "obs_point",
              "obs_inst", "obs_rigcam", "obs_cam", "point_obs",
              "point_prior", "opt_points", "cg_virt2real"):
        a, b = getattr(ours, f), getattr(ref, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f)
    ref_d, ref_per = ref_dba.shard_problem_dense(p, 3)
    ours_d, per = dba.shard_problem_dense(problem_from_numpy(p), 3)
    assert per == ref_per and per % 128 == 0
    for f in ("points", "obs_uv", "obs_inv_sd", "obs_point", "obs_inst",
              "point_obs", "opt_points", "point_prior"):
        np.testing.assert_array_equal(np.asarray(getattr(ours_d, f)),
                                      np.asarray(getattr(ref_d, f)), f)


def test_cg_args_equal(case):
    _, (ref, ours, ja, ta) = case
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]), k)
        assert ta[k].numpy().dtype == np.asarray(ja[k]).dtype, k


def _statics(ref):
    ni, nr, nc, npts, O, T = ref.counts()
    rig_mode, with_depth, has_up, has_ang = ref_dba._cg_modes(ref)
    return dict(nr=nr, rig_mode=rig_mode, with_depth=with_depth,
                has_up=has_up, has_ang=has_ang), ni, nc, ref.cam.shape[1]


def test_sharded_cost_matches_reference(meshes, case):
    jm, tm = meshes
    _, (ref, ours, ja, ta) = case
    kw, ni, nc, pmax = _statics(ref)
    names = ref_dba._cg_cost_names(kw["rig_mode"], kw["with_depth"],
                                   kw["has_up"], kw["has_ang"])
    want = ref_dba.make_sharded_cost(jm, "points", "perspective", pmax, ni,
                                     nc, **kw)(*(ja[k] for k in names))
    got = dba.make_sharded_cost(tm, "points", "perspective", pmax, ni, nc,
                                **kw)(*(ta[k] for k in names))
    assert float(got) == pytest.approx(float(want), rel=1e-12)


@pytest.mark.parametrize("solver", ["cg", "schur"])
def test_sparse_steps_match_reference(meshes, case, solver):
    """One step of the CG (to convergence of its PCG) and the
    assembled-Schur steps."""
    jm, tm = meshes
    _, (ref, ours, ja, ta) = case
    kw, ni, nc, pmax = _statics(ref)
    kw["win"] = ref.cg_window
    names = ref_dba._cg_step_names(kw["rig_mode"], kw["with_depth"],
                                   kw["has_up"], kw["has_ang"],
                                   win=ref.cg_window > 0)
    if solver == "cg":
        kw.update(cg_iters=400, cg_tol=1e-12)
        make, ref_make = dba.make_sharded_cg_lm_step, \
            ref_dba.make_sharded_cg_lm_step
    else:
        make, ref_make = dba.make_sharded_schur_lm_step, \
            ref_dba.make_sharded_schur_lm_step
    want = ref_make(jm, "points", "perspective", pmax, ni, nc, **kw)(
        *(ja[k] for k in names))
    got = make(tm, "points", "perspective", pmax, ni, nc, **kw)(
        *(ta[k] for k in names))
    assert len(got) == len(want)
    _close(got, want)


def test_replicated_dense_step_matches_reference(meshes):
    jm, tm = meshes
    ref, ours, ja, ta = _args(_variant("plain"))
    ni, nr, nc, npts, O, T = ref.counts()
    names = ("inst", "rigcam", "cam", "points", "obs_uv", "obs_inv_sd",
             "obs_point", "obs_inst", "obs_rigcam", "obs_cam")
    jargs = [ja[k] for k in names] + [jnp.asarray(ref.point_obs, jnp.int32)]
    targs = [ta[k] for k in names] + [torch.as_tensor(ours.point_obs,
                                                      dtype=torch.int32)]
    tail = ("gps_pos", "gps_inv_sd", "opt_inst", "opt_cam", "opt_points",
            "lam", "point_base")
    want = ref_dba.make_sharded_lm_step(jm, "points", "perspective", 3, ni,
                                        nr, nc)(*jargs,
                                                *(ja[k] for k in tail))
    got = dba.make_sharded_lm_step(tm, "points", "perspective", 3, ni, nr,
                                   nc)(*targs, *(ta[k] for k in tail))
    _close(got, want)


def test_dense_grid_step_matches_reference(meshes):
    """The dense-grid step: per shard the fused assembly's plain version
    (the JAX package's XLA dense path on its CPU mesh)."""
    jm, tm = meshes
    p = _make_problem(n_shots=12, n_points=256, seed=3, track_window=8)
    ref_d, _ = ref_dba.shard_problem_dense(p, N_SHARDS)
    ours_d, _ = dba.shard_problem_dense(problem_from_numpy(p), N_SHARDS)
    ni, nr, nc, npts, O, T = ref_d.counts()
    names = ("inst", "rigcam", "cam", "points", "obs_uv", "obs_inv_sd",
             "point_prior", "point_prior_inv_sd", "opt_points", "gps_pos",
             "gps_inv_sd", "cam_prior", "cam_prior_inv_sd", "cam_log_mask",
             "rigcam_prior", "rigcam_prior_inv_sd", "opt_inst", "opt_rigcam",
             "opt_cam")
    ja = ref_dba._dense_block_args(ref_d, jnp.float64)
    ta = dba._dense_block_args(ours_d, np.float64)
    want = ref_dba.make_sharded_lm_step_dense(jm, "points", ni, nr, nc, 3)(
        *(ja[k] for k in names), jnp.asarray(1e-3))
    got = dba.make_sharded_lm_step_dense(tm, "points", ni, nr, nc, 3)(
        *(ta[k] for k in names), torch.tensor(1e-3, dtype=torch.float64))
    _close(got, want)
