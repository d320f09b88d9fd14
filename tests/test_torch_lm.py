"""The port's LM bundle adjuster (`opensfm_tpu_torch.ba.lm`, on the CPU)
against the JAX reference `opensfm_tpu.ba.lm` in f64: the same accepted
iterations, the final cost within 1e-8 relative, the states within 1e-7."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from __graft_entry__ import _make_problem
from opensfm_tpu.ba import lm as ref_lm
from opensfm_tpu_torch.ba import lm as port_lm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_solve(problem, max_iterations=20):
    want = ref_lm.bundle_adjust(problem, max_iterations=max_iterations)
    got = port_lm.bundle_adjust(port_lm.problem_from_numpy(problem),
                                max_iterations=max_iterations, device="cpu")
    assert got.iterations == want.iterations
    assert abs(got.initial_cost - want.initial_cost) <= 1e-10 * want.initial_cost
    assert abs(got.final_cost - want.final_cost) <= 1e-8 * want.final_cost
    assert got.final_cost < got.initial_cost
    for name in ("inst", "rigcam", "cam", "points"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-7, err_msg=name)
    return got


def _with_priors():
    """GPS, camera and robust point priors, fixed instances and points."""
    p = _make_problem(8, 256, seed=1)
    rng = np.random.default_rng(1)
    p.gps_pos = p.gps_pos + rng.normal(0, 0.05, p.gps_pos.shape)
    p.gps_inv_sd = np.full(8, 3.0)
    p.cam_prior = p.cam_prior * np.array([[1.1, 0.9, 1.02]])
    p.cam_prior_inv_sd = np.array([[50.0, 80.0, 30.0]])
    p.opt_inst[0] = False
    p.opt_points[:5] = False
    p.point_prior = p.points + rng.normal(0, 0.02, p.points.shape)
    p.point_prior_inv_sd[10:30] = 20.0
    p.point_prior_loss = np.zeros(256)
    p.point_prior_loss[10:20] = 2.0
    p.loss = "CauchyLoss"
    return p


def _with_shot_priors():
    """Up-vector rows on every shot and pan / tilt / roll rows."""
    p = _make_problem(8, 256, seed=2)
    p.up_inst = np.arange(8, dtype=np.int32)
    p.up_rigcam = np.zeros(8, dtype=np.int32)
    p.up_vec = np.tile([[0.0, -1.0, 0.0]], (8, 1))
    p.up_inv_sd = np.full(8, 10.0)
    p.ang_kind = np.array([0, 1, 2, 0], dtype=np.int32)
    p.ang_inst = np.array([1, 2, 3, 4], dtype=np.int32)
    p.ang_rigcam = np.zeros(4, dtype=np.int32)
    p.ang_value = np.array([0.3, -0.05, 0.02, 1.5])
    p.ang_inv_sd = np.full(4, 5.0)
    p.loss = "HuberLoss"
    return p


def _two_cameras():
    """Two perspective cameras: not mono, so the canonical layout."""
    p = _make_problem(8, 256, seed=3)
    cam2 = np.concatenate([p.cam, p.cam * np.array([[0.9, 1.1, 1.01]])])
    return dataclasses.replace(
        p, cam=cam2, cam_prior=cam2.copy(),
        cam_prior_inv_sd=np.full((2, 3), 100.0),
        cam_log_mask=np.array([[False, False, True]] * 2),
        opt_cam=np.ones((2, 3), bool),
        obs_cam=(p.obs_inst % 2).astype(np.int64),
    )


@pytest.mark.parametrize("make", [
    lambda: _make_problem(8, 256),
    _with_priors,
    _with_shot_priors,
    _two_cameras,
    # 200 points: dense, but off the fused route (not a multiple of 128).
    lambda: _make_problem(8, 200, seed=4),
], ids=["dense", "priors", "shot_priors", "two_cameras", "dense_unfused"])
def test_bundle_adjust_matches_reference(make):
    problem = make()
    _, dense = port_lm.canonicalize_problem_dense(
        port_lm.problem_from_numpy(problem))
    _, ref_dense = ref_lm.canonicalize_problem_dense(problem)
    assert dense == ref_dense
    _assert_same_solve(problem)


def _canonical_only(monkeypatch):
    """Keep the port on the canonical (point, slot) layout: at CPU-test
    sizes every mono problem would densify."""
    monkeypatch.setattr(
        port_lm, "canonicalize_problem_dense",
        lambda p: (port_lm.canonicalize_problem(p), False),
    )


def _ref_state_data(problem):
    f = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    ints = ("obs_point", "obs_inst", "obs_rigcam", "obs_cam", "point_obs")
    bools = ("cam_log_mask", "opt_inst", "opt_rigcam", "opt_cam",
             "opt_points")
    floats = ("obs_uv", "obs_inv_sd", "gps_pos", "gps_inv_sd", "cam_prior",
              "cam_prior_inv_sd", "rigcam_prior", "rigcam_prior_inv_sd",
              "point_prior", "point_prior_inv_sd")
    data = {}
    for name in floats + ints + bools:
        x = getattr(problem, name)
        data[name] = (jnp.asarray(x, jnp.int32) if name in ints
                      else jnp.asarray(x, bool) if name in bools else f(x))
    state = tuple(f(getattr(problem, k))
                  for k in ("inst", "rigcam", "cam", "points"))
    return state + (jnp.zeros(0),), data


def test_canonical_step_and_cost_match_reference(monkeypatch):
    _canonical_only(monkeypatch)
    problem = ref_lm.canonicalize_problem(
        _make_problem(16, 512, track_window=6))
    state_r, data_r = _ref_state_data(problem)
    p, dense, state_p, data_p = port_lm.device_problem(
        port_lm.problem_from_numpy(problem), torch.float64,
        torch.device("cpu"))
    assert not dense
    ni, nr, nc = len(problem.inst), len(problem.rigcam), len(problem.cam)
    kw = dict(loss="SoftLOneLoss", loss_threshold=1.0)
    rkw = dict(ptype="perspective", pmax=3, rig_transform=False,
               rig_jac=False, canonical=True, dense=False, **kw)
    cost_r = float(ref_lm._total_cost(state_r, data_r, **rkw))
    cost_p = float(port_lm._total_cost(state_p, data_p, **kw))
    assert abs(cost_p - cost_r) <= 1e-10 * cost_r
    for lam in (1e-4, 1.0):
        new_r = ref_lm._lm_step(state_r, data_r, jnp.float64(lam), ni=ni,
                                nr=nr, nc=nc, **rkw)
        new_p = port_lm._lm_step(state_p, data_p, lam, pmax=3, ni=ni, nr=nr,
                                 nc=nc, dense=False, **kw)
        for a, b in zip(new_p, new_r[:4]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-9)
        c_r = float(ref_lm._total_cost(new_r, data_r, **rkw))
        c_p = float(port_lm._total_cost(new_p, data_p, **kw))
        assert abs(c_p - c_r) <= 1e-10 * c_r


def test_canonical_solve_matches_reference(monkeypatch):
    _canonical_only(monkeypatch)
    problem = _make_problem(16, 512, track_window=6)
    want = ref_lm.bundle_adjust(problem, max_iterations=10)
    got = port_lm.bundle_adjust(port_lm.problem_from_numpy(problem),
                                max_iterations=10, device="cpu")
    assert got.iterations == want.iterations
    assert abs(got.final_cost - want.final_cost) <= 1e-8 * want.final_cost
    np.testing.assert_allclose(got.points, want.points, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.inst, want.inst, rtol=0, atol=1e-7)


def test_single_segment_ptype_is_its_type():
    problem = _make_problem(8, 256, seed=5)
    tagged = dataclasses.replace(
        problem, ptype=(("perspective", 0, len(problem.obs_uv)),))
    a = port_lm.bundle_adjust(port_lm.problem_from_numpy(problem),
                              max_iterations=5, device="cpu")
    b = port_lm.bundle_adjust(port_lm.problem_from_numpy(tagged),
                              max_iterations=5, device="cpu")
    assert a.final_cost == b.final_cost and a.iterations == b.iterations


@pytest.mark.parametrize("n_shots,n_points,window", [
    (16, 512, None), (24, 700, 5), (9, 130, 4),
])
def test_make_problem_copy_matches_graft_entry(n_shots, n_points, window):
    a = sb.make_problem(n_shots, n_points, seed=11, track_window=window)
    b = _make_problem(n_shots, n_points, seed=11, track_window=window)
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _unported(kind):
    p = port_lm.problem_from_numpy(_make_problem(8, 64))
    O = len(p.obs_uv)
    if kind == "fisheye":
        return dataclasses.replace(p, ptype="fisheye")
    if kind == "mixed":
        return dataclasses.replace(
            p, ptype=(("perspective", 0, O // 2), ("fisheye", O // 2, O)))
    if kind == "rig_pose":
        return dataclasses.replace(p, rigcam=np.full((1, 6), 0.1))
    if kind == "rig_opt":
        return dataclasses.replace(p, opt_rigcam=np.ones(1, bool))
    if kind == "depth":
        return dataclasses.replace(
            p, obs_depth=np.ones(O), obs_depth_inv_sd=np.ones(O),
            obs_depth_radial=np.zeros(O, bool))
    if kind == "graph":
        return dataclasses.replace(
            p, gauge_i=np.array([0]), gauge_j=np.array([1]),
            gauge_norm=np.array([1.0]))
    if kind == "scales":
        return dataclasses.replace(p, scales=np.ones(1),
                                   opt_scales=np.ones(1, bool))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["fisheye", "mixed", "rig_pose", "rig_opt",
                                  "depth", "graph", "scales"])
def test_unported_features_raise(kind):
    """The features earlier slices refused are all ported now and solve as
    the JAX package solves them: a fisheye camera, mixed types, a fixed
    non-identity rig camera, an optimized rig camera and depth rows on the
    generic route; a pose-graph family (the gauge fix) and a scale
    variable on the kernel route of this mono perspective map."""
    problem = _unported(kind)
    want = ref_lm.bundle_adjust(
        ref_lm.BAProblem(**{f.name: getattr(problem, f.name)
                            for f in dataclasses.fields(ref_lm.BAProblem)}),
        max_iterations=10)
    got = port_lm.bundle_adjust(problem, max_iterations=10, device="cpu")
    assert got.route == ("generic" if kind not in ("graph", "scales")
                         else "dense")
    assert got.iterations == want.iterations
    assert abs(got.final_cost - want.final_cost) <= 1e-10 * want.final_cost
    for name in ("inst", "rigcam", "cam", "points"):
        a, b = getattr(got, name), getattr(want, name)
        assert np.abs(a - b).max() <= 1e-8 * max(np.abs(b).max(), 1.0), name


def test_covariances_raise():
    """`compute_covariances=True`, refused by earlier slices, gives the JAX
    package's covariances and `valid` (tests/test_torch_bundle_adjuster.py
    holds them with the pose-graph families)."""
    problem = _make_problem(8, 64)
    want = ref_lm.bundle_adjust(problem, max_iterations=5,
                                compute_covariances=True)
    got = port_lm.bundle_adjust(port_lm.problem_from_numpy(problem),
                                max_iterations=5, compute_covariances=True,
                                device="cpu")
    assert got.covariance_valid == want.covariance_valid
    assert got.covariances.shape == (8, 6, 6)
    np.testing.assert_allclose(got.covariances, want.covariances, rtol=0,
                               atol=1e-8 * np.abs(want.covariances).max())


def test_multi_gpu_bundle_raises(monkeypatch):
    """Where the reference routes a full-map bundle to its sharded solver
    (auto mode, more than one device, a large map), so does the port: over
    `default_mesh()` (here a virtual mesh of two CPU shards).  Without CUDA
    the default device raises; `bundle_distributed: no` and a small map
    solve on one device."""
    from opensfm_tpu_torch.ba import problem as port_problem
    from opensfm_tpu_torch.parallel import mesh as mesh_lib

    problem = port_lm.problem_from_numpy(_make_problem(8, 64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = {"bundle_max_iterations": 3, "bundle_distributed": "auto",
              "bundle_distributed_min_shots": 100}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_problem._solve_full_bundle(problem, config, n_shots=256)
    monkeypatch.setattr(mesh_lib, "default_mesh",
                        lambda device=None: mesh_lib.virtual_mesh("cpu", 2))
    res = port_problem._solve_full_bundle(problem, config, n_shots=256,
                                          device="cpu")
    assert res.route.startswith("sharded_")
    assert res.final_cost < res.initial_cost
    for n_shots, mode in ((256, False), (8, "auto")):  # YAML's `no`
        config["bundle_distributed"] = mode
        res = port_problem._solve_full_bundle(problem, config,
                                              n_shots=n_shots, device="cpu")
        assert not res.route.startswith("sharded_")
        assert res.final_cost < res.initial_cost