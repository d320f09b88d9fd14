"""The port's sharded bundle as a whole, on a virtual mesh of CPU shards.

- `bundle_adjust_sharded` against the JAX package's on its 4-device CPU
  mesh, one solve per route (dense, schur, cg), at the JAX tests' bounds
  (tests/test_distributed_pipeline.py:449-471: relative final cost 1e-9,
  parameters 1e-8, equal iterations);
- the sharded solve against the port's single-device `bundle_adjust` on
  every residual family (rigs fixed and optimized, up-vector rows, depth
  rows, mixed projection types, the pose-graph families with scales), at
  the JAX tests' bounds for each;
- `ba/problem._solve_full_bundle`'s routing over `default_mesh()`,
  monkeypatched to a virtual CPU mesh;
- a small incremental reconstruction with every full-map bundle sharded,
  within tests/test_reconstruction_incremental.py's bounds;
- the ValueErrors, and the required shot-row keys of `_dense_grid_data`.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import opensfm_tpu.parallel.distributed_ba as ref_dba
import synthetic_bundle as sb
from __graft_entry__ import _make_problem
from opensfm_tpu_torch import geo, reconstruction
from opensfm_tpu_torch.ba import lm
from opensfm_tpu_torch.ba import problem as ba_problem
from opensfm_tpu_torch.ba.lm import problem_from_numpy
from opensfm_tpu_torch.parallel import distributed_ba as dba
from opensfm_tpu_torch.parallel import mesh as mesh_lib
from opensfm_tpu_torch.synthetic_data import (
    synthetic_dataset,
    synthetic_examples,
    synthetic_scene,
)

N_SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return mesh_lib.virtual_mesh("cpu", N_SHARDS)


def _assert_same_solve(got, want, rel_cost=1e-9, param=1e-8):
    rel = abs(got.final_cost - want.final_cost) / want.final_cost
    assert rel < rel_cost, (got.final_cost, want.final_cost)
    assert got.iterations == want.iterations
    assert np.abs(got.inst - want.inst).max() < param
    assert np.abs(got.cam - want.cam).max() < param
    assert np.abs(got.points - want.points).max() < param


@pytest.mark.parametrize("solver", ["dense", "schur", "cg"])
def test_sharded_solve_matches_reference(mesh, solver):
    """The JAX package's sharded solve on its CPU mesh, and the port's on a
    virtual mesh, from one sparse mono problem (track_window 8)."""
    problem = _make_problem(n_shots=12, n_points=256, seed=3, track_window=8)
    want = ref_dba.bundle_adjust_sharded(
        problem, max_iterations=12, solver=solver, dtype=np.float64,
        mesh=JaxMesh(np.array(jax.devices()[:N_SHARDS]), ("points",)))
    got = dba.bundle_adjust_sharded(
        problem_from_numpy(problem), max_iterations=12, solver=solver,
        dtype=np.float64, mesh=mesh)
    assert got.route == f"sharded_{solver}"
    assert got.initial_cost == pytest.approx(want.initial_cost, rel=1e-12)
    assert got.lam == pytest.approx(want.lam, rel=1e-12)
    _assert_same_solve(got, want)


def _variant(name):
    """tests/test_distributed_pipeline.py's variants, on the port's copy of
    the problem generator."""
    p = sb.make_problem(n_shots=12, n_points=256, seed=3)
    ni, O = len(p.inst), len(p.obs_uv)
    if name in ("rig_fixed", "rig_opt"):
        p.rigcam = np.array([[0.0, 0.02, 0.0, 0.1, 0.0, 0.05]])
    if name == "rig_opt":
        p.opt_rigcam = np.ones(1, bool)
        p.rigcam_prior = p.rigcam.copy()
        p.rigcam_prior_inv_sd = np.full((1, 6), 10.0)
    elif name == "up":
        p.up_inst = np.arange(ni, dtype=np.int64)
        p.up_rigcam = np.zeros(ni, dtype=np.int64)
        p.up_vec = np.tile([0.0, 0.0, 1.0], (ni, 1))
        p.up_inv_sd = np.full(ni, 10.0)
    elif name == "depth":
        p.obs_depth = np.full(O, 10.0)
        p.obs_depth_inv_sd = np.full(O, 1.0)
        p.obs_depth_radial = np.zeros(O, bool)
    elif name == "mixed":
        # Shots 6-11 through a spherical camera: two type segments.
        split = 6 * 256
        p.cam = np.vstack([p.cam, np.zeros((1, 3))])
        p.cam_prior = p.cam.copy()
        p.cam_prior_inv_sd = np.vstack([p.cam_prior_inv_sd, np.zeros((1, 3))])
        p.cam_log_mask = np.vstack([p.cam_log_mask, np.zeros((1, 3), bool)])
        p.opt_cam = np.vstack([p.opt_cam, np.zeros((1, 3), bool)])
        p.obs_cam = np.where(np.arange(O) >= split, 1, 0).astype(np.int64)
        from opensfm_tpu_torch.geometry import cameras as cl
        from opensfm_tpu_torch.geometry.pose import Pose

        sl = slice(split, O)
        Rm = np.stack([Pose(p.inst[i, :3], p.inst[i, 3:])
                       .get_rotation_matrix() for i in p.obs_inst[sl]])
        Xc = np.einsum("oij,oj->oi", Rm, p.points[p.obs_point[sl]]) \
            + p.inst[p.obs_inst[sl], 3:]
        p.obs_uv = np.array(p.obs_uv)
        p.obs_uv[sl] = cl.project("spherical", Xc, p.cam[1], xp=np) \
            + np.random.default_rng(3).normal(0, 0.0005, (O - split, 2))
        p.ptype = (("perspective", 0, split), ("spherical", split, O))
    elif name in ("rm", "rr", "cp", "lin", "gauge", "hm"):
        p = _graph_variant(p, name)
    return p


def _graph_variant(p, family):
    """One pose-graph family (tests/test_distributed_pipeline.py's
    `_graph_problem`)."""
    from opensfm_tpu_torch.geometry import rotation as rot

    i = np.arange(0, 10, dtype=np.int32)
    j = i + 1
    K = len(i)
    if family == "rm":
        p.scales = np.ones(2)
        p.opt_scales = np.array([False, True])
        Ri = rot.rotvec_to_matrix(torch.as_tensor(p.inst[i, :3])).numpy()
        Rj = rot.rotvec_to_matrix(torch.as_tensor(p.inst[j, :3])).numpy()
        rel = np.einsum("kij,klj->kil", Rj, Ri).transpose(0, 2, 1)
        p.rm_i, p.rm_j = i, j
        p.rm_si = np.zeros(K, np.int32)
        p.rm_sj = np.ones(K, np.int32)
        p.rm_rvec = rot.matrix_to_rotvec(torch.as_tensor(rel)).numpy()
        p.rm_tvec = np.zeros((K, 3))
        p.rm_scale = np.ones(K)
        p.rm_inv_sd = np.full((K, 7), 5.0)
        p.rm_obs_scale = np.zeros(K, bool)
        p.rm_loss_c = np.ones(K)
    elif family == "rr":
        p.rr_i, p.rr_j = i, j
        p.rr_ri = np.zeros(K, np.int32)
        p.rr_rj = np.zeros(K, np.int32)
        p.rr_rvec = np.zeros((K, 3))
        p.rr_inv_sd = np.full((K, 3), 2.0)
        p.rr_loss_c = np.ones(K)
    elif family == "cp":
        p.cp_i, p.cp_j = i, j
        p.cp_ri = np.zeros(K, np.int32)
        p.cp_rj = np.zeros(K, np.int32)
        p.cp_margin = np.full(K, 1.0)
        p.cp_inv_sd = np.full(K, 0.5)
    elif family == "lin":
        K = 8
        p.lin_i0 = np.arange(K, dtype=np.int32)
        p.lin_i1 = p.lin_i0 + 1
        p.lin_i2 = p.lin_i0 + 2
        p.lin_r0 = p.lin_r1 = p.lin_r2 = np.zeros(K, np.int32)
        p.lin_alpha = np.full(K, 0.5)
        p.lin_pos_inv_sd = np.full(K, 2.0)
        p.lin_rot_inv_sd = np.full(K, 2.0)
    elif family == "gauge":
        p.gauge_i = np.array([0], np.int32)
        p.gauge_j = np.array([6], np.int32)
        p.gauge_norm = np.array([20.0])
    elif family == "hm":
        p.heatmaps = np.random.default_rng(0).random((1, 16, 16)) * 0.1
        p.hm_res = np.array([4.0])
        p.hm_inst = np.arange(4, dtype=np.int32)
        p.hm_rigcam = np.zeros(4, np.int32)
        p.hm_map = np.zeros(4, np.int32)
        p.hm_offset = np.zeros((4, 2))
        p.hm_inv_sd = np.full(4, 1.0)
    return p


@pytest.mark.parametrize("variant", [
    "plain", "rig_fixed", "rig_opt", "up", "depth", "mixed",
    "rm", "rr", "cp", "lin", "gauge", "hm",
])
def test_sharded_matches_single_device(mesh, variant):
    """The assembled-Schur sharded solve (f64) against the port's
    single-device LM: the JAX tests' bounds, 1e-9 / 1e-8 (the pose-graph
    families 1e-7 / 1e-6, scales 1e-8)."""
    graph = variant in ("rm", "rr", "cp", "lin", "gauge", "hm")
    iters = 10 if graph else 12
    want = lm.bundle_adjust(_variant(variant), max_iterations=iters,
                            device="cpu")
    p = _variant(variant)
    if graph:
        assert dba.check_cg_compatible(p) is not None
    else:
        assert dba.check_cg_compatible(p) is None
    got = dba.bundle_adjust_sharded(p, max_iterations=iters,
                                    solver="auto" if graph else "schur",
                                    dtype=np.float64, mesh=mesh)
    assert got.route == "sharded_schur"
    rel = abs(got.final_cost - want.final_cost) / want.final_cost
    if graph:
        assert rel < 1e-7, (got.final_cost, want.final_cost)
        assert np.abs(got.inst - want.inst).max() < 1e-6
        if variant == "rm":
            assert np.abs(got.scales - want.scales).max() < 1e-8
        return
    assert rel < 1e-9, (got.final_cost, want.final_cost)
    assert np.abs(got.inst - want.inst).max() < 1e-8
    assert np.abs(got.cam - want.cam).max() < 1e-8
    if variant == "rig_opt":
        assert np.abs(got.rigcam - want.rigcam).max() < 1e-8


@pytest.mark.parametrize("up", [False, True])
def test_dense_grid_matches_single_device(mesh, up):
    """The dense-grid route, with and without up-vector rows, against the
    single-device fused dense route: the same trajectory."""
    def make():
        p = sb.make_problem(n_shots=12, n_points=256, seed=3,
                            track_window=8)
        if up:
            p.up_inst = np.arange(12, dtype=np.int64)
            p.up_rigcam = np.zeros(12, dtype=np.int64)
            p.up_vec = np.tile([0.0, -1.0, 0.0], (12, 1))
            p.up_inv_sd = np.full(12, 1e3)
        return p

    want = lm.bundle_adjust(make(), max_iterations=12, device="cpu")
    got = dba.bundle_adjust_sharded(make(), max_iterations=12,
                                    solver="dense", dtype=np.float64,
                                    mesh=mesh)
    _assert_same_solve(got, want)


def test_cg_solve_reaches_single_device_basin(mesh):
    """Matrix-free CG on an optimized rig camera with depth rows: the same
    basin (final cost within 10 %) as the single-device LM."""
    p = _variant("rig_opt")
    want = lm.bundle_adjust(p, max_iterations=12, device="cpu")
    got = dba.bundle_adjust_sharded(_variant("rig_opt"), max_iterations=12,
                                    solver="cg", dtype=np.float64, mesh=mesh)
    assert got.route == "sharded_cg"
    assert got.final_cost < got.initial_cost
    assert got.final_cost <= want.final_cost * 1.10 + 1e-9
    assert np.abs(got.rigcam - want.rigcam).max() < 5e-3


def test_f32_solve_and_padding():
    """The default f32 solve over 3 shards of a 500-point map (point blocks
    padded to 128 a shard, Cauchy point priors padded with them)."""
    p = sb.make_problem(n_shots=12, n_points=500, seed=3, track_window=8)
    p.point_prior = np.asarray(p.points).copy()
    p.point_prior_inv_sd = np.full((500, 3), 0.5)
    p.point_prior_loss = np.full(500, 2.0)
    r = dba.bundle_adjust_sharded(p, max_iterations=6,
                                  mesh=mesh_lib.virtual_mesh("cpu", 3))
    assert r.route == "sharded_dense"
    assert r.final_cost < r.initial_cost
    assert r.points.shape == (500, 3)
    assert np.all(np.isfinite(r.points))


def _spy(monkeypatch):
    calls = []
    orig = dba.bundle_adjust_sharded

    def spy(*args, **kwargs):
        res = orig(*args, **kwargs)
        calls.append(dict(kwargs, route=res.route))
        return res

    monkeypatch.setattr(dba, "bundle_adjust_sharded", spy)
    return calls


@pytest.mark.parametrize("mode,n_shots,shards,sharded", [
    ("auto", 12, 2, False),  # under bundle_distributed_min_shots
    ("auto", 150, 2, True),
    ("yes", 12, 2, True),
    ("no", 150, 2, False),
    ("yes", 150, 1, False),  # one shard: nothing to shard over
])
def test_full_bundle_routing(monkeypatch, mode, n_shots, shards, sharded):
    monkeypatch.setattr(mesh_lib, "default_mesh",
                        lambda device=None: mesh_lib.virtual_mesh("cpu",
                                                                  shards))
    calls = _spy(monkeypatch)
    config = {"bundle_max_iterations": 5, "bundle_distributed": mode,
              "bundle_distributed_min_shots": 100,
              "bundle_distributed_solver": "schur",
              "bundle_distributed_cg_iters": 50}
    p = sb.make_problem(n_shots=8, n_points=128, seed=2)
    res = ba_problem._solve_full_bundle(p, config, n_shots=n_shots,
                                        device="cpu")
    assert res.final_cost < res.initial_cost
    assert bool(calls) == sharded
    assert res.route.startswith("sharded_") == sharded
    if sharded:
        assert calls[0]["solver"] == "schur"
        assert calls[0]["cg_iters"] == 50
        assert calls[0]["mesh"].n_shards == shards


def test_incompatible_problem_falls_back(monkeypatch, caplog):
    """Pose-graph rows with solver cg (and a map without observations)
    fall back to one device, logged, as the JAX package does."""
    monkeypatch.setattr(mesh_lib, "default_mesh",
                        lambda device=None: mesh_lib.virtual_mesh("cpu", 2))
    calls = _spy(monkeypatch)
    config = {"bundle_max_iterations": 3, "bundle_distributed": "yes",
              "bundle_distributed_solver": "cg"}
    p = _graph_variant(sb.make_problem(n_shots=12, n_points=64, seed=3),
                       "gauge")
    with caplog.at_level(logging.INFO, logger=ba_problem.__name__):
        res = ba_problem._solve_full_bundle(p, config, n_shots=12,
                                            device="cpu")
    assert not calls and not res.route.startswith("sharded_")
    assert "gauge_i constraints present" in caplog.text
    config["bundle_distributed_solver"] = "auto"
    res = ba_problem._solve_full_bundle(p, config, n_shots=12, device="cpu")
    assert res.route == "sharded_schur" and len(calls) == 1


def test_value_errors(mesh):
    g = _graph_variant(sb.make_problem(n_shots=12, n_points=64, seed=3),
                       "gauge")
    with pytest.raises(ValueError, match="assembled-Schur"):
        dba.bundle_adjust_sharded(g, max_iterations=2, solver="cg",
                                  mesh=mesh)
    empty = sb.make_problem(n_shots=8, n_points=64, seed=2)
    empty.obs_uv = empty.obs_uv[:0]
    empty.obs_inv_sd = empty.obs_inv_sd[:0]
    with pytest.raises(ValueError, match="no observations"):
        dba.bundle_adjust_sharded(empty, max_iterations=2, mesh=mesh)
    rig = sb.make_problem(n_shots=8, n_points=64, seed=2)
    rig.rigcam = np.array([[0.0, 0.02, 0.0, 0.1, 0.0, 0.05]])
    assert not dba._dense_grid_eligible(rig)
    with pytest.raises(ValueError, match="dense-grid"):
        dba.bundle_adjust_sharded(rig, solver="dense", mesh=mesh)
    two_cams = _variant("mixed")
    with pytest.raises(ValueError, match="densifiable"):
        dba.shard_problem_dense(two_cams, 2)
    with pytest.raises(ValueError, match="assembled-Schur"):
        dba.make_sharded_lm_block(mesh, "points", "perspective", 3, 8, 1,
                                  solver="cg", graph=("gauge_i",))


def test_dense_grid_data_needs_shot_rows():
    """The shot-row arrays are required keys, not silently empty."""
    p, _ = dba.shard_problem_dense(sb.make_problem(8, 128, seed=1), 1)
    a = dba._dense_block_args(p, np.float64)
    data = dba._dense_grid_data(a, 8)
    assert data["up_vec"].shape == (0, 3)
    for key in ("up_vec", "ang_inv_sd"):
        b = dict(a)
        del b[key]
        with pytest.raises(KeyError, match=key):
            dba._dense_grid_data(b, 8)


def _small_circle_scene(n_points=1000):
    """The JAX e2e test's circle scene (seed 42, GPS noise 5, GCPs) with
    1,000 street points in place of 5,000 (700 leave the single-device
    reconstruction outside the bounds as well)."""
    rng = np.random.RandomState(42)
    reference = geo.TopocentricConverter(47.0, 6.0, 0)
    generator = synthetic_scene.get_scene_generator("circle", 60)
    scene = synthetic_scene.SyntheticStreetScene(generator, reference,
                                                 rng=rng)
    scene.add_street(n_points, 7, 7).perturb_floor([0, 0, 0.1]).perturb_walls(
        [0.2, 0.2, 0.01])
    synthetic_examples.make_regular_scene(60, scene)
    return synthetic_scene.SyntheticInputData(
        scene.get_reconstruction(), reference, 40, 1.0, 5.0, 0.1,
        (0.01, 0.1), False, 10, None, rng=rng)


def test_incremental_reconstruction_sharded(monkeypatch):
    """Every full-map bundle of an incremental reconstruction on 2 shards
    (f32, `auto`: the dense grid for this mono map):
    tests/test_reconstruction_incremental.py's bounds (position RMS < 0.03,
    rotation RMS < 0.003, points < 0.1)."""
    monkeypatch.setattr(mesh_lib, "default_mesh",
                        lambda device=None: mesh_lib.virtual_mesh("cpu", 2))
    calls = _spy(monkeypatch)
    scene = _small_circle_scene()
    dataset = synthetic_dataset.SyntheticDataSet(
        scene.reconstruction, scene.exifs, scene.features,
        scene.tracks_manager, scene.gcps)
    dataset.config.update({
        "bundle_use_gcp": True, "bundle_max_iterations": 20,
        "bundle_distributed": "yes", "bundle_distributed_min_shots": 1,
    })
    _, recs = reconstruction.incremental_reconstruction(
        dataset, scene.tracks_manager, device="cpu")
    assert len(calls) >= 1
    assert {c["route"] for c in calls} == {"sharded_dense"}
    errors = synthetic_scene.compare(scene.reconstruction, scene.gcps,
                                     recs[0], device="cpu")
    assert errors["ratio_cameras"] == 1.0
    assert 0 < errors["aligned_position_rmse"] < 0.03
    assert 0 < errors["aligned_rotation_rmse"] < 0.003
    assert 0 < errors["aligned_points_rmse"] < 0.1


def _padded(p, n_inst=1, n_points=64, n_rows=16):
    """`p` padded as `ba/problem` pads a problem: fixed instances
    at the zero pose, fixed points at the origin, zero-weight observation
    rows on (point 0, instance 0)."""
    O = len(p.obs_uv)
    p.inst = np.vstack([p.inst, np.zeros((n_inst, 6))])
    p.gps_pos = np.vstack([p.gps_pos, np.zeros((n_inst, 3))])
    p.gps_inv_sd = np.append(p.gps_inv_sd, np.zeros(n_inst))
    p.opt_inst = np.append(p.opt_inst, np.zeros(n_inst, bool))
    for name in ("points", "point_prior", "point_prior_inv_sd"):
        setattr(p, name, np.vstack([getattr(p, name),
                                    np.zeros((n_points, 3))]))
    p.opt_points = np.append(p.opt_points, np.zeros(n_points, bool))
    p.point_obs = np.vstack([p.point_obs, np.full(
        (n_points, p.point_obs.shape[1]), O + n_rows)])
    p.point_obs[p.point_obs == O] = O + n_rows
    p.obs_uv = np.vstack([p.obs_uv, np.zeros((n_rows, 2))])
    p.obs_inv_sd = np.append(p.obs_inv_sd, np.zeros(n_rows))
    for name in ("obs_point", "obs_inst", "obs_rigcam", "obs_cam"):
        setattr(p, name, np.append(getattr(p, name),
                                   np.zeros(n_rows, np.int64)))
    return p


def test_padded_map_on_the_dense_grid(mesh):
    """A map padded as `ba/problem` pads it runs on the dense grid without
    its padding instances (the JAX package's grid cost is NaN there: 0 / 0
    at a padding instance and a padding point) and equals the single-device
    solve; an unobserved instance that is optimized keeps the map off the
    grid."""
    def make():
        return _padded(sb.make_problem(n_shots=8, n_points=128, seed=2,
                                       track_window=4))

    assert dba._dense_grid_normalize(make()).dense_keep.tolist() == \
        list(range(8))
    want = lm.bundle_adjust(make(), max_iterations=10, device="cpu")
    got = dba.bundle_adjust_sharded(make(), max_iterations=10,
                                    dtype=np.float64, mesh=mesh)
    assert got.route == "sharded_dense"
    assert got.inst.shape == (9, 6) and not np.any(got.inst[8])
    _assert_same_solve(got, want)
    p = make()
    p.opt_inst[8] = True
    assert not dba._dense_grid_eligible(p)
