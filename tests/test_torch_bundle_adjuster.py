"""The port's pose-graph bundle adjustment against the JAX package on the
CPU: the `BundleAdjuster` facade (`opensfm_tpu_torch.ba.adjuster`) and, in
`ba/lm.py`, the pose-graph constraint families, the scale variables and the
covariances.

- The twelve cases of tests/test_bundle_adjuster.py, run as written with
  the port's facade, camera and pose in place of the JAX package's (one
  parametrised test, the same assertions).
- Each family's weighted rows and Jacobian blocks, and the folded S and b,
  against the JAX package's `_graph_residuals` / `_fold_graph_rows` on the
  same state, at 1e-10 relative.
- Whole solves on the canonical, the fused dense and the generic route
  against the JAX package's (its XLA branch, what its CPU run takes), at
  1e-8; one LM step on the fused dense and the canonical layouts equal.
- Scale variables with and without sharing against the JAX facade.
- `compute_covariances=True` at 1e-8 relative, with the same `valid`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_bundle_adjuster as ref_cases
import synthetic_bundle as sb
from opensfm_tpu.ba import adjuster as ref_adjuster
from opensfm_tpu.ba import lm as ref_lm
from opensfm_tpu_torch.ba import adjuster, lm
from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose

import jax
import jax.numpy as jnp

# Families, folds and covariances: the two packages round apart only.
REL_ROWS = 1e-10
# Whole solves (same accepted steps): parameters and costs.
TOL_SOLVE = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CpuAdjuster(adjuster.BundleAdjuster):
    def __init__(self):
        super().__init__(device="cpu")


CASES = sorted(n for n in dir(ref_cases) if n.startswith("test_"))


def test_twelve_reference_cases_listed():
    assert len(CASES) == 12


@pytest.mark.parametrize("case", CASES)
def test_reference_case_through_port_facade(case, monkeypatch):
    """tests/test_bundle_adjuster.py's case as written, on the port."""
    for name, value in (("BundleAdjuster", _CpuAdjuster),
                        ("RelativeMotion", adjuster.RelativeMotion),
                        ("RelativeRotation", adjuster.RelativeRotation),
                        ("Camera", Camera), ("Pose", Pose)):
        monkeypatch.setattr(ref_cases, name, value)
    sa = _CpuAdjuster()
    camera = Camera.create_perspective(1.0, 0.0, 0.0)
    sa.add_camera("cam1", camera, camera, True)
    sa.add_rig_camera("rig_cam1", Pose(), Pose(), True)
    getattr(ref_cases, case)(sa)


@pytest.fixture(scope="module")
def graph_problem():
    return sb.add_pose_graph(sb.make_problem(8, 128, track_window=4))


def _only(problem, families):
    """`problem` keeping the pose-graph `families` (field prefixes) only."""
    drop = {"rm", "rr", "cp", "lin", "hm", "gauge"} - set(families)
    return dataclasses.replace(problem, **{
        f.name: None for f in dataclasses.fields(problem)
        if f.name.split("_")[0] in drop or (
            "hm" in drop and f.name == "heatmaps")})


@pytest.fixture(scope="module")
def solve_problem(graph_problem):
    """The whole-solve cases' problem: relative motions between scaled
    reconstructions and the gauge fix (every family's rows and fold are
    held on their own; the JAX package compiles each family into its solve,
    ~6 s a family on the CPU)."""
    return _only(graph_problem, ("rm", "gauge"))


@pytest.fixture(scope="module")
def ref_solve(solve_problem):
    return ref_lm.bundle_adjust(solve_problem, max_iterations=10,
                                compute_covariances=True)


def _jnp(state, data):
    return (tuple(jnp.asarray(x.numpy()) for x in state),
            {k: jnp.asarray(v.numpy()) for k, v in data.items()})


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_heatmap_sample_at_integer_and_border():
    """The bicubic lookup clamps and floors as the JAX package's, at an
    interior integer coordinate, on the border and beyond it."""
    grid = np.random.default_rng(4).random((16, 16))
    rows = np.array([5.0, 0.0, 15.0, -2.5, 17.25, 7.5])
    cols = np.array([7.0, 0.0, 15.0, 3.5, -1.0, 15.75])
    got = lm._bicubic(torch.as_tensor(grid).expand(6, 16, 16),
                      torch.as_tensor(rows), torch.as_tensor(cols)).numpy()
    want = [float(ref_lm._bicubic(jnp.asarray(grid), r, c))
            for r, c in zip(rows, cols)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    assert got[0] == grid[5, 7]


def test_graph_rows_and_fold_match_reference(graph_problem, monkeypatch):
    """Every family's weighted rows and Jacobian blocks (the JAX package's
    under one jit: its eager vmap is slow), the graph cost, and the folded
    S and b (the JAX package's fold of those same rows)."""
    _, _, state, data = lm.device_problem(
        lm.problem_from_numpy(graph_problem), torch.float64,
        torch.device("cpu"))
    rs, rd = _jnp(state, data)

    def ref_rows(st, d):
        return [(r, [J for _, _, J in slots])
                for r, slots in ref_lm._graph_residuals(st, d)]

    want = jax.jit(ref_rows)(rs, rd)
    got = lm._graph_residuals(state, data)
    assert len(got) == len(want) == 6
    for (r_p, slots_p), (r_r, Js_r) in zip(got, want):
        assert _rel(r_p.numpy(), r_r) <= REL_ROWS
        assert len(slots_p) == len(Js_r)
        for (_, _, Jp), Jr in zip(slots_p, Js_r):
            Jr = np.asarray(Jr)
            Jr = Jr[..., None] if Jr.ndim == 2 else Jr
            assert np.all(np.isfinite(Jp.numpy()))
            assert _rel(Jp.numpy(), Jr) <= REL_ROWS
    want_cost = float(jax.jit(ref_lm._graph_cost)(rs, rd))
    assert abs(float(lm._graph_cost(state, data)) - want_cost) \
        <= REL_ROWS * want_cost

    ni, nr, nc, pmax, ns = 8, 1, 1, 3, 3
    D = ni * 6 + nr * 6 + nc * pmax + ns
    S_p, b_p = lm._fold_graph_rows(
        torch.zeros((D, D), dtype=torch.float64),
        torch.zeros(D, dtype=torch.float64), state, data, ni, nr, nc, pmax,
        ns)
    # The JAX package's fold of its own rows, run eagerly on them.
    rows = [(r, [(f, jnp.asarray(i.numpy()), J) for (f, i, _), J
                 in zip(slots_p, Js)])
            for (r, Js), (_, slots_p) in zip(want, got)]
    monkeypatch.setattr(ref_lm, "_graph_residuals", lambda st, d: rows)
    S_r, b_r = ref_lm._fold_graph_rows(jnp.zeros((D, D)), jnp.zeros(D), rs,
                                       rd, ni, nr, nc, pmax, ns)
    assert _rel(S_p.numpy(), S_r) <= REL_ROWS
    assert _rel(b_p.numpy(), b_r) <= REL_ROWS


def _check_solve(got, want):
    assert got.iterations == want.iterations
    assert abs(got.final_cost - want.final_cost) <= TOL_SOLVE * want.final_cost
    for name in ("inst", "points", "cam", "scales"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=TOL_SOLVE)


def test_fused_dense_solve_and_covariances_match_reference(solve_problem,
                                                           ref_solve):
    got = lm.bundle_adjust(lm.problem_from_numpy(solve_problem),
                           max_iterations=10, compute_covariances=True,
                           device="cpu")
    assert got.route == "fused_dense"
    _check_solve(got, ref_solve)
    assert got.scales[0] == 1.0  # the fixed scale stays as it was
    assert got.covariance_valid == ref_solve.covariance_valid is True
    assert _rel(got.covariances, ref_solve.covariances) <= TOL_SOLVE
    cov = got.covariances
    np.testing.assert_allclose(cov, cov.transpose(0, 2, 1), rtol=0,
                               atol=1e-12 * np.abs(cov).max())


def test_canonical_solve_matches_reference(solve_problem, ref_solve,
                                           monkeypatch):
    monkeypatch.setattr(lm, "canonicalize_problem_dense",
                        lambda p: (lm.canonicalize_problem(p), False))
    got = lm.bundle_adjust(lm.problem_from_numpy(solve_problem),
                           max_iterations=10, device="cpu")
    assert got.route == "canonical"
    _check_solve(got, ref_solve)


def test_fused_dense_step_equals_canonical_step(graph_problem, monkeypatch):
    """One LM step of the graph problem on the fused dense assembly (the
    graph rows folded after the kernel assembly) and on the canonical
    kernel route: the same new state."""
    p = lm.problem_from_numpy(graph_problem)
    cpu = torch.device("cpu")
    _, dense, st_d, data_d = lm.device_problem(p, torch.float64, cpu)
    assert dense and lm._fused_dense(st_d[3], 8, 3, dense)
    monkeypatch.setattr(lm, "canonicalize_problem_dense",
                        lambda q: (lm.canonicalize_problem(q), False))
    _, canon_dense, st_c, data_c = lm.device_problem(p, torch.float64, cpu)
    assert not canon_dense
    kw = dict(loss=p.loss, loss_threshold=p.loss_threshold, pmax=3, ni=8,
              nr=1, nc=1)
    fused = lm._lm_step(st_d, data_d, 1e-3, dense=True, **kw)
    canonical = lm._lm_step(st_c, data_c, 1e-3, dense=False, **kw)
    assert len(fused) == len(canonical) == 5
    for a, b in zip(fused, canonical):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(b).max()))


def test_generic_route_solve_matches_reference():
    base = sb.make_model_problem(6, 64, track_window=4, camera_types="brown")
    rng = np.random.default_rng(2)
    K = 5
    ii = np.arange(K)
    problem = dataclasses.replace(
        base, scales=np.array([1.0, 0.8]), opt_scales=np.array([False, True]),
        rm_i=ii, rm_j=ii + 1, rm_si=np.ones(K, np.int64),
        rm_sj=np.ones(K, np.int64), rm_rvec=rng.normal(size=(K, 3)) * 0.01,
        rm_tvec=rng.normal(size=(K, 3)), rm_scale=np.ones(K),
        rm_inv_sd=np.ones((K, 7)), rm_obs_scale=np.ones(K, bool),
        rm_loss_c=np.ones(K),
        rr_i=ii, rr_j=ii + 1, rr_ri=np.zeros(K, np.int64),
        rr_rj=np.zeros(K, np.int64), rr_rvec=rng.normal(size=(K, 3)) * 0.01,
        rr_inv_sd=np.ones((K, 3)), rr_loss_c=np.ones(K))
    want = ref_lm.bundle_adjust(problem, max_iterations=8)
    got = lm.bundle_adjust(lm.problem_from_numpy(problem), max_iterations=8,
                           device="cpu")
    assert got.route == "generic"
    _check_solve(got, want)


def test_scale_variables_match_reference_facade():
    """Two reconstructions' scales, one shared and one per instance, and
    relative motions with observed scales, through both facades; the
    priors disagree, so the optimum has a residual and the two solves'
    accept/reject sequences are not decided by rounding."""
    from opensfm_tpu.geometry.pose import Pose as RefPose

    results = []
    for mod, make, P in ((ref_adjuster, ref_adjuster.BundleAdjuster, RefPose),
                         (adjuster, _CpuAdjuster, Pose)):
        sa = make()
        for i in range(4):
            iid = str(i + 1)
            sa.add_rig_instance(iid, P(np.zeros(3), np.zeros(3)),
                                {iid: "cam1"}, {iid: "rig_cam1"}, False)
        sa.add_rig_camera("rig_cam1", P(), P(), True)
        for rec, ids, shared in (("12", "12", True), ("34", "34", False)):
            sa.add_reconstruction(rec, False)
            for iid in ids:
                sa.add_reconstruction_instance(rec, 1.5, iid)
            sa.set_scale_sharing(rec, shared)
        for a, b, t, obs in (("1", "2", [-0.5, -0.5, -0.5], True),
                             ("3", "2", [0.5, 0.5, 0.5], False),
                             ("3", "4", [-2.0, -2, -2], True),
                             ("2", "3", [-2.0, -2, -2], False)):
            sa.add_relative_motion(mod.RelativeMotion(
                a, b, np.zeros(3), np.array(t), 1, 1, obs))
        for iid, pos in (("1", [0.0, 0, 0]), ("2", [0.9, 1.2, 1.0]),
                         ("4", [3.0, 3.3, 2.8])):
            sa.add_rig_instance_position_prior(iid, np.array(pos),
                                               np.ones(3), "")
        sa.run()
        results.append(sa)
    ref, port = results
    assert ref._last_result.final_cost > 1e-3
    assert port._last_result.iterations == ref._last_result.iterations
    for iid in "1234":
        np.testing.assert_allclose(
            port.get_rig_instance_pose(iid).get_origin(),
            ref.get_rig_instance_pose(iid).get_origin(), rtol=0,
            atol=TOL_SOLVE)
    for rec, ids in (("12", "12"), ("34", "34")):
        for iid in ids:
            assert abs(port.get_reconstruction(rec).get_scale(iid)
                       - ref.get_reconstruction(rec).get_scale(iid)) \
                <= TOL_SOLVE
    # Shared: one value for the reconstruction; per instance: two.
    s12 = port.get_reconstruction("12").scales
    s34 = port.get_reconstruction("34").scales
    assert s12["1"] == s12["2"] and s34["3"] != s34["4"]
