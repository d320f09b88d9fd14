"""The port's bundle adjuster on every camera model, mixed maps, rigs and
depth priors (the generic route) against the JAX package's, on the CPU in
f64: the same accepted iterations, the final cost within 1e-10 relative
and the states within 1e-8 of their largest entry.

Problems from `synthetic_bundle.make_model_problem`: the nine projection
types other than perspective, a map mixing three types, a fixed rig of two
cameras (non-identity), an optimized rig of four, and radial and z depth
rows; then the generic residuals and Jacobians on a problem with all of it
at once, which route each problem takes, and the analogues of the JAX
package's fisheye bundle (tests/test_bundle.py:203) and depth-prior
(tests/test_bundle_priors.py:94) tests."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu import config as ref_config
from opensfm_tpu import pymap as ref_pymap
from opensfm_tpu import types as ref_types
from opensfm_tpu.ba import lm as ref_lm
from opensfm_tpu.ba import problem as ref_problem
from opensfm_tpu.geometry.cameras import Camera as RefCamera
from opensfm_tpu.geometry.pose import Pose as RefPose
from opensfm_tpu_torch import config, pymap, types
from opensfm_tpu_torch.ba import lm as port_lm
from opensfm_tpu_torch.ba import problem as port_problem
from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes at once, and multi-threaded small ops then
    wait on each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

COST_REL = 1e-10
STATE_REL = 1e-8


def _ref(problem):
    return ref_lm.BAProblem(**{f.name: getattr(problem, f.name)
                               for f in dataclasses.fields(ref_lm.BAProblem)})


def _assert_parity(problem, max_iterations=10, exact_fit=False):
    """Both packages' solves agree.  With `exact_fit` the problem has an
    exact solution, so the final costs are round-off (~1e-28) and are held
    against 1e-10 of the initial cost instead of each other's."""
    want = ref_lm.bundle_adjust(_ref(problem), max_iterations=max_iterations)
    got = port_lm.bundle_adjust(problem, max_iterations=max_iterations,
                                device="cpu")
    assert got.iterations == want.iterations
    assert abs(got.initial_cost - want.initial_cost) \
        <= COST_REL * want.initial_cost
    scale = want.initial_cost if exact_fit else want.final_cost
    assert abs(got.final_cost - want.final_cost) <= COST_REL * scale
    assert got.final_cost < 0.5 * got.initial_cost
    for name in ("inst", "rigcam", "cam", "points"):
        a, b = getattr(got, name), getattr(want, name)
        assert np.abs(a - b).max() <= STATE_REL * max(np.abs(b).max(), 1.0), \
            name
    return got


OTHER_TYPES = [t for t in sb.MODEL_PARAMS if t != "perspective"]
CASES = {t: dict(camera_types=t) for t in OTHER_TYPES}
CASES.update({
    "mixed3": dict(camera_types=["brown"] * 3 + ["fisheye_opencv"] * 3
                   + ["spherical"] * 2),
    "rig_fixed": dict(camera_types="perspective", rig_cameras=2),
    "rig_optimized": dict(camera_types="brown", rig_cameras=4,
                          optimize_rig=True),
    "depth_radial": dict(camera_types="perspective", depth="radial"),
    "depth_z": dict(camera_types="fisheye", depth="z"),
})


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_matches_reference(case):
    problem = sb.make_model_problem(8, 128, seed=1, track_window=4,
                                    **CASES[case])
    got = _assert_parity(problem)
    assert got.route == "generic"
    if "rig" in case:
        # A rig is not mono: the canonical (point, slot) layout.
        assert not port_lm.canonicalize_problem_dense(problem)[1]
    if case == "rig_optimized":
        assert np.abs(got.rigcam - problem.rigcam).max() > 1e-6


def _jnp_data(data):
    out = {}
    for k, v in data.items():
        out[k] = jnp.asarray(v.numpy())
        if v.dtype == torch.int32:
            out[k] = out[k].astype(jnp.int32)
    return out


def test_generic_residual_data_matches_reference():
    """Residuals r [O, 3], Jacobians Jc [O, 3, 12 + pmax] and Jp, and the
    robust cost, on a mixed (brown, fisheye_opencv) map of a 2-camera
    optimized rig with depth rows: one batched forward-mode push per
    segment against the reference's per-direction pushes."""
    p = sb.make_model_problem(
        8, 96, seed=3, track_window=4,
        camera_types=["brown"] * 4 + ["fisheye_opencv"] * 4, rig_cameras=2,
        optimize_rig=True, depth="radial")
    p.obs_depth_radial[::2] = False  # z rows too
    p.loss = "CauchyLoss"
    lp, dense, state, data = port_lm.device_problem(p, torch.float64,
                                                    torch.device("cpu"))
    st = port_lm.solver_statics(lp, dense)
    assert not dense and not st["canonical"]
    assert st["rig_jac"] and st["rig_transform"] and st["with_depth"]
    assert st["generic"]
    got = port_lm._residual_data(
        state, data, "CauchyLoss", 1.0, ptype=st["ptype"], pmax=st["pmax"],
        with_depth=True, rig_transform=True, rig_jac=True, generic=True)
    want = ref_lm._residual_data(
        tuple(jnp.asarray(x.numpy()) for x in state), _jnp_data(data),
        ptype=st["ptype"], loss="CauchyLoss", loss_threshold=1.0,
        pmax=st["pmax"], with_depth=True, rig_transform=True, rig_jac=True,
        canonical=False, dense=False)
    assert got[1].shape == (len(p.obs_uv), 3, 12 + st["pmax"])
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("kind", ["perspective", "brown", "rig", "depth"])
def test_route_rule(kind, monkeypatch):
    """Rows 1-5 run exactly where the JAX package takes its Pallas path
    (perspective, identity rig cameras, no depth rows, pmax 3): a generic
    problem reaches none of their wrappers, a mono perspective one reaches
    the residual/Jacobian and cost kernels' (their plain versions on the
    CPU)."""
    calls = []
    for name in ("fused_residual_jacobian", "fused_cost", "fused_cost_dense",
                 "fused_schur_assembly", "fused_back_substitute"):
        fn = getattr(port_lm, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(port_lm, name, counted)
    kw = {"perspective": dict(camera_types="perspective", rig_cameras=2),
          "brown": dict(camera_types="brown"),
          "rig": dict(camera_types="perspective", rig_cameras=2),
          "depth": dict(camera_types="perspective", depth="z")}[kind]
    problem = sb.make_model_problem(8, 128, seed=2, track_window=4, **kw)
    if kind == "perspective":
        # The same shots as one camera each: the rig taken apart.
        problem = sb.make_model_problem(8, 128, seed=2, track_window=4,
                                        camera_types="perspective")
        problem.cam = problem.cam[:, :3]
    res = port_lm.bundle_adjust(problem, max_iterations=3, device="cpu")
    if kind == "perspective":
        assert res.route == "fused_dense"
        assert {"fused_schur_assembly", "fused_cost_dense"} <= set(calls)
    else:
        assert res.route == "generic" and calls == []


def _fisheye_scene(T, cam_cls, pose_cls, pymap_mod):
    """tests/test_bundle.py:203's scene, built with one package's types."""
    rng = np.random.default_rng(4)
    rec = T.Reconstruction()
    cam = cam_cls.create_fisheye(0.6, -0.02, 0.003)
    cam.id = "fish"
    cam.width, cam.height = 800, 600
    rec.add_camera(cam)
    points = rng.uniform(-3, 3, (80, 3))
    for j in range(80):
        rec.create_point(str(j), points[j])
    for i in range(6):
        ang = 2 * np.pi * i / 6
        origin = np.array([8 * np.cos(ang), 8 * np.sin(ang), 0.0])
        z = -origin / np.linalg.norm(origin)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        pose = pose_cls()
        pose.set_rotation_matrix(np.stack([x, np.cross(z, x), z]))
        pose.set_origin(origin)
        shot = rec.create_shot(f"s{i}", "fish", pose)
        shot.metadata.gps_position.value = origin
        shot.metadata.gps_accuracy.value = 1.0
        uv = shot.project_many(points)
        for j in range(80):
            rec.add_observation(
                f"s{i}", str(j),
                pymap_mod.Observation(uv[j, 0], uv[j, 1], 0.004, 0, 0, 0, j))
    gt = copy.deepcopy(rec)
    for shot in rec.shots.values():  # tests/test_bundle.py's perturb
        inst = shot.rig_instance
        p = inst.pose
        inst.pose = pose_cls(p.rotation + rng.normal(0, 0.002, 3),
                             p.translation + rng.normal(0, 0.02, 3))
    for point in rec.points.values():
        point.coordinates = point.coordinates + rng.normal(0, 0.1, 3)
    return rec, gt


def test_bundle_fisheye_camera():
    """The fisheye bundle through `ba.problem.bundle` recovers the centres
    within 0.02 (the JAX package's bound), as the JAX package's does, and
    lands where it lands (states within 1e-6, the bundle command's
    parity tolerance)."""
    rec, gt = _fisheye_scene(types, Camera, Pose, pymap)
    ref_rec, _ = _fisheye_scene(ref_types, RefCamera, RefPose, ref_pymap)
    priors = {c: cam.copy() for c, cam in rec.cameras.items()}
    ref_priors = {c: cam.copy() for c, cam in ref_rec.cameras.items()}
    report = port_problem.bundle(rec, priors, {}, None,
                                 config.default_config(), device="cpu")
    ref_problem.bundle(ref_rec, ref_priors, {}, None,
                       ref_config.default_config())
    assert report["route"] == "generic"
    for sid in gt.shots:
        o = rec.shots[sid].pose.get_origin()
        assert np.linalg.norm(o - gt.shots[sid].pose.get_origin()) < 0.02
        np.testing.assert_allclose(
            o, ref_rec.shots[sid].pose.get_origin(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rec.cameras["fish"].parameters,
                               ref_rec.cameras["fish"].parameters, rtol=0,
                               atol=1e-6)


def _depth_base_problem():
    """tests/test_bundle_priors.py's one-camera problem with radial depth
    priors asking for a 2x larger scene."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(8, 3)) + np.array([0, 0, 5.0])
    O = len(pts)
    true_depths = np.linalg.norm(pts, axis=1)
    return port_lm.BAProblem(
        inst=np.zeros((1, 6)), rigcam=np.zeros((1, 6)),
        cam=np.array([[0.0, 0.0, 0.9]]), points=pts,
        obs_uv=0.9 * pts[:, :2] / pts[:, 2:3],
        obs_inv_sd=np.full(O, 1.0 / 0.004), obs_point=np.arange(O),
        obs_inst=np.zeros(O, dtype=int), obs_rigcam=np.zeros(O, dtype=int),
        obs_cam=np.zeros(O, dtype=int),
        point_obs=np.arange(O, dtype=np.int64)[:, None],
        gps_pos=np.zeros((1, 3)), gps_inv_sd=np.zeros(1),
        cam_prior=np.array([[0.0, 0.0, 0.9]]),
        cam_prior_inv_sd=np.zeros((1, 3)),
        cam_log_mask=np.zeros((1, 3), dtype=bool),
        rigcam_prior=np.zeros((1, 6)), rigcam_prior_inv_sd=np.zeros((1, 6)),
        point_prior=np.zeros((O, 3)), point_prior_inv_sd=np.zeros((O, 3)),
        opt_inst=np.array([False]), opt_rigcam=np.array([False]),
        opt_cam=np.zeros((1, 3), dtype=bool), opt_points=np.ones(O, bool),
        ptype="perspective", loss="TrivialLoss",
        obs_depth=2.0 * true_depths, obs_depth_inv_sd=np.full(O, 1.0 / 0.01),
        obs_depth_radial=np.ones(O, dtype=bool),
    ), true_depths


def test_depth_prior_scales_scene():
    problem, true_depths = _depth_base_problem()
    got = _assert_parity(problem, max_iterations=80, exact_fit=True)
    assert got.route == "generic"
    new_depths = np.linalg.norm(got.points, axis=1)
    assert np.allclose(new_depths / true_depths, 2.0, atol=0.05)
