"""The port's growth-loop geometry and RANSAC against the JAX package on the
CPU, in f64: rotations, P3P and the absolute-pose polish, point-set
registration, the relative-pose functions, triangulation, the multiview
helpers, and every RANSAC family of the growth loop with the JAX package's
random draws injected (tolerances: 1e-9 relative on well-conditioned
outputs; the inlier sets exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensfm_tpu import io as ref_io
from opensfm_tpu import multiview as ref_mv
from opensfm_tpu import pymap as ref_pymap
from opensfm_tpu.geometry import absolute_pose as ref_ap
from opensfm_tpu.geometry import cameras as ref_cameras
from opensfm_tpu.geometry import essential as ref_ess
from opensfm_tpu.geometry import rotation as ref_rot
from opensfm_tpu.geometry import transform as ref_tf
from opensfm_tpu.geometry import triangulation as ref_tri
from opensfm_tpu.geometry.pose import Pose as RefPose
from opensfm_tpu.robust import ransac as ref_ransac
from opensfm_tpu_torch import io, multiview, pymap
from opensfm_tpu_torch.geometry import absolute_pose as ap
from opensfm_tpu_torch.geometry import cameras
from opensfm_tpu_torch.geometry import essential as ess
from opensfm_tpu_torch.geometry import rotation as rot
from opensfm_tpu_torch.geometry import transform as tf
from opensfm_tpu_torch.geometry import triangulation as tri
from opensfm_tpu_torch.geometry.pose import Pose
from opensfm_tpu_torch.robust import ransac

CPU = torch.device("cpu")
REL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes at once, and multi-threaded small ops then
    wait on each other's cores (tens of times slower); one thread is within
    2x of eight when the module runs alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def jax_samples(n, iterations, s, seed=42, n_pad=None, k_chunk=None):
    """The JAX package's draws for a RANSAC run over n rows padded to n_pad
    (the single-problem padding by default), chunk by chunk, in the port's
    injected layout [n_chunks * k_chunk, s]."""
    n_pad = n_pad or max(64, 1 << int(n - 1).bit_length())
    p = np.zeros(n_pad)
    p[:n] = 1.0 / n
    k = max(iterations, 64)
    k_chunk = k_chunk or min(k, ransac.CHUNK)
    return np.concatenate([
        np.asarray(ref_ransac._sample_indices(
            jax.random.PRNGKey(seed + ci * 7919), n_pad, k_chunk, s, J(p)))
        for ci in range(-(-k // k_chunk))])


def rotation(v):
    return np.asarray(ref_rot.rotvec_to_matrix(J(v)))


@pytest.fixture(scope="module")
def scene():
    """150 points in front of two cameras; 30 % of the second camera's
    bearings replaced by random directions."""
    rng = np.random.default_rng(1)
    n = 150
    X = rng.normal(size=(n, 3)) * 2 + [0, 0, 8]
    R = rotation([0.05, -0.1, 0.02])
    t = np.array([1.0, 0.1, 0.05])
    b1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    X2 = X @ R.T + t
    b2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True)
    out = rng.random(n) < 0.3
    b2[out] = rng.normal(size=(out.sum(), 3))
    b2 += rng.normal(size=b2.shape) * 2e-4
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    return dict(rng=rng, n=n, X=X, R=R, t=t, b1=b1, b2=b2, out=out)


def assert_same(ref, ours, tol=REL):
    assert ours.model is not None
    assert np.array_equal(ours.inliers_indices, ref.inliers_indices)
    assert rel(ours.model, ref.model) < tol


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def test_rotation_conversions_match_reference():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=(6, 3)), [[0, 0, 0], [np.pi - 1e-3,
                                                              0, 0]]])
    R = np.asarray(ref_rot.rotvec_to_matrix(J(v)))
    assert rel(rot.matrix_to_rotvec(T(R)), ref_rot.matrix_to_rotvec(J(R))) < REL
    assert rel(rot.matrix_to_quat(T(R)), ref_rot.matrix_to_quat(J(R))) < REL


def test_p3p_and_absolute_pose_match_reference(scene):
    rng = np.random.default_rng(2)
    Rt = np.concatenate([scene["R"], [[0.1], [0.2], [8.0]]], axis=1)
    P = rng.normal(size=(4, 3, 3)) * 3
    pc = P @ Rt[:, :3].T + Rt[:, 3]
    b = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    ours, valid = ap.p3p(T(b), T(P))  # batched over 4 samples
    for k in range(4):
        ref, ref_valid = ref_ap.p3p(J(b[k]), J(P[k]))
        assert np.array_equal(valid[k].numpy(), np.asarray(ref_valid))
        v = np.asarray(ref_valid)
        assert rel(ours[k].numpy()[v], np.asarray(ref)[v]) < REL
    N = 60
    P = rng.normal(size=(N, 3)) * 3
    pc = P @ Rt[:, :3].T + Rt[:, 3]
    b = pc / np.linalg.norm(pc, axis=1, keepdims=True) \
        + rng.normal(size=(N, 3)) * 1e-3
    mask = rng.random(N) > 0.2
    Rt1 = Rt + np.concatenate([np.zeros((3, 3)), [[0.05], [-0.02], [0.1]]], 1)
    assert rel(ap.absolute_pose_gn_refine(T(Rt1), T(b), T(P), mask=T(mask)),
               ref_ap.absolute_pose_gn_refine(J(Rt1), J(b), J(P),
                                              mask=J(mask))) < REL
    assert np.abs(ap.absolute_pose_error(T(Rt1), T(b), T(P)).numpy()
                  - np.asarray(ref_ap.absolute_pose_error(
                      J(Rt1), J(b), J(P)))).max() < 1e-14
    for fn in ("absolute_pose_known_rotation_n_points",
               "translation_between_points"):
        assert rel(getattr(ap, fn)(T(b), T(P), T(Rt[:, :3]), mask=T(mask)),
                   getattr(ref_ap, fn)(J(b), J(P), J(Rt[:, :3]),
                                       mask=J(mask))) < REL


def test_point_set_registration_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, 3))
    y = 1.7 * x @ rotation([0.3, -0.2, 0.9]).T + 2.0 \
        + rng.normal(size=x.shape) * 0.01
    mask = rng.random((2, 20)) > 0.3
    for fn in ("rotation_between_points", "similarity_between_points"):
        assert rel(getattr(tf, fn)(T(x), T(y), T(mask)),
                   getattr(ref_tf, fn)(J(x), J(y), J(mask))) < REL
        assert rel(getattr(tf, fn)(T(x[0]), T(y[0])),
                   getattr(ref_tf, fn)(J(x[0]), J(y[0]))) < REL


def test_relative_pose_functions_match_reference(scene):
    b1, R, t = scene["b1"], scene["R"], scene["t"]
    X2 = scene["X"] @ R.T + t
    b2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True)
    E = ess.essential_from_pose(T(R), T(t))
    assert rel(E, ref_ess.essential_from_pose(J(R), J(t))) < REL
    Rs, ts = ess.decompose_essential(E)
    ref_Rs, ref_ts = ref_ess.decompose_essential(J(E.numpy()))
    # The four candidates as a set (the SVD of E is not unique).
    for k in range(4):
        assert min(rel(np.concatenate([Rs[k], ts[k, :, None]], 1),
                       np.concatenate([ref_Rs[j], ref_ts[j, :, None]], 1))
                   for j in range(4)) < REL
    Rt = ess.relative_pose_from_essential(E, T(b1), T(b2))
    ref_Rt = ref_ess.relative_pose_from_essential(J(E.numpy()), J(b1), J(b2))
    assert rel(Rt, ref_Rt) < REL
    err = ess.relative_pose_error(Rt, T(scene["b1"]), T(scene["b2"])).numpy()
    ref_err = np.asarray(ref_ess.relative_pose_error(
        ref_Rt, J(scene["b1"]), J(scene["b2"])))
    assert np.abs(err - ref_err).max() < 1e-12
    mask = ~scene["out"]
    Rt0 = np.asarray(ref_Rt) + 0.02
    ours = ess.refine_relative_pose(T(Rt0), T(scene["b1"]), T(scene["b2"]),
                                    mask=T(mask), iterations=20)
    ref = ref_ess.refine_relative_pose(J(Rt0), J(scene["b1"]),
                                       J(scene["b2"]), mask=J(mask),
                                       iterations=20)
    assert rel(ours, ref) < REL


def test_triangulation_matches_reference():
    rng = np.random.default_rng(4)
    K = 5
    o = rng.normal(size=(7, K, 3)) * 3
    X = rng.normal(size=(7, 3))
    b = X[:, None] - o
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    b += rng.normal(size=b.shape) * 1e-3
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    m = rng.random((7, K)) > 0.3
    th = np.full((7, K), 0.01)
    ref_ok, ref_X = jax.vmap(lambda a, c, d, e: ref_tri.triangulate_bearings_midpoint(
        a, c, d, e, 0.01, 1e-3))(J(o), J(b), J(m), J(th))
    ok, Xm = tri.triangulate_bearings_midpoint(T(o), T(b), T(m), T(th), 0.01,
                                               1e-3)
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert rel(Xm, ref_X) < REL
    ref_Xr = jax.vmap(lambda a, c, x, d: ref_tri.point_refinement(
        a, c, x, d, 10))(J(o), J(b), ref_X, J(m))
    assert rel(tri.point_refinement(T(o), T(b), Xm, T(m), 10), ref_Xr) < REL

    Rts = np.stack([np.concatenate([rotation(rng.normal(size=3) * 0.1),
                                    rng.normal(size=(3, 1))], 1)
                    for _ in range(K)])
    Xw = rng.normal(size=3) + [0, 0, 5.0]
    pc = np.einsum("kij,j->ki", Rts, np.append(Xw, 1))
    bc = pc / np.linalg.norm(pc, axis=1, keepdims=True)
    ones = np.ones(K, bool)
    ref_ok, ref_X = ref_tri.triangulate_bearings_dlt(J(Rts), J(bc), J(ones),
                                                     0.01, 0.01)
    ok, Xd = tri.triangulate_bearings_dlt(T(Rts), T(bc), T(ones), 0.01, 0.01)
    assert bool(ok) == bool(ref_ok) and rel(Xd, ref_X) < REL

    b1 = rng.normal(size=(30, 3)) + [0, 0, 6]
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2 = rng.normal(size=(20, 3)) + [0, 0, 6]
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    R, t = rotation([0.1, 0.2, -0.1]), np.array([1.0, 0.3, 0.2])
    assert rel(tri.epipolar_angle_two_bearings_many(T(b1), T(b2), T(R), T(t)),
               ref_tri.epipolar_angle_two_bearings_many(J(b1), J(b2), J(R),
                                                        J(t))) < REL
    ok, X2 = tri.triangulate_two_bearings_midpoint(T(b1[:20]), T(b2), T(R),
                                                   T(t))
    ref_ok, ref_X2 = ref_tri.triangulate_two_bearings_midpoint(
        J(b1[:20]), J(b2), J(R), J(t))
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert rel(X2, ref_X2) < REL


def test_multiview_helpers_match_reference():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(30, 3)) * [5, 5, 0.1]
    vecs = rng.normal(size=(4, 3)) * [1, 1, 0.01]
    verts = [np.array([0, 0, 1.0])]
    p = multiview.fit_plane(pts, vecs, verts)
    assert rel(p, ref_mv.fit_plane(pts, vecs, verts)) < REL
    assert rel(multiview.plane_horizontalling_rotation(p),
               ref_mv.plane_horizontalling_rotation(p)) < REL
    H = np.array([[1.1, 0.1, 0.2], [-0.05, 0.9, 0.1], [0.01, 0.02, 1.0]])
    ours, ref = multiview.motion_from_plane_homography(H), \
        ref_mv.motion_from_plane_homography(H)
    assert len(ours) == len(ref) == 8
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            assert rel(x, y) < REL
    Tm = np.eye(4)
    Tm[:3, :3] = 2.0 * rotation([0.1, 0.2, 0.3])
    Tm[:3, 3] = [1, 2, 3]
    for x, y in zip(multiview.decompose_similarity_transform(Tm),
                    ref_mv.decompose_similarity_transform(Tm)):
        assert rel(x, y) < REL
    assert multiview.focal_from_homography(H) == pytest.approx(
        ref_mv.focal_from_homography(H), rel=REL)
    assert rel(multiview.R_from_homography(H, 0.9, 1.1),
               ref_mv.R_from_homography(H, 0.9, 1.1)) < REL


def test_triangulate_gcp_matches_reference():
    """A GCP seen from three shots of a circle, through both packages'
    shot objects."""
    cams, ref_cams = cameras.Camera.create_perspective(0.9, -0.05, 0.01), \
        ref_cameras.Camera.create_perspective(0.9, -0.05, 0.01)
    shots, ref_shots = {}, {}
    gcp = io.GroundControlPoint()
    ref_gcp = ref_io.GroundControlPoint()
    X = np.array([0.2, -0.3, 0.5])
    for i in range(3):
        ang = 0.4 * i
        origin = np.array([10 * np.cos(ang), 10 * np.sin(ang), 0.0])
        z = -origin / np.linalg.norm(origin)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        pose, ref_pose = Pose(), RefPose()
        for p in (pose, ref_pose):
            p.set_rotation_matrix(R)
            p.set_origin(origin)
        sid = f"s{i}"
        shots[sid] = pymap.Shot(sid, cams, pose)
        ref_shots[sid] = ref_pymap.Shot(sid, ref_cams, ref_pose)
        uv = cams.project(R @ (X - origin)) + 1e-4 * i
        for g, mod in ((gcp, io), (ref_gcp, ref_io)):
            o = mod.GroundControlPointObservation()
            o.shot_id, o.projection = sid, uv
            g.observations.append(o)
    ours = multiview.triangulate_gcp(gcp, shots, device=CPU)
    ref = ref_mv.triangulate_gcp(ref_gcp, ref_shots)
    assert ours is not None and rel(ours, ref) < REL
    assert multiview.triangulate_gcp(gcp, {"s0": shots["s0"]},
                                     device=CPU) is None


# ---------------------------------------------------------------------------
# RANSAC families under the JAX package's draws
# ---------------------------------------------------------------------------


def test_draw_subsets_are_distinct_and_in_range():
    counts = np.array([3, 5, 64, 1000])
    ranks = ransac.draw_subsets(7, 1, counts, 500, 3)
    assert ranks.shape == (4, 500, 3)
    for b, n in enumerate(counts):
        assert ranks[b].min() >= 0 and ranks[b].max() < n
        assert all(len(set(r)) == 3 for r in ranks[b].tolist())
    assert np.array_equal(ranks, ransac.draw_subsets(7, 1, counts, 500, 3))
    # Every 3-subset of 3 rows draws the rows in all orders.
    assert {tuple(r) for r in ranks[0].tolist()} == {
        (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)}


def test_ransac_relative_pose_matches_reference(scene):
    n = scene["n"]
    ref = ref_ransac.ransac_relative_pose(scene["b1"], scene["b2"], 0.004,
                                          200)
    ours = ransac.ransac_relative_pose(scene["b1"], scene["b2"], 0.004, 200,
                                       device=CPU,
                                       samples=jax_samples(n, 200, 5))
    assert_same(ref, ours)
    assert ours.num_inliers > 90


def test_ransac_relative_rotation_matches_reference(scene):
    rng = np.random.default_rng(6)
    b1 = scene["b1"]
    b2 = b1 @ scene["R"].T + rng.normal(size=b1.shape) * 1e-4
    b2[scene["out"]] = scene["b2"][scene["out"]]
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    n = scene["n"]
    ref = ref_ransac.ransac_relative_rotation(b1, b2, 0.004, 1000)
    ours = ransac.ransac_relative_rotation(b1, b2, 0.004, 1000, device=CPU,
                                           samples=jax_samples(n, 1000, 3))
    assert_same(ref, ours)
    assert ours.num_inliers > 90
    # The batched form gives each pair the single-problem result under the
    # same draws, whatever the other pairs' sizes.
    sizes = [150, 70, 20]
    samples = np.stack([jax_samples(s, 1000, 3, n_pad=256) for s in sizes])
    batched = ransac.ransac_relative_rotation_batched(
        [b1[:s] for s in sizes], [b2[:s] for s in sizes], 0.004, 1000,
        device=CPU, samples=samples)
    for s, samp, res in zip(sizes, samples, batched):
        ref = ref_ransac.ransac_relative_rotation(b1[:s], b2[:s], 0.004, 1000)
        if s == 150:
            assert_same(ref, res)
        single = ransac.ransac_relative_rotation(b1[:s], b2[:s], 0.004, 1000,
                                                 device=CPU, samples=samp)
        assert_same(single, res, tol=1e-12)


def test_ransac_absolute_pose_matches_reference(scene):
    n = scene["n"]
    ref = ref_ransac.ransac_absolute_pose(scene["b2"], scene["X"], 0.004, 1000)
    ours = ransac.ransac_absolute_pose(scene["b2"], scene["X"], 0.004, 1000,
                                       device=CPU,
                                       samples=jax_samples(n, 1000, 3))
    assert_same(ref, ours)
    assert ours.num_inliers > 90


def test_ransac_absolute_pose_batched_matches_reference(scene):
    """B = 3 candidates of different sizes in one batched run, the JAX
    package's batched draws injected (its common padding, one chunk)."""
    sizes = [150, 90, 40]
    bl = [scene["b2"][:s] for s in sizes]
    xl = [scene["X"][:s] for s in sizes]
    ref = ref_ransac.ransac_absolute_pose_batched(bl, xl, 0.004, 500)
    samples = np.stack([jax_samples(s, 500, 3, n_pad=256, k_chunk=500)
                        for s in sizes])
    ours = ransac.ransac_absolute_pose_batched(bl, xl, 0.004, 500,
                                               device=CPU, samples=samples)
    for r, o in zip(ref, ours):
        assert_same(r, o)
    # Too few correspondences: an empty result, as in the reference.
    few = ransac.ransac_absolute_pose_batched([bl[0][:2]], [xl[0][:2]], 0.004,
                                              100, device=CPU)
    assert few[0].model is None


def test_batched_ransac_runs_one_core_call_per_chunk(scene, monkeypatch):
    """The launches of a batched round do not grow with B: the core runs
    once per chunk of hypotheses for all candidates."""
    calls = []
    core = ransac._abspose_core

    def counting(*args):
        calls.append(args[0].shape[0])
        return core(*args)

    monkeypatch.setattr(ransac, "_abspose_core", counting)
    for B in (1, 8):
        calls.clear()
        ransac.ransac_absolute_pose_batched(
            [scene["b2"][:30]] * B, [scene["X"][:30]] * B, 0.004, 1000,
            device=CPU)
        assert calls == [B, B]  # two chunks of 512, all B at once


def test_ransac_known_rotation_matches_reference(scene):
    b = scene["X"] + scene["t"]
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    b[scene["out"]] = scene["b2"][scene["out"]]
    n = scene["n"]
    ref = ref_ransac.ransac_absolute_pose_known_rotation(
        b, scene["X"], np.eye(3), 0.004, 1000)
    ours = ransac.ransac_absolute_pose_known_rotation(
        b, scene["X"], np.eye(3), 0.004, 1000, device=CPU,
        samples=jax_samples(n, 1000, 2))
    assert_same(ref, ours)
    assert rel(multiview.absolute_pose_known_rotation_ransac(
        b, scene["X"], 0.004, 1000, device=CPU,
        samples=jax_samples(n, 1000, 2)),
        ref_mv.absolute_pose_known_rotation_ransac(b, scene["X"], 0.004,
                                                   1000)) < REL


def test_ransac_similarity_matches_reference(scene):
    rng = np.random.default_rng(7)
    X = scene["X"]
    Y = 1.5 * X @ scene["R"].T + scene["t"]
    Y[scene["out"]] += rng.normal(size=(scene["out"].sum(), 3))
    Y += rng.normal(size=Y.shape) * 0.01
    n = scene["n"]
    ref = ref_ransac.ransac_similarity(X, Y, 0.05, 1000)
    ours = ransac.ransac_similarity(X, Y, 0.05, 1000, device=CPU,
                                    samples=jax_samples(n, 1000, 3))
    assert_same(ref, ours)
    Tm, inl = multiview.fit_similarity_transform(
        X, Y, 1000, 0.05, device=CPU, samples=jax_samples(n, 1000, 3))
    ref_T, ref_inl = ref_mv.fit_similarity_transform(X, Y, 1000, 0.05)
    assert np.array_equal(inl, ref_inl) and rel(Tm, ref_T) < REL


def test_ransac_homography_matches_reference(scene):
    rng = np.random.default_rng(8)
    n = scene["n"]
    x1 = rng.normal(size=(n, 2))
    H = np.array([[1.1, 0.1, 0.2], [-0.05, 0.9, 0.1], [0.01, 0.02, 1.0]])
    x2h = np.c_[x1, np.ones(n)] @ H.T
    x2 = x2h[:, :2] / x2h[:, 2:]
    x2[scene["out"]] = rng.normal(size=(scene["out"].sum(), 2))
    x2 += rng.normal(size=x2.shape) * 1e-3
    ref = ref_ransac.ransac_homography(x1, x2, 0.01, 1000)
    ours = ransac.ransac_homography(x1, x2, 0.01, 1000, device=CPU,
                                    samples=jax_samples(n, 1000, 4))
    assert_same(ref, ours)
    assert ours.num_inliers > 90


def test_multiview_pose_wrappers_match_reference(scene):
    """The wrappers at 200 iterations (one chunk).  The nonlinear refinement
    runs on the inliers, as the growth loop runs it: with the outliers in,
    pairs at |y . E x| near 1 make the geodesic's Jacobian ill-conditioned
    and the two packages part at ~1e-8."""
    n = scene["n"]
    b1, b2 = scene["b1"], scene["b2"]
    Rt = multiview.relative_pose_ransac(b1, b2, 0.004, 200, device=CPU,
                                        samples=jax_samples(n, 200, 5))
    ref_Rt = ref_mv.relative_pose_ransac(b1, b2, 0.004, 200)
    assert rel(Rt, ref_Rt) < REL
    assert np.array_equal(
        multiview.relative_pose_inliers(Rt, b1, b2, 0.004, device=CPU),
        ref_mv.relative_pose_inliers(np.asarray(ref_Rt), b1, b2, 0.004))
    R, t = Rt[:, :3], Rt[:, 3]
    inl = ~scene["out"]
    assert rel(multiview.relative_pose_optimize_nonlinear(
        b1[inl], b2[inl], t, R, 10, device=CPU),
        ref_mv.relative_pose_optimize_nonlinear(b1[inl], b2[inl], t, R,
                                                10)) < REL
    Tp = multiview.absolute_pose_ransac(b2, scene["X"], 0.004, 200,
                                        device=CPU,
                                        samples=jax_samples(n, 200, 3))
    assert rel(Tp, ref_mv.absolute_pose_ransac(b2, scene["X"], 0.004,
                                               200)) < REL


def test_ransac_without_device_needs_cuda(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ransac.ransac_absolute_pose(scene["b2"], scene["X"], 0.004, 100)
