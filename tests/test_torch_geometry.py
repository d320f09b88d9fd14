"""The port's torch geometry (rotation, small linear algebra, perspective
projection, midpoint triangulation) against the JAX package in f64, and
the FeaturesData npz format shared by both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensfm_tpu.features import FeaturesData as RefFeaturesData
from opensfm_tpu.geometry import cameras as ref_cameras
from opensfm_tpu.geometry import rotation as ref_rot
from opensfm_tpu.geometry import triangulation as ref_tri
from opensfm_tpu.ops import linalg as ref_linalg
from opensfm_tpu_torch.features import FeaturesData
from opensfm_tpu_torch.geometry import cameras, rotation, triangulation
from opensfm_tpu_torch.ops import linalg

T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rotvecs(rng, n):
    r = rng.normal(size=(n, 3))
    r[0] = 0.0  # identity
    r[1] = 1e-9  # small-angle series
    r[2] *= 3.0  # near pi
    return r


def test_rotation_matches_reference():
    rng = np.random.default_rng(0)
    r, x = _rotvecs(rng, 20), rng.normal(size=(20, 3))
    np.testing.assert_allclose(rotation.rotate(T(r), T(x)).numpy(),
                               np.asarray(ref_rot.rotate(r, x)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rotation.rotvec_to_matrix(T(r)).numpy(),
                               np.asarray(ref_rot.rotvec_to_matrix(r)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rotation.hat(T(x)).numpy(),
                               np.asarray(ref_rot.hat(x)), rtol=0, atol=0)
    want = jax.vmap(jax.jacfwd(ref_rot.rotate, argnums=0))(r, x)
    np.testing.assert_allclose(rotation.rotate_jacobian(T(r), T(x)).numpy(),
                               np.asarray(want), rtol=1e-10, atol=1e-12)


def test_linalg_matches_reference():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(5, 7, 7))
    A = M @ M.transpose(0, 2, 1) + 7.0 * np.eye(7)
    b = rng.normal(size=(5, 7))
    np.testing.assert_allclose(linalg.solve_spd(T(A), T(b)).numpy(),
                               np.asarray(ref_linalg.solve_spd(A, b)),
                               rtol=1e-10, atol=1e-12)
    B = rng.normal(size=(6, 3, 3)) + 3.0 * np.eye(3)
    c = rng.normal(size=(6, 3))
    np.testing.assert_allclose(linalg.inv3(T(B)).numpy(),
                               np.asarray(ref_linalg.inv3(B)), rtol=1e-12)
    np.testing.assert_allclose(linalg.solve3(T(B), T(c)).numpy(),
                               np.asarray(ref_linalg.solve3(B, c)),
                               rtol=1e-12)
    # Not positive definite: NaN, as the reference's Cholesky gives.
    bad = linalg.solve_spd(T(-A[0]), T(b[0]))
    assert bool(torch.isnan(bad).all())


def test_project_torch_matches_numpy_and_rejects_other_types():
    """Perspective and fisheye (every type since the generic BA route;
    tests/test_torch_cameras.py holds all ten) match the numpy form; a type
    outside the ten is rejected."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(30, 3)) + np.array([0.0, 0.0, 6.0])
    params = np.array([-0.05, 0.002, 0.85])
    for ptype in ("perspective", "fisheye"):
        np.testing.assert_allclose(
            cameras.project_torch(ptype, T(X), T(params)).numpy(),
            ref_cameras.project(ptype, X, params, xp=np),
            rtol=1e-13, atol=0)
    with pytest.raises(ValueError):
        cameras.project_torch("orthographic", T(X), T(params))


def test_triangulate_midpoint_matches_reference():
    rng = np.random.default_rng(3)
    X = np.array([0.3, -0.2, 5.0])
    centers = rng.normal(size=(5, 3))
    bearings = X - centers + rng.normal(0, 1e-3, (5, 3))
    bearings /= np.linalg.norm(bearings, axis=1, keepdims=True)
    mask = np.array([True, True, True, False, True])
    thr = np.full(5, 0.01)
    for min_angle in (np.radians(1.0), np.radians(60.0)):
        ok_r, X_r = ref_tri.triangulate_bearings_midpoint(
            jnp.asarray(centers), jnp.asarray(bearings), jnp.asarray(mask),
            jnp.asarray(thr), min_angle=min_angle)
        ok_p, X_p = triangulation.triangulate_bearings_midpoint(
            T(centers), T(bearings), T(mask), T(thr), min_angle=min_angle)
        assert bool(ok_p) == bool(ok_r)
        np.testing.assert_allclose(X_p.numpy(), np.asarray(X_r), rtol=1e-10)


def test_features_npz_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    points = rng.random((50, 4))
    desc = rng.random((50, 128)).astype(np.float32)
    colors = rng.integers(0, 255, (50, 3))
    config = {"feature_type": "SIFT"}
    FeaturesData(points, desc, colors).save(str(tmp_path / "p.npz"), config)
    RefFeaturesData(points, desc, colors).save(str(tmp_path / "r.npz"), config)
    for path in ("p.npz", "r.npz"):
        a = FeaturesData.from_file(str(tmp_path / path), config)
        b = RefFeaturesData.from_file(str(tmp_path / path), config)
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.descriptors, b.descriptors)
        np.testing.assert_array_equal(a.colors, b.colors)
        np.testing.assert_allclose(a.points, points.astype(np.float32))
