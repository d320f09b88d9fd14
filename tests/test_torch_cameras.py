"""The port's batched torch projection (`cameras.project_torch`) against
the JAX package's `cameras.project(..., xp=jnp)` on all ten projection
types in f64: the values within 1e-12, and its forward-mode Jacobian with
respect to the point and the parameters (`torch.func.jacfwd`) against
`jax.jacfwd` within 1e-10, a point on the optical axis and the spherical
seam included.  Also `bearing(..., xp=torch)`, which the renderer casts
its rays with, against the numpy form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu.geometry import cameras as ref_cl
from opensfm_tpu_torch.geometry import cameras as cl


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes at once, and multi-threaded small ops then
    wait on each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(ptype, n=64, seed=0):
    """Camera-frame points in front of the camera (one on the optical
    axis, one at the spherical seam) and per-point parameters around
    MODEL_PARAMS."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3))
    X[:, 2] = rng.uniform(1.5, 4.0, n)
    X[0] = [0.0, 0.0, 2.0]
    X[1] = [1e-9, -2.0, -1.0]  # behind: lon = atan2(x, z) near pi
    P = np.tile(np.asarray(sb.MODEL_PARAMS[ptype], dtype=np.float64), (n, 1))
    P = P + rng.normal(0, 1e-3, P.shape)
    return X, P


@pytest.mark.parametrize("ptype", cl.PROJECTION_TYPES)
def test_project_torch_matches_reference(ptype):
    X, P = _inputs(ptype)
    want = np.asarray(ref_cl.project(ptype, jnp.asarray(X), jnp.asarray(P),
                                     xp=jnp))
    got = cl.project_torch(ptype, torch.tensor(X), torch.tensor(P)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ptype", cl.PROJECTION_TYPES)
def test_project_torch_jacobian_matches_jacfwd(ptype):
    X, P = _inputs(ptype, n=16, seed=1)

    def ref_one(x, p):
        return ref_cl.project(ptype, x, p, xp=jnp)

    want_x = np.asarray(jax.vmap(jax.jacfwd(ref_one, 0))(jnp.asarray(X),
                                                         jnp.asarray(P)))
    got_x = torch.func.vmap(torch.func.jacfwd(
        lambda x, p: cl.project_torch(ptype, x, p), 0))(
            torch.tensor(X), torch.tensor(P)).numpy()
    assert np.all(np.isfinite(got_x))
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-10)
    if P.shape[1] == 0:
        return
    want_p = np.asarray(jax.vmap(jax.jacfwd(ref_one, 1))(jnp.asarray(X),
                                                         jnp.asarray(P)))
    got_p = torch.func.vmap(torch.func.jacfwd(
        lambda x, p: cl.project_torch(ptype, x, p), 1))(
            torch.tensor(X), torch.tensor(P)).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-10)


@pytest.mark.parametrize("ptype", cl.PROJECTION_TYPES)
def test_bearing_torch_matches_numpy(ptype):
    X, P = _inputs(ptype, seed=2)
    X = X[2:]
    P = P[2:]
    uv = cl.project(ptype, X, P)
    want = cl.bearing(ptype, uv, P)
    got = cl.bearing(ptype, torch.tensor(uv), torch.tensor(P),
                     xp=torch).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        got, X / np.linalg.norm(X, axis=1, keepdims=True), rtol=0,
        atol=1e-9)
