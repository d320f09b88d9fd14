"""The port's top-2 search (`ops/kernels/top2`) against the JAX package's
Pallas kernel (interpret mode) and its jnp twins, on the CPU.

On uint8-valued descriptors every distance is an exact integer in float32,
so indices and distances must be equal; on float descriptors the distances
agree within 1e-4 of the row's sq1 + sq2 scale and the indices wherever the
best candidate leads the next by more than that.  The CUDA kernel itself is
held against the plain twin on the card by `chip_smoke.py`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opensfm_tpu.ops.matching import _top2_sqdist, _top2_sqdist_masked
from opensfm_tpu.ops.pallas_kernels.top2 import (
    TILE_M,
    TILE_N,
    top2_sqdist_pallas,
)
from opensfm_tpu_torch.ops.kernels import top2 as T

N, M, D = TILE_N, 2 * TILE_M, 128  # tests/test_pallas_kernels.py's shapes
N2 = M - 37


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(kind, seed=7, n=N, m=M, d=D):
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        d1 = rng.integers(0, 256, (n, d)).astype(np.float32)
        d2 = rng.integers(0, 256, (m, d)).astype(np.float32)
        # Near-duplicates, so the best candidates are decided by small gaps.
        k = min(n, m) // 2
        d2[:k] = np.clip(d1[:k] + rng.integers(-2, 3, (k, d)), 0, 255)
    else:
        d1 = rng.normal(size=(n, d)).astype(np.float32)
        d2 = rng.normal(size=(m, d)).astype(np.float32)
    mask = rng.random((n, m)) < 0.25
    return d1, d2, mask


def _port(d1, d2, n2, mask):
    idx, dist = T.top2_sqdist(torch.from_numpy(d1), torch.from_numpy(d2), n2,
                              None if mask is None else torch.from_numpy(mask))
    return idx.numpy(), dist.numpy()


def _pallas(d1, d2, n2, mask):
    idx, dist = top2_sqdist_pallas(
        jnp.asarray(d1), jnp.asarray(d2), n2,
        None if mask is None else jnp.asarray(mask.astype(np.float32)),
        interpret=True)
    return np.asarray(idx), np.asarray(dist)


def _twin(d1, d2, n2, mask):
    valid = jnp.asarray(np.arange(len(d2)) < n2)
    if mask is None:
        idx, dist = _top2_sqdist(jnp.asarray(d1), jnp.asarray(d2), valid)
    else:
        idx, dist = _top2_sqdist_masked(jnp.asarray(d1), jnp.asarray(d2),
                                        valid, jnp.asarray(mask))
    return np.asarray(idx)[:, :1], np.asarray(dist)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("reference", ["pallas", "jnp"])
def test_top2_uint8_exact(masked, reference):
    d1, d2, mask = _inputs("uint8")
    mask = mask if masked else None
    ref = (_pallas if reference == "pallas" else _twin)(d1, d2, N2, mask)
    got = _port(d1.astype(np.uint8), d2.astype(np.uint8), N2, mask)
    np.testing.assert_array_equal(got[1], ref[1])
    finite = np.isfinite(ref[1][:, 0])
    np.testing.assert_array_equal(got[0][finite], ref[0][finite])
    # Rows with no allowed candidate: +inf and column 0, like the Pallas
    # kernel (the jnp twin's top_k order there is its own).
    assert np.all(got[0][~finite] == 0)
    # The float32 path of the twin gives the same bits on these values.
    got_f = _port(d1, d2, N2, mask)
    np.testing.assert_array_equal(got_f[1], got[1])
    np.testing.assert_array_equal(got_f[0], got[0])


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_top2_float_within_tolerance(masked):
    d1, d2, mask = _inputs("float", seed=11)
    mask = mask if masked else None
    ref_i, ref_d = _pallas(d1, d2, N2, mask)
    got_i, got_d = _port(d1, d2, N2, mask)
    scale = (d1.astype(np.float64) ** 2).sum(1)[:, None] + \
        (d2[:N2].astype(np.float64) ** 2).sum(1).max()
    finite = np.isfinite(ref_d)
    np.testing.assert_array_equal(np.isfinite(got_d), finite)
    assert np.all(np.abs(got_d[finite] - ref_d[finite])
                  <= 1e-4 * np.broadcast_to(scale, ref_d.shape)[finite])
    # Indices agree wherever the best leads the second by more than that.
    clear = (ref_d[:, 1] - ref_d[:, 0]) > 1e-4 * scale[:, 0]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_i[clear], ref_i[clear])


def test_top2_ties_and_empty_rows():
    d2 = np.full((300, 128), 9, dtype=np.uint8)
    d2[200] = d2[250] = 0  # two columns tie for the best
    d1 = np.zeros((5, 128), dtype=np.uint8)
    mask = np.ones((5, 300), dtype=bool)
    mask[3] = False  # a row with no allowed column
    mask[4] = False
    mask[4, 250] = True  # a row with one allowed column
    idx, dist = _port(d1, d2, 300, mask)
    assert idx[:3, 0].tolist() == [200] * 3
    np.testing.assert_array_equal(dist[:3], 0.0)  # d2 == d1 on a tie
    assert idx[3, 0] == 0 and np.isinf(dist[3]).all()
    assert idx[4, 0] == 250 and dist[4, 0] == 0 and np.isinf(dist[4, 1])
    # The same through the Pallas kernel, padded to its tile shapes.
    p1 = np.zeros((TILE_N, 128), np.float32)
    p1[:5] = d1
    p2 = np.zeros((TILE_M, 128), np.float32)
    p2[:300] = d2
    pm = np.zeros((TILE_N, TILE_M), bool)
    pm[:5, :300] = mask
    ref_i, ref_d = _pallas(p1, p2, 300, pm)
    np.testing.assert_array_equal(idx, ref_i[:5])
    np.testing.assert_array_equal(dist, ref_d[:5])


@pytest.mark.parametrize("shape", [(5, 3, 128), (37, 1000, 129),
                                   (300, 129, 64)], ids=str)
def test_top2_ragged_sizes(shape):
    n, m, d = shape
    d1, d2, mask = _inputs("uint8", seed=n, n=n, m=m, d=d)
    for n2 in (m, m - 2):
        for msk in (None, mask):
            got_i, got_d = _port(d1.astype(np.uint8), d2.astype(np.uint8), n2,
                                 msk)
            ref_i, ref_d = _twin(d1, d2, n2, msk)
            np.testing.assert_array_equal(got_d, ref_d)
            finite = np.isfinite(ref_d[:, 0])
            np.testing.assert_array_equal(got_i[finite], ref_i[finite])


def test_split_columns_covers_the_columns():
    for n, n2 in [(8192, 8192), (128, 300), (5, 3), (100000, 64), (1, 0)]:
        splits, per = T.split_columns(n, n2)
        assert per % T.TILE_M == 0
        assert splits * per >= n2 and (splits - 1) * per < max(n2, 1)
    assert T.split_columns(8192, 8192) == (8, 1024)


@pytest.mark.parametrize("n,n2", [(8192, 8155), (8192, 129), (1000, 740),
                                  (7, 4099), (300, 1)], ids=str)
def test_split_columns_at_ragged_n2(n, n2):
    """Every column below n2 lies in exactly one slice of whole 128-column
    tiles, and no slice is empty (the last one holds the ragged tail)."""
    splits, per = T.split_columns(n, n2)
    starts = np.arange(splits) * per
    ends = np.minimum(starts + per, n2)
    assert per % T.TILE_M == 0 and np.all(ends > starts)
    cover = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
    np.testing.assert_array_equal(cover, np.arange(n2))


@pytest.mark.parametrize("kind,d,route", [
    ("uint8", 128, "u8"), ("uint8", 129, "u8"), ("uint8", 130, "f32"),
    ("uint8", 258, "f32"), ("uint8", 259, "f32"), ("float32", 128, "f32"),
    ("mixed", 128, "f32")])
def test_kernel_route(kind, d, route):
    """uint8 pairs of width <= U8_MAX_D (129, the widest OpenSfM feature
    type) take the tensor-core kernel, whose integer epilogue needs the
    norms' sum below 2^24; wider, float and mixed pairs the float32 one,
    which stays bitwise equal to the twin while D * 255^2 < 2^24."""
    assert 2 * T.U8_MAX_D * 255 ** 2 < 2 ** 24 <= 2 * (T.U8_MAX_D + 1) * 255 ** 2
    assert T.U8_BITWISE_MAX_D * 255 ** 2 < 2 ** 24 \
        <= (T.U8_BITWISE_MAX_D + 1) * 255 ** 2
    d1 = torch.zeros((3, d), dtype=torch.float32 if kind == "float32"
                     else torch.uint8)
    d2 = torch.zeros((5, d), dtype=torch.float32 if kind != "uint8"
                     else torch.uint8)
    assert T.kernel_route(d1, d2) == route


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_top2_uint8_bitwise_where_norm_sums_round(masked):
    """uint8 descriptors of width U8_BITWISE_MAX_D with norms near
    255^2 * 258: their float32 sum rounds above 2^24, but every product is
    exact, so the plain twin (what the float32 kernel is held to bitwise on
    the card) and the JAX package's jnp twin agree bitwise."""
    rng = np.random.default_rng(3)
    d = T.U8_BITWISE_MAX_D
    d1 = (255 - rng.integers(0, 4, (60, d))).astype(np.float32)
    d2 = np.concatenate([d1[:30] - 1, 255 - rng.integers(0, 4, (70, d))])
    d2 = d2.astype(np.float32)
    assert 2 * (d1 ** 2).sum(1).min() > 2 ** 24
    mask = (rng.random((60, 100)) < 0.5) if masked else None
    got_i, got_d = _port(d1.astype(np.uint8), d2.astype(np.uint8), 100, mask)
    ref_i, ref_d = _twin(d1, d2, 100, mask)
    np.testing.assert_array_equal(got_d, ref_d)
    finite = np.isfinite(ref_d[:, 0])
    np.testing.assert_array_equal(got_i[finite], ref_i[finite])


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_top2_uint8_wider_than_exact(masked):
    """uint8 descriptors of width 300 (the float32 kernel's route on the
    card): float32 sums may round, so the plain twin is held against the
    JAX package's jnp twin within 1e-6 of the row's sq1 + sq2 scale, and
    on indices where the best leads the second by more than that."""
    d1, d2, mask = _inputs("uint8", seed=5, n=64, m=300, d=300)
    d1, d2 = 160 + d1 % 96, 160 + d2 % 96  # large norms: sums above 2^24
    mask = mask if masked else None
    got_i, got_d = _port(d1.astype(np.uint8), d2.astype(np.uint8), 290, mask)
    ref_i, ref_d = _twin(d1, d2, 290, mask)
    scale = (d1.astype(np.float64) ** 2).sum(1)[:, None] + \
        (d2[:290].astype(np.float64) ** 2).sum(1).max()
    assert scale.max() > 2 ** 24  # the sums do round here
    finite = np.isfinite(ref_d)
    np.testing.assert_array_equal(np.isfinite(got_d), finite)
    assert np.all(np.abs(got_d[finite] - ref_d[finite])
                  <= 1e-6 * np.broadcast_to(scale, ref_d.shape)[finite])
    clear = (ref_d[:, 1] - ref_d[:, 0]) > 1e-6 * scale[:, 0]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_i[clear], ref_i[clear])


def test_cuda_tensor_never_takes_the_plain_path():
    """A tensor on a device other than the CPU goes to the kernel or
    raises; here a meta tensor stands for one the wrapper cannot serve."""
    a = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        T.top2_sqdist(a, a, 4)
