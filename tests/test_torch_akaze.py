"""The port's AKAZE (`opensfm_tpu_torch.ops.akaze`) against the JAX
package's (`opensfm_tpu.ops.akaze`) on the CPU.

The same 256 x 256 image of blobs and noise (seeded numpy) goes through
both `extract_akaze_features` with the M-SURF, M-SURF upright and M-LDB
descriptors (400 features asked).  Measured here: the same keypoint count
(159 of 159) and every keypoint within 4.6e-5 px of a JAX one at the same
scale; angles within 3.2e-4 degrees; M-SURF descriptors within 3.1e-6,
M-LDB bits all equal.  Held: at least 99 % of the keypoints matched within
1e-3 px at the same scale, the counts within 1 %, angles within 0.01
degrees on matched keypoints, M-SURF descriptors within 1e-4 and M-LDB bits
equal on at least 99.5 % of them.  The contrast factor `k` is held to a
relative 1e-6 and to the same histogram bin: on this image the two
packages' `k` differ by 2 f32 ulps (their largest gradient magnitudes, by
which the bin is scaled, round differently), in the same bin, and every
keypoint still pairs up.  The JAX
package (x64 in the tests) runs the orientation histogram in f64 where the
port keeps f32, and XLA's CPU convolutions round their sums in another
order than oneDNN's: the positions move by 1e-5 px, not the detections.

`tests/test_akaze.py`'s own checks (detections on a 300 x 400 image, unit
M-SURF norms, 486 binary M-LDB bits, zero upright angles, translation
repeatability) run on the port's function too.
"""

import numpy as np
import pytest
import torch

from opensfm_tpu.ops import akaze as ref_akaze
from opensfm_tpu_torch.ops import akaze

MATCHED_SHARE = 0.99
POS_TOL = 1e-3  # px
ANGLE_TOL = 0.01  # degrees
MSURF_TOL = 1e-4
MLDB_EQUAL_SHARE = 0.995


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _blobs(h, w, seed, n):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), dtype=np.float32)
    for _ in range(n):
        cy = rng.integers(20, h - 20)
        cx = rng.integers(20, w - 20)
        r = int(rng.integers(4, 14))
        y, x = np.ogrid[-r:r + 1, -r:r + 1]
        blob = (y * y + x * x <= r * r).astype(np.float32)
        img[cy - r:cy + r + 1, cx - r:cx + r + 1] += blob * rng.uniform(0.3,
                                                                        1.0)
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    return np.clip(img, 0, 1) * 255


@pytest.fixture(scope="module")
def parity_image():
    return _blobs(256, 256, 7, 50)


@pytest.fixture(scope="module")
def test_image():
    """tests/test_akaze.py's image (300 x 400, 60 blobs)."""
    rng = np.random.default_rng(7)
    img = np.zeros((300, 400), dtype=np.float32)
    for _ in range(60):
        cy = rng.integers(30, 270)
        cx = rng.integers(30, 370)
        r = int(rng.integers(4, 14))
        y, x = np.ogrid[-r:r + 1, -r:r + 1]
        blob = (y * y + x * x <= r * r).astype(np.float32)
        img[cy - r:cy + r + 1, cx - r:cx + r + 1] += blob * rng.uniform(0.3,
                                                                        1.0)
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    return np.clip(img, 0, 1) * 255


def test_kcontrast_equals_the_jax_package(parity_image):
    import jax.numpy as jnp

    img = parity_image / 255.0
    want = float(ref_akaze._kcontrast(jnp.asarray(img), 0.7))
    got = float(akaze._kcontrast(torch.as_tensor(img), 0.7))
    assert abs(got - want) <= 1e-6 * want
    # The same histogram bin: k = (bin + 0.5) / 300 * the largest magnitude.
    smooth = akaze._sep_blur(torch.as_tensor(img),
                             akaze._gaussian_kernel(1.0))
    hmax = float(torch.hypot(akaze._scharr(smooth, 1),
                             akaze._scharr(smooth, 0)).max())
    bins = [round(k / hmax * akaze.KCONTRAST_NBINS - 0.5) for k in (want, got)]
    assert bins[0] == bins[1]


@pytest.mark.parametrize("descriptor", ["MSURF", "MSURF_UPRIGHT", "MLDB"])
def test_akaze_equals_the_jax_package(parity_image, descriptor):
    config = {"akaze_descriptor": descriptor}
    pj, dj = ref_akaze.extract_akaze_features(parity_image, config, 400)
    pt, dt = akaze.extract_akaze_features(parity_image, config, 400,
                                          device="cpu")
    assert len(pj) > 100
    assert abs(len(pt) - len(pj)) <= 0.01 * len(pj)
    assert dt.shape[1] == dj.shape[1] == (486 if descriptor == "MLDB" else 64)
    # Pair each JAX keypoint with the nearest port keypoint of its scale.
    dist = np.linalg.norm(pj[:, None, :2] - pt[None, :, :2], axis=2)
    dist[np.abs(pj[:, None, 2] - pt[None, :, 2]) > 1e-6] = np.inf
    nn = dist.argmin(1)
    near = dist[np.arange(len(pj)), nn] <= POS_TOL
    assert near.mean() >= MATCHED_SHARE
    angle = np.abs(pj[near, 3] - pt[nn[near], 3])
    assert np.minimum(angle, 360 - angle).max() <= ANGLE_TOL
    if descriptor == "MLDB":
        assert set(np.unique(dt)) <= {0.0, 1.0}
        assert (dj[near] == dt[nn[near]]).mean() >= MLDB_EQUAL_SHARE
    else:
        assert np.abs(dj[near] - dt[nn[near]]).max() <= MSURF_TOL


def test_fed_schedule_equals_the_jax_package():
    for T in (0.0, 0.3, 1.28, 2.56, 7.7):
        np.testing.assert_array_equal(akaze._fed_tau_schedule(T),
                                      ref_akaze._fed_tau_schedule(T))
    np.testing.assert_array_equal(akaze._MSURF_W, ref_akaze._MSURF_W)
    np.testing.assert_array_equal(akaze._MLDB_ASSIGN, ref_akaze._MLDB_ASSIGN)
    assert akaze._MLDB_PAIRS == ref_akaze._MLDB_PAIRS


# tests/test_akaze.py's checks, on the port's function.

def _extract(image, config, n):
    return akaze.extract_akaze_features(image, config, n, device="cpu")


def test_akaze_msurf_detect(test_image):
    pts, desc = _extract(test_image, {}, 500)
    assert len(pts) > 100
    assert desc.shape[1] == 64
    assert np.allclose(np.linalg.norm(desc, axis=1), 1.0, atol=1e-4)
    assert (pts[:, 0] >= 0).all() and (pts[:, 0] < 400).all()
    assert (pts[:, 1] >= 0).all() and (pts[:, 1] < 300).all()
    assert (pts[:, 2] > 0).all()


def test_akaze_mldb_binary(test_image):
    pts, desc = _extract(test_image, {"akaze_descriptor": "MLDB"}, 300)
    assert len(pts) > 50
    assert desc.shape[1] == 486  # 3 channels x (6 + 36 + 120) comparisons
    assert set(np.unique(desc)).issubset({0.0, 1.0})


def test_akaze_upright_zero_angle(test_image):
    pts, _ = _extract(test_image, {"akaze_descriptor": "MSURF_UPRIGHT"}, 200)
    assert np.allclose(pts[:, 3], 0.0)


def test_akaze_translation_repeatability(test_image):
    shift = 16
    shifted = np.roll(test_image, shift, axis=1)
    pts1, desc1 = _extract(test_image, {}, 400)
    pts2, desc2 = _extract(shifted, {}, 400)
    d = ((desc1[:, None] - desc2[None]) ** 2).sum(-1)
    nn12 = d.argmin(1)
    nn21 = d.argmin(0)
    mutual = nn21[nn12] == np.arange(len(desc1))
    dx = pts2[nn12, 0] - pts1[:, 0]
    dy = pts2[nn12, 1] - pts1[:, 1]
    good = mutual & (np.abs(dx - shift) < 2.0) & (np.abs(dy) < 2.0)
    assert good.sum() > 0.5 * mutual.sum()
    assert good.sum() > 50


def test_akaze_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        akaze.extract_akaze_features(np.zeros((64, 64), np.float32), {}, 10)
