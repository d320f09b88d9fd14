"""The port's HAHOG/SIFT detector and its image preparation against the JAX
package and OpenCV on the CPU.

`extract_dog_features` (the host wrapper: padding bucket, octaves and
candidate budget, then `detect_and_describe`) runs through both packages on
the same seeded textured images: the Hessian detector (HAHOG) with dual
orientations, the 2x upsample and RootSIFT uchar descriptors at 256 x 256,
and the DoG detector (SIFT) without upsample and with float descriptors at
300 x 214 (a size that is not a multiple of the padding bucket).

Tolerances, measured on these inputs: the two packages do not round every
sum alike (XLA's CPU build fuses some multiply-adds of the filter chains,
its atan2 differs from torch's by an ulp, and the histogram and norm sums
run in another order), so a keypoint's subpixel offset moves by up to
4.1e-3 px (up to 6.2e-4 of its size on the renders of
tests/test_torch_detect_command.py; 99 % within 9.5e-4 px), its parabolic angle
by up to 2 degrees, and where two histogram bins nearly tie the dominant
orientation flips (one keypoint of 418 on another seed).  Held here: at
most 0.5 % of either package's keypoints without a partner (candidates at
the top-k cut or the peak threshold); partners of equal scale (1e-6
relative), within POS_TOL px for 99 % of them and POS_REL_TOL of their size
for all; at most 0.5 % of them with angles more than ANGLE_TOL degrees
apart; and over the others uint8 descriptors within +-1 on >= 99.9 % of
entries (float ones within 1e-2).
Also: the 2x upsample against `jax.image.resize` and the filter chain
against the JAX package's (both within 2 ulp), `resized_image` against
`cv2.resize(INTER_AREA)` (bit-exact at integer ratios, within 1 grey level
otherwise), and the grey conversion bit-exact against `cv2.cvtColor`.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from opensfm_tpu.ops import features as ref_ops
from opensfm_tpu_torch import features
from opensfm_tpu_torch.ops import features as ops

POS_TOL = 1e-3  # px, keypoint positions (99 % of partners)
POS_REL_TOL = 1e-3  # of the keypoint's size (all partners)
ANGLE_TOL = 2.5  # degrees
UNMATCHED = 0.005  # share of keypoints without a partner
ULP = 2 ** -23


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """A uint8 image of multi-scale block noise, smoothed."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for s in (2, 4, 8, 16, 32):
        n = rng.normal(size=(h // s + 2, w // s + 2))
        img += np.kron(n, np.ones((s, s)))[:h, :w] * s ** 0.5
    img = gaussian_filter(img, 1.0)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def _partners(pr, pt):
    """For each reference keypoint, the index of the port keypoint with the
    same position and scale and the nearest angle (-1 when none is within
    1e-2 px), each port keypoint used once."""
    used = np.zeros(len(pt), bool)
    out = np.full(len(pr), -1)
    for i, p in enumerate(pr):
        d = np.abs(pt[:, :3] - p[:3]).max(axis=1)
        ang = np.abs((pt[:, 3] - p[3] + 180.0) % 360.0 - 180.0)
        cost = np.where(used | (d > 1e-2), np.inf, d + 1e-3 * ang)
        j = int(np.argmin(cost))
        if np.isfinite(cost[j]):
            out[i] = j
            used[j] = True
    return out


CASES = {
    "hahog_upsample_uchar": dict(
        shape=(256, 256), detector="hessian", n_orientations=2,
        upsample=True, root_uchar=True, peak_threshold=1e-5,
        target_features=500),
    "sift_float_ragged": dict(
        shape=(214, 300), detector="dog", n_orientations=1, upsample=False,
        root_uchar=False, peak_threshold=0.005, target_features=500),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_detect_and_describe_matches_reference(case):
    kw = dict(CASES[case])
    img = textured(*kw.pop("shape"), seed=3)
    pr, dr = ref_ops.extract_dog_features(img, **kw)
    pt, dt = ops.extract_dog_features(img, device="cpu", **kw)
    assert len(pr) > 300 and abs(len(pr) - len(pt)) <= UNMATCHED * len(pr)
    j = _partners(pr, pt)
    ok = j >= 0
    assert (~ok).mean() <= UNMATCHED
    assert len(pt) - ok.sum() <= UNMATCHED * len(pt)
    a, b = pr[ok], pt[j[ok]]
    dxy = np.abs(a[:, :2] - b[:, :2]).max(axis=1)
    assert np.quantile(dxy, 0.99) <= POS_TOL
    assert (dxy <= POS_REL_TOL * a[:, 2]).all()
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=1e-6)
    same = np.abs((a[:, 3] - b[:, 3] + 180.0) % 360.0 - 180.0) <= ANGLE_TOL
    assert (~same).mean() <= UNMATCHED
    assert dt.dtype == dr.dtype == (np.uint8 if kw["root_uchar"]
                                    else np.float32)
    diff = np.abs(dr[ok][same].astype(np.float64)
                  - dt[j[ok]][same].astype(np.float64))
    if kw["root_uchar"]:
        assert (diff <= 1).mean() >= 0.999
    else:
        assert (diff <= 1e-2).mean() >= 0.999


def test_upsample_matches_jax_resize():
    """The detector's 2x upsample (`_upsample2`, written out so that every
    device rounds alike) is the linear resize with half-pixel centres:
    jax.image.resize(linear, antialias=False) and F.interpolate(bilinear,
    align_corners=False), each within 2 ulp (measured: 1 ulp)."""
    x = np.random.default_rng(0).random((37, 50)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (74, 100), "linear",
                                      antialias=False))
    ours = ops._upsample2(torch.from_numpy(x)).numpy()
    interp = F.interpolate(torch.from_numpy(x)[None, None], scale_factor=2,
                           mode="bilinear", align_corners=False)[0, 0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2 * ULP)
    np.testing.assert_allclose(interp, ref, rtol=0, atol=2 * ULP)


def test_filter_chain_matches_reference():
    """The shifted-slice Gaussian blur against the JAX package's, jitted
    as the detector runs it: within 2 ulp."""
    x = np.random.default_rng(1).random((64, 48)).astype(np.float32)
    k = ops._gaussian_kernel(1.6, 4)
    ref = np.asarray(jax.jit(lambda a: ref_ops._sep_blur(a, k))(x))
    ours = ops._sep_blur(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2 * ULP)
    np.testing.assert_array_equal(
        ops._maxpool3(torch.from_numpy(x)).numpy(),
        np.asarray(ref_ops._maxpool3(jnp.asarray(x))))


@pytest.mark.parametrize("shape,max_size", [
    ((300, 400), 200), ((300, 400, 3), 100), ((300, 450), 150),
    ((300, 400), 333), ((97, 131, 3), 64), ((214, 300), 128)])
def test_resized_image_matches_inter_area(shape, max_size):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    h, w = shape[:2]
    size = max(h, w)
    ref = cv2.resize(img, (w * max_size // size, h * max_size // size),
                     interpolation=cv2.INTER_AREA)
    ours = features.resized_image(img, max_size, device="cpu")
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int))
    if h % ours.shape[0] == 0 and w % ours.shape[1] == 0:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1
    assert features.resized_image(img, 0, device="cpu") is img


def test_rgb_to_grey_bit_exact():
    img = np.random.default_rng(4).integers(0, 256, (120, 90, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(features.rgb_to_grey(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def test_unported_extractors_raise(monkeypatch):
    """Every feature type is ported: none raises NotImplementedError any
    more.  The OpenCV-backed SIFT_CV, ORB and SURF raise the JAX package's
    ImportError where cv2 is absent; AKAZE runs without it."""
    import sys

    config = {"feature_process_size": 64, "feature_min_frames": 10}
    img = np.zeros((32, 32), np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in ("SIFT_CV", "ORB", "SURF"):
        with pytest.raises(ImportError, match="cv2"):
            features.extract_features(img, dict(config, feature_type=name),
                                      False, device="cpu")
    out = features.extract_features(img, dict(config, feature_type="AKAZE"),
                                    False, device="cpu")
    assert len(out.points) == 0  # a blank image has no keypoints
