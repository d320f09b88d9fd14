"""Every `feature_type` through the port's `features.extract_features`
against the JAX package's on the CPU.

- SIFT_CV and ORB: OpenCV's detectors in both packages on the pixels of
  the port's own resize and grey conversion (OpenCV's INTER_AREA at an
  integer ratio and RGB2GRAY, bit for bit): equal keypoints and
  descriptors (tolerance: none).
  SURF needs OpenCV's contrib module; where it is absent (OpenCV built
  without contrib) both packages raise the same RuntimeError, else they
  agree exactly.  With cv2 hidden, the three raise an ImportError naming
  cv2, as in the JAX package.
- AKAZE through `extract_features` (M-SURF with `feature_root`, M-LDB):
  keypoints in normalized coordinates within 1e-5 of the JAX package's
  (1e-3 px at 400 wide; the keypoint-level parity is
  tests/test_torch_akaze.py's), rooted M-SURF descriptors within 1e-3,
  M-LDB bits equal on 99.5 %; `FeaturesData.save` keeps M-LDB as uint8
  and `from_file` gives the same 0/1 bytes back.
"""

import sys

import numpy as np
import pytest
import torch

from opensfm_tpu import config as ref_config
from opensfm_tpu import features as ref_features
from opensfm_tpu_torch import config, features

POINT_TOL = 1e-5  # normalized coordinates
ROOT_MSURF_TOL = 1e-3
MLDB_EQUAL_SHARE = 0.995


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def image():
    """A 600 x 800 RGB image of blobs and texture (seeded numpy), which both
    packages resize to 400 wide (a ratio of 2, where the port's INTER_AREA
    is OpenCV's bit for bit)."""
    rng = np.random.default_rng(3)
    img = np.zeros((600, 800), dtype=np.float32)
    for _ in range(200):
        cy, cx = rng.integers(40, 560), rng.integers(40, 760)
        r = int(rng.integers(8, 30))
        y, x = np.ogrid[-r:r + 1, -r:r + 1]
        img[cy - r:cy + r + 1, cx - r:cx + r + 1] += (
            (y * y + x * x <= r * r) * rng.uniform(0.2, 1.0))
    img += rng.normal(0, 0.02, img.shape)
    grey = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    tint = rng.integers(0, 40, (1, 1, 3))
    return np.clip(grey[..., None] + tint, 0, 255).astype(np.uint8)


def _configs(feature_type, **extra):
    ours, theirs = config.default_config(), ref_config.default_config()
    for c in (ours, theirs):
        c.update(feature_type=feature_type, feature_min_frames=400,
                 feature_process_size=400, **extra)
    return ours, theirs


@pytest.mark.parametrize("feature_type", ["SIFT_CV", "ORB", "SURF"])
def test_opencv_feature_types_equal_the_jax_package(image, feature_type):
    ours, theirs = _configs(feature_type)
    try:
        want = ref_features.extract_features(image, theirs, False)
    except RuntimeError as e:  # SURF without OpenCV's contrib module
        with pytest.raises(RuntimeError, match=str(e)):
            features.extract_features(image, ours, False, device="cpu")
        return
    got = features.extract_features(image, ours, False, device="cpu")
    assert len(got.points) > 50
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.descriptors, want.descriptors)
    np.testing.assert_array_equal(got.colors, want.colors)


@pytest.mark.parametrize("feature_type", ["SIFT_CV", "ORB", "SURF"])
def test_opencv_feature_types_without_cv2(image, feature_type, monkeypatch):
    ours, _ = _configs(feature_type)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        features.extract_features(image, ours, False, device="cpu")


@pytest.mark.parametrize("descriptor", ["MSURF", "MLDB"])
def test_akaze_through_extract_features(image, descriptor, tmp_path):
    ours, theirs = _configs("AKAZE", akaze_descriptor=descriptor)
    want = ref_features.extract_features(image, theirs, False)
    got = features.extract_features(image, ours, False, device="cpu")
    assert len(got.points) > 50
    assert abs(len(got.points) - len(want.points)) <= 0.01 * len(want.points)
    dist = np.abs(want.points[:, None, :3] - got.points[None, :, :3]).max(-1)
    nn = dist.argmin(1)
    near = dist[np.arange(len(want.points)), nn] <= POINT_TOL
    assert near.mean() >= 0.99
    dw, dg = want.descriptors[near], got.descriptors[nn[near]]
    if descriptor == "MLDB":
        assert (dw == dg).mean() >= MLDB_EQUAL_SHARE
        path = tmp_path / "f.npz"
        got.save(str(path), ours)
        back = features.FeaturesData.from_file(str(path), ours)
        assert back.descriptors.dtype == np.uint8
        np.testing.assert_array_equal(back.descriptors, got.descriptors)
    else:
        assert ours["feature_root"]
        assert np.abs(dw - dg).max() <= ROOT_MSURF_TOL
        assert np.abs(got.descriptors).max() <= 1.0 + 1e-6
