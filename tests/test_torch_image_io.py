"""The port's image writing and its own counterparts of OpenCV's remap and
resizes, against OpenCV on the CPU.

- `io.encode_png` (grey, grey+alpha, RGB, RGBA) reads back bit for bit
  through the port's `decode_png`/`imread` and through `cv2.imread`.
- `UndistortedDataSet`'s image, mask and segmentation round trips, with
  neither cv2 nor PIL importable, PNG and JPEG (the port's own codec; the
  JPEG read back within its quality-95 loss); a TIFF write then raises
  naming cv2.
- `ops.image.remap_linear` against `cv2.remap(..., INTER_LINEAR)` (the
  installed OpenCV, 5.0: a float32 bilinear with fused multiply-adds) on a
  random 96 x 64 RGB image through a distorting map whose taps cross the
  border, with NaN and far-away coordinates: equal at every pixel
  (measured: 100 % of 12,000 pixels; bound >= 99.9 % equal and within 1
  level everywhere).
- `ops.image.resize_area` on uint8 (equal) and float32 (within 2e-7)
  images, and `resize_nearest` (equal), against `cv2.resize`.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from opensfm_tpu_torch import io
from opensfm_tpu_torch.dataset import DataSet, UndistortedDataSet
from opensfm_tpu_torch.ops import image as ops_image

REMAP_EQUAL_SHARE = 0.999
AREA_FLOAT_TOL = 2e-7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    pix = rng.integers(0, 256, shape, dtype=np.uint8)
    pix[:4] = 0  # runs and wraps of the Sub filter
    pix[4:8] = 255
    path = str(tmp_path / "a.png")
    io.imwrite(path, pix)
    with open(path, "rb") as f:
        data = f.read()
    assert np.array_equal(io.decode_png(data), pix)
    assert io.image_size(path) == (37, 53)
    unchanged = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels >= 3:  # OpenCV gives BGR(A)
        unchanged[..., :3] = unchanged[..., 2::-1]
        assert np.array_equal(unchanged, pix)
        assert np.array_equal(io.imread(path), pix[..., :3])
    elif channels == 2:  # OpenCV expands grey+alpha to BGRA
        assert np.array_equal(unchanged[..., 0], pix[..., 0])
        assert np.array_equal(unchanged[..., 3], pix[..., 1])
    else:
        assert np.array_equal(unchanged, pix)
        assert np.array_equal(io.imread(path, grayscale=True), pix)


def _hide_image_libraries(monkeypatch):
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def test_undistorted_dataset_io_without_cv2_or_pil(tmp_path, monkeypatch):
    (tmp_path / "images").mkdir()
    (tmp_path / "config.yaml").write_text("{}\n")
    udata = UndistortedDataSet(DataSet(str(tmp_path)),
                               str(tmp_path / "undistorted"))
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    mask = rng.integers(0, 2, (30, 41), dtype=np.uint8) * 255
    seg = rng.integers(0, 9, (30, 41), dtype=np.uint8)
    _hide_image_libraries(monkeypatch)
    udata.save_undistorted_image("im.png", rgb)
    udata.save_undistorted_mask("im.png", mask)
    udata.save_undistorted_segmentation("im.png", seg)
    assert np.array_equal(udata.load_undistorted_image("im.png"), rgb)
    assert udata.undistorted_image_size("im.png") == (30, 41)
    assert udata.undistorted_mask_exists("im.png")
    assert np.array_equal(udata.load_undistorted_mask("im.png"), mask)
    assert udata.undistorted_segmentation_exists("im.png")
    assert np.array_equal(udata.load_undistorted_segmentation("im.png"), seg)
    assert udata.load_undistorted_mask("other.png") is None
    with pytest.raises(IOError):
        udata.load_undistorted_image("other.png")
    yy, xx = np.mgrid[0:30, 0:41]
    smooth = np.stack([xx * 5, yy * 8, (xx + yy) * 3], -1).astype(np.uint8)
    udata.save_undistorted_image("im.jpg", smooth)
    back = udata.load_undistorted_image("im.jpg")
    assert back.shape == smooth.shape
    err = back.astype(float) - smooth
    assert 10 * np.log10(255.0**2 / np.mean(err**2)) > 35.0  # PSNR, dB
    assert udata.undistorted_image_size("im.jpg") == (30, 41)
    with pytest.raises(ImportError, match="cv2"):
        udata.save_undistorted_image("im.tif", rgb)


def _distorting_map(rng, w, h, src_w, src_h):
    """A radially distorted map over a w x h output whose samples spill a
    few pixels past every border of the src_w x src_h source, with noise,
    NaN and far-away coordinates."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    u = (xs - (w - 1) / 2) / w
    v = (ys - (h - 1) / 2) / w
    r2 = u * u + v * v
    mx = (src_w - 1) / 2 + u * (1 + 0.8 * r2) * src_w * 1.1
    my = (src_h - 1) / 2 + v * (1 + 0.8 * r2) * src_w * 1.1
    mx = mx + rng.normal(0, 0.2, mx.shape)
    my = my + rng.normal(0, 0.2, my.shape)
    mx[0, :5] = np.nan
    my[1, :5] = 1e9
    mx[2, :5] = -3e7
    return mx.astype(np.float32), my.astype(np.float32)


@pytest.mark.parametrize("grey", [False, True])
def test_remap_linear_against_cv2(grey):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    if grey:
        img = img[..., 0].copy()
    mx, my = _distorting_map(rng, 120, 100, 96, 64)
    assert (mx < 0).any() and (mx > 95).any() and (my < 0).any() \
        and (my > 63).any()
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR).astype(np.int64)
    out = ops_image.remap_linear(img, mx, my, "cpu").numpy().astype(np.int64)
    assert out.shape == ref.shape and out.dtype == np.int64
    diff = np.abs(out - ref)
    per_pixel = diff if grey else diff.max(axis=-1)
    assert (per_pixel == 0).mean() >= REMAP_EQUAL_SHARE
    assert diff.max() <= 1


@pytest.mark.parametrize("size", [(48, 32), (40, 27), (33, 21), (96, 64)])
def test_resizes_against_cv2(size):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    w, h = size
    out = ops_image.resize_area(img, w, h, "cpu").numpy()
    assert np.array_equal(out, cv2.resize(img, (w, h),
                                          interpolation=cv2.INTER_AREA))
    f = img[..., 1].astype(np.float32) / 255.0
    ref = cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA)
    out = ops_image.resize_area(f, w, h, "cpu").numpy()
    assert out.dtype == np.float32
    assert np.abs(out - ref).max() <= AREA_FLOAT_TOL
    for src in (img, img[..., 0]):
        assert np.array_equal(
            ops_image.resize_nearest(src, w, h, "cpu").numpy(),
            cv2.resize(src, (w, h), interpolation=cv2.INTER_NEAREST))
    up = ops_image.resize_nearest(img, 150, 101, "cpu").numpy()
    assert np.array_equal(up, cv2.resize(img, (150, 101),
                                         interpolation=cv2.INTER_NEAREST))


def test_image_ops_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops_image.remap_linear(np.zeros((4, 4), np.uint8),
                               np.zeros((2, 2), np.float32),
                               np.zeros((2, 2), np.float32))
