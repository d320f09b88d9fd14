"""EXIF orientation in the port's image reads, against OpenCV and the JAX
package on the CPU.

cv2.imread turns an image upright for the Orientation tag (1-8) of its EXIF
(a JPEG's APP1 segment, a PNG's eXIf chunk) under IMREAD_COLOR and
IMREAD_GRAYSCALE (with or without IMREAD_ANYDEPTH), and not under
IMREAD_UNCHANGED; its grey read rotates the grey image (converting after
the turn gives the same pixels: the turn moves pixels, it rounds nothing).
The port's `io.imread` does the same: equal shapes and pixels for
orientations 1-8 on PNG and JPEG (tolerance: none).  `io.image_size` gives
what the grey read gives, the JAX package's `IoFilesystemDefault`
definition of it (`imread(grayscale=True).shape`).  `extract_metadata`'s
width and height equal the JAX package's, which come from its
`DataSet.image_size`: PIL's size as stored, not turned (a 20 x 40 image
of orientation 6 reads as 40 rows of 20, and both packages record width
40 and height 20).

The fault this repairs: the port's PNG path read the pixels as stored, so
an orientation-6 PNG of 20 x 40 read as (20, 40, 3) where cv2 gives
(40, 20, 3); `io.decode_png` still returns the stored pixels, which shows
that shape.
"""

import struct

import cv2
import numpy as np
import pytest

import synthetic_images as si
from opensfm_tpu import io as ref_io
from opensfm_tpu_torch import exif, io, native

FLAGS = ((False, False, False, cv2.IMREAD_COLOR),
         (True, False, False, cv2.IMREAD_GRAYSCALE),
         (False, True, False, cv2.IMREAD_UNCHANGED),
         (False, False, True, cv2.IMREAD_COLOR | cv2.IMREAD_ANYDEPTH),
         (True, False, True, cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH))


def _tiff(orientation: int, make: str = "") -> bytes:
    """A little-endian TIFF block with IFD0's Orientation (and Make)."""
    entries = [struct.pack("<HHLHH", 0x0112, 3, 1, orientation, 0)]
    data = b""
    if make:
        raw = make.encode() + b"\0"
        entries.insert(0, struct.pack("<HHLL", 0x010F, 2, len(raw),
                                      8 + 2 + 12 * 2 + 4))
        data = raw
    ifd = struct.pack("<H", len(entries)) + b"".join(entries) + b"\0" * 4
    return b"II*\0" + struct.pack("<L", 8) + ifd + data


def _write(path, rgb, orientation, fmt):
    if fmt == "png":
        si.write_png(str(path), rgb, exif=_tiff(orientation, "Canon"))
    else:
        si.write_jpeg(str(path), rgb, exif=_tiff(orientation, "Canon"))


def _cv_rgb(path, flags):
    img = cv2.imread(str(path), flags)
    return img[..., ::-1] if img.ndim == 3 else img


def _image(h=20, w=40):
    rng = np.random.default_rng(h * w)
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                            (5, 5), 1.5)


def test_orientation_6_png_fault_and_repair(tmp_path):
    path = tmp_path / "o6.png"
    _write(path, _image(), 6, "png")
    assert cv2.imread(str(path), cv2.IMREAD_COLOR).shape == (40, 20, 3)
    # The stored pixels, which the PNG path returned before the repair.
    assert io.decode_png(path.read_bytes()).shape == (20, 40, 3)
    assert io.imread(str(path)).shape == (40, 20, 3)
    assert io.imread(str(path), unchanged=True).shape == (20, 40, 3)
    assert io.image_size(str(path)) == (40, 20)


@pytest.mark.parametrize("fmt", ["png", "jpg"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_like_cv2(tmp_path, fmt, orientation):
    if fmt == "jpg":
        try:
            native._jpeg()
        except native.NativeError as e:
            pytest.skip(f"no g++ for the JPEG codec: {e}")
    path = tmp_path / f"o.{fmt}"
    _write(path, _image(), orientation, fmt)
    assert exif.orientation(path.read_bytes()) == orientation
    for grayscale, unchanged, anydepth, flags in FLAGS:
        ours = io.imread(str(path), grayscale=grayscale, unchanged=unchanged,
                         anydepth=anydepth)
        ref = _cv_rgb(path, flags)
        assert ours.shape == ref.shape, (grayscale, unchanged, anydepth)
        np.testing.assert_array_equal(ours, ref)
    # Grey: cv2 turns the grey image; converting after the turn is equal.
    grey = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    colour = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if fmt == "png":
        stored = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            grey, io.apply_orientation(io._png_imread(
                path.read_bytes(), True, False, False), orientation))
        assert stored.shape == (20, 40, 3)
    assert grey.shape == colour.shape[:2]
    # image_size is the JAX package's imread(grayscale=True).shape.
    assert io.image_size(str(path)) == grey.shape
    assert io.image_size(str(path)) == ref_io.IoFilesystemDefault().image_size(
        str(path))


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_extract_metadata_size_equals_the_jax_package(tmp_path, fmt):
    """extract_metadata's width and height on an orientation-6 image."""
    from opensfm_tpu import dataset as ref_dataset
    from opensfm_tpu.actions import extract_metadata as ref_extract
    from opensfm_tpu_torch.actions import extract_metadata
    from opensfm_tpu_torch.dataset import DataSet

    if fmt == "jpg":
        try:
            native._jpeg()
        except native.NativeError as e:
            pytest.skip(f"no g++ for the JPEG codec: {e}")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for root in (ours, theirs):
        (root / "images").mkdir(parents=True)
        (root / "config.yaml").write_text("{}\n")
        _write(root / "images" / f"a.{fmt}", _image(), 6, fmt)
    extract_metadata.run_dataset(DataSet(str(ours)))
    ref_extract.run_dataset(ref_dataset.DataSet(str(theirs)))
    got = DataSet(str(ours)).load_exif(f"a.{fmt}")
    want = ref_dataset.DataSet(str(theirs)).load_exif(f"a.{fmt}")
    assert (got["width"], got["height"]) == (want["width"], want["height"])
    assert (got["width"], got["height"]) == (40, 20)  # as stored
    assert got["orientation"] == want["orientation"] == 6
