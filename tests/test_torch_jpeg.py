"""The port's own JPEG codec (`native/jpeg_codec.cpp` through `io.imread`
and `io.imwrite`) against OpenCV on the CPU.

- Reading: JPEGs written by `cv2.imencode` from seeded numpy images,
  baseline and progressive, chroma 4:4:4, 4:2:2, 4:2:0 and 4:4:0 and grey,
  qualities 50, 75 and 95, restart intervals 0 and 4, sizes 101 x 67, 16 x
  16 and 1 x 1: `io.imread` equals `cv2.imread` at every pixel under the
  colour, grey and unchanged reads (tolerance: none; every libjpeg-turbo
  step at OpenCV's defaults, the slow integer IDCT, fancy upsampling and
  the fixed-point YCbCr->RGB tables, is matched).
- The variants the codec does not decode (arithmetic coding, lossless,
  12-bit, CMYK) raise `UnsupportedImage` inside the port and go on to
  `_library_imread`; where the codec cannot be built, a JPEG read raises
  with the build's error and nothing falls back to cv2.
- Writing: `io.imwrite` of RGB and grey images writes what
  `cv2.imwrite` writes at its defaults (quality 95, 4:2:0): equal bytes,
  and so equal pixels when cv2 decodes both.
"""

import ctypes

import cv2
import numpy as np
import pytest

from opensfm_tpu_torch import io, native

SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "grey": None,
}
SIZES = ((67, 101), (16, 16), (1, 1))


@pytest.fixture(scope="module", autouse=True)
def codec():
    try:
        native._jpeg()
    except native.NativeError as e:
        pytest.skip(f"no g++ for the JPEG codec: {e}")


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.GaussianBlur(x, (7, 7), 1.5)  # some smooth, some sharp


def _cv_rgb(path, flags):
    img = cv2.imread(str(path), flags)
    return img[..., ::-1] if img.ndim == 3 else img


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_read_equals_cv2(tmp_path, progressive, sampling):
    path = tmp_path / "a.jpg"
    cases = 0
    for (h, w) in SIZES:
        img = _image(h, w, h * w)
        if sampling == "grey":
            img = img[..., 1]
        for quality in (50, 75, 95):
            for rst in (0, 4):
                params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                          cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                if SAMPLING[sampling] is not None:
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               SAMPLING[sampling]]
                ok, data = cv2.imencode(".jpg", img, params)
                assert ok
                path.write_bytes(data.tobytes())
                for grayscale, unchanged, flags in (
                        (False, False, cv2.IMREAD_COLOR),
                        (True, False, cv2.IMREAD_GRAYSCALE),
                        (False, True, cv2.IMREAD_UNCHANGED)):
                    ours = io.imread(str(path), grayscale=grayscale,
                                     unchanged=unchanged)
                    ref = _cv_rgb(path, flags)
                    assert ours.dtype == np.uint8 and ours.shape == ref.shape
                    np.testing.assert_array_equal(
                        ours, ref, err_msg=f"{h}x{w} q{quality} rst{rst} "
                        f"grey={grayscale} unchanged={unchanged}")
                assert io.image_size(str(path)) == (h, w)
                cases += 1
    assert cases == len(SIZES) * 6


def _patched(data: bytes, offset_of_sof: int, marker: int = None,
             precision: int = None, components: int = None) -> bytes:
    b = bytearray(data)
    if marker is not None:
        b[offset_of_sof + 1] = marker
    if precision is not None:
        b[offset_of_sof + 4] = precision
    if components is not None:
        b[offset_of_sof + 9] = components
    return bytes(b)


@pytest.mark.parametrize("variant", ["arithmetic", "lossless", "12-bit",
                                     "cmyk"])
def test_jpeg_variants_go_to_the_library(tmp_path, variant, monkeypatch):
    ok, data = cv2.imencode(".jpg", _image(24, 40, 3))
    data = data.tobytes()
    sof = data.index(b"\xff\xc0")
    patched = {
        "arithmetic": lambda: _patched(data, sof, marker=0xC9),
        "lossless": lambda: _patched(data, sof, marker=0xC3),
        "12-bit": lambda: _patched(data, sof, marker=0xC1, precision=12),
        "cmyk": lambda: _patched(data, sof, components=4),
    }[variant]()
    with pytest.raises(io.UnsupportedImage):
        io._jpeg_imread(patched, False)
    path = tmp_path / "v.jpg"
    path.write_bytes(patched)
    calls = []
    monkeypatch.setattr(io, "_library_imread",
                        lambda *a, **k: calls.append(a) or "library")
    assert io.imread(str(path)) == "library" and len(calls) == 1


def test_jpeg_size_and_pixels_come_from_one_marker_walk(tmp_path):
    """A stray RST0 after SOI, then a 96 x 128 file ending at EOI, then a
    1 x 1 frame header 0xFFE0 bytes after the RST0 (where a walk that
    read a length after RST0 would land).  The size, the pixels and
    cv2's reading all come from the 96 x 128 frame; and the decoder
    refuses an output buffer that does not fit the frame."""
    ok, enc = cv2.imencode(".jpg", _image(96, 128, 7))
    enc = enc.tobytes()
    assert enc[2:4] == b"\xff\xe0"
    data = b"\xff\xd8\xff\xd0" + enc[2:]
    assert len(data) < 4 + 0xFFE0
    data += bytes(4 + 0xFFE0 - len(data))
    data += bytes.fromhex("ffc0000b080001000101011100")
    path = tmp_path / "rst.jpg"
    path.write_bytes(data)
    assert native.jpeg_info(data)[:3] == (96, 128, 3)
    assert io.image_size(str(path)) == (96, 128)
    assert io.image_size_from_header(data) == (96, 128)
    ours = io.imread(str(path))
    assert ours.shape == (96, 128, 3)
    np.testing.assert_array_equal(ours, _cv_rgb(path, cv2.IMREAD_COLOR))
    out = np.empty(1, dtype=np.uint8)
    with pytest.raises(native.NativeError, match="does not fit"):
        native._jpeg_call(native._jpeg().jpeg_decode, data, 0,
                          native._as_ptr(out, ctypes.c_uint8),
                          out.size)


def test_jpeg_decoded_by_the_port_even_with_cv2(tmp_path, monkeypatch):
    """No quiet fallback: the port's codec reads a JPEG though cv2 is
    installed, and a codec that cannot be built raises its error."""
    path = tmp_path / "a.jpg"
    cv2.imwrite(str(path), _image(30, 50, 1))
    want = _cv_rgb(path, cv2.IMREAD_COLOR)

    def no_library(*args, **kwargs):
        raise AssertionError("JPEG handed to the library")

    monkeypatch.setattr(io, "_library_imread", no_library)
    np.testing.assert_array_equal(io.imread(str(path)), want)
    monkeypatch.setattr(native, "_jpeg_lib", None)
    monkeypatch.setattr(native, "_jpeg_error",
                        "the JPEG codec could not be built: g++ failed")
    with pytest.raises(native.JpegCodecUnavailable, match="g\\+\\+ failed"):
        io.imread(str(path))
    with pytest.raises(ImportError):
        io.imwrite(str(tmp_path / "b.jpg"), want)


@pytest.mark.parametrize("shape", [(67, 101, 3), (480, 640, 3), (33, 2, 3),
                                   (1, 1, 3), (67, 101)])
def test_jpeg_write_equals_cv2(tmp_path, shape):
    rgb = _image(shape[0], shape[1], sum(shape))
    if len(shape) == 2:
        rgb = rgb[..., 0]
    ours = tmp_path / "ours.jpg"
    io.imwrite(str(ours), rgb)
    theirs = tmp_path / "theirs.jpg"
    cv2.imwrite(str(theirs), rgb[..., ::-1] if rgb.ndim == 3 else rgb)
    # The bytes are equal (markers, tables, entropy-coded data) ...
    assert ours.read_bytes() == theirs.read_bytes()
    # ... and so the pixels cv2 decodes from each.
    np.testing.assert_array_equal(cv2.imread(str(ours), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(theirs),
                                             cv2.IMREAD_UNCHANGED))
    # RGBA: the alpha is dropped, as cv2.imwrite drops it.
    if rgb.ndim == 3:
        rgba = np.concatenate([rgb, rgb[..., :1]], axis=2)
        assert io.encode_jpeg(rgba) == theirs.read_bytes()
