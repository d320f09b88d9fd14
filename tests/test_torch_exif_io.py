"""The port's own image decoders and EXIF parser against OpenCV, PIL and the
JAX package on the CPU.

- PNG (8-bit grey, grey+alpha, RGB, RGBA; every row filter, written by hand
  so that all five occur) and PGM/PPM decode bit-exact against
  `cv2.imread` in its three modes (colour, grey, unchanged) on the same
  files; `image_size` reads the header.
- `extract_exif_from_file` equals the JAX package's (PIL-backed) on JPEGs
  and PNGs PIL writes with Make/Model/focal/GPS/orientation/datetime tags,
  in both byte orders, and on files with no EXIF; the parsed tag maps equal
  PIL's `_getexif()` (rationals compared as floats, exactly).
- `camera_from_exif_metadata` gives the same camera, and the `sensors`
  lookups give tests/test_sensors.py's answers.
- With neither cv2 nor PIL importable, `extract_metadata` and
  `detect_features` run on PNG, PGM and JPEG images (the port's own JPEG
  codec), and an arithmetic-coded JPEG, which the codec does not decode,
  raises an error naming the missing packages.
"""

import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from PIL.TiffImagePlugin import IFDRational

from opensfm_tpu import exif as ref_exif
from opensfm_tpu_torch import exif, io, native, sensors
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet

COLOUR_TYPES = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> channels


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _filter_row(line: np.ndarray, prev: np.ndarray, bpp: int, f: int):
    """PNG filter `f` applied to one row (the encoder side)."""
    x = line.astype(np.int64)
    b = prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if f == 0:
        pred = np.zeros_like(x)
    elif f == 1:
        pred = a
    elif f == 2:
        pred = b
    elif f == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def _write_png_all_filters(path, pix: np.ndarray, ctype: int) -> None:
    """A PNG whose rows cycle through the five filter types."""
    h, w = pix.shape[:2]
    c = COLOUR_TYPES[ctype]
    rows = pix.reshape(h, w * c)
    prev = np.zeros(w * c, np.uint8)
    raw = b""
    for y in range(h):
        f = y % 5
        raw += bytes([f]) + _filter_row(rows[y], prev, c, f).tobytes()
        prev = rows[y]
    data = (io.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _pixels(h, w, c, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _cv_rgb(path, flags):
    img = cv2.imread(str(path), flags)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img.copy()
        img[..., :3] = img[..., [2, 1, 0]]
    return img


def _assert_decodes_like_cv2(path, h, w):
    for grayscale, unchanged, flags in (
            (False, False, cv2.IMREAD_COLOR),
            (True, False, cv2.IMREAD_GRAYSCALE),
            (False, True, cv2.IMREAD_UNCHANGED)):
        ours = io.imread(str(path), grayscale=grayscale, unchanged=unchanged)
        ref = _cv_rgb(path, flags)
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)
    assert io.image_size(str(path)) == (h, w)


@pytest.mark.parametrize("native_core", [True, False])
@pytest.mark.parametrize("ctype", sorted(COLOUR_TYPES))
def test_png_all_filters_bit_exact(tmp_path, ctype, native_core, monkeypatch):
    """Every colour type with rows of all five filters, through the native
    unfilter loop and the Python one."""
    if not native_core:
        monkeypatch.setattr(native, "NATIVE_AVAILABLE", False)
    elif not native.available():
        pytest.skip("no g++ for the native core")
    h, w = 23, 37
    pix = _pixels(h, w, COLOUR_TYPES[ctype], ctype)
    path = tmp_path / "f.png"
    _write_png_all_filters(path, pix, ctype)
    _assert_decodes_like_cv2(path, h, w)
    np.testing.assert_array_equal(io.decode_png(path.read_bytes()), pix)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_written_by_pil_bit_exact(tmp_path, mode):
    """PIL's own PNGs (its adaptive filter choice), a ragged size."""
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    pix = _pixels(61, 45, c, 7)
    path = tmp_path / "p.png"
    Image.fromarray(pix, mode).save(path)
    _assert_decodes_like_cv2(path, 61, 45)


@pytest.mark.parametrize("ext,mode", [("pgm", "L"), ("ppm", "RGB"),
                                      ("pnm", "RGB")])
def test_pnm_bit_exact(tmp_path, ext, mode):
    pix = _pixels(19, 33, 1 if mode == "L" else 3, 3)
    path = tmp_path / f"p.{ext}"
    Image.fromarray(pix, mode).save(path, format="PPM")
    _assert_decodes_like_cv2(path, 19, 33)


@pytest.mark.parametrize("grayscale", [False, True])
def test_16bit_png_anydepth_like_cv2(tmp_path, grayscale):
    """A 16-bit PNG keeps its 16-bit samples with `anydepth`, as cv2 does
    with IMREAD_ANYDEPTH, and is reduced to 8 bits as cv2 reduces it
    without."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, rng.integers(0, 65536, (23, 31), dtype=np.uint16))
    base = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
    for anydepth in (False, True):
        want = cv2.imread(path, base | (cv2.IMREAD_ANYDEPTH if anydepth
                                        else 0))
        if not grayscale:
            want = want[..., ::-1]
        got = io.imread(path, grayscale=grayscale, anydepth=anydepth)
        assert got.dtype == (np.uint16 if anydepth else np.uint8)
        np.testing.assert_array_equal(got, want)


def test_jpeg_size_from_header(tmp_path):
    path = tmp_path / "j.jpg"
    Image.fromarray(_pixels(50, 70, 3, 1)).save(path, quality=90)
    assert io.image_size(str(path)) == (50, 70)
    assert io.image_size_from_header(path.read_bytes()[:4096]) == (50, 70)


def _exif_bytes(endian: str, gps_west: bool = False) -> bytes:
    ex = Image.Exif()
    ex.endian = endian
    ex[0x010F] = "Canon"
    ex[0x0110] = "Canon EOS 5D Mark III"
    ex[0x0112] = 6
    ex[0x0132] = "2020:01:02 03:04:05"
    ifd = ex.get_ifd(0x8769)
    ifd[0xA405] = 35
    ifd[0x920A] = IFDRational(24, 1)
    ifd[0x9003] = "2021:02:03 04:05:06"
    ifd[0x9291] = "25"
    gps = ex.get_ifd(0x8825)
    gps[0] = b"\x02\x02\x00\x00"
    gps[1] = "N"
    gps[2] = (IFDRational(47, 1), IFDRational(30, 1), IFDRational(1234, 100))
    gps[3] = "W" if gps_west else "E"
    gps[4] = (IFDRational(6, 1), IFDRational(7, 1), IFDRational(85, 10))
    gps[5] = b"\x00"
    gps[6] = IFDRational(1234, 10)
    gps[11] = IFDRational(5, 2)
    return ex.tobytes()


def _norm(v):
    """PIL value -> plain Python (rationals as floats, 1-tuples bare)."""
    if isinstance(v, tuple):
        v = tuple(_norm(x) for x in v)
        return v[0] if len(v) == 1 else v
    if isinstance(v, IFDRational):
        return float(v)
    return v


def _image_files(tmp_path):
    pix = _pixels(48, 64, 3, 5)
    files = []
    for endian in ("<", ">"):
        for ext in ("jpg", "png"):
            path = tmp_path / f"e{endian == '<'}.{ext}"
            Image.fromarray(pix).save(path, exif=_exif_bytes(endian,
                                                             endian == ">"))
            files.append(path)
    for ext in ("jpg", "png"):
        path = tmp_path / f"plain.{ext}"
        Image.fromarray(pix).save(path)
        files.append(path)
    small = tmp_path / "focal.jpg"  # FocalLength only: the sensor table
    ex = Image.Exif()
    ex[0x010F], ex[0x0110] = "NIKON CORPORATION", "NIKON D90"
    ex.get_ifd(0x8769)[0x920A] = IFDRational(18, 1)
    Image.fromarray(pix).save(small, exif=ex.tobytes())
    files.append(small)
    return files


def test_exif_maps_equal_pil(tmp_path):
    for path in _image_files(tmp_path):
        data = path.read_bytes()
        tags, gps = exif.parse_exif(exif.exif_block(data))
        raw = Image.open(path)._getexif() or {}
        from PIL.ExifTags import GPSTAGS, TAGS
        ref_tags = {TAGS.get(k, k): _norm(v) for k, v in raw.items()
                    if TAGS.get(k, k) != "GPSInfo"}
        ref_gps = {GPSTAGS.get(k, k): _norm(v)
                   for k, v in raw.get(0x8825, {}).items()}
        assert {k: _norm(v) for k, v in tags.items()} == ref_tags, path
        assert {k: _norm(v) for k, v in gps.items()} == ref_gps, path


def test_extract_exif_from_file_equals_reference(tmp_path):
    seen_gps = 0
    for path in _image_files(tmp_path):
        with open(path, "rb") as f:
            ours = exif.extract_exif_from_file(f, name=path.name)
        with open(path, "rb") as f:
            ref = ref_exif.extract_exif_from_file(f, name=path.name)
        assert ours == ref, path
        seen_gps += bool(ours["gps"])
    assert seen_gps == 4


class _Data:
    config = {"default_focal_prior": 0.85}


def test_camera_from_exif_metadata_equal(tmp_path):
    for path in _image_files(tmp_path):
        with open(path, "rb") as f:
            d = exif.extract_exif_from_file(f, name=path.name)
        ours = exif.camera_from_exif_metadata(d, _Data())
        ref = ref_exif.camera_from_exif_metadata(d, _Data())
        assert ours.id == ref.id
        assert (ours.width, ours.height) == (ref.width, ref.height)
        assert ours.projection_type == ref.projection_type
        assert ours.focal == ref.focal
        assert (ours.k1, ours.k2) == (ref.k1, ref.k2)


def test_sensor_lookups_match_the_reference_cases():
    assert sensors.sensor_width("canon eos 5d mark iii") == 36.0
    assert sensors.sensor_width("nikon d90") == 23.5
    assert sensors.sensor_width("dji fc6310") == 13.2
    assert sensors.sensor_width("gopro hero4 black") == 6.17
    assert sensors.sensor_width("not a camera") is None
    assert sensors.sensor_width(None) is None
    focal_35, ratio = exif.compute_focal(None, 24.0, None,
                                         "canon eos 5d mark iii")
    assert ratio == pytest.approx(24.0 / 36.0)
    assert exif.compute_focal(None, 24.0, None, "unknown camera xyz") == \
        (0.0, 0.0)
    assert exif.sensor_string("Canon", "Canon EOS 5D Mark III") == \
        "canon eos 5d mark iii"


def _hide_image_libraries(monkeypatch):
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def test_no_cv2_no_pil_png_pgm_chain_and_jpeg_error(tmp_path, monkeypatch):
    """extract_metadata and detect_features on PNG, PGM and JPEG images
    with neither cv2 nor PIL importable; an arithmetic-coded JPEG (a
    variant the port's codec does not decode) then passes
    extract_metadata, and its decode, alone and through detect_features,
    raises an error naming both packages."""
    path = tmp_path / "data"
    os.makedirs(path / "images")
    rng = np.random.default_rng(2)
    grey = (rng.random((96, 128)) * 255).astype(np.uint8)
    Image.fromarray(np.stack([grey] * 3, -1)).save(
        path / "images" / "a.png", exif=_exif_bytes("<"))
    Image.fromarray(grey).save(path / "images" / "b.pgm")
    Image.fromarray(np.stack([grey] * 3, -1)).save(
        path / "images" / "c.jpg", exif=_exif_bytes("<"))
    arith = tmp_path / "d.jpg"
    Image.fromarray(np.stack([grey] * 3, -1)).save(arith,
                                                   exif=_exif_bytes("<"))
    data = bytearray(arith.read_bytes())
    data[data.index(b"\xff\xc0") + 1] = 0xC9  # SOF9: arithmetic coding
    arith.write_bytes(bytes(data))
    with open(path / "config.yaml", "w") as f:
        f.write("feature_min_frames: 50\nfeature_process_size: 128\n")
    _hide_image_libraries(monkeypatch)
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    command_runner(opensfm_commands,
                   argv=["extract_metadata", str(path), "--device", "cpu"])
    report = command_runner(opensfm_commands, argv=[
        "detect_features", str(path), "--device", "cpu"])
    data = DataSet(str(path))
    assert data.load_exif("a.png")["make"] == "Canon"
    assert data.load_exif("c.jpg")["make"] == "Canon"
    assert data.load_exif("b.pgm")["width"] == 128
    for im in ("a.png", "b.pgm", "c.jpg"):
        assert len(data.load_features(im).points) > 0
        assert report["images"][im]["features"] > 0
    # The arithmetic-coded JPEG (written before the libraries were hidden):
    # its EXIF and size come from the port's own parsers, its pixels need
    # cv2 or PIL, so detect_features fails naming both.
    shutil.move(arith, path / "images" / "d.jpg")
    with pytest.raises(ImportError, match="JPG.*cv2.*PIL"):
        io.imread(str(path / "images" / "d.jpg"))
    command_runner(opensfm_commands,
                   argv=["extract_metadata", str(path), "--device", "cpu"])
    assert DataSet(str(path)).load_exif("d.jpg")["make"] == "Canon"
    with pytest.raises(ImportError, match="JPG.*cv2.*PIL"):
        command_runner(opensfm_commands, argv=[
            "detect_features", str(path), "--device", "cpu"])
    assert not DataSet(str(path)).features_exist("d.jpg")
