"""ctypes bindings for the native runtime core (tracks codec + union-find,
and the PNG decoder's row unfiltering) and for the JPEG codec.

Port of `opensfm_tpu.native`: the same C ABI (`tracks_core.cpp`, this
package's own copy), compiled with g++ at first use instead of at import,
into `build/native/` in the checkout (the library's name carries a hash of
the source, so an edited source rebuilds), and loaded with ctypes.  As in
the reference, callers take the native path when the library is available
and their pure-Python path otherwise: `available()` tries the build once
and caches the answer in `NATIVE_AVAILABLE` (None until tried; a test sets
it to False to force the Python paths).

The JPEG codec (`jpeg_codec.cpp`) is a library of its own, built the same
way on first use.  It has no Python path: where it cannot build, reading or
writing a JPEG raises `JpegCodecUnavailable` with the build's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "tracks_core.cpp"
_JPEG_SRC = Path(__file__).resolve().parent / "jpeg_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

NATIVE_AVAILABLE: Optional[bool] = None  # None: the build was not tried yet
_lib = None
_jpeg_lib = None
_jpeg_error: Optional[str] = None
_lock = threading.Lock()


class NativeError(RuntimeError):
    """Raised when the native library rejects its input."""


class JpegCodecUnavailable(NativeError, ImportError):
    """The JPEG codec could not be built or loaded on this host (an
    ImportError, like a missing image library)."""


class JpegUnsupported(NativeError):
    """A JPEG variant the codec does not decode (arithmetic coding,
    lossless, 12-bit, CMYK, ...)."""


_CXXFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def library_path(src: Path = _SRC) -> Path:
    """The library's path: its name carries a hash of the source and the
    compiler flags, so an edited source rebuilds."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(_CXXFLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"_{src.stem}_{digest}.so"


def _build(src: Path = _SRC) -> Path:
    so = library_path(src)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_CXXFLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode:
            raise NativeError(f"{' '.join(cmd)} failed: {proc.stderr}")
        os.replace(tmp, so)  # atomic: safe under concurrent builders
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_ll = ctypes.c_longlong
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    llp = ctypes.POINTER(c_ll)

    lib.uf_components.argtypes = [llp, llp, c_ll, c_ll, i32p]
    lib.uf_components.restype = c_ll

    lib.tc_parse.argtypes = [ctypes.c_char_p, c_ll]
    lib.tc_parse.restype = ctypes.c_void_p
    lib.tc_num_rows.argtypes = [ctypes.c_void_p]
    lib.tc_num_rows.restype = c_ll
    lib.tc_shot_table.argtypes = [ctypes.c_void_p, llp]
    lib.tc_shot_table.restype = ctypes.c_void_p
    lib.tc_track_table.argtypes = [ctypes.c_void_p, llp]
    lib.tc_track_table.restype = ctypes.c_void_p
    lib.tc_fill.argtypes = [ctypes.c_void_p, i32p, i32p, i64p, f64p, i64p, i64p]
    lib.tc_fill.restype = None
    lib.tc_free.argtypes = [ctypes.c_void_p]
    lib.tc_free.restype = None

    lib.tc_serialize.argtypes = [
        ctypes.c_char_p, c_ll, ctypes.c_char_p, c_ll,
        i32p, i32p, i64p, f64p, i64p, i64p, c_ll, llp,
    ]
    lib.tc_serialize.restype = ctypes.c_void_p
    lib.tc_free_buf.argtypes = [ctypes.c_void_p]
    lib.tc_free_buf.restype = None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.png_unfilter.argtypes = [u8p, c_ll, c_ll, c_ll, u8p]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether the native library is loaded, building it on the first call;
    a failed build (no g++, a compile error) logs and answers False."""
    global NATIVE_AVAILABLE, _lib
    if NATIVE_AVAILABLE is not None:
        return NATIVE_AVAILABLE
    with _lock:
        if NATIVE_AVAILABLE is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build())))
                NATIVE_AVAILABLE = True
            except Exception as exc:  # toolchain missing, compile/load error
                logger.info("Native tracks core unavailable, using Python "
                            "paths: %s", exc)
                NATIVE_AVAILABLE = False
    return NATIVE_AVAILABLE


def _loaded() -> ctypes.CDLL:
    if not available():
        raise NativeError("the native tracks core is not available")
    return _lib


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def union_find_components(
    u: np.ndarray, v: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, int]:
    """Dense component labels (int32[n_nodes]) and component count for the
    graph on nodes 0..n_nodes-1 with edges (u[i], v[i])."""
    lib = _loaded()
    u = np.ascontiguousarray(u, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    labels = np.empty(n_nodes, dtype=np.int32)
    k = lib.uf_components(
        _as_ptr(u, ctypes.c_longlong), _as_ptr(v, ctypes.c_longlong),
        len(u), n_nodes, _as_ptr(labels, ctypes.c_int32),
    )
    if k < 0:
        raise NativeError("uf_components: invalid edge list")
    return labels, int(k)


def parse_tracks(text: str):
    """Parse a tracks.csv string into columnar arrays.

    Returns (shot_names, track_names, shot_idx[i32 n], track_idx[i32 n],
    feat_id[i64 n], xys[f64 n,3], rgb[i64 n,3], seg_inst[i64 n,2]).
    """
    lib = _loaded()
    data = text.encode("utf-8")
    handle = lib.tc_parse(data, len(data))
    if not handle:
        raise NativeError("tc_parse: malformed tracks data")
    try:
        n = lib.tc_num_rows(handle)
        buf_len = ctypes.c_longlong()
        ptr = lib.tc_shot_table(handle, ctypes.byref(buf_len))
        shot_blob = ctypes.string_at(ptr, buf_len.value) if buf_len.value else b""
        ptr = lib.tc_track_table(handle, ctypes.byref(buf_len))
        track_blob = ctypes.string_at(ptr, buf_len.value) if buf_len.value else b""
        shot_names = shot_blob.decode("utf-8").split("\n") if shot_blob else []
        track_names = track_blob.decode("utf-8").split("\n") if track_blob else []

        shot_idx = np.empty(n, dtype=np.int32)
        track_idx = np.empty(n, dtype=np.int32)
        feat_id = np.empty(n, dtype=np.int64)
        xys = np.empty((n, 3), dtype=np.float64)
        rgb = np.empty((n, 3), dtype=np.int64)
        seg_inst = np.empty((n, 2), dtype=np.int64)
        lib.tc_fill(
            handle,
            _as_ptr(shot_idx, ctypes.c_int32), _as_ptr(track_idx, ctypes.c_int32),
            _as_ptr(feat_id, ctypes.c_int64), _as_ptr(xys, ctypes.c_double),
            _as_ptr(rgb, ctypes.c_int64), _as_ptr(seg_inst, ctypes.c_int64),
        )
    finally:
        lib.tc_free(handle)
    return shot_names, track_names, shot_idx, track_idx, feat_id, xys, rgb, seg_inst


def serialize_tracks(
    shot_names: List[str], track_names: List[str],
    shot_idx: np.ndarray, track_idx: np.ndarray, feat_id: np.ndarray,
    xys: np.ndarray, rgb: np.ndarray, seg_inst: np.ndarray,
) -> str:
    """Serialize columnar observation rows to a tracks.csv v2 string."""
    lib = _loaded()
    shot_blob = b"\0".join(s.encode("utf-8") for s in shot_names) + b"\0"
    track_blob = b"\0".join(t.encode("utf-8") for t in track_names) + b"\0"
    shot_idx = np.ascontiguousarray(shot_idx, dtype=np.int32)
    track_idx = np.ascontiguousarray(track_idx, dtype=np.int32)
    feat_id = np.ascontiguousarray(feat_id, dtype=np.int64)
    xys = np.ascontiguousarray(xys, dtype=np.float64)
    rgb = np.ascontiguousarray(rgb, dtype=np.int64)
    seg_inst = np.ascontiguousarray(seg_inst, dtype=np.int64)
    out_len = ctypes.c_longlong()
    buf = lib.tc_serialize(
        shot_blob, len(shot_names), track_blob, len(track_names),
        _as_ptr(shot_idx, ctypes.c_int32), _as_ptr(track_idx, ctypes.c_int32),
        _as_ptr(feat_id, ctypes.c_int64), _as_ptr(xys, ctypes.c_double),
        _as_ptr(rgb, ctypes.c_int64), _as_ptr(seg_inst, ctypes.c_int64),
        len(shot_idx), ctypes.byref(out_len),
    )
    if not buf:
        raise NativeError("tc_serialize: invalid columns")
    try:
        return ctypes.string_at(buf, out_len.value).decode("utf-8")
    finally:
        lib.tc_free_buf(buf)


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Pixel bytes [height, stride] of PNG scanlines `raw` ([height,
    1 + stride], each led by its filter byte) of `bpp`-byte pixels."""
    lib = _loaded()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.shape != (height, stride + 1) or bpp < 1:
        raise NativeError(f"png_unfilter: scanlines of shape {raw.shape}, "
                          f"not ({height}, {stride + 1})")
    out = np.empty((height, stride), dtype=np.uint8)
    if lib.png_unfilter(_as_ptr(raw, ctypes.c_uint8), height, stride, bpp,
                        _as_ptr(out, ctypes.c_uint8)):
        raise NativeError("png_unfilter: unknown row filter")
    return out


# ---------------------------------------------------------------------------
# JPEG codec
# ---------------------------------------------------------------------------


def _jpeg() -> ctypes.CDLL:
    """The JPEG codec library, built on the first call; raises
    JpegCodecUnavailable with the build's error where it cannot be built or
    loaded."""
    global _jpeg_lib, _jpeg_error
    if _jpeg_lib is None and _jpeg_error is None:
        with _lock:
            if _jpeg_lib is None and _jpeg_error is None:
                try:
                    lib = ctypes.CDLL(str(_build(_JPEG_SRC)))
                    u8p, c_ll = ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong
                    i32p = ctypes.POINTER(ctypes.c_int32)
                    lib.jpeg_info.argtypes = [u8p, c_ll, i32p, ctypes.c_char_p,
                                              ctypes.c_int]
                    lib.jpeg_info.restype = ctypes.c_int
                    lib.jpeg_decode.argtypes = [u8p, c_ll, ctypes.c_int, u8p,
                                                c_ll, ctypes.c_char_p,
                                                ctypes.c_int]
                    lib.jpeg_decode.restype = ctypes.c_int
                    lib.jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.POINTER(c_ll)]
                    lib.jpeg_encode.restype = ctypes.c_void_p
                    lib.jpeg_free.argtypes = [ctypes.c_void_p]
                    lib.jpeg_free.restype = None
                    _jpeg_lib = lib
                except Exception as exc:  # toolchain missing, compile error
                    _jpeg_error = f"the JPEG codec could not be built: {exc}"
    if _jpeg_lib is None:
        raise JpegCodecUnavailable(_jpeg_error)
    return _jpeg_lib


def _jpeg_call(fn, data: bytes, *args) -> None:
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, dtype=np.uint8)
    code = fn(_as_ptr(buf, ctypes.c_uint8), len(data), *args, err, 256)
    if code == 1:
        raise JpegUnsupported(err.value.decode())
    if code:
        raise NativeError(f"corrupt JPEG data: {err.value.decode()}")


def jpeg_info(data: bytes) -> Tuple[int, int, int, bool]:
    """(height, width, components, progressive) from a JPEG's frame header."""
    info = np.zeros(4, dtype=np.int32)
    _jpeg_call(_jpeg().jpeg_info, data, _as_ptr(info, ctypes.c_int32))
    return int(info[0]), int(info[1]), int(info[2]), bool(info[3])


def jpeg_decode(data: bytes, grey: bool = False) -> np.ndarray:
    """Pixels of a JPEG file's bytes, as libjpeg gives them at OpenCV's
    defaults: [H, W] for a grey file or with `grey` (the Y plane of a
    YCbCr file), else [H, W, 3] RGB.  Raises JpegUnsupported for the
    variants the codec does not decode."""
    h, w, c, _ = jpeg_info(data)
    c = 1 if grey or c == 1 else 3
    out = np.empty((h, w, c) if c == 3 else (h, w), dtype=np.uint8)
    _jpeg_call(_jpeg().jpeg_decode, data, int(grey),
               _as_ptr(out, ctypes.c_uint8), out.size)
    return out


def jpeg_encode(image: np.ndarray) -> bytes:
    """A baseline JFIF JPEG of uint8 `image` ([H, W] grey or [H, W, 3]
    RGB) at quality 95, 4:2:0 for colour: what cv2.imwrite writes at its
    defaults."""
    pix = np.ascontiguousarray(image, dtype=np.uint8)
    if pix.ndim == 3 and pix.shape[2] == 1:
        pix = pix[..., 0]
    if not (pix.ndim == 2 or (pix.ndim == 3 and pix.shape[2] == 3)):
        raise ValueError(f"jpeg_encode takes grey or RGB pixels, not shape "
                         f"{pix.shape}")
    lib = _jpeg()
    n = ctypes.c_longlong()
    buf = lib.jpeg_encode(_as_ptr(pix, ctypes.c_uint8), pix.shape[0],
                          pix.shape[1], 1 if pix.ndim == 2 else 3,
                          ctypes.byref(n))
    if not buf:
        raise NativeError(f"jpeg_encode: cannot encode shape {pix.shape}")
    try:
        return ctypes.string_at(buf, n.value)
    finally:
        lib.jpeg_free(buf)
