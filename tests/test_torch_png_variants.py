"""The PNG variants the port decodes itself beyond 8-bit non-interlaced
grey/RGB(A), against `cv2.imread` on the CPU.

16-bit grey, grey+alpha, RGB and RGBA (written by cv2, and by the test's
own writer with a tRNS colour), palettes of 1, 2, 4 and 8 bits with and
without a tRNS chunk, grey of 1, 2 and 4 bits, and Adam7 interlacing of
each, all written by the test in numpy with their samples drawn from a
seeded generator.  Under the five flag sets the port's `io.imread` maps to
(colour, grey and unchanged, and colour and grey with IMREAD_ANYDEPTH)
`io.imread` equals `cv2.imread` at every pixel, in shape and dtype
(tolerance: none): 16 bits are kept under unchanged and anydepth reads and
reduced to their high byte otherwise (libpng's strip_16), grey from colour
is libpng's rgb_to_gray at the stored depth (rounded at 16 bits, truncated
at 8), a palette or RGB image with tRNS reads as RGBA when unchanged, and
low-bit grey is scaled to 8 bits.
"""

import zlib

import cv2
import numpy as np
import pytest
import torch

from opensfm_tpu_torch import io

FLAGS = ((False, False, False, cv2.IMREAD_COLOR),
         (True, False, False, cv2.IMREAD_GRAYSCALE),
         (False, True, False, cv2.IMREAD_UNCHANGED),
         (False, False, True, cv2.IMREAD_COLOR | cv2.IMREAD_ANYDEPTH),
         (True, False, True, cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH))
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (len(payload).to_bytes(4, "big") + kind + payload
            + (zlib.crc32(kind + payload) & 0xFFFFFFFF).to_bytes(4, "big"))


def _rows(samples: np.ndarray, depth: int):
    """Filter-type-0 scanlines of [h, n] samples packed at `depth` bits."""
    h, n = samples.shape
    if depth == 16:
        packed = samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    elif depth == 8:
        packed = samples.astype(np.uint8)
    else:
        per = 8 // depth
        cols = -(-n // per) * per
        padded = np.zeros((h, cols), np.uint8)
        padded[:, :n] = samples
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        packed = (padded.reshape(h, -1, per) << shifts).sum(
            -1, dtype=np.uint8)
    return np.concatenate([np.zeros((h, 1), np.uint8), packed], axis=1)


def write_png(path, samples, ctype, depth, palette=None, trns=None,
              interlace=False):
    """A PNG of `samples` ([h, w, c] raw values) as the test builds it."""
    h, w, c = samples.shape
    if interlace:
        subs = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7
                if x0 < w and y0 < h]
        raw = b"".join(_rows(s.reshape(s.shape[0], -1), depth).tobytes()
                       for s in subs)
    else:
        raw = _rows(samples.reshape(h, w * c), depth).tobytes()
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([depth, ctype, 0, 0, int(interlace)]))
    data = io.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _cv_rgb(path, flags):
    img = cv2.imread(str(path), flags)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img.copy()
        img[..., :3] = img[..., 2::-1]
    return img


def _assert_like_cv2(path):
    for grayscale, unchanged, anydepth, flags in FLAGS:
        ours = io.imread(str(path), grayscale=grayscale, unchanged=unchanged,
                         anydepth=anydepth)
        ref = _cv_rgb(path, flags)
        assert (ours.shape, ours.dtype) == (ref.shape, ref.dtype), flags
        np.testing.assert_array_equal(ours, ref, err_msg=str(flags))


VARIANTS = [(0, 1), (0, 2), (0, 4), (0, 16), (2, 16), (4, 16), (6, 16),
            (3, 1), (3, 2), (3, 4), (3, 8), (0, 8), (2, 8), (4, 8), (6, 8)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", VARIANTS)
def test_png_variant_like_cv2(tmp_path, ctype, depth, interlace):
    rng = np.random.default_rng(100 * ctype + depth + interlace)
    h, w, c = 13, 11, CHANNELS[ctype]
    path = tmp_path / "v.png"
    for trns in (False, True):
        if trns and ctype in (4, 6):
            continue  # alpha channels already
        palette = tr = None
        if ctype == 3:
            n = min(1 << depth, 40)
            samples = rng.integers(0, n, (h, w, 1))
            palette = rng.integers(0, 256, (n, 3))
            if trns:
                tr = rng.integers(0, 256, min(n, 7)).astype(np.uint8).tobytes()
        else:
            samples = rng.integers(0, 1 << depth, (h, w, c))
            if trns:  # one colour of the image made transparent
                tr = b"".join(int(v).to_bytes(2, "big")
                              for v in samples[3, 4])
        write_png(path, samples, ctype, depth, palette, tr, interlace)
        _assert_like_cv2(path)
        assert io.image_size(str(path)) == (h, w)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_16bit_png_written_by_cv2(tmp_path, channels):
    """cv2's own 16-bit PNGs (its filters and deflate settings)."""
    rng = np.random.default_rng(channels)
    shape = (29, 37) if channels == 1 else (29, 37, channels)
    path = tmp_path / "c.png"
    cv2.imwrite(str(path), rng.integers(0, 65536, shape, dtype=np.uint16))
    _assert_like_cv2(path)
