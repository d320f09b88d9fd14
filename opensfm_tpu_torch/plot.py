"""Raster figures drawn without matplotlib: the port's plots for
`stats` (match graph, top view, feature heatmaps, residual grids).

A `Figure` is an [H, W, 3] uint8 image composed on a device (the card
unless the caller asks for the CPU).  Three rules make the card's image
bit-equal to the CPU's:

1. Geometry on the host in f64.  Every coordinate (data to pixel, segment
   sample points, disc and rectangle footprints, glyph bits) is worked out
   in f64 NumPy; only integer pixel indices, primitive order numbers and
   colours go to the device.
2. Overlaps in a fixed order.  Each primitive gets an order number as it
   is drawn (painter's order); each pixel keeps the primitive of the
   largest number, by `scatter_reduce(..., "amax")` of the numbers and a
   gather of that primitive's colour.  An integer maximum does not depend
   on the order the device applies the updates in, unlike `index_put_`
   with repeated indices.
3. Batches.  One scatter per primitive kind and figure, not a launch per
   point.

`VIRIDIS` is matplotlib's 256-entry viridis table (its `_viridis_data`
rounded to 8 bits), kept here as a constant; `colormap` looks fractions up
in it as matplotlib does (index floor(256 c), clipped to the table).  Text
is a built-in 5 x 7 bitmap font for printable ASCII, scaled by whole
pixels; any other character draws as '?'.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device

_VIRIDIS_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725"
)
# 95 glyphs, ' ' to '~': 7 rows of 5 bits each (two hex digits a row, the
# leftmost pixel in the highest bit).
_FONT_HEX = (
    "00000000000000040404040400040a0a0a000000000a0a1f0a1f0a0a040f140e051e04"
    "181902040813030c12140815120d040408000000000204080808040208040202020408"
    "0004150e1504000004041f040400000000000c04080000001f00000000000000000c0c"
    "000102040810000e11131519110e040c040404040e0e11010204081f1f02040201110e"
    "02060a121f02021f101e0101110e0608101e11110e1f0102040808080e11110e11110e"
    "0e11110f01020c000c0c000c0c00000c0c000c04080204081008040200001f001f0000"
    "080402010204080e1101020400040e11010d15150e0e11111f1111111e11111e11111e"
    "0e11101010110e1c12111111121c1f10101e10101f1f10101e1010100e11101711110f"
    "1111111f1111110e04040404040e0702020202120c111214181412111010101010101f"
    "111b1515111111111119151311110e11111111110e1e11111e1010100e11111115120d"
    "1e11111e1412110f10100e01011e1f0404040404041111111111110e11111111110a04"
    "1111111515150a11110a040a111111110a040404041f01020408101f0e08080808080e"
    "001008040201000e02020202020e040a11000000000000000000001f08040200000000"
    "00000e010f110f1010161911111e00000e1010110e01010d1311110f00000e111f100e"
    "0609081c080808000f11110f010e1010161911111104000c0404040e0200060202120c"
    "101012141814120c04040404040e00001a151511110000161911111100000e1111110e"
    "00001e111e101000000d130f01010000161910101000000e100e011e08081c08080906"
    "0000111111130d00001111110a040000111115150a0000110a040a11000011110f010e"
    "00001f0204081f02040408040402040404040404040804040204040800000815020000"
)

VIRIDIS = np.frombuffer(bytes.fromhex("".join(_VIRIDIS_HEX)),
                        dtype=np.uint8).reshape(256, 3)
_FONT = np.frombuffer(bytes.fromhex("".join(_FONT_HEX)),
                      dtype=np.uint8).reshape(95, 7)
GLYPH_W, GLYPH_H = 5, 7

WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
RED = (255, 0, 0)  # matplotlib's "red"


def colormap(fractions, name: str = "viridis") -> np.ndarray:
    """uint8 RGB [N, 3] of `fractions` in "viridis" or "viridis_r", looked
    up as matplotlib's 256-entry colormaps do (index floor(256 c); below 0
    the first entry, from 1 on the last)."""
    table = {"viridis": VIRIDIS, "viridis_r": VIRIDIS[::-1]}[name]
    c = np.asarray(fractions, dtype=np.float64).reshape(-1)
    return table[np.clip(np.floor(c * 256.0), 0, 255).astype(np.int64)]


def text_mask(s: str) -> np.ndarray:
    """[7, 6 len(s) - 1] bool bitmap of `s` in the 5 x 7 font, one blank
    column between glyphs."""
    if not s:
        return np.zeros((GLYPH_H, 0), dtype=bool)
    codes = np.array([ord(ch) - 32 if 32 <= ord(ch) < 127 else ord("?") - 32
                      for ch in s])
    rows = _FONT[codes]  # [n, 7]
    bits = (rows[:, :, None] >> np.arange(GLYPH_W - 1, -1, -1)) & 1
    cells = np.concatenate(
        [bits.astype(bool), np.zeros((len(s), GLYPH_H, 1), dtype=bool)],
        axis=2)  # [n, 7, 6]
    return cells.transpose(1, 0, 2).reshape(GLYPH_H, -1)[:, :-1]


def nice_ticks(lo: float, hi: float, most: int = 6) -> np.ndarray:
    """Round tick values in [lo, hi]: a step of 1, 2 or 5 times a power of
    ten giving at most `most` ticks."""
    span = hi - lo
    if not span > 0:
        return np.array([lo])
    base = 10.0 ** math.floor(math.log10(span / most))
    step = next(m * base for m in (1, 2, 5, 10) if span / (m * base) <= most)
    first = math.ceil(lo / step - 1e-9)
    last = math.floor(hi / step + 1e-9)
    return np.arange(first, last + 1) * step


def tick_label(value: float, step: float) -> str:
    decimals = max(0, -int(math.floor(math.log10(step)))) if step > 0 else 0
    text = f"{value:.{decimals}f}"
    return "0" if float(text) == 0 else text


def data_limits(values, margin: float = 0.05) -> Tuple[float, float]:
    """(lo, hi) of `values` widened by `margin` of their span on each side
    (matplotlib's default margins); a single value gets +-0.5."""
    v = np.asarray(values, dtype=np.float64)
    lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
    if hi == lo:
        return lo - 0.5, hi + 0.5
    pad = (hi - lo) * margin
    return lo - pad, hi + pad


def _as_colors(colors, n: int) -> np.ndarray:
    c = np.asarray(colors)
    if c.dtype != np.uint8:
        c = np.clip(np.rint(c.astype(np.float64)), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.broadcast_to(c.reshape(-1, 3), (n, 3)))


def _disc_footprint(cx, cy, radius: float):
    """(ix, iy, which): the pixels whose centre lies within `radius` of
    (cx[which], cy[which]), and the pixel holding each centre."""
    k = int(math.ceil(radius)) + 1
    off = np.arange(-k, k + 1)
    ox, oy = (a.reshape(-1) for a in np.meshgrid(off, off))
    bx = np.floor(cx)[:, None] + ox
    by = np.floor(cy)[:, None] + oy
    d2 = (bx + 0.5 - cx[:, None]) ** 2 + (by + 0.5 - cy[:, None]) ** 2
    inside = (d2 <= radius * radius) | ((ox == 0) & (oy == 0))
    which, slot = np.nonzero(inside)
    return (bx[which, slot].astype(np.int64), by[which, slot].astype(np.int64),
            which)


class Figure:
    """A white [height, width] RGB raster on `device` (CUDA unless told
    otherwise), drawn in painter's order and composed by `render`."""

    def __init__(self, width: int, height: int, device=None) -> None:
        self.width, self.height = int(width), int(height)
        self.device = resolve_device(device)
        self._footprints = {}  # kind -> [(flat pixel, order)]
        self._colors = []  # uint8 [n, 3] per batch, in order
        self._count = 0

    def _add(self, kind: str, ix, iy, which, colors, n: int) -> None:
        keep = ((ix >= 0) & (ix < self.width) & (iy >= 0)
                & (iy < self.height))
        pix = iy[keep] * self.width + ix[keep]
        order = self._count + which[keep].astype(np.int64)
        self._footprints.setdefault(kind, []).append((pix, order))
        self._colors.append(_as_colors(colors, n))
        self._count += n

    def rects(self, x0, y0, x1, y1, colors) -> None:
        """Filled rectangles in pixels: every pixel whose centre lies in
        [x0, x1) x [y0, y1)."""
        x0, y0, x1, y1 = np.broadcast_arrays(
            *(np.atleast_1d(np.asarray(a, dtype=np.float64))
              for a in (x0, y0, x1, y1)))
        n = len(x0)
        ax = np.clip(np.ceil(x0 - 0.5), 0, self.width).astype(np.int64)
        bx = np.clip(np.ceil(x1 - 0.5), 0, self.width).astype(np.int64)
        ay = np.clip(np.ceil(y0 - 0.5), 0, self.height).astype(np.int64)
        by = np.clip(np.ceil(y1 - 0.5), 0, self.height).astype(np.int64)
        w, h = np.maximum(bx - ax, 0), np.maximum(by - ay, 0)
        counts = w * h
        which = np.repeat(np.arange(n), counts)
        local = np.arange(int(counts.sum())) - np.repeat(
            np.cumsum(counts) - counts, counts)
        ww = np.maximum(w[which], 1)
        self._add("rects", ax[which] + local % ww, ay[which] + local // ww,
                  which, colors, n)

    def discs(self, cx, cy, radius: float, colors) -> None:
        """Filled discs of `radius` pixels centred on (cx, cy) in pixels."""
        cx = np.atleast_1d(np.asarray(cx, dtype=np.float64))
        cy = np.atleast_1d(np.asarray(cy, dtype=np.float64))
        ix, iy, which = _disc_footprint(cx, cy, float(radius))
        self._add("discs", ix, iy, which, colors, len(cx))

    def segments(self, x0, y0, x1, y1, colors, width: float) -> None:
        """Line segments `width` pixels wide between pixel points: discs of
        radius max(width / 2, 0.71) a pixel apart along each."""
        x0, y0, x1, y1 = (np.atleast_1d(np.asarray(a, dtype=np.float64))
                          for a in (x0, y0, x1, y1))
        n = len(x0)
        steps = np.ceil(np.hypot(x1 - x0, y1 - y0)).astype(np.int64) + 1
        seg = np.repeat(np.arange(n), steps)
        k = np.arange(int(steps.sum())) - np.repeat(np.cumsum(steps) - steps,
                                                     steps)
        t = k / np.maximum(steps[seg] - 1, 1)
        sx = x0[seg] + t * (x1 - x0)[seg]
        sy = y0[seg] + t * (y1 - y0)[seg]
        ix, iy, sample = _disc_footprint(sx, sy, max(width / 2.0, 0.71))
        which = seg[sample]
        # One entry per (segment, pixel) of the canvas: the samples overlap.
        keep = np.nonzero((ix >= 0) & (ix < self.width) & (iy >= 0)
                          & (iy < self.height))[0]
        flat = (which[keep] * self.height + iy[keep]) * self.width + ix[keep]
        first = keep[np.unique(flat, return_index=True)[1]]
        self._add("segments", ix[first], iy[first], which[first], colors, n)

    def text(self, x: float, y: float, s: str, scale: int = 2,
             color=BLACK, anchor: str = "left") -> None:
        """`s` in the bitmap font, `scale` pixels a font pixel, its top at
        row y and its left edge, centre or right edge (`anchor`) at x."""
        mask = np.kron(text_mask(s), np.ones((scale, scale), dtype=bool))
        iy, ix = np.nonzero(mask)
        shift = {"left": 0.0, "center": mask.shape[1] / 2.0,
                 "right": float(mask.shape[1])}[anchor]
        x0 = int(math.floor(x - shift + 0.5))
        y0 = int(math.floor(y + 0.5))
        self._add("text", ix + x0, iy + y0, np.zeros(len(ix), np.int64),
                  color, 1)

    def render(self) -> np.ndarray:
        """The [height, width, 3] uint8 image: per pixel the colour of the
        last primitive drawn over it, white where none is."""
        dev = self.device
        best = torch.full((self.height * self.width,), -1, dtype=torch.int64,
                          device=dev)
        for kind in sorted(self._footprints):
            parts = self._footprints[kind]
            pix = torch.from_numpy(np.concatenate([p for p, _ in parts]))
            order = torch.from_numpy(np.concatenate([o for _, o in parts]))
            best.scatter_reduce_(0, pix.to(dev), order.to(dev), reduce="amax",
                                 include_self=True)
        palette = torch.from_numpy(np.concatenate(
            [np.array([WHITE], dtype=np.uint8)] + self._colors)).to(dev)
        image = palette[best + 1].reshape(self.height, self.width, 3)
        return image.cpu().numpy()


class Axes:
    """A data rectangle [xlim] x [ylim] mapped onto the pixel box (left,
    top, width, height) of a figure, in f64 on the host.  `equal` widens
    the narrower range so both axes have one scale; `invert_y` puts ylim[0]
    at the top."""

    def __init__(self, fig: Figure, box: Sequence[float], xlim, ylim,
                 invert_y: bool = False, equal: bool = False) -> None:
        self.fig = fig
        self.left, self.top, self.w, self.h = (float(v) for v in box)
        (x0, x1), (y0, y1) = (tuple(map(float, xlim)),
                              tuple(map(float, ylim)))
        if equal:
            per_px = max((x1 - x0) / self.w, (y1 - y0) / self.h)
            xc, yc = (x0 + x1) / 2.0, (y0 + y1) / 2.0
            x0, x1 = xc - per_px * self.w / 2.0, xc + per_px * self.w / 2.0
            y0, y1 = yc - per_px * self.h / 2.0, yc + per_px * self.h / 2.0
        self.xlim, self.ylim, self.invert_y = (x0, x1), (y0, y1), invert_y

    def to_pixel(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        px = self.left + (np.asarray(x, np.float64) - x0) / (x1 - x0) * self.w
        fy = (np.asarray(y, np.float64) - y0) / (y1 - y0)
        py = self.top + (fy if self.invert_y else 1.0 - fy) * self.h
        return px, py

    def scale(self) -> float:
        """Pixels per data unit along x."""
        return self.w / (self.xlim[1] - self.xlim[0])

    def frame(self, ticks: bool = True, text_scale: int = 2) -> None:
        """The box's border, with round ticks and their labels outside it."""
        l, t, w, h = self.left, self.top, self.w, self.h
        lw = 2.0
        self.fig.rects([l - lw, l - lw, l - lw, l + w],
                       [t - lw, t + h, t - lw, t - lw],
                       [l + w + lw, l + w + lw, l, l + w + lw],
                       [t, t + h + lw, t + h + lw, t + h + lw], BLACK)
        if not ticks:
            return
        tick = 4 * text_scale
        for axis in ("x", "y"):
            lo, hi = self.xlim if axis == "x" else self.ylim
            values = nice_ticks(lo, hi)
            step = values[1] - values[0] if len(values) > 1 else 1.0
            if axis == "x":
                px, _ = self.to_pixel(values, np.zeros_like(values))
                self.fig.rects(px - 1, t + h, px + 1, t + h + tick, BLACK)
                for p, v in zip(px, values):
                    self.fig.text(p, t + h + tick + 2 * text_scale,
                                  tick_label(v, step), text_scale,
                                  anchor="center")
            else:
                _, py = self.to_pixel(np.zeros_like(values), values)
                self.fig.rects(l - tick, py - 1, l, py + 1, BLACK)
                for p, v in zip(py, values):
                    self.fig.text(l - tick - 2 * text_scale,
                                  p - GLYPH_H * text_scale / 2.0,
                                  tick_label(v, step), text_scale,
                                  anchor="right")

    def title(self, s: str, text_scale: int = 3) -> None:
        self.fig.text(self.left + self.w / 2.0,
                      self.top - (GLYPH_H + 5) * text_scale, s, text_scale,
                      anchor="center")


def write_png(image: np.ndarray, path: str) -> None:
    """`image` as a PNG file through `io.encode_png`."""
    from opensfm_tpu_torch import io

    with open(path, "wb") as f:
        f.write(io.encode_png(image))
