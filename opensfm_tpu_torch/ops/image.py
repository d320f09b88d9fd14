"""The port's own counterparts of the OpenCV image calls the dense
pipeline makes, as tensor code on a device.

- `remap_linear`: `cv2.remap(image, map_x, map_y, INTER_LINEAR)` with
  BORDER_CONSTANT 0 on uint8 images, computed as OpenCV 5 computes it: the
  tap at floor(x), floor(y), the fractions in float32, taps outside the
  image reading 0, two horizontal lerps then a vertical one, each a fused
  multiply-add in float32, and the result rounded half to even.  (OpenCV
  4's fixed-point remap, with the maps quantised to 1/32 pixel, rounds
  many pixels another way.)
- `resize_area`: `cv2.resize(..., INTER_AREA)` to a given (width, height)
  for uint8 (bit for bit, `features.area_weights`) and float images.
- `resize_nearest`: `cv2.resize(..., INTER_NEAREST)`.
"""

from __future__ import annotations

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device

def remap_linear(image, map_x, map_y, device=None) -> torch.Tensor:
    """`image` [H, W] or [H, W, C] uint8 sampled at (map_x, map_y)
    ([h, w] float32 source pixel coordinates) as cv2.remap with
    INTER_LINEAR and a constant 0 border: [h, w(, C)] uint8 on `device`."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                          else image, device=dev)
    if img.dtype != torch.uint8:
        raise ValueError(f"remap_linear takes uint8 images, not {img.dtype}")
    grey = img.dim() == 2
    if grey:
        img = img[..., None]
    H, W, C = img.shape
    mx = torch.as_tensor(map_x, device=dev, dtype=torch.float32)
    my = torch.as_tensor(map_y, device=dev, dtype=torch.float32)
    # NaN and far-away coordinates land outside, where every tap reads 0.
    lim = float(1 << 30)
    mx = torch.nan_to_num(mx, nan=-lim).clamp(-lim, lim)
    my = torch.nan_to_num(my, nan=-lim).clamp(-lim, lim)
    x0, y0 = torch.floor(mx), torch.floor(my)
    a, b = (mx - x0)[..., None], (my - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(H * W, C)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.where(inside, yi * W + xi, 0)
        return (flat[idx] * inside[..., None]).to(torch.float32)

    def fma(x, y, z):  # float32 x * y + z, rounded once
        return (x.double() * y.double() + z.double()).float()

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top, bottom = fma(a, p01 - p00, p00), fma(a, p11 - p10, p10)
    out = torch.round(fma(b, bottom - top, top)).clamp(0, 255)
    out = out.to(torch.uint8)
    return out[..., 0] if grey else out


def resize_area(image, width: int, height: int, device=None) -> torch.Tensor:
    """`image` [H, W] or [H, W, C], uint8 or float, resized to (width,
    height) as cv2.resize(..., INTER_AREA) does: separable coverage
    weights (`features.area_weights`), i.e. two matrix products in f64;
    uint8 rounded as OpenCV rounds it (at integer ratios its box sums,
    resizeAreaFast, bit for bit), float cast back to the input's type."""
    from opensfm_tpu_torch.features import area_weights

    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                        else image, device=dev)
    h, w = x.shape[:2]
    if (w, h) == (width, height):
        return x.clone()
    is_u8 = x.dtype == torch.uint8
    wy, wx = area_weights(h, height), area_weights(w, width)
    fast = is_u8 and h % height == 0 and w % width == 0
    if fast:  # weights 1, then an integer division with rounding
        area = (h // height) * (w // width)
        wy, wx = (wy > 0).astype(np.float64), (wx > 0).astype(np.float64)
    wy = torch.as_tensor(wy, device=dev)
    wx = torch.as_tensor(wx, device=dev)
    out = torch.einsum("yh,hw...,xw->yx...", wy, x.to(torch.float64), wx)
    if not is_u8:
        return out.to(x.dtype)
    if fast and area == 4:  # the 2x2 vector path: (sum + 2) >> 2
        out = torch.div(out + 2, 4, rounding_mode="floor")
    elif fast:  # float(sum) * float(1 / area), rounded half to even
        out = out.to(torch.float32) * np.float32(1.0 / area)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _nearest_indices(ssize: int, dsize: int) -> np.ndarray:
    """Source index of each of `dsize` outputs along one axis, as OpenCV's
    resizeNN takes it: min(floor(d / (dsize / ssize)), ssize - 1)."""
    ifx = 1.0 / (dsize / ssize)
    return np.minimum(np.floor(np.arange(dsize) * ifx).astype(np.int64),
                      ssize - 1)


def resize_nearest(image, width: int, height: int,
                   device=None) -> torch.Tensor:
    """`image` resized to (width, height) as cv2.resize(..., INTER_NEAREST)
    does (segmentations and labels)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image)
                        else image, device=dev)
    h, w = x.shape[:2]
    ys = torch.as_tensor(_nearest_indices(h, height), device=dev)
    xs = torch.as_tensor(_nearest_indices(w, width), device=dev)
    return x[ys][:, xs]

