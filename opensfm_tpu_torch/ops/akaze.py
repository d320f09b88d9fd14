"""AKAZE features in PyTorch: the FED nonlinear diffusion scale space, the
Hessian detector and M-SURF / M-LDB descriptors on the device.

Port of `opensfm_tpu.ops.akaze` (Alcantarilla et al., "Fast Explicit
Diffusion for Accelerated Features in Nonlinear Scale Spaces", BMVC 2013,
rebuilt as dense tensor code; the reference's binding is
pyfeatures.akaze).  No hand-written kernel: the JAX module holds no Pallas
call, and this is its tensor program step for step, batched per image and
per evolution level:

- the separable Gaussian and the dilated Scharr filters are `F.conv2d`
  passes with explicit zero padding (cuDNN's TF32 off, so the card keeps
  FP32 as the CPU does); the 3x3 non-maximum test is `F.max_pool2d`;
- the FED cycle of a level is a loop over its step sizes (the JAX form's
  `lax.scan`), each step one 4-neighbour flux update of the whole level;
- the candidates of a level are one `torch.topk` over its masked response,
  and the orientation and descriptor samples of all of a level's slots are
  one gather and one product each, so the launches of an image depend on
  its size and levels, never on its keypoints.

The host wrapper `extract_akaze_features` pads to a multiple of 128, clamps
the octave count, sizes the slots a level and keeps the strongest
keypoints, as the JAX package's does.  Its documented divergences from the
reference binary (extrema compared within an octave, a 2D quadratic
sub-pixel fit, M-LDB as unpacked 0/1 bytes so squared L2 is Hamming
distance) are the JAX package's, kept.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from opensfm_tpu_torch import resolve_device

N_SUBLEVELS = 4  # AKAZE default nsublevels
SOFFSET = 1.6  # base scale
TAU_MAX = 0.25  # FED stability bound for the 2D explicit scheme
KCONTRAST_NBINS = 300
ORI_BINS = 42  # orientation histogram bins (60-degree window: 8 bins)


# ---------------------------------------------------------------------------
# convolution helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _cached(data: bytes, dtype: str, shape: Tuple[int, ...],
            device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=dtype).reshape(
        shape).copy()).to(device)


def _const(array: np.ndarray, device) -> torch.Tensor:
    """A small host constant (filter taps, sample grids) on `device`,
    copied there once: a copy a call would stall the stream on each."""
    a = np.ascontiguousarray(array)
    return _cached(a.tobytes(), a.dtype.str, a.shape, str(device))


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(int(3.0 * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_axis(x: torch.Tensor, taps: np.ndarray, axis: int,
               dilation: int = 1) -> torch.Tensor:
    """Zero-padded same-size correlation of [H, W] `x` with `taps` along
    `axis` (1: along rows, 0: along columns), taps `dilation` apart."""
    k = _const(np.asarray(taps, dtype=np.float32), x.device).to(x.dtype)
    pad = dilation * ((len(taps) - 1) // 2)
    if axis == 1:
        w, padding, dil = k.view(1, 1, 1, -1), (0, pad), (1, dilation)
    else:
        w, padding, dil = k.view(1, 1, -1, 1), (pad, 0), (dilation, 1)
    return F.conv2d(x[None, None], w, padding=padding, dilation=dil)[0, 0]


def _sep_blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    return _conv_axis(_conv_axis(img, kernel, 1), kernel, 0)


_SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], dtype=np.float32) / 16.0
_SCHARR_DERIV = np.array([-1.0, 0.0, 1.0], dtype=np.float32) / 2.0


def _scharr(img: torch.Tensor, axis: int, dilation: int = 1) -> torch.Tensor:
    """Scharr first derivative along `axis` (1: d/dx, 0: d/dy) with a
    dilated aperture (the reference enlarges the kernel with scale)."""
    kx, ky = ((_SCHARR_DERIV, _SCHARR_SMOOTH) if axis == 1
              else (_SCHARR_SMOOTH, _SCHARR_DERIV))
    return _conv_axis(_conv_axis(img, kx, 1, dilation), ky, 0, dilation)


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


# ---------------------------------------------------------------------------
# nonlinear scale space
# ---------------------------------------------------------------------------


def _fed_tau_schedule(T: float) -> np.ndarray:
    """FED step sizes summing exactly to total diffusion time T."""
    if T <= 0:
        return np.zeros(0, dtype=np.float32)
    n = int(np.ceil(np.sqrt(3.0 * T / TAU_MAX + 0.25) - 0.5 - 1e-8)) + 1
    n = max(n, 1)
    j = np.arange(n, dtype=np.float64)
    tau = TAU_MAX / (2.0 * np.cos(np.pi * (2 * j + 1) / (4 * n + 2)) ** 2)
    return (tau * (T / tau.sum())).astype(np.float32)


def _diffusion_steps(L: torch.Tensor, k2: torch.Tensor, taus: np.ndarray,
                     isotropic: bool) -> torch.Tensor:
    """The FED cycle: explicit 4-neighbour flux steps with the PM-G2
    conductivity computed once per cycle; zero-flux borders.  `k2` is the
    squared contrast factor (a 0-d tensor)."""
    if len(taus) == 0:
        return L
    if isotropic:
        g = torch.ones_like(L)
    else:
        smooth = _sep_blur(L, _gaussian_kernel(1.0))
        lx = _scharr(smooth, axis=1)
        ly = _scharr(smooth, axis=0)
        g = 1.0 / (1.0 + (lx * lx + ly * ly) / k2)
    H, W = L.shape
    col = torch.arange(W, device=L.device)
    row = torch.arange(H, device=L.device)[:, None]
    gxp = torch.where(col == W - 1, 0.0, torch.roll(g, -1, 1) + g)
    gxm = torch.where(col == 0, 0.0, torch.roll(g, 1, 1) + g)
    gyp = torch.where(row == H - 1, 0.0, torch.roll(g, -1, 0) + g)
    gym = torch.where(row == 0, 0.0, torch.roll(g, 1, 0) + g)
    for tau in taus.tolist():  # f32 values: 0.5 * tau is exact in f32
        fxp = gxp * (torch.roll(L, -1, 1) - L)
        fxm = gxm * (L - torch.roll(L, 1, 1))
        fyp = gyp * (torch.roll(L, -1, 0) - L)
        fym = gym * (L - torch.roll(L, 1, 0))
        L = L + (0.5 * tau) * (fxp - fxm + fyp - fym)
    return L


def _kcontrast(image: torch.Tensor, percentile: float) -> torch.Tensor:
    """Contrast factor: the percentile of the gradient-magnitude histogram
    of the sigma=1 smoothed image (a 0-d tensor; no host sync)."""
    smooth = _sep_blur(image, _gaussian_kernel(1.0))
    lx = _scharr(smooth, axis=1)
    ly = _scharr(smooth, axis=0)
    mag = torch.sqrt(lx * lx + ly * ly)
    hmax = mag.max()
    bins = (mag / torch.clamp(hmax, min=1e-12) * KCONTRAST_NBINS).to(
        torch.int32).clamp(0, KCONTRAST_NBINS - 1).reshape(-1).long()
    nonzero = (mag > 1e-12).reshape(-1).to(torch.float64)
    hist = torch.zeros(KCONTRAST_NBINS, dtype=torch.float64,
                       device=image.device).index_add_(0, bins, nonzero)
    csum = torch.cumsum(hist, 0)
    idx = torch.argmax((csum >= percentile * hist.sum()).to(torch.uint8))
    k = (idx.to(image.dtype) + 0.5) / KCONTRAST_NBINS * hmax
    return torch.clamp(k, min=1e-3)


# ---------------------------------------------------------------------------
# descriptor sample grids (host, numpy)
# ---------------------------------------------------------------------------


def _msurf_weights() -> Tuple[np.ndarray, np.ndarray]:
    """M-SURF: 24x24 samples, 4x4 overlapping 9x9 subregions spaced 5
    apart.  Returns (offsets[576, 2] in units of sigma, W[576, 16] the
    subregion Gaussian (sigma=2.5) x the global one (sigma=1.5 on the
    subregion grid))."""
    coords = np.arange(24, dtype=np.float64) - 11.5  # sample centres
    u, v = np.meshgrid(coords, coords, indexing="xy")
    offsets = np.stack([u.reshape(-1), v.reshape(-1)], axis=1)
    centers = np.array([-7.5, -2.5, 2.5, 7.5])
    W = np.zeros((576, 16), dtype=np.float64)
    for a, cu in enumerate(centers):
        for b, cv in enumerate(centers):
            du = offsets[:, 0] - cu
            dv = offsets[:, 1] - cv
            inside = (np.abs(du) <= 4.5) & (np.abs(dv) <= 4.5)
            wsub = np.exp(-(du**2 + dv**2) / (2 * 2.5**2))
            wglob = np.exp(-((cu / 5.0) ** 2 + (cv / 5.0) ** 2)
                           / (2 * 1.5**2))
            W[:, b * 4 + a] = inside * wsub * wglob
    return offsets.astype(np.float32), W.astype(np.float32)


def _mldb_cells() -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """M-LDB: mean-pooling cells of 2x2, 3x3 and 4x4 grids over a 20-sigma
    square sampled 24 x 24, and the cell pairs compared.  Returns
    (offsets[S, 2], cell_assign[S, 29], pairs)."""
    PATT = 10.0
    S = 24
    coords = (np.arange(S) + 0.5) / S * 2 * PATT - PATT
    u, v = np.meshgrid(coords, coords, indexing="xy")
    offsets = np.stack([u.reshape(-1), v.reshape(-1)], axis=1)
    assigns = []
    pairs: List[Tuple[int, int]] = []
    cell_base = 0
    for grid in (2, 3, 4):
        edges = np.linspace(-PATT, PATT, grid + 1)
        iu = np.clip(np.digitize(offsets[:, 0], edges) - 1, 0, grid - 1)
        iv = np.clip(np.digitize(offsets[:, 1], edges) - 1, 0, grid - 1)
        cell = iv * grid + iu
        A = np.zeros((len(offsets), grid * grid), dtype=np.float64)
        A[np.arange(len(offsets)), cell] = 1.0
        A /= np.maximum(A.sum(axis=0, keepdims=True), 1.0)  # mean pooling
        assigns.append(A)
        n = grid * grid
        for i in range(n):
            for j in range(i + 1, n):
                pairs.append((cell_base + i, cell_base + j))
        cell_base += n
    return (offsets.astype(np.float32),
            np.concatenate(assigns, axis=1).astype(np.float32), pairs)


_MSURF_OFFS, _MSURF_W = _msurf_weights()
_MLDB_OFFS, _MLDB_ASSIGN, _MLDB_PAIRS = _mldb_cells()
_MLDB_PI = np.array([p[0] for p in _MLDB_PAIRS], dtype=np.int64)
_MLDB_PJ = np.array([p[1] for p in _MLDB_PAIRS], dtype=np.int64)
# Orientation sampling: a SURF-style circle of radius 6 (sigma units).
_ORI_OFFS = np.array(
    [(x, y) for x in range(-6, 7) for y in range(-6, 7) if x * x + y * y <= 36],
    dtype=np.float32)
_ORI_W = np.exp(-(np.sum(_ORI_OFFS**2, axis=1)) / (2 * 2.5**2)).astype(
    np.float32)


def _bilerp(img2d: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor) -> torch.Tensor:
    H, W = img2d.shape
    y0 = torch.floor(ys).to(torch.int64).clamp(0, H - 2)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, W - 2)
    fy = (ys - y0).clamp(0.0, 1.0)
    fx = (xs - x0).clamp(0.0, 1.0)
    flat = img2d.reshape(-1)
    base = y0 * W + x0
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + W]
    v11 = flat[base + W + 1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def _dominant_orientation(lx_s: torch.Tensor, ly_s: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """SURF's sliding 60-degree window orientation from the gradient
    samples lx_s, ly_s [K, S] of each slot, weighted by w [S]."""
    ang = torch.atan2(ly_s, lx_s)
    b = ((ang + np.pi) / (2 * np.pi) * ORI_BINS).to(torch.int32).clamp(
        0, ORI_BINS - 1).long()
    K = lx_s.shape[0]
    sumx = torch.zeros((K, ORI_BINS), dtype=lx_s.dtype,
                       device=lx_s.device).scatter_add_(1, b, lx_s * w)
    sumy = torch.zeros_like(sumx).scatter_add_(1, b, ly_s * w)
    width = ORI_BINS // 6 + 1  # circular boxcar of consecutive bins
    winx = sum(torch.roll(sumx, -i, 1) for i in range(width))
    winy = sum(torch.roll(sumy, -i, 1) for i in range(width))
    best = torch.argmax(winx * winx + winy * winy, dim=1, keepdim=True)
    return torch.atan2(winy.gather(1, best)[:, 0], winx.gather(1, best)[:, 0])


def _sample_frame(xs, ys, theta, sloc, offsets, device):
    """Sample positions [K, S] of `offsets` (sigma units) rotated by
    theta about each slot, and the slot's cos / sin [K, 1]."""
    offs = _const(offsets, device)
    cos_t = torch.cos(theta)[:, None]
    sin_t = torch.sin(theta)[:, None]
    ru = cos_t * offs[None, :, 0] - sin_t * offs[None, :, 1]
    rv = sin_t * offs[None, :, 0] + cos_t * offs[None, :, 1]
    return ys[:, None] + sloc * rv, xs[:, None] + sloc * ru, cos_t, sin_t


# ---------------------------------------------------------------------------
# main detector
# ---------------------------------------------------------------------------


@torch.no_grad()
def detect_and_describe_akaze(image: torch.Tensor, dthreshold: float,
                              omax: int, k_per_level: int, descriptor: str,
                              isotropic: bool, percentile: float):
    """(points[N, 4] (x, y, size, angle in degrees), desc[N, D], valid[N],
    response[N]) of a [H, W] float32 image in [0, 1] on its device, with
    N = levels x `k_per_level`."""
    dev = image.device
    upright = descriptor.endswith("_UPRIGHT")
    binary = descriptor.startswith("MLDB")
    k = _kcontrast(image, percentile)
    k2 = k * k
    L = _sep_blur(image, _gaussian_kernel(SOFFSET))
    t_prev = 0.5 * SOFFSET**2
    all_pts, all_desc, all_valid, all_resp = [], [], [], []
    for octave in range(omax):
        ratio = 2.0**octave
        if octave > 0:
            L = L[::2, ::2].contiguous()
            k2 = k2 * (0.75**2)  # contrast shrinks with smoothing/decimation
        H, W = L.shape
        if min(H, W) < 32:
            break
        levels = []  # (L, sigma in the octave's pixels)
        for j in range(N_SUBLEVELS):
            sigma = SOFFSET * 2.0 ** (octave + j / N_SUBLEVELS)
            t_cur = 0.5 * sigma**2
            # Diffusion time in the octave's pixels scales by 1 / ratio^2.
            taus = _fed_tau_schedule((t_cur - t_prev) / ratio**2)
            L = _diffusion_steps(L, k2, taus, isotropic)
            t_prev = t_cur
            levels.append((L, sigma / ratio))

        responses, deriv = [], []
        for Lj, sloc in levels:
            d = max(int(round(sloc / 2.0)), 1)  # dilated derivative aperture
            lx = _scharr(Lj, axis=1, dilation=d)
            ly = _scharr(Lj, axis=0, dilation=d)
            lxx = _scharr(lx, axis=1, dilation=d)
            lyy = _scharr(ly, axis=0, dilation=d)
            lxy = _scharr(lx, axis=0, dilation=d)
            responses.append(np.float32(sloc**4) * (lxx * lyy - lxy * lxy))
            deriv.append((lx, ly))

        rows = torch.arange(H, device=dev)[:, None]
        cols = torch.arange(W, device=dev)[None, :]
        for j, (Lj, sloc) in enumerate(levels):
            ldet = responses[j]
            is_max = (ldet >= _maxpool3(ldet)) & (ldet > dthreshold)
            if j > 0:
                is_max &= ldet >= _maxpool3(responses[j - 1])
            if j + 1 < len(responses):
                is_max &= ldet >= _maxpool3(responses[j + 1])
            border = max(int(12 * sloc) + 2, 14)
            inside = ((rows >= border) & (rows < H - border)
                      & (cols >= border) & (cols < W - border))
            resp = torch.where(is_max & inside, ldet, 0.0)
            vals, idx = torch.topk(resp.reshape(-1), k_per_level)
            valid = vals > 0.0

            # 2D quadratic sub-pixel refinement on ldet.
            yi = torch.div(idx, W, rounding_mode="floor").clamp(1, H - 2)
            xi = (idx % W).clamp(1, W - 2)
            ys = torch.div(idx, W, rounding_mode="floor").to(image.dtype)
            xs = (idx % W).to(image.dtype)
            flat = ldet.reshape(-1)

            def at(dy, dx):
                return flat[(yi + dy) * W + xi + dx]

            c = at(0, 0)
            dx_ = 0.5 * (at(0, 1) - at(0, -1))
            dy_ = 0.5 * (at(1, 0) - at(-1, 0))
            dxx = at(0, 1) + at(0, -1) - 2 * c
            dyy = at(1, 0) + at(-1, 0) - 2 * c
            dxy = 0.25 * (at(1, 1) + at(-1, -1) - at(1, -1) - at(-1, 1))
            det = dxx * dyy - dxy * dxy
            ok = torch.abs(det) > 1e-12
            ox = torch.where(ok, -(dyy * dx_ - dxy * dy_) / det, 0.0)
            oy = torch.where(ok, -(dxx * dy_ - dxy * dx_) / det, 0.0)
            xs = xs + ox.clamp(-1.0, 1.0)
            ys = ys + oy.clamp(-1.0, 1.0)

            lx, ly = deriv[j]
            if upright:
                theta = torch.zeros(k_per_level, dtype=image.dtype, device=dev)
            else:
                oys, oxs, _, _ = _sample_frame(
                    xs, ys, torch.zeros_like(xs), sloc, _ORI_OFFS, dev)
                theta = _dominant_orientation(
                    _bilerp(lx, oys, oxs), _bilerp(ly, oys, oxs),
                    _const(_ORI_W, dev))

            if binary:
                sys_, sxs, cos_t, sin_t = _sample_frame(
                    xs, ys, theta, sloc, _MLDB_OFFS, dev)
                li = _bilerp(Lj, sys_, sxs)
                lxi = _bilerp(lx, sys_, sxs)
                lyi = _bilerp(ly, sys_, sxs)
                # Gradients rotated into the keypoint's frame.
                gx = cos_t * lxi + sin_t * lyi
                gy = -sin_t * lxi + cos_t * lyi
                A = _const(_MLDB_ASSIGN, dev)  # [S, 29]
                means = torch.stack([li @ A, gx @ A, gy @ A], dim=-1)
                pi = _const(_MLDB_PI, dev)
                pj = _const(_MLDB_PJ, dev)
                desc = (means[:, pi, :] > means[:, pj, :]).to(
                    image.dtype).reshape(k_per_level, -1)  # [K, 486]
            else:
                sys_, sxs, cos_t, sin_t = _sample_frame(
                    xs, ys, theta, sloc, _MSURF_OFFS, dev)
                lxi = _bilerp(lx, sys_, sxs)
                lyi = _bilerp(ly, sys_, sxs)
                gx = cos_t * lxi + sin_t * lyi
                gy = -sin_t * lxi + cos_t * lyi
                Wm = _const(_MSURF_W, dev)  # [576, 16]
                desc = torch.stack([gx @ Wm, torch.abs(gx) @ Wm, gy @ Wm,
                                    torch.abs(gy) @ Wm],
                                   dim=-1).reshape(k_per_level, 64)
                nrm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
                desc = desc / torch.clamp(nrm, min=1e-12)

            all_pts.append(torch.stack(
                [xs * ratio, ys * ratio,
                 torch.full_like(xs, sloc * ratio), torch.rad2deg(theta)],
                dim=1))
            all_desc.append(desc)
            all_valid.append(valid)
            all_resp.append(vals)
    return (torch.cat(all_pts), torch.cat(all_desc), torch.cat(all_valid),
            torch.cat(all_resp))


def extract_akaze_features(image_gray: np.ndarray, config: Dict,
                           target_features: int, device=None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper (the reference's extract_features_akaze,
    features.py:485-513) on `device` (CUDA unless told otherwise): pad to a
    multiple of 128, clamp the octave count, run the detector, drop the
    invalid slots and keep the strongest `target_features`."""
    dev = resolve_device(device)
    img = np.asarray(image_gray, dtype=np.float32)
    if img.max() > 2.0:
        img = img / 255.0
    H, W = img.shape
    H_pad = ((H + 127) // 128) * 128
    W_pad = ((W + 127) // 128) * 128
    padded = np.zeros((H_pad, W_pad), dtype=np.float32)
    padded[:H, :W] = img

    omax = int(config.get("akaze_omax", 4))
    omax = min(omax, max(int(np.log2(min(H, W) / 64)), 1) + 1)
    descriptor = str(config.get("akaze_descriptor", "MSURF")).upper()
    n_levels = omax * N_SUBLEVELS
    k_per_level = max(int(target_features * 3) // n_levels, 64)

    flags = (torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False)
             if dev.type == "cuda" else contextlib.nullcontext())
    with flags:
        pts, desc, valid, resp = detect_and_describe_akaze(
            torch.as_tensor(padded, device=dev),
            float(config.get("akaze_dthreshold", 0.001)), omax, k_per_level,
            descriptor,
            bool(config.get("akaze_use_isotropic_diffusion", False)),
            float(config.get("akaze_kcontrast_percentile", 0.7)))
    pts, desc = pts.cpu().numpy(), desc.cpu().numpy()
    valid = valid.cpu().numpy() & (pts[:, 0] < W) & (pts[:, 1] < H)
    resp = resp.cpu().numpy()
    pts, desc, resp = pts[valid], desc[valid], resp[valid]
    if len(pts) > target_features > 0:
        keep = np.argsort(-resp)[:target_features]
        pts, desc = pts[keep], desc[keep]
    return pts, desc
