"""Scale-space detectors (DoG + multi-scale Hessian) and SIFT-class
descriptors in PyTorch.

Port of `opensfm_tpu.ops.features` (the reference's VLFeat HAHOG,
pyfeatures.hahog, features/src/hahog.cc:1-206, rebuilt as dense tensor
code): the scale space is built with separable Gaussian filters, extrema
detection is a 3x3x3 max/min pool, and each keypoint's orientation and
descriptor come from dense soft-binned gradient fields gathered at 16 cell
centres, with fixed top-K keypoints per octave and scale, so every image of
a processing size runs the same shapes.  No hand-written kernel: the JAX
module holds no Pallas call, and this is its tensor program, step for step:

- the separable filters are zero-padded sums of shifted slices in tap
  order (`_conv1d`), not convolutions, so the CPU and the card sum the
  same terms in the same order as the JAX package;
- the 2x upsample is the half-pixel-centre linear resize
  `jax.image.resize` does (and `F.interpolate(bilinear,
  align_corners=False)`), written out as products and sums that round
  alike on every device (`_upsample2`);
- the candidate selection is `torch.topk`, where the JAX package calls
  `approx_max_k`, which is exact off the TPU;
- the descriptor planes are cast to bfloat16 at the same point, and
  `remainder` is fmod plus the divisor's sign fix, as `jnp.remainder`.

Detectors: ``detector="hessian"`` is the scale-normalised determinant of
the Hessian (VL_COVDET_METHOD_HESSIAN, hahog.cc:139, HAHOG) and
``detector="dog"`` the classic SIFT DoG; ``n_orientations=2`` adds a second
oriented copy where a secondary histogram peak reaches 80% of the dominant
one (hahog.cc:92-122); locations are refined by a 2x2 Newton step.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from opensfm_tpu_torch import resolve_device

N_SCALES = 3  # scales per octave where extrema are detected
PATCH = 16  # descriptor patch size (octave pixels)
N_ORI_BINS = 36
DESC_SPATIAL = 4
DESC_ORI = 8
SECOND_PEAK_RATIO = 0.8  # VLFeat's threshold for secondary orientations


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(x: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """Zero-padded same-size 1D correlation along `dim`, as a chain of
    shifted-slice products summed in tap order, as
    `opensfm_tpu.ops.features._conv1d`: one rounding per product and per
    sum (XLA's CPU build fuses some into multiply-adds, so the JAX package's
    sums differ from these by an ulp at a few per cent of the pixels)."""
    k = np.asarray(kernel)
    r = (len(k) - 1) // 2
    pad = [0, 0] * x.dim()
    pad[2 * (x.dim() - 1 - dim)] = r
    pad[2 * (x.dim() - 1 - dim) + 1] = r
    xp = F.pad(x, pad)
    L = x.shape[dim]
    out = None
    for i, t in enumerate(k.tolist()):
        term = xp.narrow(dim, i, L) * torch.tensor(t, dtype=x.dtype,
                                                   device=x.device)
        out = term if out is None else out + term
    return out


def _sep_blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] via two 1D passes."""
    return _conv1d(_conv1d(img, kernel, 1), kernel, 0)


def _sep_blur_batch(x: torch.Tensor, ky: np.ndarray,
                    kx: np.ndarray) -> torch.Tensor:
    """Separable filter of [C, H, W] with per-axis 1D kernels."""
    return _conv1d(_conv1d(x, kx, 2), ky, 1)


def _shift_reduce3(x: torch.Tensor, op, fill: float) -> torch.Tensor:
    """3x3 window reduction via shifted slices."""
    out = x
    for dim in (0, 1):
        pad = [0, 0, 1, 1] if dim == 0 else [1, 1, 0, 0]
        xp = F.pad(out, pad, value=fill)
        L = x.shape[dim]
        out = op(op(xp.narrow(dim, 0, L), xp.narrow(dim, 1, L)),
                 xp.narrow(dim, 2, L))
    return out


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    return _shift_reduce3(x, torch.maximum, -math.inf)


def _minpool3(x: torch.Tensor) -> torch.Tensor:
    return _shift_reduce3(x, torch.minimum, math.inf)


def _hessian_maps(g: torch.Tensor):
    """Second-difference Hessian component maps (dxx, dyy, dxy), with the
    wrap-around of `jnp.roll`."""
    dxx = torch.roll(g, -1, 1) + torch.roll(g, 1, 1) - 2 * g
    dyy = torch.roll(g, -1, 0) + torch.roll(g, 1, 0) - 2 * g
    dxy = 0.25 * (
        torch.roll(g, (-1, -1), (0, 1))
        + torch.roll(g, (1, 1), (0, 1))
        - torch.roll(g, (-1, 1), (0, 1))
        - torch.roll(g, (1, -1), (0, 1))
    )
    return dxx, dyy, dxy


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x linear resize with half-pixel centres, edges clamped (what
    `jax.image.resize(..., "linear", antialias=False)` and
    `F.interpolate(bilinear, align_corners=False)` compute at 2x), one axis
    after the other as explicit products and sums: out[2i] = 0.25 x[i-1] +
    0.75 x[i], out[2i+1] = 0.75 x[i] + 0.25 x[i+1].  Every device rounds
    these alike, so the CPU and the card detect at the same positions."""
    for dim in (0, 1):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)],
                        dim)
        even = 0.25 * prev + 0.75 * x
        odd = 0.75 * x + 0.25 * nxt
        x = torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)
    return x


def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.gradient` along `dim` at unit spacing: central differences
    inside, one-sided at the two edges."""
    n = a.shape[dim]
    upper = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    lower = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim=dim)


def _remainder(x: torch.Tensor, y: float) -> torch.Tensor:
    """`jnp.remainder` for a positive divisor: fmod, plus y where negative."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def detect_and_describe(
    image: torch.Tensor,  # [H, W] grayscale: uint8 or float32 in [0, 1]
    peak_threshold: float,
    k_per_octave: int,
    n_octaves: int,
    edge_threshold: float = 10.0,
    upsample: bool = False,
    root_uchar: bool = False,
    detector: str = "dog",
    n_orientations: int = 1,
):
    """Detect scale-space keypoints and compute 128-d descriptors on the
    image's device.

    Returns (points[N, 4] (x_px, y_px, size_px, angle_deg in full-image
    pixel coords), descriptors[N, 128], valid[N]) with
    N = (k_per_octave // 3) * 3 * n_octaves * n_orientations, as
    `opensfm_tpu.ops.features.detect_and_describe`.  `upsample` doubles
    the image first (the SIFT -1 octave); `root_uchar` applies RootSIFT and
    the x362 uchar quantization and returns uint8 descriptors."""
    if detector not in ("dog", "hessian"):
        raise ValueError(f"unknown detector {detector!r}")
    if image.dtype == torch.uint8:
        # A tensor divisor: CUDA divides by a host scalar as a product with
        # its reciprocal, which rounds some pixels otherwise than the CPU.
        image = image.to(torch.float32) / torch.tensor(
            255.0, device=image.device)
    if upsample:
        image = _upsample2(image)
    dtype, dev = image.dtype, image.device
    sigma0 = 1.6
    k_step = 2.0 ** (1.0 / N_SCALES)
    base = _sep_blur(image, _gaussian_kernel(sigma0, 4))

    all_pts, all_desc, all_valid = [], [], []
    centers = torch.tensor(
        (np.arange(DESC_ORI) + 0.5) / DESC_ORI * 2 * np.pi - np.pi,
        dtype=torch.float32, device=dev).to(dtype)
    obins = torch.arange(DESC_ORI, device=dev)
    binw = 2 * np.pi / DESC_ORI

    octave_img = base
    for octave in range(n_octaves):
        H, W = octave_img.shape
        gauss = [octave_img]
        sig_prev = sigma0
        for s in range(1, N_SCALES + 3):
            sig_total = sigma0 * (k_step**s)
            sig_extra = float(np.sqrt(max(sig_total**2 - sig_prev**2, 1e-6)))
            radius = max(int(3.0 * sig_extra + 0.5), 1)
            gauss.append(_sep_blur(gauss[-1],
                                   _gaussian_kernel(sig_extra, radius)))
            sig_prev = sig_total

        if detector == "dog":
            resp = [gauss[i + 1] - gauss[i] for i in range(N_SCALES + 2)]
        else:
            resp = []
            for i in range(N_SCALES + 2):
                sig = sigma0 * (k_step**i)
                dxx, dyy, dxy = _hessian_maps(gauss[i])
                resp.append((sig**4) * (dxx * dyy - dxy * dxy))

        border = PATCH // 2 + 1
        inside = torch.zeros((H, W), dtype=torch.bool, device=dev)
        inside[border:H - border, border:W - border] = True
        for s in range(1, N_SCALES + 1):
            d_prev, d_cur, d_next = resp[s - 1], resp[s], resp[s + 1]
            mx = torch.maximum(torch.maximum(_maxpool3(d_prev),
                                             _maxpool3(d_next)),
                               _maxpool3(d_cur))
            mn = torch.minimum(torch.minimum(_minpool3(d_prev),
                                             _minpool3(d_next)),
                               _minpool3(d_cur))
            is_max = (d_cur >= mx) & (d_cur > peak_threshold)
            is_min = (d_cur <= mn) & (d_cur < -peak_threshold)

            # Edge (ridge) rejection: curvature ratio of the response.
            dxx, dyy, dxy = _hessian_maps(d_cur)
            tr = dxx + dyy
            det = dxx * dyy - dxy * dxy
            r = edge_threshold
            edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

            candidate = (is_max | is_min) & edge_ok & inside
            response = torch.where(candidate, torch.abs(d_cur),
                                   torch.zeros((), dtype=dtype, device=dev))
            k_scale = max(k_per_octave // N_SCALES, 1)
            vals, idx = torch.topk(response.reshape(-1), k_scale)
            ys = idx // W
            xs = idx % W
            valid = vals > 0.0

            # Subpixel refinement: a Newton step on the response surface
            # from the 9-tap neighbourhood (dead slots clamped inside).
            flat = d_cur.reshape(-1)
            base_i = ys.clamp(1, H - 2) * W + xs.clamp(1, W - 2)
            offsets = torch.tensor([dy * W + dx for dy in (-1, 0, 1)
                                    for dx in (-1, 0, 1)], device=dev)
            taps = flat[(base_i[:, None] + offsets[None]).reshape(-1)] \
                .reshape(-1, 3, 3)

            def tap(dy, dx):
                return taps[:, dy + 1, dx + 1]

            c = tap(0, 0)
            gx_k = 0.5 * (tap(0, 1) - tap(0, -1))
            gy_k = 0.5 * (tap(1, 0) - tap(-1, 0))
            hxx = tap(0, 1) + tap(0, -1) - 2 * c
            hyy = tap(1, 0) + tap(-1, 0) - 2 * c
            hxy = 0.25 * (tap(1, 1) + tap(-1, -1) - tap(1, -1) - tap(-1, 1))
            det_h = hxx * hyy - hxy * hxy
            inv_ok = torch.abs(det_h) > 1e-20
            det_safe = torch.where(inv_ok, det_h, torch.ones_like(det_h))
            zero = torch.zeros_like(det_h)
            off_x = torch.where(inv_ok, -(hyy * gx_k - hxy * gy_k) / det_safe,
                                zero).clamp(-0.6, 0.6)
            off_y = torch.where(inv_ok, -(hxx * gy_k - hxy * gx_k) / det_safe,
                                zero).clamp(-0.6, 0.6)
            xs_sub = xs.to(dtype) + off_x
            ys_sub = ys.to(dtype) + off_y

            # Dense descriptor fields: soft-orientation-binned gradient
            # planes, smoothed by the descriptor-cell tent, gathered at 16
            # cell centres per keypoint.
            m_s = float(k_step ** (s - 1))
            g = gauss[s]
            gx = _gradient(g, 1)
            gy = _gradient(g, 0)
            mag = torch.sqrt(gx * gx + gy * gy)
            ori = torch.atan2(gy, gx)
            dang = ori[None] - centers[:, None, None]
            dang = _remainder(dang + math.pi, 2 * math.pi) - math.pi
            B = (mag[None] * torch.clamp_min(
                1.0 - torch.abs(dang) / binw, 0.0)).to(torch.bfloat16)

            cell = PATCH / DESC_SPATIAL * m_s
            r_cell = max(int(np.ceil(cell)) - 1, 1)
            ktaps = np.arange(-r_cell, r_cell + 1, dtype=np.float64)
            k_cell = np.maximum(0.0, 1.0 - np.abs(ktaps) / cell) \
                .astype(np.float32)
            Cfield = _sep_blur_batch(B, k_cell, k_cell).to(dtype)  # [8, H, W]

            grid = ((np.arange(DESC_SPATIAL) - (DESC_SPATIAL - 1) / 2.0)
                    * PATCH / DESC_SPATIAL * m_s)
            grid_t = torch.tensor(grid, dtype=torch.float32,
                                  device=dev).to(dtype)
            gy_c = torch.round(ys.to(dtype)[:, None] + grid_t[None]) \
                .to(torch.int64).clamp(0, H - 1)
            gx_c = torch.round(xs.to(dtype)[:, None] + grid_t[None]) \
                .to(torch.int64).clamp(0, W - 1)
            flat_idx = (obins[None, None, None, :] * (H * W)
                        + (gy_c[:, :, None] * W + gx_c[:, None, :])[..., None])
            cells = Cfield.reshape(-1)[flat_idx.reshape(-1)] \
                .reshape(flat_idx.shape)  # [K, 4, 4, 8]

            wcell = np.exp(-0.5 * (grid / m_s) ** 2 / (0.5 * PATCH) ** 2) \
                .astype(np.float32)
            w2d = torch.tensor(np.outer(wcell, wcell), device=dev).to(dtype)
            cells = cells * w2d[None, :, :, None]
            hist8 = cells.sum(dim=(1, 2))  # [K, 8]

            def peak_theta(hist, hb):
                """Parabolic-refined angle of histogram bin hb."""
                hprev = torch.gather(hist, 1, ((hb - 1) % DESC_ORI)[:, None])[:, 0]
                hnext = torch.gather(hist, 1, ((hb + 1) % DESC_ORI)[:, None])[:, 0]
                hmax = torch.gather(hist, 1, hb[:, None])[:, 0]
                denom = hprev - 2 * hmax + hnext
                frac = torch.where(torch.abs(denom) > 1e-12,
                                   0.5 * (hprev - hnext) / denom,
                                   torch.zeros_like(denom)).clamp(-0.5, 0.5)
                return ((hb.to(dtype) + 0.5 + frac) / DESC_ORI * 2 * math.pi
                        - math.pi), hmax

            flat_cells = cells.reshape(-1, DESC_SPATIAL * DESC_SPATIAL,
                                       DESC_ORI)

            def oriented_descriptor(theta):
                """Orientation bins rotated to theta (a fractional circular
                shift), then SIFT's L2 / clip 0.2 / L2 normalisation."""
                shift = (theta + math.pi) / (2 * math.pi) * DESC_ORI - 0.5
                s0 = torch.floor(shift).to(torch.int64)
                sf = (shift - s0.to(dtype))[:, None, None]
                idx0 = (obins[None] + s0[:, None]) % DESC_ORI  # [K, 8]
                idx1 = (idx0 + 1) % DESC_ORI
                n_cells = DESC_SPATIAL * DESC_SPATIAL
                g0 = torch.gather(flat_cells, 2,
                                  idx0[:, None, :].expand(-1, n_cells, -1))
                g1 = torch.gather(flat_cells, 2,
                                  idx1[:, None, :].expand(-1, n_cells, -1))
                desc = ((1 - sf) * g0 + sf * g1).reshape(-1, 128)
                norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
                desc = desc / torch.clamp_min(norm, 1e-12)
                desc = torch.clamp_max(desc, 0.2)
                norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
                return desc / torch.clamp_min(norm, 1e-12)

            hb1 = torch.argmax(hist8, dim=1)
            theta1, hmax1 = peak_theta(hist8, hb1)
            scale_px = sigma0 * (k_step**s) * (2.0**octave) * 2.0

            def keypoint_rows(theta):
                return torch.stack([
                    xs_sub * (2.0**octave), ys_sub * (2.0**octave),
                    torch.full(xs.shape, scale_px, dtype=dtype, device=dev),
                    torch.rad2deg(theta)], dim=1)

            all_pts.append(keypoint_rows(theta1))
            all_desc.append(oriented_descriptor(theta1))
            all_valid.append(valid)

            if n_orientations >= 2:
                # Secondary orientation: the best non-adjacent bin, kept
                # when its peak reaches SECOND_PEAK_RATIO of the dominant.
                adj = torch.stack([(hb1 - 1) % DESC_ORI, hb1,
                                   (hb1 + 1) % DESC_ORI], dim=1)
                is_adj = (obins[None, :, None] == adj[:, None, :]).any(dim=2)
                masked = torch.where(
                    is_adj, torch.full((), -math.inf, dtype=dtype, device=dev),
                    hist8)
                hb2 = torch.argmax(masked, dim=1)
                theta2, hmax2 = peak_theta(hist8, hb2)
                valid2 = valid & (hmax2 > SECOND_PEAK_RATIO * hmax1)
                all_pts.append(keypoint_rows(theta2))
                all_desc.append(oriented_descriptor(theta2))
                all_valid.append(valid2)

        # Next octave: downsample the 2x-blurred level.
        octave_img = gauss[N_SCALES][::2, ::2]

    desc_all = torch.cat(all_desc)
    if root_uchar:
        # RootSIFT + x362 uchar quantization (reference
        # extract_features_hahog, features.py:526-534).
        desc_all = torch.sqrt(torch.clamp_min(desc_all, 0.0))
        desc_all = torch.round(torch.clamp(desc_all * 362.0, 0.0, 255.0)) \
            .to(torch.uint8)
    return torch.cat(all_pts), desc_all, torch.cat(all_valid)


def detector_shapes(H0: int, W0: int, upsample: bool,
                    target_features: int) -> Tuple[int, int, int, int]:
    """(padded height, padded width, n_octaves, k_per_octave) of an
    H0 x W0 image, as the JAX package's host wrapper derives them: the base
    image padded to multiples of 64 (upsampled) or 128, the octaves and the
    candidate budget from the (doubled) unpadded size."""
    factor = 2 if upsample else 1
    mult = 64 if upsample else 128
    H_pad = ((H0 + mult - 1) // mult) * mult
    W_pad = ((W0 + mult - 1) // mult) * mult
    H, W = H0 * factor, W0 * factor
    n_octaves = min(max(int(np.log2(min(H, W) / 32)), 1), 6)
    # The budget is a minimum (the anneal loop stops once count >= budget),
    # and orientation copies come on top of the spatial slots.
    k_per_octave = int(target_features * 3 // n_octaves)
    return H_pad, W_pad, n_octaves, k_per_octave


def extract_dog_features(
    image_gray: np.ndarray,
    peak_threshold: float = 0.01,
    target_features: int = 4000,
    upsample: bool = True,
    root_uchar: bool = False,
    detector: str = "dog",
    n_orientations: int = 1,
    edge_threshold: float = 10.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host wrapper: pad to a static bucket, run the detector on `device`
    (CUDA unless told otherwise), strip invalid keypoints.  Returns
    (points[N, 4] pixel coords, desc[N, 128]; uint8 descriptors when
    `root_uchar`).  The image goes up as uint8 and the valid rows come
    down."""
    dev = resolve_device(device)
    img = np.asarray(image_gray)
    if img.dtype != np.uint8:
        scale = 255.0 if img.max() <= 2.0 else 1.0
        img = np.clip(img * scale, 0, 255).astype(np.uint8)
    H0, W0 = img.shape
    factor = 2.0 if upsample else 1.0
    H_pad, W_pad, n_octaves, k_per_octave = detector_shapes(
        H0, W0, upsample, target_features)
    padded = np.zeros((H_pad, W_pad), dtype=np.uint8)
    padded[:H0, :W0] = img
    H, W = int(H0 * factor), int(W0 * factor)

    pts, desc, valid = detect_and_describe(
        torch.from_numpy(padded).to(dev), float(peak_threshold),
        k_per_octave, n_octaves, edge_threshold=float(edge_threshold),
        upsample=upsample, root_uchar=root_uchar, detector=detector,
        n_orientations=n_orientations,
    )
    # Drop padding-area detections and invalid slots; undo the upsampling.
    keep = valid & (pts[:, 0] < W) & (pts[:, 1] < H)
    pts = pts[keep].cpu().numpy()
    desc = desc[keep].cpu().numpy()
    pts[:, :3] = pts[:, :3] / factor
    return pts, desc
