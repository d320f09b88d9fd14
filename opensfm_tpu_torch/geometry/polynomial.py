"""Batched polynomial root finding (Durand-Kerner / Weierstrass iteration).

Port of `opensfm_tpu.geometry.polynomial`: the same seeds, radius, fixed
iteration count and split real/imaginary arithmetic, so the roots agree with
the reference's to rounding.  The iteration is a loop of small elementwise
ops over a batch of polynomials (on the card, one launch per op).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate sum coeffs[i] * x^(D-i) (highest coefficient first) by
    Horner's rule: coeffs [..., D+1], x [..., K]."""
    out = torch.zeros_like(x) + coeffs[..., 0:1]
    for i in range(1, coeffs.shape[-1]):
        out = out * x + coeffs[..., i:i + 1]
    return out


def _polyval_ri(cr, ci, xr, xi):
    """Horner evaluation with split re/im: coeffs [..., D+1], x [..., D]."""
    outr = torch.zeros_like(xr) + cr[..., 0:1]
    outi = torch.zeros_like(xi) + ci[..., 0:1]
    for i in range(1, cr.shape[-1]):
        nr = outr * xr - outi * xi + cr[..., i:i + 1]
        ni = outr * xi + outi * xr + ci[..., i:i + 1]
        outr, outi = nr, ni
    return outr, outi


def roots_ri(coeffs: torch.Tensor, iterations: int = 60
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All roots of real polynomial(s), highest coefficient first, as a
    (real[..., D], imag[..., D]) pair of real tensors."""
    degree = coeffs.shape[-1] - 1
    lead = coeffs[..., 0:1]
    lead = torch.where(torch.abs(lead) < 1e-30,
                       torch.full_like(lead, 1e-30), lead)
    cr = coeffs / lead  # monic, [..., D+1]
    ci = torch.zeros_like(cr)

    # Scale roots to O(1): Cauchy-style radius from coefficient magnitudes.
    radius = 1.0 + torch.amax(torch.abs(cr[..., 1:]), dim=-1, keepdim=True)

    # Standard non-real seed angles (avoids symmetry stalls): (0.4+0.9i)^k.
    k = np.arange(1, degree + 1)
    ang = np.arctan2(0.9, 0.4) * k
    mag = (0.4 ** 2 + 0.9 ** 2) ** (0.5 * k)
    kw = dict(dtype=coeffs.dtype, device=coeffs.device)
    seedr = torch.as_tensor(mag * np.cos(ang), **kw)
    seedi = torch.as_tensor(mag * np.sin(ang), **kw)
    shape = coeffs.shape[:-1] + (degree,)
    zr = seedr.expand(shape) * radius
    zi = seedi.expand(shape) * radius

    eye = torch.eye(degree, **kw)
    for _ in range(iterations):
        pr, pi = _polyval_ri(cr, ci, zr, zi)
        # denom_i = prod_{j != i} (z_i - z_j); the eye kills diagonal zeros.
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        qr = dr[..., 0]
        qi = di[..., 0]
        for j in range(1, degree):
            nr = qr * dr[..., j] - qi * di[..., j]
            ni = qr * di[..., j] + qi * dr[..., j]
            qr, qi = nr, ni
        mag2 = torch.clamp_min(qr * qr + qi * qi, 1e-60)
        # z - p/q  with  p/q = p * conj(q) / |q|^2
        stepr = (pr * qr + pi * qi) / mag2
        stepi = (pi * qr - pr * qi) / mag2
        zr, zi = zr - stepr, zi - stepi
    return zr, zi


def roots(coeffs: torch.Tensor, iterations: int = 60) -> torch.Tensor:
    """All (complex) roots of polynomial(s), highest coefficient first:
    coeffs [..., D+1] real -> [..., D] complex (`roots_ri` as one complex
    tensor)."""
    zr, zi = roots_ri(coeffs, iterations)
    return torch.complex(zr, zi)


def real_roots(coeffs: torch.Tensor, iterations: int = 60,
               imag_tol: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(roots_real[..., D], is_real[..., D]) — real parts + realness mask."""
    zr, zi = roots_ri(coeffs, iterations)
    scale = 1.0 + torch.sqrt(zr * zr + zi * zi)
    is_real = torch.abs(zi) <= imag_tol * scale
    return zr, is_real
