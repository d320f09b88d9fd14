"""Camera models: 10 projection types on NumPy, and a batched torch projection.

Copy of `opensfm_tpu.geometry.cameras`: each model is `affine ∘ distortion ∘
projection`, written once as array code parameterized by the array module
(`numpy` for the host-side `Camera` shell, `torch` for the device).
`project_torch` is the batched torch form of `project` for all ten types,
which the bundle adjuster's generic route differentiates in forward mode;
`bearing(..., xp=torch)` casts rays through any model.

Parameter vector layouts follow the reference's `Camera::types_` ordering
(geometry/src/camera.cc), e.g. perspective = [k1, k2, focal].
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np

# Parameter layout (names per type, in storage order).
PARAMS: Dict[str, Tuple[str, ...]] = {
    "perspective": ("k1", "k2", "focal"),
    "brown": ("k1", "k2", "k3", "p1", "p2", "focal", "aspect_ratio", "cx", "cy"),
    "fisheye": ("k1", "k2", "focal"),
    "fisheye_opencv": ("k1", "k2", "k3", "k4", "focal", "aspect_ratio", "cx", "cy"),
    "fisheye62": (
        "k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2",
        "focal", "aspect_ratio", "cx", "cy",
    ),
    "fisheye624": (
        "k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2", "s0", "s1", "s2", "s3",
        "focal", "aspect_ratio", "cx", "cy",
    ),
    "spherical": (),
    "dual": ("transition", "k1", "k2", "focal"),
    "radial": ("k1", "k2", "focal", "aspect_ratio", "cx", "cy"),
    "simple_radial": ("k1", "focal", "aspect_ratio", "cx", "cy"),
}

PROJECTION_TYPES: List[str] = list(PARAMS.keys())
MAX_PARAMS = max(len(v) for v in PARAMS.values())  # 16 (fisheye624)

_NEWTON_ITERS_RADIAL = 10  # camera_distortions_functions.h Disto2/24/2468
_NEWTON_ITERS_TANGENTIAL = 10
_NEWTON_ITERS_DUAL = 5  # DualProjection::iterations


# ---------------------------------------------------------------------------
# Core projections (3D point in camera frame -> ideal image plane coords)
# ---------------------------------------------------------------------------


def _proj_perspective(xp, point):
    z = point[..., 2:3]
    return point[..., :2] / z


def _bearing_perspective(xp, uv):
    ones = xp.ones_like(uv[..., :1])
    b = xp.concatenate([uv, ones], axis=-1)
    return b / xp.linalg.norm(b, axis=-1, keepdims=True)


def _proj_fisheye(xp, point):
    # theta/r scaling; falls back to perspective at the optical axis.
    x, y = point[..., 0], point[..., 1]
    z = point[..., 2]
    r = xp.sqrt(x * x + y * y)
    theta = xp.arctan2(r, z)
    small = r < 1e-8
    safe_r = xp.where(small, xp.ones_like(r), r)
    s = xp.where(small, 1.0 / xp.where(z == 0, xp.ones_like(z), z), theta / safe_r)
    return xp.stack([x * s, y * s], axis=-1)


def _bearing_fisheye(xp, uv):
    theta = xp.sqrt(xp.sum(uv * uv, axis=-1))
    small = theta < 1e-8
    safe = xp.where(small, xp.ones_like(theta), theta)
    r_div_theta = xp.where(small, xp.ones_like(theta), xp.sin(safe) / safe)
    x = uv[..., 0] * r_div_theta
    y = uv[..., 1] * r_div_theta
    z = xp.cos(theta)
    return xp.stack([x, y, z], axis=-1)


def _proj_spherical(xp, point):
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    lon = xp.arctan2(x, z)
    lat = xp.arctan2(-y, xp.sqrt(x * x + z * z))
    inv = 1.0 / (2.0 * math.pi)
    return xp.stack([lon * inv, -lat * inv], axis=-1)


def _bearing_spherical(xp, uv):
    lon = uv[..., 0] * 2.0 * math.pi
    lat = -uv[..., 1] * 2.0 * math.pi
    return xp.stack(
        [xp.cos(lat) * xp.sin(lon), -xp.sin(lat), xp.cos(lat) * xp.cos(lon)],
        axis=-1,
    )


def _proj_dual(xp, point, transition):
    p = _proj_perspective(xp, point)
    f = _proj_fisheye(xp, point)
    return transition * p + (1.0 - transition) * f


def _bearing_dual(xp, uv, transition):
    # Solve transition*tan(theta) + (1-transition)*theta = r for theta
    # (DualProjection::Backward, with its first-step half-stepping trick).
    r = xp.sqrt(xp.sum(uv * uv, axis=-1))
    theta = xp.zeros_like(r)
    for it in range(_NEWTON_ITERS_DUAL):
        f = transition * xp.tan(theta) + (1.0 - transition) * theta - r
        sec = 1.0 / xp.cos(theta)
        mult = 2.0 if it == 0 else 1.0
        df = mult * (transition * sec * sec - transition + 1.0)
        theta = theta - f / df
    tan_t = xp.tan(theta)
    denom = transition * tan_t + (1.0 - transition) * theta
    denom = xp.where(xp.abs(denom) < 1e-12, xp.ones_like(denom), denom)
    s = tan_t / denom
    x = s * uv[..., 0]
    y = s * uv[..., 1]
    inv_norm = 1.0 / xp.sqrt(x * x + y * y + 1.0)
    return xp.stack([x * inv_norm, y * inv_norm, inv_norm], axis=-1)


# ---------------------------------------------------------------------------
# Distortions (ideal image plane -> distorted image plane)
# ---------------------------------------------------------------------------


def _radial_poly(xp, r2, ks):
    """1 + r2*(k1 + r2*(k2 + ...)) — Horner evaluation for any #coeffs."""
    out = xp.zeros_like(r2)
    for k in reversed(ks):
        out = r2 * (k + out)
    return 1.0 + out


def _radial_poly_deriv_wrt_r(xp, r2, ks):
    """d/d(ru) [ru * poly(ru^2)] where r2 = ru^2: 1 + sum (2i+1) k_i r2^i."""
    out = xp.zeros_like(r2)
    for i in reversed(range(len(ks))):
        out = r2 * out + (2 * i + 3) * ks[i]
    return 1.0 + r2 * out


def _distort_radial(xp, uv, ks):
    r2 = xp.sum(uv * uv, axis=-1, keepdims=True)
    return uv * _radial_poly(xp, r2, ks)


def _undistort_radial(xp, uv, ks):
    """Invert pure-radial distortion via scalar Newton on the radius
    (Disto2/Disto24/Disto2468::Backward semantics, 10 iterations)."""
    rd = xp.sqrt(xp.sum(uv * uv, axis=-1, keepdims=True))
    ru = rd
    for _ in range(_NEWTON_ITERS_RADIAL):
        r2 = ru * ru
        f = ru * _radial_poly(xp, r2, ks) - rd
        df = _radial_poly_deriv_wrt_r(xp, r2, ks)
        ru = ru - f / df
    distortion = _radial_poly(xp, ru * ru, ks)
    return uv / distortion


def _tangential(xp, r2, x, y, p1, p2):
    tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    ty = 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return tx, ty


def _thin_prism(xp, r2, s0, s1, s2, s3):
    return s0 * r2 + s1 * r2 * r2, s2 * r2 + s3 * r2 * r2


def _distort_full(xp, uv, ks, p1, p2, ss=None):
    """Radial + tangential (+ optional thin-prism) distortion."""
    x, y = uv[..., 0], uv[..., 1]
    r2 = x * x + y * y
    radial = _radial_poly(xp, r2, ks)
    tx, ty = _tangential(xp, r2, x, y, p1, p2)
    dx = x * radial + tx
    dy = y * radial + ty
    if ss is not None:
        px, py = _thin_prism(xp, r2, *ss)
        dx = dx + px
        dy = dy + py
    return xp.stack([dx, dy], axis=-1)


def _undistort_full(xp, uv, ks, p1, p2, ss=None):
    """Invert radial+tangential(+prism) distortion with 2D Newton using the
    analytic Jacobian (DistoBrown/Disto62/Disto624::Backward semantics)."""
    ux, uy = uv[..., 0], uv[..., 1]
    tx_, ty_ = uv[..., 0], uv[..., 1]

    n = len(ks)
    for _ in range(_NEWTON_ITERS_TANGENTIAL):
        x, y = ux, uy
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        radial = _radial_poly(xp, r2, ks)
        # dp/dr2 = sum_i (i+1) k_i r2^i
        dp_dr2 = xp.zeros_like(r2)
        for i in reversed(range(n)):
            dp_dr2 = r2 * dp_dr2 + (i + 1) * ks[i]
        tx, ty = _tangential(xp, r2, x, y, p1, p2)
        fx = x * radial + tx
        fy = y * radial + ty
        # Jacobian of the distortion map.
        j00 = radial + x * dp_dr2 * 2.0 * x + 2.0 * y * p1 + 6.0 * p2 * x
        j01 = x * dp_dr2 * 2.0 * y + 2.0 * x * p1 + 2.0 * p2 * y
        j10 = y * dp_dr2 * 2.0 * x + 2.0 * x * p1 + 2.0 * p2 * y
        j11 = radial + y * dp_dr2 * 2.0 * y + 2.0 * x * p2 + 6.0 * p1 * y
        if ss is not None:
            s0, s1, s2, s3 = ss
            px, py = _thin_prism(xp, r2, s0, s1, s2, s3)
            fx = fx + px
            fy = fy + py
            j00 = j00 + (s0 + 2.0 * s1 * r2) * 2.0 * x
            j01 = j01 + (s0 + 2.0 * s1 * r2) * 2.0 * y
            j10 = j10 + (s2 + 2.0 * s3 * r2) * 2.0 * x
            j11 = j11 + (s2 + 2.0 * s3 * r2) * 2.0 * y
        rx = fx - tx_
        ry = fy - ty_
        det = j00 * j11 - j01 * j10
        det = xp.where(xp.abs(det) < 1e-16, xp.ones_like(det), det)
        ux = ux - (j11 * rx - j01 * ry) / det
        uy = uy - (-j10 * rx + j00 * ry) / det
    return xp.stack([ux, uy], axis=-1)


# ---------------------------------------------------------------------------
# Affine (distorted plane -> normalized pixel coords)
# ---------------------------------------------------------------------------


def _affine_fwd(xp, uv, focal, aspect_ratio, cx, cy):
    x = focal * uv[..., 0] + cx
    y = focal * aspect_ratio * uv[..., 1] + cy
    return xp.stack([x, y], axis=-1)


def _affine_bwd(xp, uv, focal, aspect_ratio, cx, cy):
    x = (uv[..., 0] - cx) / focal
    y = (uv[..., 1] - cy) / (focal * aspect_ratio)
    return xp.stack([x, y], axis=-1)


# ---------------------------------------------------------------------------
# Full per-type pipelines
# ---------------------------------------------------------------------------


def project(ptype: str, point, params, xp=np):
    """Camera-frame 3D point(s) -> normalized image coordinates.

    `params` is the flat parameter vector in `PARAMS[ptype]` order; may carry
    leading batch dims matching `point` (params[..., P], point[..., 3]).
    """
    p = lambda name: params[..., PARAMS[ptype].index(name)][..., None]

    if ptype == "perspective":
        uv = _proj_perspective(xp, point)
        uv = _distort_radial(xp, uv, [p("k1"), p("k2")])
        return uv * p("focal")
    if ptype == "brown":
        uv = _proj_perspective(xp, point)
        uv = _distort_full(
            xp, uv,
            [p("k1")[..., 0], p("k2")[..., 0], p("k3")[..., 0]],
            p("p1")[..., 0], p("p2")[..., 0],
        )
        return _affine_fwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
    if ptype == "fisheye":
        uv = _proj_fisheye(xp, point)
        uv = _distort_radial(xp, uv, [p("k1"), p("k2")])
        return uv * p("focal")
    if ptype == "fisheye_opencv":
        uv = _proj_fisheye(xp, point)
        uv = _distort_radial(xp, uv, [p("k1"), p("k2"), p("k3"), p("k4")])
        return _affine_fwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
    if ptype == "fisheye62":
        uv = _proj_fisheye(xp, point)
        uv = _distort_full(
            xp, uv,
            [p(k)[..., 0] for k in ("k1", "k2", "k3", "k4", "k5", "k6")],
            p("p1")[..., 0], p("p2")[..., 0],
        )
        return _affine_fwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
    if ptype == "fisheye624":
        uv = _proj_fisheye(xp, point)
        uv = _distort_full(
            xp, uv,
            [p(k)[..., 0] for k in ("k1", "k2", "k3", "k4", "k5", "k6")],
            p("p1")[..., 0], p("p2")[..., 0],
            ss=tuple(p(s)[..., 0] for s in ("s0", "s1", "s2", "s3")),
        )
        return _affine_fwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
    if ptype == "spherical":
        return _proj_spherical(xp, point)
    if ptype == "dual":
        uv = _proj_dual(xp, point, p("transition"))
        uv = _distort_radial(xp, uv, [p("k1"), p("k2")])
        return uv * p("focal")
    if ptype == "radial":
        uv = _proj_perspective(xp, point)
        uv = _distort_radial(xp, uv, [p("k1"), p("k2")])
        return _affine_fwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
    if ptype == "simple_radial":
        uv = _proj_perspective(xp, point)
        uv = _distort_radial(xp, uv, [p("k1")])
        return _affine_fwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
    raise ValueError(f"Unknown projection type: {ptype}")


def project_torch(ptype: str, point, params):
    """Batched torch `project` for every projection type: camera-frame
    points [..., 3] and parameters [..., P] (in `PARAMS[ptype]` order; wider
    rows are read only at their type's columns) -> normalized image coords
    [..., 2].  Differentiable in forward mode (`torch.func.jvp`, under
    `torch.func.vmap` too): the guarded branches (fisheye's optical axis)
    keep the derivatives finite.  The spherical seam is not wrapped here;
    the bundle adjuster's residual wraps it."""
    import torch

    return project(ptype, point, params, xp=torch)


def bearing(ptype: str, uv, params, xp=np):
    """Normalized image coordinates -> unit bearing vector in camera frame."""
    p = lambda name: params[..., PARAMS[ptype].index(name)][..., None]

    if ptype == "perspective":
        q = uv / p("focal")
        q = _undistort_radial(xp, q, [p("k1"), p("k2")])
        return _bearing_perspective(xp, q)
    if ptype == "brown":
        q = _affine_bwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
        q = _undistort_full(
            xp, q,
            [p(k)[..., 0] for k in ("k1", "k2", "k3")],
            p("p1")[..., 0], p("p2")[..., 0],
        )
        return _bearing_perspective(xp, q)
    if ptype == "fisheye":
        q = uv / p("focal")
        q = _undistort_radial(xp, q, [p("k1"), p("k2")])
        return _bearing_fisheye(xp, q)
    if ptype == "fisheye_opencv":
        q = _affine_bwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
        q = _undistort_radial(xp, q, [p("k1"), p("k2"), p("k3"), p("k4")])
        return _bearing_fisheye(xp, q)
    if ptype == "fisheye62":
        q = _affine_bwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
        q = _undistort_full(
            xp, q,
            [p(k)[..., 0] for k in ("k1", "k2", "k3", "k4", "k5", "k6")],
            p("p1")[..., 0], p("p2")[..., 0],
        )
        return _bearing_fisheye(xp, q)
    if ptype == "fisheye624":
        q = _affine_bwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
        q = _undistort_full(
            xp, q,
            [p(k)[..., 0] for k in ("k1", "k2", "k3", "k4", "k5", "k6")],
            p("p1")[..., 0], p("p2")[..., 0],
            ss=tuple(p(s)[..., 0] for s in ("s0", "s1", "s2", "s3")),
        )
        return _bearing_fisheye(xp, q)
    if ptype == "spherical":
        return _bearing_spherical(xp, uv)
    if ptype == "dual":
        q = uv / p("focal")
        q = _undistort_radial(xp, q, [p("k1"), p("k2")])
        return _bearing_dual(xp, q, p("transition")[..., 0])
    if ptype == "radial":
        q = _affine_bwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
        q = _undistort_radial(xp, q, [p("k1"), p("k2")])
        return _bearing_perspective(xp, q)
    if ptype == "simple_radial":
        q = _affine_bwd(
            xp, uv, p("focal")[..., 0], p("aspect_ratio")[..., 0],
            p("cx")[..., 0], p("cy")[..., 0],
        )
        q = _undistort_radial(xp, q, [p("k1")])
        return _bearing_perspective(xp, q)
    raise ValueError(f"Unknown projection type: {ptype}")


def pad_params(ptype: str, params: np.ndarray) -> np.ndarray:
    """Pad a parameter vector to MAX_PARAMS for batched device kernels."""
    out = np.zeros(MAX_PARAMS, dtype=np.float64)
    out[: len(PARAMS[ptype])] = params
    return out


# ---------------------------------------------------------------------------
# Pixel <-> normalized coordinate conversions (camera.h:89-112)
# ---------------------------------------------------------------------------


def normalized_image_coordinates(pixel_coords, width: int, height: int, xp=np):
    """pt' = (pt - [(w-1)/2, (h-1)/2]) / max(w, h)."""
    size = max(width, height)
    pixel_coords = xp.asarray(pixel_coords)
    cx = (width - 1.0) / 2.0
    cy = (height - 1.0) / 2.0
    return (pixel_coords - xp.asarray([cx, cy], dtype=pixel_coords.dtype)) / size


def denormalized_image_coordinates(norm_coords, width: int, height: int, xp=np):
    """pt = pt' * max(w, h) + [(w-1)/2, (h-1)/2]."""
    size = max(width, height)
    norm_coords = xp.asarray(norm_coords)
    cx = (width - 1.0) / 2.0
    cy = (height - 1.0) / 2.0
    return norm_coords * size + xp.asarray([cx, cy], dtype=norm_coords.dtype)


def normalized_pixel_grid(width: int, height: int, device):
    """Normalized image coordinates [height * width, 2] (f64, row-major)
    of every pixel centre of a width x height image, as torch on
    `device`."""
    import torch

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float64, device=device),
        torch.arange(width, dtype=torch.float64, device=device),
        indexing="ij")
    size = max(width, height)
    return torch.stack([(xs.reshape(-1) - (width - 1.0) / 2.0) / size,
                        (ys.reshape(-1) - (height - 1.0) / 2.0) / size], 1)


# ---------------------------------------------------------------------------
# Host-side Camera shell (mirrors pygeometry.Camera)
# ---------------------------------------------------------------------------


class Camera:
    """User-facing camera object mirroring the reference `pygeometry.Camera`.

    Parameters are exposed both as a flat vector (`parameters`) and as named
    attributes (`camera.focal`, `camera.k1`, ...), as downstream code in the
    reference accesses them both ways.
    """

    def __init__(self, projection_type: str, values) -> None:
        if projection_type not in PARAMS:
            raise ValueError(f"Unknown projection type: {projection_type}")
        object.__setattr__(self, "projection_type", projection_type)
        object.__setattr__(
            self, "_values",
            np.asarray(values, dtype=np.float64).reshape(len(PARAMS[projection_type])),
        )
        object.__setattr__(self, "id", "")
        object.__setattr__(self, "width", 1)
        object.__setattr__(self, "height", 1)

    # -- constructors (pygeometry.Camera.create_*) --------------------------
    @classmethod
    def create_perspective(cls, focal: float, k1: float, k2: float) -> "Camera":
        return cls("perspective", [k1, k2, focal])

    @classmethod
    def create_brown(cls, focal, aspect_ratio, principal_point, distortion) -> "Camera":
        k1, k2, k3, p1, p2 = np.asarray(distortion, dtype=np.float64)
        cx, cy = np.asarray(principal_point, dtype=np.float64)
        return cls("brown", [k1, k2, k3, p1, p2, focal, aspect_ratio, cx, cy])

    @classmethod
    def create_fisheye(cls, focal: float, k1: float, k2: float) -> "Camera":
        return cls("fisheye", [k1, k2, focal])

    @classmethod
    def create_fisheye_opencv(
        cls, focal, aspect_ratio, principal_point, distortion
    ) -> "Camera":
        k1, k2, k3, k4 = np.asarray(distortion, dtype=np.float64)
        cx, cy = np.asarray(principal_point, dtype=np.float64)
        return cls("fisheye_opencv", [k1, k2, k3, k4, focal, aspect_ratio, cx, cy])

    @classmethod
    def create_fisheye62(
        cls, focal, aspect_ratio, principal_point, distortion
    ) -> "Camera":
        d = np.asarray(distortion, dtype=np.float64)
        cx, cy = np.asarray(principal_point, dtype=np.float64)
        return cls("fisheye62", list(d) + [focal, aspect_ratio, cx, cy])

    @classmethod
    def create_fisheye624(
        cls, focal, aspect_ratio, principal_point, distortion
    ) -> "Camera":
        d = np.asarray(distortion, dtype=np.float64)
        cx, cy = np.asarray(principal_point, dtype=np.float64)
        return cls("fisheye624", list(d) + [focal, aspect_ratio, cx, cy])

    @classmethod
    def create_dual(cls, transition, focal, k1, k2) -> "Camera":
        return cls("dual", [transition, k1, k2, focal])

    @classmethod
    def create_spherical(cls) -> "Camera":
        return cls("spherical", [])

    @classmethod
    def create_radial(cls, focal, aspect_ratio, principal_point, distortion) -> "Camera":
        k1, k2 = np.asarray(distortion, dtype=np.float64)
        cx, cy = np.asarray(principal_point, dtype=np.float64)
        return cls("radial", [k1, k2, focal, aspect_ratio, cx, cy])

    @classmethod
    def create_simple_radial(
        cls, focal, aspect_ratio, principal_point, k1
    ) -> "Camera":
        cx, cy = np.asarray(principal_point, dtype=np.float64)
        return cls("simple_radial", [k1, focal, aspect_ratio, cx, cy])

    # -- named parameter access ---------------------------------------------
    def __getattr__(self, name: str):
        layout = PARAMS[object.__getattribute__(self, "projection_type")]
        if name in layout:
            return float(object.__getattribute__(self, "_values")[layout.index(name)])
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        layout = PARAMS.get(self.projection_type, ())
        if name in layout:
            self._values[layout.index(name)] = value
        else:
            object.__setattr__(self, name, value)

    @property
    def parameters(self) -> np.ndarray:
        return self._values

    def get_parameters_values(self) -> np.ndarray:
        return self._values.copy()

    def set_parameters_values(self, values) -> None:
        self._values[:] = np.asarray(values, dtype=np.float64)

    def get_parameters_types(self) -> Tuple[str, ...]:
        return PARAMS[self.projection_type]

    def get_parameters_map(self) -> Dict[str, float]:
        return dict(zip(PARAMS[self.projection_type], self._values.tolist()))

    # -- projection ----------------------------------------------------------
    def project(self, point) -> np.ndarray:
        """3D point in camera coordinates -> normalized image coords."""
        return np.asarray(
            project(self.projection_type, np.asarray(point, dtype=np.float64),
                    self._values, xp=np)
        )

    def project_many(self, points) -> np.ndarray:
        return self.project(points)

    def bearing(self, point) -> np.ndarray:
        """Normalized image coords -> unit bearing in camera frame."""
        return np.asarray(
            bearing(self.projection_type, np.asarray(point, dtype=np.float64),
                    self._values, xp=np)
        )

    def bearings(self, points) -> np.ndarray:
        return self.bearing(points)

    def bearings_many(self, points) -> np.ndarray:
        return self.bearing(points)

    def project_many_torch(self, points):
        """`project_many` on a torch tensor [..., 3], on its device and in
        its dtype."""
        import torch

        params = torch.as_tensor(self._values, dtype=points.dtype,
                                 device=points.device)
        return project(self.projection_type, points, params, xp=torch)

    def bearings_many_torch(self, points):
        """`bearings_many` on a torch tensor [..., 2], on its device and in
        its dtype."""
        import torch

        params = torch.as_tensor(self._values, dtype=points.dtype,
                                 device=points.device)
        return bearing(self.projection_type, points, params, xp=torch)

    # -- pixel <-> normalized -----------------------------------------------
    def pixel_to_normalized_coordinates(self, px_coord) -> np.ndarray:
        return normalized_image_coordinates(px_coord, self.width, self.height)

    def pixel_to_normalized_coordinates_many(self, px_coords) -> np.ndarray:
        return normalized_image_coordinates(px_coords, self.width, self.height)

    def normalized_to_pixel_coordinates(self, norm_coord) -> np.ndarray:
        return denormalized_image_coordinates(norm_coord, self.width, self.height)

    def normalized_to_pixel_coordinates_many(self, norm_coords) -> np.ndarray:
        return denormalized_image_coordinates(norm_coords, self.width, self.height)

    # -- K matrices ----------------------------------------------------------
    def get_K(self) -> np.ndarray:
        """3x3 calibration matrix in normalized coordinates."""
        layout = PARAMS[self.projection_type]
        focal = self._values[layout.index("focal")] if "focal" in layout else 1.0
        ar = (
            self._values[layout.index("aspect_ratio")]
            if "aspect_ratio" in layout
            else 1.0
        )
        cx = self._values[layout.index("cx")] if "cx" in layout else 0.0
        cy = self._values[layout.index("cy")] if "cy" in layout else 0.0
        return np.array([[focal, 0.0, cx], [0.0, focal * ar, cy], [0.0, 0.0, 1.0]])

    def get_K_in_pixel_coordinates(
        self, width: int = -1, height: int = -1
    ) -> np.ndarray:
        w = width if width > 0 else self.width
        h = height if height > 0 else self.height
        size = max(w, h)
        K = self.get_K()
        S = np.array(
            [[size, 0.0, (w - 1.0) / 2.0], [0.0, size, (h - 1.0) / 2.0], [0.0, 0.0, 1.0]]
        )
        return S @ K

    # -- misc ----------------------------------------------------------------
    def is_panorama(self) -> bool:
        return self.projection_type in ("spherical", "equirectangular")

    def copy(self) -> "Camera":
        cam = Camera(self.projection_type, self._values.copy())
        cam.id = self.id
        cam.width = self.width
        cam.height = self.height
        return cam

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, Camera)
            and self.projection_type == o.projection_type
            and self.id == o.id
            and self.width == o.width
            and self.height == o.height
            and np.allclose(self._values, o._values)
        )

    def __repr__(self) -> str:
        return (
            f"Camera({self.projection_type!r}, id={self.id!r}, "
            f"{self.width}x{self.height}, {self.get_parameters_map()})"
        )
