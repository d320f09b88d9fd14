"""WGS84 geodesy: ECEF / LLA / topocentric conversions.

Host-side, float64 NumPy (geodetic math needs doubles; it is never a hot
loop).  API mirrors the reference `opensfm/geo.py:14-316` and the C++
`geo/geo.h:1-50` so downstream code (alignment, pair selection, submodels)
reads identically.  All functions broadcast over arrays.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

WGS84_A = 6378137.0  # semi-major axis
WGS84_B = 6356752.314245  # semi-minor axis

ArrayLike = Union[float, np.ndarray]


def ecef_from_lla(lat: ArrayLike, lon: ArrayLike, alt: ArrayLike):
    """Geodetic lat/lon/alt (deg, m) -> ECEF x/y/z (m)."""
    a2 = WGS84_A**2
    b2 = WGS84_B**2
    lat = np.radians(lat)
    lon = np.radians(lon)
    l_ = 1.0 / np.sqrt(a2 * np.cos(lat) ** 2 + b2 * np.sin(lat) ** 2)
    x = (a2 * l_ + alt) * np.cos(lat) * np.cos(lon)
    y = (a2 * l_ + alt) * np.cos(lat) * np.sin(lon)
    z = (b2 * l_ + alt) * np.sin(lat)
    return x, y, z


def lla_from_ecef(x: ArrayLike, y: ArrayLike, z: ArrayLike):
    """ECEF x/y/z (m) -> geodetic lat/lon/alt (deg, m).

    Closed-form (Vermeille-style) solution, no iteration.
    """
    a = WGS84_A
    b = WGS84_B
    ea = np.sqrt((a**2 - b**2) / a**2)
    eb = np.sqrt((a**2 - b**2) / b**2)
    p = np.sqrt(x**2 + y**2)
    theta = np.arctan2(z * a, p * b)
    lon = np.arctan2(y, x)
    lat = np.arctan2(
        z + eb**2 * b * np.sin(theta) ** 3, p - ea**2 * a * np.cos(theta) ** 3
    )
    n = a / np.sqrt(1.0 - ea**2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return np.degrees(lat), np.degrees(lon), alt


def ecef_from_topocentric_transform(lat: float, lon: float, alt: float) -> np.ndarray:
    """4x4 transform taking local topocentric (ENU) coords to ECEF.

    The topocentric frame sits at (lat, lon, alt) with X east, Y north and
    Z up (reference: opensfm/geo.py:80-105).
    """
    x, y, z = ecef_from_lla(lat, lon, alt)
    sa = np.sin(np.radians(lat))
    ca = np.cos(np.radians(lat))
    so = np.sin(np.radians(lon))
    co = np.cos(np.radians(lon))
    return np.array(
        [
            [-so, -sa * co, ca * co, x],
            [co, -sa * so, ca * so, y],
            [0.0, ca, sa, z],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def topocentric_from_lla(
    lat: ArrayLike,
    lon: ArrayLike,
    alt: ArrayLike,
    reflat: float,
    reflon: float,
    refalt: float,
):
    """lat/lon/alt -> local ENU coords around the (reflat, reflon, refalt) origin."""
    T = np.linalg.inv(ecef_from_topocentric_transform(reflat, reflon, refalt))
    x, y, z = ecef_from_lla(lat, lon, alt)
    tx = T[0, 0] * x + T[0, 1] * y + T[0, 2] * z + T[0, 3]
    ty = T[1, 0] * x + T[1, 1] * y + T[1, 2] * z + T[1, 3]
    tz = T[2, 0] * x + T[2, 1] * y + T[2, 2] * z + T[2, 3]
    return tx, ty, tz


def lla_from_topocentric(
    x: ArrayLike,
    y: ArrayLike,
    z: ArrayLike,
    reflat: float,
    reflon: float,
    refalt: float,
):
    """Local ENU coords around (reflat, reflon, refalt) -> lat/lon/alt."""
    T = ecef_from_topocentric_transform(reflat, reflon, refalt)
    ex = T[0, 0] * x + T[0, 1] * y + T[0, 2] * z + T[0, 3]
    ey = T[1, 0] * x + T[1, 1] * y + T[1, 2] * z + T[1, 3]
    ez = T[2, 0] * x + T[2, 1] * y + T[2, 2] * z + T[2, 3]
    return lla_from_ecef(ex, ey, ez)


def gps_distance(latlon_1, latlon_2):
    """Great-circle-ish distance via ECEF chord over the mean sphere (m).

    Matches the reference's chord-on-ellipsoid distance
    (opensfm/geo.py:244-272): ECEF of both points at altitude 0, then the
    Euclidean distance between them.
    """
    latlon_1 = np.asarray(latlon_1, dtype=np.float64)
    latlon_2 = np.asarray(latlon_2, dtype=np.float64)
    x1, y1, z1 = ecef_from_lla(latlon_1[..., 0], latlon_1[..., 1], 0.0)
    x2, y2, z2 = ecef_from_lla(latlon_2[..., 0], latlon_2[..., 1], 0.0)
    return np.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2 + (z1 - z2) ** 2)


class TopocentricConverter:
    """Convert to/from a local ENU frame at a reference lat/lon/alt.

    Mirrors opensfm/geo.py:275-318 and geo/geo.h:35-49.
    """

    def __init__(self, reflat: float, reflon: float, refalt: float) -> None:
        self.lat = float(reflat)
        self.lon = float(reflon)
        self.alt = float(refalt)

    def to_topocentric(self, lat, lon, alt):
        return topocentric_from_lla(lat, lon, alt, self.lat, self.lon, self.alt)

    def to_lla(self, x, y, z):
        return lla_from_topocentric(x, y, z, self.lat, self.lon, self.alt)

    def __eq__(self, o: object) -> bool:
        return (
            isinstance(o, TopocentricConverter)
            and self.lat == o.lat
            and self.lon == o.lon
            and self.alt == o.alt
        )

    def __repr__(self) -> str:
        return f"TopocentricConverter({self.lat}, {self.lon}, {self.alt})"
