"""GPX geotagging: interpolate GPS tracks onto image timestamps.

Port of `opensfm_tpu.geotag_from_gpx` (reference
`opensfm/geotag_from_gpx.py:56-343`: GPX parsing, lat/lon/bearing
interpolation, EXIF GPS overrides).  Times are naive datetimes as in the
JAX package, computed without Python 3.12's deprecated `utcnow` and
`utcfromtimestamp`.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
from typing import Optional

logger = logging.getLogger(__name__)


def utc_to_localtime(utc_time: datetime.datetime) -> datetime.datetime:
    """Naive UTC -> naive local wall-clock time, at the host's UTC offset
    now (the JAX package's `utc_time - (utcnow() - now())`, read from one
    clock reading instead of two)."""
    return utc_time + datetime.datetime.now().astimezone().utcoffset()


def utc_from_timestamp(timestamp: float) -> datetime.datetime:
    """Naive UTC datetime of a POSIX timestamp (what the deprecated
    `datetime.utcfromtimestamp` returns)."""
    return datetime.datetime.fromtimestamp(
        timestamp, datetime.timezone.utc).replace(tzinfo=None)


def get_lat_lon_time(gpx_file: str, gpx_time: str = "utc"):
    """(time, lat, lon, elevation) samples from a GPX file
    (geotag_from_gpx.py:61-87); minimal XML parsing, no gpxpy dependency."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(gpx_file)
    root = tree.getroot()
    ns = {"gpx": root.tag.split("}")[0].strip("{")} if "}" in root.tag else {}

    def findall(elem, path):
        return elem.findall(path.replace("x:", "gpx:"), ns) if ns else elem.findall(
            path.replace("x:", "")
        )

    points = []
    for trk in findall(root, "x:trk"):
        for seg in findall(trk, "x:trkseg"):
            for pt in findall(seg, "x:trkpt"):
                lat = float(pt.attrib["lat"])
                lon = float(pt.attrib["lon"])
                time_el = findall(pt, "x:time")
                ele_el = findall(pt, "x:ele")
                if not time_el:
                    continue
                t = datetime.datetime.strptime(
                    time_el[0].text.strip().replace("Z", ""), "%Y-%m-%dT%H:%M:%S"
                )
                if gpx_time == "utc":
                    t = utc_to_localtime(t)
                ele = float(ele_el[0].text) if ele_el else 0.0
                points.append((t, lat, lon, ele))
    points.sort(key=lambda x: x[0])
    return points


def compute_bearing(
    start_lat: float, start_lon: float, end_lat: float, end_lon: float
) -> float:
    """Initial course between two points, degrees (geotag_from_gpx.py:90)."""
    start_lat, start_lon = math.radians(start_lat), math.radians(start_lon)
    end_lat, end_lon = math.radians(end_lat), math.radians(end_lon)
    d_lon = end_lon - start_lon
    if abs(d_lon) > math.pi:
        d_lon = -(2.0 * math.pi - d_lon) if d_lon > 0.0 else (2.0 * math.pi + d_lon)
    tan_start = math.tan(start_lat / 2.0 + math.pi / 4.0)
    tan_end = math.tan(end_lat / 2.0 + math.pi / 4.0)
    d_phi = math.log(tan_end / tan_start) if tan_start != 0 and tan_end > 0 else 0.0
    return (math.degrees(math.atan2(d_lon, d_phi)) + 360.0) % 360.0


def interpolate_lat_lon(points, t, max_dt: float = 1.0):
    """Interpolate position at time t (geotag_from_gpx.py:122-162)."""
    if not points:
        raise ValueError("Empty GPS track")
    if t < points[0][0]:
        if (points[0][0] - t).total_seconds() > max_dt:
            raise ValueError("Time out of track range")
        return points[0][1], points[0][2], 0.0, points[0][3]
    if t > points[-1][0]:
        if (t - points[-1][0]).total_seconds() > max_dt:
            raise ValueError("Time out of track range")
        return points[-1][1], points[-1][2], 0.0, points[-1][3]
    for i in range(len(points) - 1):
        t1, t2 = points[i][0], points[i + 1][0]
        if t1 <= t <= t2:
            dt = (t2 - t1).total_seconds()
            a = (t - t1).total_seconds() / dt if dt > 0 else 0.0
            lat = points[i][1] + a * (points[i + 1][1] - points[i][1])
            lon = points[i][2] + a * (points[i + 1][2] - points[i][2])
            ele = points[i][3] + a * (points[i + 1][3] - points[i][3])
            bearing = compute_bearing(
                points[i][1], points[i][2], points[i + 1][1], points[i + 1][2]
            )
            return lat, lon, bearing, ele
    raise ValueError("Time not found in track")


def gpx_lerp(alpha: float, a, b):
    """Interpolate gpx point as (1 - alpha) * a + alpha * b
    (geotag_from_gpx.py:183-194)."""
    dt = alpha * (b[0] - a[0]).total_seconds()
    t = a[0] + datetime.timedelta(seconds=dt)
    lat = (1 - alpha) * a[1] + alpha * b[1]
    lon = (1 - alpha) * a[2] + alpha * b[2]
    alt = (1 - alpha) * a[3] + alpha * b[3]
    return t, lat, lon, alt


def sample_gpx(points, dx: float, dt: Optional[float] = None):
    """Resample a track by distance dx (geotag_from_gpx.py:257-283)."""
    from opensfm_tpu_torch.geo import gps_distance

    if not points:
        return []
    sampled = [points[0]]
    for p in points[1:]:
        last = sampled[-1]
        d = gps_distance([last[1], last[2]], [p[1], p[2]])
        if d >= dx:
            sampled.append(p)
    logger.info("Sampled %d points from %d", len(sampled), len(points))
    return sampled


def add_gps_to_exif_overrides(data, gpx_file: str, time_offset: float = 0.0):
    """Write exif_overrides.json mapping images to interpolated GPS
    (the add_exif_using_timestamp equivalent, writing overrides instead of
    mutating image files)."""
    import json

    points = get_lat_lon_time(gpx_file)
    overrides = {}
    for image in data.images():
        exif = data.load_exif(image) if data.exif_exists(image) else data.extract_exif(image)
        if not exif.get("capture_time"):
            continue
        t = utc_from_timestamp(exif["capture_time"] + time_offset)
        try:
            lat, lon, bearing, ele = interpolate_lat_lon(points, t)
        except ValueError:
            continue
        overrides[image] = {
            "gps": {
                "latitude": lat, "longitude": lon,
                "altitude": ele, "dop": 5.0,
            },
            "compass": {"angle": bearing},
        }
    path = os.path.join(data.data_path, "exif_overrides.json")
    with open(path, "w") as f:
        json.dump(overrides, f, indent=4)
    return overrides
