"""EXIF extraction: image metadata -> camera model priors + GPS.

Port of `opensfm_tpu.exif` (reference `opensfm/exif.py`: EXIF class:175,
compute_focal:62, camera_id:91, calibration_from_metadata:715,
camera_from_exif_metadata:744) with its own EXIF parser in place of PIL:
the TIFF-structured block of a JPEG's APP1 segment or a PNG's eXIf chunk
(IFD0, the Exif IFD at 0x8769 and the GPS IFD at 0x8825; either byte
order) becomes the same {tag name: value} and {GPS tag name: value} maps
PIL's `_getexif()` gives, with rationals as floats.
"""

from __future__ import annotations

import datetime
import logging
import struct
from io import BytesIO
from typing import Any, BinaryIO, Callable, Dict, Optional, Tuple

from opensfm_tpu_torch import io
from opensfm_tpu_torch.exif_tags import GPS_TAGS, TAGS

logger = logging.getLogger(__name__)

maximum_altitude = 1e4
default_projection = "perspective"


def _to_int(value) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        return 0


def compute_focal(
    focal_35: Optional[float], focal: Optional[float],
    sensor_width: Optional[float], sensor_string: Optional[str],
) -> Tuple[float, float]:
    """(focal_35mm_equiv, focal_ratio) following exif.py:62-88, with the
    sensor-width database fallback (reference data/sensor_data.json via
    context.py:20 -> opensfm_tpu_torch.sensors)."""
    if focal_35 is not None and focal_35 > 0:
        focal_ratio = focal_35 / 36.0  # 35mm film produces 36x24mm pictures.
    else:
        if not sensor_width:
            from opensfm_tpu_torch import sensors

            sensor_width = sensors.sensor_width(sensor_string)
        if sensor_width and focal:
            focal_ratio = focal / sensor_width
            focal_35 = 36.0 * focal_ratio
        else:
            focal_35 = 0.0
            focal_ratio = 0.0
    return focal_35, focal_ratio


def sensor_string(make: str, model: str) -> str:
    if make != "unknown":
        model = model.replace(make, "")  # remove duplicate make in model
    return (make.strip() + " " + model.strip()).lower()


def camera_id(exif: Dict[str, Any]) -> str:
    return camera_id_(
        exif["make"], exif["model"], exif["width"], exif["height"],
        exif["projection_type"], exif["focal_ratio"],
    )


def camera_id_(
    make: str, model: str, width: int, height: int,
    projection_type: str, focal: float,
) -> str:
    """Camera identifier string (exif.py:102-118)."""
    if make != "unknown":
        model = model.replace(make, "")
    return " ".join(
        [
            "v2", make.strip(), model.strip(), str(int(width)),
            str(int(height)), projection_type, str(float(focal))[:6],
        ]
    ).lower()


def _dms_to_deg(dms, ref) -> float:
    deg = float(dms[0]) + float(dms[1]) / 60.0 + float(dms[2]) / 3600.0
    if ref in ("S", "W"):
        deg = -deg
    return deg


# ---------------------------------------------------------------------------
# EXIF block parser (TIFF structure, EXIF 2.32 section 4.6)
# ---------------------------------------------------------------------------

_EXIF_IFD, _GPS_IFD = 0x8769, 0x8825
# type -> (bytes per value, struct code); 5 and 10 are (numerator,
# denominator) pairs.
_TIFF_TYPES = {1: (1, "B"), 2: (1, "s"), 3: (2, "H"), 4: (4, "L"),
               5: (8, "LL"), 6: (1, "b"), 7: (1, "s"), 8: (2, "h"),
               9: (4, "l"), 10: (8, "ll"), 11: (4, "f"), 12: (8, "d")}


def exif_block(data: bytes) -> Optional[bytes]:
    """The TIFF-structured EXIF block of a JPEG (APP1 "Exif\\0\\0") or a
    PNG (eXIf chunk) file's bytes; None when there is none."""
    found = io.walk_header(BytesIO(data), data)
    return found[1] if found is not None else None


def _ifd_entries(tiff: bytes, offset: int, bo: str) -> Dict[int, Any]:
    """{tag id: value} of the IFD at `offset`: ASCII as str (one trailing
    NUL stripped), BYTE and UNDEFINED as bytes, numbers as int or float
    (rationals as floats; 0/0 is nan), one value bare and several as a
    tuple, as PIL gives them."""
    (n,) = struct.unpack_from(bo + "H", tiff, offset)
    out: Dict[int, Any] = {}
    for k in range(n):
        tag, typ, count, raw = struct.unpack_from(
            bo + "HHL4s", tiff, offset + 2 + 12 * k)
        if typ not in _TIFF_TYPES:
            continue
        size, code = _TIFF_TYPES[typ]
        nbytes = size * count
        if nbytes > 4:
            (ptr,) = struct.unpack(bo + "L", raw)
            buf = tiff[ptr:ptr + nbytes]
        else:
            buf = raw[:nbytes]
        if len(buf) < nbytes:
            continue
        if typ == 2:
            value: Any = buf[:-1] if buf.endswith(b"\0") else buf
            value = value.decode("latin-1", "replace")
        elif typ in (1, 7):
            value = bytes(buf)
        else:
            flat = struct.unpack(bo + code * count, buf)
            if typ in (5, 10):
                flat = tuple(a / b if b else float("nan")
                             for a, b in zip(flat[0::2], flat[1::2]))
            value = flat[0] if count == 1 else tuple(flat)
        out[tag] = value
    return out


def orientation(data: bytes) -> int:
    """The EXIF Orientation (1-8) in IFD0 of a JPEG or PNG file's bytes,
    as cv2.imread reads it; 1 where there is none or it is out of range."""
    return tiff_orientation(exif_block(data))


def tiff_orientation(tiff: Optional[bytes]) -> int:
    """The Orientation (1-8) in IFD0 of a TIFF-structured EXIF block; 1
    where there is none or it is out of range."""
    if not tiff or tiff[:2] not in (b"II", b"MM"):
        return 1
    bo = "<" if tiff[:2] == b"II" else ">"
    try:
        (ifd0,) = struct.unpack_from(bo + "L", tiff, 4)
        value = _ifd_entries(tiff, ifd0, bo).get(0x0112, 1)
        value = int(value[0] if isinstance(value, tuple) else value)
    except (struct.error, TypeError, ValueError, IndexError):
        return 1
    return value if 1 <= value <= 8 else 1


def parse_exif(tiff: Optional[bytes]) -> Tuple[Dict[Any, Any], Dict[Any, Any]]:
    """({tag name: value} of IFD0 merged with the Exif IFD, {GPS tag name:
    value}) of a TIFF-structured EXIF block, keyed as `opensfm_tpu.exif`
    keys PIL's `_getexif()` map (a tag without a name keeps its id)."""
    if not tiff or tiff[:2] not in (b"II", b"MM"):
        return {}, {}
    bo = "<" if tiff[:2] == b"II" else ">"
    (ifd0,) = struct.unpack_from(bo + "L", tiff, 4)
    raw = _ifd_entries(tiff, ifd0, bo)
    if _EXIF_IFD in raw:
        raw.update(_ifd_entries(tiff, raw[_EXIF_IFD], bo))
    gps = {}
    if _GPS_IFD in raw:
        gps = {GPS_TAGS.get(k, k): v
               for k, v in _ifd_entries(tiff, raw.pop(_GPS_IFD), bo).items()}
    tags = {TAGS.get(k, k): v for k, v in raw.items()}
    return tags, gps


class EXIF:
    """EXIF reader over a file object (the port's own parser)."""

    def __init__(
        self,
        fileobj: BinaryIO,
        image_size_loader: Optional[Callable[[], Tuple[int, int]]] = None,
        use_exif_size: bool = True,
        name: Optional[str] = None,
    ) -> None:
        self.image_size_loader = image_size_loader
        self.use_exif_size = use_exif_size
        self.fileobj_name = name or getattr(fileobj, "name", "unknown")
        self.tags: Dict[str, Any] = {}
        self.gps: Dict[str, Any] = {}
        self.pil_size: Optional[Tuple[int, int]] = None
        self.xmp_projection: Optional[str] = None
        try:
            fileobj.seek(0)
            head = fileobj.read(256 * 1024)
            if b"GPano:ProjectionType" in head or b"ProjectionType" in head:
                for token in (b"equirectangular", b"spherical", b"cylindrical"):
                    if token in head:
                        self.xmp_projection = token.decode()
                        break
            fileobj.seek(0)
            data = fileobj.read()
            size = io.image_size_from_header(data)
            if size is not None:
                self.pil_size = (size[1], size[0])  # (width, height)
            self.tags, self.gps = parse_exif(exif_block(data))
        except Exception as e:  # pragma: no cover - corrupt files
            logger.warning("Failed reading EXIF of %s: %s", self.fileobj_name, e)

    # -- pieces --------------------------------------------------------------
    def extract_image_size(self) -> Tuple[int, int]:
        if (
            self.use_exif_size
            and "ExifImageWidth" in self.tags
            and "ExifImageHeight" in self.tags
        ):
            try:
                return (
                    int(self.tags["ExifImageWidth"]),
                    int(self.tags["ExifImageHeight"]),
                )
            except (TypeError, ValueError):
                pass
        if self.image_size_loader is not None:
            h, w = self.image_size_loader()
            return w, h
        if self.pil_size is not None:
            return self.pil_size
        return -1, -1

    def extract_make(self) -> str:
        value = self.tags.get("Make", "unknown")
        return str(value).strip("\x00 ").strip() or "unknown"

    def extract_model(self) -> str:
        value = self.tags.get("Model", "unknown")
        return str(value).strip("\x00 ").strip() or "unknown"

    def extract_projection_type(self) -> str:
        if self.xmp_projection in ("equirectangular", "spherical"):
            return "equirectangular"
        return "perspective"

    def extract_focal(self) -> Tuple[float, float]:
        make, model = self.extract_make(), self.extract_model()
        focal_35 = self.tags.get("FocalLengthIn35mmFilm")
        focal = self.tags.get("FocalLength")
        try:
            focal = float(focal) if focal is not None else None
        except (TypeError, ValueError):
            focal = None
        try:
            focal_35 = float(focal_35) if focal_35 is not None else None
        except (TypeError, ValueError):
            focal_35 = None
        return compute_focal(
            focal_35, focal, self.extract_sensor_width(),
            sensor_string(make, model),
        )

    def extract_sensor_width(self) -> Optional[float]:
        """Sensor width from the FocalPlane resolution tags
        (reference exif.py:258-283)."""
        unit = self.tags.get("FocalPlaneResolutionUnit")
        ppu = self.tags.get("FocalPlaneXResolution")
        if unit is None or ppu is None:
            return None
        mm_per_unit = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(_to_int(unit))
        if not mm_per_unit:
            return None
        try:
            pixels_per_unit = float(ppu)
        except (TypeError, ValueError):
            return None
        if pixels_per_unit <= 0.0:
            try:
                pixels_per_unit = float(self.tags.get("FocalPlaneYResolution", 0))
            except (TypeError, ValueError):
                return None
            if pixels_per_unit <= 0.0:
                return None
        width_in_pixels = self.extract_image_size()[0]
        if width_in_pixels <= 0:
            return None
        return width_in_pixels / pixels_per_unit * mm_per_unit

    def extract_orientation(self) -> int:
        try:
            return int(self.tags.get("Orientation", 1))
        except (TypeError, ValueError):
            return 1

    def extract_lon_lat(self) -> Tuple[Optional[float], Optional[float]]:
        if "GPSLatitude" in self.gps and "GPSLongitude" in self.gps:
            lat = _dms_to_deg(self.gps["GPSLatitude"], self.gps.get("GPSLatitudeRef", "N"))
            lon = _dms_to_deg(self.gps["GPSLongitude"], self.gps.get("GPSLongitudeRef", "E"))
            return lon, lat
        return None, None

    def extract_altitude(self) -> Optional[float]:
        if "GPSAltitude" in self.gps:
            try:
                alt = float(self.gps["GPSAltitude"])
            except (TypeError, ValueError, ZeroDivisionError):
                return None
            ref = self.gps.get("GPSAltitudeRef", 0)
            try:
                if int(ref) == 1:
                    alt = -alt
            except (TypeError, ValueError):
                pass
            return min(alt, maximum_altitude)
        return None

    def extract_dop(self) -> Optional[float]:
        if "GPSDOP" in self.gps:
            try:
                return float(self.gps["GPSDOP"])
            except (TypeError, ValueError, ZeroDivisionError):
                return None
        return None

    def extract_geo(self) -> Dict[str, Any]:
        lon, lat = self.extract_lon_lat()
        d: Dict[str, Any] = {}
        if lat is not None and lon is not None:
            d["latitude"] = lat
            d["longitude"] = lon
            alt = self.extract_altitude()
            if alt is not None:
                d["altitude"] = alt
            dop = self.extract_dop()
            if dop is not None:
                d["dop"] = dop
        return d

    def extract_capture_time(self) -> float:
        for tag in ("DateTimeOriginal", "DateTimeDigitized", "DateTime"):
            value = self.tags.get(tag)
            if not value:
                continue
            try:
                dt = datetime.datetime.strptime(str(value), "%Y:%m:%d %H:%M:%S")
                ts = (dt - datetime.datetime(1970, 1, 1)).total_seconds()
                subsec = self.tags.get("SubsecTimeOriginal") or self.tags.get(
                    "SubsecTime"
                )
                if subsec:
                    try:
                        ts += float("0." + str(subsec).strip())
                    except ValueError:
                        pass
                return ts
            except ValueError:
                continue
        return 0.0

    def extract_exif(self) -> Dict[str, Any]:
        width, height = self.extract_image_size()
        projection_type = self.extract_projection_type()
        focal_35, focal_ratio = self.extract_focal()
        make, model = self.extract_make(), self.extract_model()
        orientation = self.extract_orientation()
        geo = self.extract_geo()
        capture = self.extract_capture_time()
        d = {
            "make": make,
            "model": model,
            "width": width,
            "height": height,
            "projection_type": projection_type,
            "focal_ratio": focal_ratio,
            "orientation": orientation,
            "capture_time": capture,
            "gps": geo,
        }
        d["camera"] = camera_id(d)
        return d


def extract_exif_from_file(
    fileobj: BinaryIO,
    image_size_loader: Optional[Callable[[], Tuple[int, int]]] = None,
    use_exif_size: bool = True,
    name: Optional[str] = None,
) -> Dict[str, Any]:
    return EXIF(fileobj, image_size_loader, use_exif_size, name=name).extract_exif()


# ---------------------------------------------------------------------------
# Calibration (exif.py:600-744)
# ---------------------------------------------------------------------------


def hard_coded_calibration(exif: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Known-camera calibration database hook (exif.py:636).  Empty for now."""
    return None


def focal_ratio_calibration(exif: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if exif.get("focal_ratio"):
        return {
            "focal": exif["focal_ratio"],
            "k1": 0.0,
            "k2": 0.0,
        }
    return None


def focal_xy_calibration(exif: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    focal = exif.get("focal_x", exif.get("focal_ratio"))
    if focal:
        return {
            "focal_x": focal,
            "focal_y": exif.get("focal_y", focal),
            "c_x": exif.get("c_x", 0.0),
            "c_y": exif.get("c_y", 0.0),
            "k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0, "k5": 0.0, "k6": 0.0,
            "p1": 0.0, "p2": 0.0, "s0": 0.0, "s1": 0.0, "s2": 0.0, "s3": 0.0,
        }
    return None


def default_calibration(data) -> Dict[str, Any]:
    prior = data.config["default_focal_prior"]
    return {
        "focal": prior, "focal_x": prior, "focal_y": prior,
        "c_x": 0.0, "c_y": 0.0,
        "k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0, "k5": 0.0, "k6": 0.0,
        "p1": 0.0, "p2": 0.0, "s0": 0.0, "s1": 0.0, "s2": 0.0, "s3": 0.0,
    }


def calibration_from_metadata(metadata: Dict[str, Any], data) -> Dict[str, Any]:
    """Best available calibration (exif.py:715-742)."""
    pt = metadata.get("projection_type", default_projection).lower()
    if pt in ("brown", "fisheye_opencv", "radial", "simple_radial",
              "fisheye62", "fisheye624"):
        calib = (
            hard_coded_calibration(metadata)
            or focal_xy_calibration(metadata)
            or default_calibration(data)
        )
    else:
        calib = (
            hard_coded_calibration(metadata)
            or focal_ratio_calibration(metadata)
            or default_calibration(data)
        )
    if "projection_type" not in calib:
        calib["projection_type"] = pt
    return calib


def camera_from_exif_metadata(
    metadata: Dict[str, Any], data,
    calibration_func=calibration_from_metadata,
):
    """Camera object from EXIF metadata (exif.py:744-830)."""
    from opensfm_tpu_torch.geometry.cameras import Camera

    calib = calibration_func(metadata, data)
    pt = calib.get("projection_type", default_projection).lower()

    if pt == "perspective":
        camera = Camera.create_perspective(calib["focal"], calib["k1"], calib["k2"])
    elif pt == "brown":
        camera = Camera.create_brown(
            calib["focal_x"], calib["focal_y"] / calib["focal_x"],
            [calib["c_x"], calib["c_y"]],
            [calib["k1"], calib["k2"], calib["k3"], calib["p1"], calib["p2"]],
        )
    elif pt == "fisheye":
        camera = Camera.create_fisheye(calib["focal"], calib["k1"], calib["k2"])
    elif pt == "fisheye_opencv":
        camera = Camera.create_fisheye_opencv(
            calib["focal_x"], calib["focal_y"] / calib["focal_x"],
            [calib["c_x"], calib["c_y"]],
            [calib["k1"], calib["k2"], calib["k3"], calib["k4"]],
        )
    elif pt == "fisheye62":
        camera = Camera.create_fisheye62(
            calib["focal_x"], calib["focal_y"] / calib["focal_x"],
            [calib["c_x"], calib["c_y"]],
            [calib[k] for k in ("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2")],
        )
    elif pt == "fisheye624":
        camera = Camera.create_fisheye624(
            calib["focal_x"], calib["focal_y"] / calib["focal_x"],
            [calib["c_x"], calib["c_y"]],
            [
                calib[k]
                for k in ("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2",
                          "s0", "s1", "s2", "s3")
            ],
        )
    elif pt == "radial":
        camera = Camera.create_radial(
            calib["focal_x"], calib["focal_y"] / calib["focal_x"],
            [calib["c_x"], calib["c_y"]], [calib["k1"], calib["k2"]],
        )
    elif pt == "simple_radial":
        camera = Camera.create_simple_radial(
            calib["focal_x"], calib["focal_y"] / calib["focal_x"],
            [calib["c_x"], calib["c_y"]], calib["k1"],
        )
    elif pt in ("equirectangular", "spherical"):
        camera = Camera.create_spherical()
    else:
        raise ValueError(f"Unknown projection type: {pt}")

    camera.id = metadata["camera"]
    camera.width = int(metadata["width"])
    camera.height = int(metadata["height"])
    return camera
