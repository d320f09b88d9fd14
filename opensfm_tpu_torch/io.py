"""JSON / PLY serialization of reconstructions, GCPs and features.

Byte-format compatible with the reference `opensfm/io.py` (cameras:
io.py:33-496, shots/metadata: io.py:498-601, reconstruction:
io.py:286-347,612-663, GCP files: io.py:981-1062, PLY: io.py:1093-1249) so
datasets interoperate in both directions.
"""

from __future__ import annotations

import json
from io import BytesIO
from typing import Any, Dict, IO, List, Optional, TextIO, Tuple

import numpy as np

from opensfm_tpu_torch import geo, pymap, types
from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose, Similarity


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------


def camera_from_json(key: str, obj: Dict[str, Any]) -> Camera:
    """Read a camera from a json object (field names per io.py:33-165)."""
    pt = obj.get("projection_type", "perspective")
    if pt in ("perspective",):
        camera = Camera.create_perspective(
            obj["focal"], obj.get("k1", 0.0), obj.get("k2", 0.0)
        )
    elif pt == "brown":
        camera = Camera.create_brown(
            obj["focal_x"],
            obj["focal_y"] / obj["focal_x"],
            [obj.get("c_x", 0.0), obj.get("c_y", 0.0)],
            [
                obj.get("k1", 0.0), obj.get("k2", 0.0), obj.get("k3", 0.0),
                obj.get("p1", 0.0), obj.get("p2", 0.0),
            ],
        )
    elif pt == "fisheye":
        camera = Camera.create_fisheye(
            obj["focal"], obj.get("k1", 0.0), obj.get("k2", 0.0)
        )
    elif pt == "fisheye_opencv":
        camera = Camera.create_fisheye_opencv(
            obj["focal_x"],
            obj["focal_y"] / obj["focal_x"],
            [obj.get("c_x", 0.0), obj.get("c_y", 0.0)],
            [obj.get(k, 0.0) for k in ("k1", "k2", "k3", "k4")],
        )
    elif pt == "fisheye62":
        camera = Camera.create_fisheye62(
            obj["focal_x"],
            obj["focal_y"] / obj["focal_x"],
            [obj.get("c_x", 0.0), obj.get("c_y", 0.0)],
            [obj.get(k, 0.0) for k in ("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2")],
        )
    elif pt == "fisheye624":
        camera = Camera.create_fisheye624(
            obj["focal_x"],
            obj["focal_y"] / obj["focal_x"],
            [obj.get("c_x", 0.0), obj.get("c_y", 0.0)],
            [
                obj.get(k, 0.0)
                for k in (
                    "k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2",
                    "s0", "s1", "s2", "s3",
                )
            ],
        )
    elif pt == "radial":
        camera = Camera.create_radial(
            obj["focal_x"],
            obj["focal_y"] / obj["focal_x"],
            [obj.get("c_x", 0.0), obj.get("c_y", 0.0)],
            [obj.get("k1", 0.0), obj.get("k2", 0.0)],
        )
    elif pt == "simple_radial":
        camera = Camera.create_simple_radial(
            obj["focal_x"],
            obj["focal_y"] / obj["focal_x"],
            [obj.get("c_x", 0.0), obj.get("c_y", 0.0)],
            obj.get("k1", 0.0),
        )
    elif pt == "dual":
        camera = Camera.create_dual(
            obj.get("transition", 0.5), obj["focal"],
            obj.get("k1", 0.0), obj.get("k2", 0.0),
        )
    elif pt in ("spherical", "equirectangular"):
        camera = Camera.create_spherical()
    else:
        raise NotImplementedError(f"Unknown projection type {pt}")
    camera.id = key
    camera.width = int(obj.get("width", 0))
    camera.height = int(obj.get("height", 0))
    return camera


def camera_to_json(camera: Camera) -> Dict[str, Any]:
    """Write a camera to a json object (field names per io.py:364-496)."""
    pt = camera.projection_type
    obj: Dict[str, Any] = {
        "projection_type": pt,
        "width": camera.width,
        "height": camera.height,
    }
    if pt in ("perspective", "fisheye"):
        obj.update(focal=camera.focal, k1=camera.k1, k2=camera.k2)
    elif pt == "dual":
        obj.update(
            focal=camera.focal, k1=camera.k1, k2=camera.k2,
            transition=camera.transition,
        )
    elif pt in ("spherical", "equirectangular"):
        pass
    else:
        obj.update(
            focal_x=camera.focal,
            focal_y=camera.focal * camera.aspect_ratio,
            c_x=camera.cx,
            c_y=camera.cy,
        )
        if pt == "brown":
            names = ("k1", "k2", "p1", "p2", "k3")
        elif pt == "fisheye_opencv":
            names = ("k1", "k2", "k3", "k4")
        elif pt == "fisheye62":
            names = ("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2")
        elif pt == "fisheye624":
            names = ("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2",
                     "s0", "s1", "s2", "s3")
        elif pt == "radial":
            names = ("k1", "k2")
        elif pt == "simple_radial":
            names = ("k1",)
        else:
            raise NotImplementedError(pt)
        for n in names:
            obj[n] = getattr(camera, n)
    return obj


def cameras_from_json(obj: Dict[str, Any]) -> Dict[str, Camera]:
    return {key: camera_from_json(key, value) for key, value in obj.items()}


def cameras_to_json(cameras: Dict[str, Camera]) -> Dict[str, Dict[str, Any]]:
    return {camera.id: camera_to_json(camera) for camera in cameras.values()}


# ---------------------------------------------------------------------------
# Poses / biases / rigs
# ---------------------------------------------------------------------------


def pose_from_json(obj: Dict[str, Any]) -> Pose:
    pose = Pose()
    pose.rotation = obj["rotation"]
    if "translation" in obj:
        pose.translation = obj["translation"]
    return pose


def pose_to_json(pose: Pose) -> Dict[str, Any]:
    return {
        "rotation": list(pose.rotation),
        "translation": list(pose.translation),
    }


def bias_from_json(obj: Dict[str, Any]) -> Similarity:
    return Similarity(obj["rotation"], obj["translation"], obj["scale"])


def bias_to_json(bias: Similarity) -> Dict[str, Any]:
    return {
        "rotation": list(bias.rotation),
        "translation": list(bias.translation),
        "scale": bias.scale,
    }


def rig_camera_from_json(key: str, obj: Dict[str, Any]) -> pymap.RigCamera:
    return pymap.RigCamera(pose_from_json(obj), key)


def rig_cameras_from_json(obj: Dict[str, Any]) -> Dict[str, pymap.RigCamera]:
    return {key: rig_camera_from_json(key, value) for key, value in obj.items()}


def rig_camera_to_json(rig_camera: pymap.RigCamera) -> Dict[str, Any]:
    return pose_to_json(rig_camera.pose)


def rig_cameras_to_json(rig_cameras: Dict[str, pymap.RigCamera]) -> Dict[str, Any]:
    return {rc.id: rig_camera_to_json(rc) for rc in rig_cameras.values()}


def rig_instance_to_json(rig_instance: pymap.RigInstance) -> Dict[str, Any]:
    return {
        "translation": list(rig_instance.pose.translation),
        "rotation": list(rig_instance.pose.rotation),
        "rig_camera_ids": rig_instance.rig_camera_ids,
    }


# ---------------------------------------------------------------------------
# Shot metadata
# ---------------------------------------------------------------------------


def pymap_metadata_to_json(metadata: pymap.ShotMeasurements) -> Dict[str, Any]:
    obj: Dict[str, Any] = {}
    if metadata.orientation.has_value:
        obj["orientation"] = metadata.orientation.value
    if metadata.capture_time.has_value:
        obj["capture_time"] = metadata.capture_time.value
    if metadata.gps_accuracy.has_value:
        obj["gps_dop"] = metadata.gps_accuracy.value
    if metadata.gps_position.has_value:
        obj["gps_position"] = list(metadata.gps_position.value)
    if metadata.gravity_down.has_value:
        obj["gravity_down"] = list(metadata.gravity_down.value)
    if metadata.compass_angle.has_value or metadata.compass_accuracy.has_value:
        compass = {}
        if metadata.compass_angle.has_value:
            compass["angle"] = metadata.compass_angle.value
        if metadata.compass_accuracy.has_value:
            compass["accuracy"] = metadata.compass_accuracy.value
        obj["compass"] = compass
    if metadata.sequence_key.has_value:
        obj["skey"] = metadata.sequence_key.value
    return obj


def json_to_pymap_metadata(obj: Dict[str, Any]) -> pymap.ShotMeasurements:
    metadata = pymap.ShotMeasurements()
    if obj.get("orientation") is not None:
        metadata.orientation.value = obj["orientation"]
    if obj.get("capture_time") is not None:
        metadata.capture_time.value = obj["capture_time"]
    if obj.get("gps_dop") is not None:
        metadata.gps_accuracy.value = obj["gps_dop"]
    if obj.get("gps_position") is not None:
        metadata.gps_position.value = np.array(obj["gps_position"], dtype=np.float64)
    if obj.get("skey") is not None:
        metadata.sequence_key.value = obj["skey"]
    if obj.get("gravity_down") is not None:
        metadata.gravity_down.value = np.array(obj["gravity_down"], dtype=np.float64)
    if obj.get("compass") is not None:
        compass = obj["compass"]
        if "angle" in compass:
            metadata.compass_angle.value = compass["angle"]
        if "accuracy" in compass:
            metadata.compass_accuracy.value = compass["accuracy"]
    return metadata


# ---------------------------------------------------------------------------
# Shots / points / reconstructions
# ---------------------------------------------------------------------------


def shot_to_json(shot: pymap.Shot) -> Dict[str, Any]:
    obj: Dict[str, Any] = {
        "rotation": list(shot.pose.rotation),
        "translation": list(shot.pose.translation),
        "camera": shot.camera.id,
    }
    if shot.metadata is not None:
        obj.update(pymap_metadata_to_json(shot.metadata))
    if shot.mesh is not None and shot.mesh.vertices is not None:
        obj["vertices"] = [list(v) for v in shot.mesh.vertices]
        obj["faces"] = [list(f) for f in shot.mesh.faces]
    obj["scale"] = shot.scale
    if shot.covariance is not None:
        obj["covariance"] = np.asarray(shot.covariance).tolist()
    obj["merge_cc"] = shot.merge_cc
    return obj


def assign_shot_attributes(obj: Dict[str, Any], shot: pymap.Shot) -> None:
    shot.metadata = json_to_pymap_metadata(obj)
    if "scale" in obj:
        shot.scale = obj["scale"]
    if "covariance" in obj:
        shot.covariance = np.array(obj["covariance"])
    if "merge_cc" in obj:
        shot.merge_cc = obj["merge_cc"]
    if "vertices" in obj and "faces" in obj:
        shot.mesh.vertices = obj["vertices"]
        shot.mesh.faces = obj["faces"]


def point_to_json(point: pymap.Landmark) -> Dict[str, Any]:
    return {
        "color": list(point.color.astype(float)),
        "coordinates": list(point.coordinates),
    }


def rig_instance_camera_per_shot(obj: Dict[str, Any]) -> Dict[str, Tuple[str, str]]:
    """(rig_instance_id, rig_camera_id) per shot from the json root."""
    panoshots = set(obj.get("pano_shots", {}).keys())
    rig_shots = {}
    for i_key, ri in obj.get("rig_instances", {}).items():
        for s_key, c_key in ri.get("rig_camera_ids", {}).items():
            if s_key not in panoshots:
                rig_shots[s_key] = (i_key, c_key)
    return rig_shots


def reconstruction_from_json(obj: Dict[str, Any]) -> types.Reconstruction:
    reconstruction = types.Reconstruction()

    for key, value in obj.get("cameras", {}).items():
        reconstruction.add_camera(camera_from_json(key, value))

    for key, value in obj.get("biases", {}).items():
        reconstruction.set_bias(key, bias_from_json(value))

    for key, value in obj.get("rig_cameras", {}).items():
        reconstruction.add_rig_camera(rig_camera_from_json(key, value))

    for key, value in obj.get("rig_instances", {}).items():
        instance = pymap.RigInstance(key)
        instance.pose = pose_from_json(value)
        reconstruction.add_rig_instance(instance)

    rig_shots = rig_instance_camera_per_shot(obj)
    for key, value in obj.get("shots", {}).items():
        pose = pose_from_json(value)
        if key in rig_shots:
            instance_id, camera_id = rig_shots[key]
            shot = reconstruction.create_shot(
                key, value["camera"], None,
                rig_camera_id=camera_id, rig_instance_id=instance_id,
            )
        else:
            shot = reconstruction.create_shot(key, value["camera"], pose)
        assign_shot_attributes(value, shot)

    for key, value in obj.get("points", {}).items():
        point = reconstruction.create_point(key, value["coordinates"])
        point.color = np.array(value["color"], dtype=np.int64)

    for key, value in obj.get("pano_shots", {}).items():
        shot = reconstruction.create_pano_shot(key, value["camera"], pose_from_json(value))
        assign_shot_attributes(value, shot)

    if "reference_lla" in obj:
        lla = obj["reference_lla"]
        reconstruction.reference = geo.TopocentricConverter(
            lla["latitude"], lla["longitude"], lla["altitude"]
        )

    return reconstruction


def reconstruction_to_json(reconstruction: types.Reconstruction) -> Dict[str, Any]:
    obj: Dict[str, Any] = {"cameras": {}, "shots": {}, "points": {}, "biases": {}}

    for camera in reconstruction.cameras.values():
        obj["cameras"][camera.id] = camera_to_json(camera)

    for camera_id, bias in reconstruction.biases.items():
        obj["biases"][camera_id] = bias_to_json(bias)

    if len(reconstruction.rig_cameras):
        obj["rig_cameras"] = rig_cameras_to_json(reconstruction.rig_cameras)
    if len(reconstruction.rig_instances):
        obj["rig_instances"] = {
            ri.id: rig_instance_to_json(ri)
            for ri in reconstruction.rig_instances.values()
        }

    for shot in reconstruction.shots.values():
        obj["shots"][shot.id] = shot_to_json(shot)

    for point in reconstruction.points.values():
        obj["points"][point.id] = point_to_json(point)

    if len(reconstruction.pano_shots) > 0:
        obj["pano_shots"] = {
            shot.id: shot_to_json(shot)
            for shot in reconstruction.pano_shots.values()
        }

    if reconstruction.reference is not None:
        ref = reconstruction.reference
        obj["reference_lla"] = {
            "latitude": ref.lat,
            "longitude": ref.lon,
            "altitude": ref.alt,
        }

    return obj


def reconstructions_from_json(obj: List[Dict[str, Any]]) -> List[types.Reconstruction]:
    return [reconstruction_from_json(i) for i in obj]


def reconstructions_to_json(reconstructions) -> List[Dict[str, Any]]:
    return [reconstruction_to_json(r) for r in reconstructions]


# ---------------------------------------------------------------------------
# Ground control points (io.py:981-1062)
# ---------------------------------------------------------------------------


class GroundControlPointObservation:
    """A GCP observation in one shot: shot_id + normalized projection."""

    def __init__(self, shot_id: str = "", projection=None) -> None:
        self.shot_id = shot_id
        self.projection = (
            np.zeros(2) if projection is None
            else np.asarray(projection, dtype=np.float64)
        )


class GroundControlPoint:
    """A ground control point: world position (LLA or local) + observations."""

    def __init__(self) -> None:
        self.id = ""
        self.lla: Optional[Dict[str, float]] = None
        self.has_altitude = False
        self.observations: List[GroundControlPointObservation] = []

    @property
    def lla_vec(self) -> np.ndarray:
        assert self.lla is not None
        return np.array(
            [self.lla["latitude"], self.lla["longitude"], self.lla.get("altitude", 0.0)]
        )


def read_ground_control_points(fileobj: IO) -> List[GroundControlPoint]:
    """Read GCPs from the json file format (io.py:996-1035)."""
    obj = json.load(fileobj)
    points = []
    for point_dict in obj["points"]:
        point = GroundControlPoint()
        point.id = point_dict["id"]
        lla = point_dict.get("position")
        if lla:
            point.lla = lla
            point.has_altitude = "altitude" in point.lla
        observations = []
        for o_dict in point_dict.get("observations", []):
            o = GroundControlPointObservation()
            o.shot_id = o_dict["shot_id"]
            if "projection" in o_dict:
                o.projection = np.array(o_dict["projection"], dtype=np.float64)
            observations.append(o)
        point.observations = observations
        points.append(point)
    return points


def write_ground_control_points(gcp: List[GroundControlPoint], fileobj: IO) -> None:
    obj = {"points": []}
    for point in gcp:
        point_obj: Dict[str, Any] = {"id": point.id, "observations": []}
        if point.lla:
            point_obj["position"] = point.lla
        for observation in point.observations:
            point_obj["observations"].append(
                {
                    "shot_id": observation.shot_id,
                    "projection": tuple(observation.projection),
                }
            )
        obj["points"].append(point_obj)
    json.dump(obj, fileobj, indent=4)


# ---------------------------------------------------------------------------
# JSON helpers
# ---------------------------------------------------------------------------


def _json_default(o):
    """Coerce numpy scalars/arrays that leak into JSON trees (np.float32 is
    not a Python float subclass, so json.dump rejects it)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(
        f"Object of type {o.__class__.__name__} is not JSON serializable"
    )


def json_dump(data, fout: TextIO, minify: bool = False) -> None:
    if minify:
        json.dump(data, fout, indent=None, separators=(",", ":"),
                  sort_keys=True, default=_json_default)
    else:
        json.dump(data, fout, indent=4, sort_keys=True, default=_json_default)


def json_dumps(data, minify: bool = False) -> str:
    if minify:
        return json.dumps(data, indent=None, separators=(",", ":"),
                          sort_keys=True, default=_json_default)
    return json.dumps(data, indent=4, sort_keys=True, default=_json_default)


def json_load(fp) -> Any:
    return json.load(fp)


def json_loads(text) -> Any:
    return json.loads(text)


# ---------------------------------------------------------------------------
# PLY (io.py:1093-1249)
# ---------------------------------------------------------------------------


def ply_header(
    count_vertices: int, with_normals: bool = False, point_num_views: bool = False
) -> List[str]:
    header = [
        "ply",
        "format ascii 1.0",
        f"element vertex {count_vertices}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if with_normals:
        header += ["property float nx", "property float ny", "property float nz"]
    header += [
        "property uchar diffuse_red",
        "property uchar diffuse_green",
        "property uchar diffuse_blue",
    ]
    if point_num_views:
        header += ["property uchar views"]
    header += ["end_header"]
    return header


def points_to_ply_string(vertices: List[str], point_num_views: bool = False) -> str:
    header = ply_header(len(vertices), point_num_views=point_num_views)
    return "\n".join(header + vertices + [""])


def reconstruction_to_ply(
    reconstruction: types.Reconstruction,
    tracks_manager: Optional[pymap.TracksManager] = None,
    no_cameras: bool = False,
    no_points: bool = False,
    point_num_views: bool = False,
) -> str:
    """Export reconstruction points and camera positions to PLY."""
    vertices = []
    if not no_points:
        for point in reconstruction.points.values():
            p, c = point.coordinates, point.color
            views = 0
            if tracks_manager is not None:
                views = len(tracks_manager.get_track_observations(point.id))
            s = "{} {} {} {} {} {}".format(
                p[0], p[1], p[2], int(c[0]), int(c[1]), int(c[2])
            )
            if point_num_views:
                s += f" {views}"
            vertices.append(s)
    if not no_cameras:
        for shot in reconstruction.shots.values():
            o = shot.pose.get_origin()
            R = shot.pose.get_rotation_matrix()
            for axis in range(3):
                c = 255 * np.eye(3)[axis]
                for depth in np.linspace(0, 2, 10):
                    p = o + depth * R[axis]
                    s = "{} {} {} {} {} {}".format(
                        p[0], p[1], p[2], int(c[0]), int(c[1]), int(c[2])
                    )
                    if point_num_views:
                        s += " 0"
                    vertices.append(s)
    return points_to_ply_string(vertices, point_num_views)


def point_cloud_to_ply(
    points: np.ndarray,
    normals: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray,
    fp: TextIO,
) -> None:
    """Dense point cloud with normals/labels to PLY (io.py:1093-1133)."""
    fp.write("ply\n")
    fp.write("format ascii 1.0\n")
    fp.write(f"element vertex {len(points)}\n")
    fp.write("property float x\n")
    fp.write("property float y\n")
    fp.write("property float z\n")
    fp.write("property float nx\n")
    fp.write("property float ny\n")
    fp.write("property float nz\n")
    fp.write("property uchar diffuse_red\n")
    fp.write("property uchar diffuse_green\n")
    fp.write("property uchar diffuse_blue\n")
    fp.write("property int class\n")
    fp.write("end_header\n")
    for p, n, c, l in zip(points, normals, colors, labels):
        fp.write(
            "{:.4f} {:.4f} {:.4f} {:.3f} {:.3f} {:.3f} {} {} {} {}\n".format(
                p[0], p[1], p[2], n[0], n[1], n[2],
                int(c[0]), int(c[1]), int(c[2]), int(l),
            )
        )


def point_cloud_from_ply(fp: TextIO) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read back a dense point cloud PLY written by `point_cloud_to_ply`
    (reference: io.py:1184-1207).  Returns (points, normals, colors, labels).
    Tolerates both `red/...` and `diffuse_red/...` property names."""
    lines = fp.read().splitlines()
    start = lines.index("end_header") + 1
    body = lines[start:]
    n = len(body)
    points = np.zeros((n, 3), dtype=np.float32)
    normals = np.zeros((n, 3), dtype=np.float32)
    colors = np.zeros((n, 3), dtype=np.uint8)
    labels = np.zeros((n,), dtype=np.uint8)
    for i, row in enumerate(body):
        w = row.split()
        points[i] = [float(v) for v in w[0:3]]
        normals[i] = [float(v) for v in w[3:6]]
        colors[i] = [int(v) for v in w[6:9]]
        labels[i] = int(w[9])
    return points, normals, colors, labels


# ---------------------------------------------------------------------------
# Filesystem abstraction (reference: io.py:1357-1510) so datasets can live on
# storage backends other than the local filesystem.
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Images: PNG, JPEG and PGM/PPM decoded (PNG and JPEG also encoded) here,
# other formats through cv2 or PIL
# ---------------------------------------------------------------------------

IMAGE_EXTENSIONS = {"jpg", "jpeg", "png", "tif", "tiff", "pgm", "pnm", "gif",
                    "bmp"}
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# Grey from RGB as cv2.imread(..., IMREAD_GRAYSCALE) gives it: libpng's
# rgb_to_gray (15-bit weights, truncated at 8 bits, rounded at 16) for PNG,
# and OpenCV's 14-bit rounded weights (icvCvt_BGR2Gray_8u) for PPM.
_PNG_GREY = (9797, 19234, 3737, 15, 0)
_PNG_GREY16 = (9797, 19234, 3737, 15, 1 << 14)
_CV_GREY = (4899, 9617, 1868, 14, 1 << 13)


class UnsupportedImage(ValueError):
    """An image variant the port's own decoders do not read."""


def png_chunks(data: bytes):
    """(type, payload) of each chunk of a PNG file's bytes."""
    if not data.startswith(PNG_SIGNATURE):
        raise UnsupportedImage("not a PNG file")
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n


def _png_header(data: bytes):
    kind, ihdr = next(png_chunks(data))
    if kind != b"IHDR":
        raise UnsupportedImage("PNG without IHDR")
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    return w, h, ihdr[8], ihdr[9], ihdr[12]


def _unfilter_rows(raw: np.ndarray, height: int, stride: int,
                   bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of `raw`
    ([height, 1 + stride] bytes): the native core's loop when its library
    is available, else this one (Sub and Up vectorised per row)."""
    from opensfm_tpu_torch import native

    if native.available():
        return native.png_unfilter(raw, height, stride, bpp)
    out = np.zeros((height + 1, stride), dtype=np.uint8)  # row 0: zeros
    for y in range(height):
        f, line, up = int(raw[y, 0]), raw[y, 1:], out[y]
        if f == 0:
            row = line
        elif f == 1:
            row = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   .reshape(-1) & 255).astype(np.uint8)
        elif f == 2:
            row = line + up
        elif f in (3, 4):
            cur = bytearray(line.tobytes())
            prev = up.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
            row = np.frombuffer(bytes(cur), dtype=np.uint8)
        else:
            raise ValueError(f"bad PNG row filter {f}")
        out[y + 1] = row
    return out[1:]


def _png_samples(raw: np.ndarray, pos: int, w: int, h: int, c: int,
                 depth: int):
    """The [h, w, c] samples of one (sub-)image's filtered scanlines at
    `raw[pos:]`, and the position after them."""
    stride = (w * c * depth + 7) // 8
    rows = raw[pos:pos + h * (stride + 1)]
    if rows.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = _unfilter_rows(rows.reshape(h, stride + 1), h, stride,
                          max(1, c * depth // 8))
    if depth == 8:
        samples = rows[:, :w * c]
    elif depth == 16:
        samples = rows[:, :2 * w * c].copy().view(">u2").astype(np.uint16)
    else:
        bits = np.unpackbits(rows, axis=1)[:, :w * c * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits.reshape(h, w * c, depth) * weights).sum(
            -1, dtype=np.uint8)
    return samples.reshape(h, w, c), pos + h * (stride + 1)


def _png_decode(data: bytes):
    """(pixels [H, W, C] in file channel order, colour type, tRNS payload)
    of a PNG: 8-bit as uint8 and 16-bit as uint16 samples, grey of 1, 2 or
    4 bits scaled to 8 (x 255, 85, 17, as libpng's expand), a palette
    expanded to RGB, or RGBA where a tRNS chunk gives its alpha, and Adam7
    interlacing undone.  Raises UnsupportedImage for invalid headers."""
    import zlib

    w, h, depth, ctype, interlace = _png_header(data)
    if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype] \
            or interlace not in (0, 1):
        raise UnsupportedImage(
            f"PNG of bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}")
    c = _PNG_CHANNELS[ctype]
    chunks = list(png_chunks(data))
    raw = np.frombuffer(zlib.decompress(
        b"".join(p for k, p in chunks if k == b"IDAT")), dtype=np.uint8)
    trns = next((p for k, p in chunks if k == b"tRNS"), None)
    if not interlace:
        pix, _ = _png_samples(raw, 0, w, h, c, depth)
    else:
        pix = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                sub, pos = _png_samples(raw, pos, pw, ph, c, depth)
                pix[y0::dy, x0::dx] = sub
    if ctype == 3:
        plte = next((p for k, p in chunks if k == b"PLTE"), None)
        if plte is None:
            raise UnsupportedImage("palette PNG without PLTE")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        n = len(plte) // 3
        table[:n, :3] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
        if trns:
            table[:len(trns), 3] = np.frombuffer(trns[:256], np.uint8)
        pix = table[pix[..., 0], :4 if trns else 3]
    elif depth < 8:
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
    return pix, ctype, trns


def decode_png(data: bytes) -> np.ndarray:
    """Pixels of a PNG as stored: [H, W] for grey, else [H, W, C] in file
    order (R, G, B, A); 16-bit samples as uint16, palettes expanded to RGB
    (RGBA with a tRNS chunk), grey below 8 bits scaled to 8 bits, Adam7
    interlacing undone."""
    pix = _png_decode(data)[0]
    return pix[..., 0] if pix.shape[2] == 1 else pix


def _png_imread(data: bytes, grayscale: bool, unchanged: bool,
                anydepth: bool) -> np.ndarray:
    """A PNG's pixels as cv2.imread gives them (in RGB order) before the
    EXIF orientation: UNCHANGED keeps 16 bits and gives RGBA for grey+alpha
    (GGGA), RGBA and palette or RGB with a tRNS chunk, the stored channels
    otherwise; colour and grey reads drop alpha, take libpng's rgb_to_gray
    for grey, and keep 16 bits only with `anydepth` (else the high byte,
    libpng's strip_16)."""
    pix, ctype, trns = _png_decode(data)
    c = pix.shape[2]
    if unchanged:
        if c == 2:  # grey+alpha -> GGGA
            return pix[..., [0, 0, 0, 1]]
        if ctype == 2 and trns and len(trns) >= 6:  # tRNS colour -> alpha
            key = np.frombuffer(trns[:6], ">u2").astype(pix.dtype)
            top = np.iinfo(pix.dtype).max
            alpha = np.where((pix == key).all(-1), 0, top).astype(pix.dtype)
            return np.concatenate([pix, alpha[..., None]], axis=2)
        return pix[..., 0] if c == 1 else pix
    if c >= 3 and grayscale:
        out = _grey(pix[..., :3], _PNG_GREY16 if pix.dtype == np.uint16
                    else _PNG_GREY, pix.dtype)
    elif c >= 3:
        out = pix[..., :3]
    elif grayscale:
        out = pix[..., 0]
    else:
        out = np.repeat(pix[..., :1], 3, axis=2)
    if pix.dtype == np.uint16 and not anydepth:
        out = (out >> 8).astype(np.uint8)
    return out


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    import zlib

    return (len(payload).to_bytes(4, "big") + kind + payload
            + (zlib.crc32(kind + payload) & 0xFFFFFFFF).to_bytes(4, "big"))


def encode_png(image: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit PNG of `image`: [H, W] (or [H, W, 1]) grey, [H, W, 2] grey
    and alpha, [H, W, 3] RGB or [H, W, 4] RGBA, channels in file order.
    Every row is Sub-filtered and the stream deflated by stdlib `zlib` at
    `level`; `decode_png` and `cv2.imread` read it back bit for bit."""
    import zlib

    pix = np.asarray(image)
    if pix.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 pixels, not {pix.dtype}")
    if pix.ndim == 3 and pix.shape[2] == 1:
        pix = pix[..., 0]
    c = 1 if pix.ndim == 2 else pix.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(c)
    if pix.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"encode_png takes 1 to 4 channels, not shape "
                         f"{pix.shape}")
    h, w = pix.shape[:2]
    rows = np.ascontiguousarray(pix).reshape(h, w * c)
    sub = rows.copy()
    sub[:, c:] -= rows[:, :-c]  # uint8 wraps: the Sub filter
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, ctype, 0, 0, 0]))
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def encode_jpeg(image: np.ndarray) -> bytes:
    """A baseline JPEG of uint8 `image` ([H, W] grey, [H, W, 3] RGB, or
    RGBA whose alpha is dropped) by the port's own codec, as cv2.imwrite
    writes it at its defaults (quality 95, 4:2:0, the standard Huffman
    tables): the same bytes in the tests."""
    from opensfm_tpu_torch import native

    pix = np.asarray(image)
    if pix.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8 pixels, not {pix.dtype}")
    if pix.ndim == 3 and pix.shape[2] == 4:
        pix = pix[..., :3]
    return native.jpeg_encode(pix)


def imwrite(path: str, image: np.ndarray) -> None:
    """Write uint8 pixels in RGB(A) order (as `imread` gives them): PNG
    by `encode_png` and JPEG by `encode_jpeg`, any other extension through
    cv2, which must then be installed."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext in ("png", "jpg", "jpeg"):
        data = encode_png(image) if ext == "png" else encode_jpeg(image)
        with open(path, "wb") as f:
            f.write(data)
        return
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f"writing {ext.upper()} images needs cv2 (opencv-python), which "
            f"is not installed; the port writes PNG and JPEG itself: "
            f"{path}") from None
    if image.ndim == 3 and image.shape[2] >= 3:
        image = image.copy()
        image[..., :3] = image[..., [2, 1, 0]]  # RGB -> BGR
    if not cv2.imwrite(path, image):
        raise IOError(f"Unable to write image {path}")


def _pnm_header(data: bytes):
    """(magic, width, height, maxval, offset of the pixels) of a binary
    PGM/PPM."""
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic = fields[0]
    if magic not in (b"P5", b"P6"):
        raise UnsupportedImage(f"PNM {magic!r}: the port decodes P5 and P6")
    return magic, int(fields[1]), int(fields[2]), int(fields[3]), pos + 1


def decode_pnm(data: bytes) -> np.ndarray:
    """Pixels of an 8-bit binary PGM (P5, [H, W]) or PPM (P6, [H, W, 3])."""
    magic, w, h, maxval, off = _pnm_header(data)
    if maxval > 255:
        raise UnsupportedImage(f"PNM of maxval {maxval}: the port decodes "
                               "8-bit PNM")
    c = 1 if magic == b"P5" else 3
    pix = np.frombuffer(data, dtype=np.uint8, count=w * h * c, offset=off)
    return pix.reshape(h, w) if c == 1 else pix.reshape(h, w, c)


def _grey(rgb: np.ndarray, weights, dtype=np.uint8) -> np.ndarray:
    wr, wg, wb, shift, rnd = weights
    x = rgb.astype(np.int64)
    return ((wr * x[..., 0] + wg * x[..., 1] + wb * x[..., 2] + rnd)
            >> shift).astype(dtype)


def _jpeg_imread(data: bytes, grayscale: bool) -> np.ndarray:
    """A JPEG's pixels by the port's codec, as cv2.imread gives them (RGB
    order) before the EXIF orientation: [H, W, 3] for a YCbCr file unless
    `grayscale` (its Y plane, libjpeg's grey output), [H, W] for a grey
    file."""
    from opensfm_tpu_torch import native

    try:
        return native.jpeg_decode(data, grey=grayscale)
    except native.JpegUnsupported as e:
        raise UnsupportedImage(f"JPEG variant: {e}") from None


def apply_orientation(image: np.ndarray, orientation: int) -> np.ndarray:
    """`image` turned upright for its EXIF orientation (1-8), as OpenCV's
    ExifTransform does."""
    if orientation in (5, 6, 7, 8):
        image = image.swapaxes(0, 1)
    flip = {2: (slice(None), slice(None, None, -1)),
            3: (slice(None, None, -1), slice(None, None, -1)),
            4: (slice(None, None, -1),),
            6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1), slice(None, None, -1)),
            8: (slice(None, None, -1),)}.get(orientation)
    return image[flip] if flip else image


def _library_imread(path: str, grayscale: bool, unchanged: bool,
                    anydepth: bool = False) -> np.ndarray:
    """Formats the port does not decode itself, through cv2 or else PIL;
    `anydepth` keeps 16-bit samples (cv2.IMREAD_ANYDEPTH, or PIL's
    16-bit grey modes) instead of reducing them to 8 bits."""
    ext = path.rsplit(".", 1)[-1].lower()
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        flags = (cv2.IMREAD_GRAYSCALE if grayscale else
                 cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR)
        if anydepth:
            flags |= cv2.IMREAD_ANYDEPTH
        image = cv2.imread(path, flags)
        if image is None:
            raise IOError(f"Unable to load image {path}")
        if image.ndim == 3 and image.shape[2] >= 3:
            image = image.copy()
            image[..., :3] = image[..., [2, 1, 0]]  # BGR -> RGB
        return image
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"reading {ext.upper()} images needs cv2 (opencv-python) or PIL "
            f"(Pillow), and neither is installed; the port decodes PNG, JPEG "
            f"and PGM/PPM itself: {path}") from None
    with Image.open(path) as img:
        if anydepth and img.mode.startswith("I;16"):
            return np.asarray(img).astype(np.uint16)
        if grayscale:
            img = img.convert("L")
        elif not unchanged and img.mode != "RGB":
            img = img.convert("RGB")
        return np.asarray(img).copy()


def imread(path: str, grayscale: bool = False, unchanged: bool = False,
           anydepth: bool = False) -> np.ndarray:
    """An image's pixels as cv2.imread gives them, with RGB order: [H, W, 3]
    RGB by default (grey replicated, alpha dropped), [H, W] with
    `grayscale`, the stored channels with `unchanged` (grey+alpha as four
    channels, as OpenCV gives it), 16-bit samples kept with `anydepth` or
    `unchanged`.  Colour and grey reads turn the image upright for its EXIF
    orientation, as cv2 does; `unchanged` does not.  PNG (every variant),
    JPEG (baseline and progressive Huffman, by the native codec) and
    binary PGM/PPM are decoded here; other formats and JPEG variants need
    cv2 or PIL."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(PNG_SIGNATURE):
            image = _png_imread(data, grayscale, unchanged, anydepth)
        elif data[:2] == b"\xff\xd8":
            image = _jpeg_imread(data, grayscale)
            if image.ndim == 2 and not (grayscale or unchanged):
                image = np.repeat(image[:, :, None], 3, axis=2)
        elif data[:2] in (b"P5", b"P6"):
            pix = decode_pnm(data)
            if unchanged or (pix.ndim == 3) != grayscale:
                return pix.copy()
            if grayscale:
                return _grey(pix, _CV_GREY)
            return np.repeat(pix[:, :, None], 3, axis=2)
        else:
            return _library_imread(path, grayscale, unchanged, anydepth)
    except UnsupportedImage:
        return _library_imread(path, grayscale, unchanged, anydepth)
    if not unchanged:
        from opensfm_tpu_torch import exif

        image = apply_orientation(image, exif.orientation(data))
    return np.ascontiguousarray(image)


def image_size_from_header(head: bytes) -> Optional[Tuple[int, int]]:
    """(height, width) as stored, read from the first bytes of a PNG,
    PGM/PPM or JPEG file (no EXIF orientation); None for other formats."""
    if head[:2] in (b"P5", b"P6"):
        _, w, h, _, _ = _pnm_header(head)
        return h, w
    found = walk_header(BytesIO(head), head)
    return found[0] if found is not None else None


def walk_header(f, data: bytes):
    """((height, width) as stored, the EXIF block or None) of the PNG or
    JPEG file `f` whose first bytes are `data`, reading only headers: the
    chunk or segment headers by seeks, and the payloads of IHDR / SOF and of
    the EXIF chunk or APP1 segment; None for other formats."""
    size, tiff = None, None
    if data.startswith(PNG_SIGNATURE):
        f.seek(len(PNG_SIGNATURE))
        while True:
            head = f.read(8)
            if len(head) < 8 or head[4:] == b"IEND":
                break
            n, kind = int.from_bytes(head[:4], "big"), head[4:]
            if kind in (b"IHDR", b"eXIf"):
                payload = f.read(n)
                f.seek(4, 1)
                if kind == b"IHDR":
                    size = (int.from_bytes(payload[4:8], "big"),
                            int.from_bytes(payload[0:4], "big"))
                else:
                    tiff = payload[6:] if payload.startswith(b"Exif\0\0") \
                        else payload
            else:
                f.seek(n + 4, 1)
        return size, tiff
    if data[:2] != b"\xff\xd8":
        return None
    # The markers are walked by the JPEG codec's rules: bytes between
    # markers are skipped, and SOI, RSTn and TEM carry no length.
    f.seek(2)
    while True:
        head = f.read(2)
        if len(head) < 2:
            break
        marker = head[1]
        if head[0] != 0xFF or marker == 0xFF:
            f.seek(-1, 1)
            continue
        if marker in (0xD9, 0xDA):  # end of image, start of scan
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        n = int.from_bytes(f.read(2), "big")
        if n < 2:
            break
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            sof = f.read(5)
            if len(sof) < 5:
                break
            if size is None:
                size = (int.from_bytes(sof[1:3], "big"),
                        int.from_bytes(sof[3:5], "big"))
            f.seek(n - 7, 1)
        elif marker == 0xE1 and tiff is None:
            payload = f.read(n - 2)
            if payload.startswith(b"Exif\0\0"):
                tiff = payload[6:]
        else:
            f.seek(n - 2, 1)
    return size, tiff


def image_size(path: str, upright: bool = True) -> Tuple[int, int]:
    """(height, width) of an image as `imread(path, grayscale=True)` gives
    it (the JAX package's `IoFilesystemDefault.image_size`), from the
    headers of a PNG, PGM/PPM or JPEG, swapped for EXIF orientations 5-8
    unless `upright` is False (the size as stored, which the JAX package's
    `DataSet.image_size` reads through PIL); other formats through PIL or
    cv2."""
    from opensfm_tpu_torch import exif

    with open(path, "rb") as f:
        head = f.read(1 << 16)
        if head[:2] in (b"P5", b"P6"):
            return image_size_from_header(head)
        found = walk_header(f, head)
    if found is not None and found[0] is not None:
        size, tiff = found
        if upright and exif.tiff_orientation(tiff) >= 5:
            size = (size[1], size[0])
        return size
    try:
        from PIL import Image

        with Image.open(path) as img:
            w, h = img.size
        return h, w
    except ImportError:
        image = _library_imread(path, True, False)
        return image.shape[0], image.shape[1]


class IoFilesystemBase:
    """Abstract filesystem interface for `DataSet` storage backends."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def ls(self, path: str) -> List[str]:
        raise NotImplementedError

    def isfile(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def rm_if_exist(self, filename: str) -> None:
        raise NotImplementedError

    def symlink(self, src_path: str, dst_path: str, **kwargs: Any) -> None:
        raise NotImplementedError

    def open(self, path: str, mode: str = "rt"):
        raise NotImplementedError

    def open_wb(self, path: str):
        return self.open(path, "wb")

    def open_rb(self, path: str):
        return self.open(path, "rb")

    def open_wt(self, path: str):
        return self.open(path, "wt")

    def open_rt(self, path: str):
        return self.open(path, "rt")

    def open_at(self, path: str):
        return self.open(path, "at")

    def mkdir_p(self, path: str) -> None:
        raise NotImplementedError

    def imread(self, path: str, grayscale: bool = False,
               unchanged: bool = False, anydepth: bool = False) -> np.ndarray:
        raise NotImplementedError

    def imwrite(self, path: str, image: np.ndarray) -> None:
        raise NotImplementedError

    def image_size(self, path: str) -> Tuple[int, int]:
        raise NotImplementedError

    def timestamp(self, path: str) -> float:
        raise NotImplementedError


class IoFilesystemDefault(IoFilesystemBase):
    """Local-filesystem implementation (reference: io.py:1429-1510)."""

    type = "default"

    def exists(self, path: str) -> bool:
        import os
        return os.path.exists(path)

    def ls(self, path: str) -> List[str]:
        import os
        return os.listdir(path)

    def isfile(self, path: str) -> bool:
        import os
        return os.path.isfile(path)

    def isdir(self, path: str) -> bool:
        import os
        return os.path.isdir(path)

    def rm_if_exist(self, filename: str) -> None:
        import os
        import shutil
        if os.path.islink(filename):
            os.unlink(filename)
        elif os.path.isdir(filename):
            shutil.rmtree(filename)
        elif os.path.exists(filename):
            os.remove(filename)

    def symlink(self, src_path: str, dst_path: str, **kwargs: Any) -> None:
        import os
        os.symlink(src_path, dst_path, **kwargs)

    def open(self, path: str, mode: str = "rt"):
        return open(path, mode)

    def mkdir_p(self, path: str) -> None:
        import os
        os.makedirs(path, exist_ok=True)

    def imread(self, path: str, grayscale: bool = False,
               unchanged: bool = False, anydepth: bool = False) -> np.ndarray:
        return imread(path, grayscale=grayscale, unchanged=unchanged,
                      anydepth=anydepth)

    def imwrite(self, path: str, image: np.ndarray) -> None:
        imwrite(path, image)

    def image_size(self, path: str) -> Tuple[int, int]:
        return image_size(path)

    def timestamp(self, path: str) -> float:
        import os
        return os.path.getmtime(path)
