"""OpenMVS scene (.mvs) binary writer.

Port of `opensfm_tpu.io_openmvs` (the same bytes).  Pure-Python serializer
for the MVS::Interface stream format (reference
src/third_party/openmvs/Interface.h, used by src/dense/openmvs_exporter.h):
"MVSI" magic + u32 version + u32 reserved, then the Interface struct with
u64-length-prefixed strings/vectors, row-major f64 matrices, f32 vertex
positions.  Written for project version 6 (MVSI_PROJECT_VER), loadable by
OpenMVS `InterfaceMVS`-based tools (DensifyPointCloud etc.).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np

MVSI_PROJECT_ID = b"MVSI"
MVSI_PROJECT_VER = 6
NO_ID = 0xFFFFFFFF


class _Writer:
    def __init__(self) -> None:
        self.chunks: List[bytes] = []

    def u32(self, v: int) -> None:
        self.chunks.append(struct.pack("<I", v & 0xFFFFFFFF))

    def u64(self, v: int) -> None:
        self.chunks.append(struct.pack("<Q", v))

    def f32(self, v) -> None:
        self.chunks.append(np.asarray(v, dtype="<f4").tobytes())

    def f64(self, v) -> None:
        self.chunks.append(np.asarray(v, dtype="<f8").tobytes())

    def string(self, s: str) -> None:
        raw = s.encode("utf-8")
        self.u64(len(raw))
        if raw:
            self.chunks.append(raw)

    def bytes_(self, b: bytes) -> None:
        self.chunks.append(b)

    def data(self) -> bytes:
        return b"".join(self.chunks)


class Camera:
    """Platform camera: intrinsics + relative pose (Interface.h:375-403)."""

    def __init__(self, name: str, width: int, height: int, K: np.ndarray,
                 R: Optional[np.ndarray] = None,
                 C: Optional[np.ndarray] = None, band_name: str = "") -> None:
        self.name = name
        self.band_name = band_name
        self.width = int(width)
        self.height = int(height)
        self.K = np.asarray(K, np.float64).reshape(3, 3)
        self.R = (np.asarray(R, np.float64).reshape(3, 3)
                  if R is not None else np.eye(3))
        self.C = (np.asarray(C, np.float64).reshape(3)
                  if C is not None else np.zeros(3))

    def write(self, w: _Writer) -> None:
        w.string(self.name)
        w.string(self.band_name)  # version > 3
        w.u32(self.width)         # version > 0
        w.u32(self.height)
        w.f64(self.K)
        w.f64(self.R)
        w.f64(self.C)


class Pose:
    """World-to-camera rotation + camera center (Interface.h:407-428)."""

    def __init__(self, R: np.ndarray, C: np.ndarray) -> None:
        self.R = np.asarray(R, np.float64).reshape(3, 3)
        self.C = np.asarray(C, np.float64).reshape(3)

    def write(self, w: _Writer) -> None:
        w.f64(self.R)
        w.f64(self.C)


class Platform:
    def __init__(self, name: str) -> None:
        self.name = name
        self.cameras: List[Camera] = []
        self.poses: List[Pose] = []

    def write(self, w: _Writer) -> None:
        w.string(self.name)
        w.u64(len(self.cameras))
        for c in self.cameras:
            c.write(w)
        w.u64(len(self.poses))
        for p in self.poses:
            p.write(w)


class Image:
    def __init__(self, name: str, mask_name: str, platform_id: int,
                 camera_id: int, pose_id: int, image_id: int = NO_ID) -> None:
        self.name = name
        self.mask_name = mask_name
        self.platform_id = platform_id
        self.camera_id = camera_id
        self.pose_id = pose_id
        self.id = image_id

    def write(self, w: _Writer) -> None:
        w.string(self.name)
        w.string(self.mask_name)  # version > 4
        w.u32(self.platform_id)
        w.u32(self.camera_id)
        w.u32(self.pose_id)
        w.u32(self.id)            # version > 2


class Vertex:
    def __init__(self, X: np.ndarray, views: Sequence[int],
                 confidences: Optional[Sequence[float]] = None) -> None:
        self.X = np.asarray(X, np.float32).reshape(3)
        self.views = list(views)
        self.confidences = (list(confidences) if confidences is not None
                            else [0.0] * len(self.views))

    def write(self, w: _Writer) -> None:
        w.f32(self.X)
        w.u64(len(self.views))
        for image_id, conf in zip(self.views, self.confidences):
            w.u32(image_id)
            w.f32(conf)


class OpenMVSExporter:
    """pydense.OpenMVSExporter parity (dense/openmvs_exporter.h:7-70):
    one platform per camera, poses appended per shot, vertices with view
    lists; `export()` writes the version-6 binary stream."""

    def __init__(self) -> None:
        self.platforms: List[Platform] = []
        self.images: List[Image] = []
        self.vertices: List[Vertex] = []
        self._platform_ids = {}
        self._image_ids = {}

    def add_camera(self, camera_id: str, K: np.ndarray, width: int,
                   height: int) -> None:
        platform = Platform(camera_id)
        platform.cameras.append(Camera(camera_id, width, height, K))
        self._platform_ids[camera_id] = len(self.platforms)
        self.platforms.append(platform)

    def add_shot(self, path: str, mask_path: str, shot_id: str,
                 camera_id: str, R: np.ndarray, C: np.ndarray) -> None:
        platform_id = self._platform_ids[camera_id]
        platform = self.platforms[platform_id]
        pose_id = len(platform.poses)
        platform.poses.append(Pose(R, C))
        self._image_ids[shot_id] = len(self.images)
        self.images.append(Image(path, mask_path, platform_id, 0, pose_id))

    def add_point(self, coordinates: np.ndarray,
                  shot_ids: Sequence[str]) -> None:
        views = [self._image_ids[s] for s in shot_ids if s in self._image_ids]
        if views:
            self.vertices.append(Vertex(coordinates, views))

    def export(self, filename: str) -> None:
        w = _Writer()
        w.bytes_(MVSI_PROJECT_ID)
        w.u32(MVSI_PROJECT_VER)
        w.u32(0)  # reserved

        # Interface::serialize (Interface.h:622-641), version 6.
        w.u64(len(self.platforms))
        for p in self.platforms:
            p.write(w)
        w.u64(len(self.images))
        for im in self.images:
            im.write(w)
        w.u64(len(self.vertices))
        for v in self.vertices:
            v.write(w)
        w.u64(0)  # verticesNormal
        w.u64(0)  # verticesColor
        w.u64(0)  # lines            (version > 0)
        w.u64(0)  # linesNormal
        w.u64(0)  # linesColor
        w.f64(np.eye(4))  # transform (version > 1)
        # obb (version > 5): rot + ptMin + ptMax
        w.f64(np.eye(3))
        w.f64(np.zeros(3))
        w.f64(np.zeros(3))

        with open(filename, "wb") as f:
            f.write(w.data())


class _Reader:
    """Minimal stream reader (testing / debugging)."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def f32(self, n: int = 1) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype="<f4")

    def f64(self, n: int = 1) -> np.ndarray:
        return np.frombuffer(self.take(8 * n), dtype="<f8")

    def string(self) -> str:
        n = self.u64()
        return self.take(n).decode("utf-8") if n else ""


def read_mvs(filename: str) -> dict:
    """Parse a .mvs scene back into plain dicts (round-trip validation)."""
    with open(filename, "rb") as f:
        r = _Reader(f.read())
    if r.take(4) != MVSI_PROJECT_ID:
        raise ValueError(f"{filename} is not an OpenMVS scene (bad magic)")
    version = r.u32()
    r.u32()  # reserved
    scene = {"version": version, "platforms": [], "images": [], "vertices": []}
    for _ in range(r.u64()):
        p = {"name": r.string(), "cameras": [], "poses": []}
        for _ in range(r.u64()):
            cam = {"name": r.string()}
            if version > 3:
                cam["band_name"] = r.string()
            if version > 0:
                cam["width"] = r.u32()
                cam["height"] = r.u32()
            cam["K"] = r.f64(9).reshape(3, 3)
            cam["R"] = r.f64(9).reshape(3, 3)
            cam["C"] = r.f64(3)
            p["cameras"].append(cam)
        for _ in range(r.u64()):
            p["poses"].append({"R": r.f64(9).reshape(3, 3), "C": r.f64(3)})
        scene["platforms"].append(p)
    for _ in range(r.u64()):
        im = {"name": r.string()}
        if version > 4:
            im["mask_name"] = r.string()
        im["platform_id"] = r.u32()
        im["camera_id"] = r.u32()
        im["pose_id"] = r.u32()
        if version > 2:
            im["id"] = r.u32()
        scene["images"].append(im)
    for _ in range(r.u64()):
        X = r.f32(3)
        views = [(r.u32(), float(r.f32(1)[0])) for _ in range(r.u64())]
        scene["vertices"].append({"X": X, "views": views})
    return scene
