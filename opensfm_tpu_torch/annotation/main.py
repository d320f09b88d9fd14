"""Web GCP annotation tool (stdlib HTTP, no flask) on the port.

Port of `annotation_gui_gcp/main.py`, which mirrors the reference
`annotation_gui_gcp/main.py` + `lib/GUI.py`: browse the dataset's images
side by side, click to add GCP observations, persist them to
`ground_control_points.json` (the format `run_ba.py` and the pipeline's GCP
alignment read), and run the analyses of `opensfm_tpu_torch.annotation.
run_ba` on `--device` (CUDA unless told otherwise).  The annotation store
(`annotation_gui_gcp/lib/gcp_manager.py`) and the page
(`annotation_gui_gcp/templates/annotation.html`) are shared with the JAX
package's tool; neither imports either package.

    python -m opensfm_tpu_torch.annotation.main <dataset> [--port 8090]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import posixpath
import queue
import threading
import time
import urllib.parse
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import torch

from annotation_gui_gcp.lib.gcp_manager import GroundControlPointManager
from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.annotation import run_ba
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.geo import TopocentricConverter

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TEMPLATE = os.path.join(REPO, "annotation_gui_gcp", "templates",
                        "annotation.html")

# Errors of the device (out of memory, a failed launch or build, no CUDA):
# /analyze reports a dataset's faults to the page and lets these through.
_DEVICE_ERRORS = (torch.OutOfMemoryError,
                  getattr(torch, "AcceleratorError", torch.OutOfMemoryError))
_DEVICE_MARKERS = ("CUDA", "nvcc", "kernel launch")


def analyze_dataset(dataset_path: str, device=None):
    """Triangulate annotated GCPs against the dataset's reconstruction and
    report per-observation reprojection + geopositional errors (reference
    annotation_gui_gcp run_ba analysis loop)."""
    data = DataSet(dataset_path)
    if not data.reconstruction_exists():
        return {"error": "no reconstruction.json — run the pipeline first"}
    rec = data.load_reconstruction()[0]
    gcps = data.load_ground_control_points()
    if not gcps:
        return {"error": "no annotated GCPs"}
    reproj = run_ba.reproject_gcps(gcps, rec, device=device)
    geo = run_ba.gcp_geopositional_error(gcps, rec, device=device)
    return {"reprojections": reproj, "geo_errors": geo}


def run_analysis(dataset_path: str, mode: str, device=None):
    """The tools pane's analysis (reference tools_view.py:12-31 +
    GUI.py:103-134): "reproject" = quick GCP reprojection check,
    "rigid"/"flex"/"full" = the run_ba alignment variants.  A dataset that
    cannot be aligned (no tracks, reconstructions or GCPs, too few common
    GCPs) gives {"error": ...}; a device error propagates."""
    if mode == "reproject":
        return analyze_dataset(dataset_path, device=device)
    try:
        return run_ba.align(dataset_path, mode=mode, device=device)
    except (RuntimeError, OSError, ValueError) as e:
        device_fault = isinstance(e, _DEVICE_ERRORS) or (
            not isinstance(e, OSError)
            and any(m in str(e) for m in _DEVICE_MARKERS))
        if device_fault:
            raise
        return {"error": f"{type(e).__name__}: {e}"}


def load_model_payload(dataset_path: str):
    """Reconstruction summary for the map/CAD pane (reference
    annotation_gui_gcp/lib/views/cad_view.py role: a georeferenced model
    the user clicks to place control points): subsampled point cloud,
    shot origins and the topocentric reference."""
    data = DataSet(dataset_path)
    if not data.reconstruction_exists():
        return {"error": "no reconstruction.json — run the pipeline first"}
    rec = data.load_reconstruction()[0]
    pts = list(rec.points.values())
    step = max(len(pts) // 20000, 1)
    points = []
    for p in pts[::step]:
        c = p.coordinates
        col = getattr(p, "color", None)
        col = [int(x) for x in col] if col is not None else [180, 180, 180]
        points.append([
            round(float(c[0]), 3), round(float(c[1]), 3),
            round(float(c[2]), 3), col[0], col[1], col[2],
        ])
    shots = {
        sid: [round(float(v), 3) for v in shot.pose.get_origin()]
        for sid, shot in rec.shots.items()
    }
    ref = None
    if data.reference_lla_exists():
        lla = data.load_reference_lla()
        ref = [lla["latitude"], lla["longitude"], lla["altitude"]]
    return {"points": points, "shots": shots, "reference_lla": ref}


_DISTINCT_COLORS = [
    "#46f0f0", "#f032e6", "#bcf60c", "#fabebe", "#008080", "#e6beff",
    "#9a6324", "#fffac8", "#800000", "#aaffc3", "#808000", "#ffd8b1",
    "#000075", "#808080", "#ffffff", "#e6194b", "#3cb44b", "#ffe119",
    "#4363d8",
]


def point_color(point_id: str) -> str:
    """Per-point color (reference lib/views/image_view.py:7-9 point_color
    over web_view.distinct_colors); it follows the process's hash seed."""
    return _DISTINCT_COLORS[hash(point_id) % 19]


def visible_points(manager, image: str):
    """Control-point observations in one image with their colors — the
    reference ImageView.sync_to_client payload (image_view.py:78-100):
    lets the client draw every annotated point on the displayed frame."""
    out = {}
    for point_id, point in manager.points.items():
        for obs in point["observations"]:
            if obs["shot_id"] == image:
                out[point_id] = {
                    "projection": obs["projection"],
                    "color": point_color(point_id),
                }
    return out


def point_images(manager, point_id: str):
    """Images observing a control point, in filename order — track-level
    navigation (the reference image_view's jump-through-track flow)."""
    point = manager.points.get(point_id)
    if not point:
        return []
    return sorted(o["shot_id"] for o in point["observations"])


def cp_finder_candidates(manager, point_id: str, shown):
    """Candidate images for the selected control point, images not in any
    other open view first (reference lib/views/cp_finder_view.py:21-37
    get_candidate_images ordering)."""
    point = manager.points.get(point_id)
    if not point:
        return []
    observed = [o["shot_id"] for o in point["observations"]]
    unaccounted = [i for i in observed if i not in shown]
    in_views = [i for i in observed if i in shown]
    return unaccounted + in_views


def set_position_from_world(manager, dataset_path: str, point_id: str,
                            x: float, y: float, z: float = 0.0):
    """Click in the georeferenced model pane -> world (topocentric)
    coordinates -> LLA position for the point (reference cad_view.py
    add_remove_update_point_observation with is_geo_reference=True: the
    model click PLACES the point)."""
    data = DataSet(dataset_path)
    if not data.reference_lla_exists():
        return {"error": "no reference_lla.json"}
    lla = data.load_reference_lla()
    conv = TopocentricConverter(
        lla["latitude"], lla["longitude"], lla["altitude"]
    )
    lat, lon, alt = conv.to_lla(x, y, z)
    if point_id not in manager.points:
        manager.add_point(point_id)
    manager.set_point_position(point_id, float(lat), float(lon), float(alt))
    manager.write_to_file()
    return {
        "ok": True, "latitude": float(lat), "longitude": float(lon),
        "altitude": float(alt),
    }


# --- Server -> client push channel (reference lib/views/web_view.py:74-90:
# every view holds an event queue drained into a Server-Sent Events
# stream; state changes broadcast a "sync" event so every open pane
# refreshes without polling). ---------------------------------------------
_SSE_CLIENTS: list = []
_SSE_LOCK = threading.Lock()


def broadcast_sync(data=None, event_type="sync") -> None:
    """Queue an SSE message for every connected client
    (web_view.py:send_sse_message semantics, incl. the time field)."""
    payload = dict(data or {})
    payload["time"] = time.time()
    msg = f"event: {event_type}\ndata: {json.dumps(payload)}\n\n"
    with _SSE_LOCK:
        clients = list(_SSE_CLIENTS)
    for q in clients:
        q.put(msg)


class AnnotationHandler(SimpleHTTPRequestHandler):
    dataset_path = "."
    manager: GroundControlPointManager = None
    device = None  # where /analyze runs (resolve_device's default: CUDA)

    def do_GET(self):  # noqa: N802 (stdlib API)
        parsed = urllib.parse.urlparse(self.path)
        path = posixpath.normpath(parsed.path)
        query = urllib.parse.parse_qs(parsed.query)
        if path in ("/", "/index.html"):
            return self._serve_file(TEMPLATE, "text/html")
        if path == "/images":
            images = sorted(
                os.listdir(os.path.join(self.dataset_path, "images"))
            )
            return self._json({"images": images})
        if path == "/sequences":
            return self._json({"sequences": self._sequences()})
        if path == "/points":
            return self._json({"points": self.manager.points})
        if path == "/model":
            return self._json(load_model_payload(self.dataset_path))
        if path == "/visible_points":
            image = (query.get("image") or [""])[0]
            return self._json({
                "points": visible_points(self.manager, image),
            })
        if path == "/point_images":
            point_id = (query.get("point_id") or [""])[0]
            return self._json({
                "images": point_images(self.manager, point_id),
            })
        if path == "/cp_finder":
            point_id = (query.get("point_id") or [""])[0]
            shown = [
                s for s in (query.get("shown") or [""])[0].split(",") if s
            ]
            return self._json({
                "images": cp_finder_candidates(
                    self.manager, point_id, shown
                ),
            })
        if path.startswith("/image/"):
            image = urllib.parse.unquote(path[len("/image/"):])
            candidate = os.path.join(self.dataset_path, "images", image)
            return self._serve_file(candidate, "image/jpeg")
        if path == "/stream":
            return self._serve_stream()
        self.send_error(404)

    def _serve_stream(self):
        """Server-Sent Events endpoint: blocks this handler thread on a
        per-client queue (the server is threading, so other requests keep
        flowing) and relays every broadcast_sync message."""
        q: "queue.Queue[str]" = queue.Queue()
        with _SSE_LOCK:
            _SSE_CLIENTS.append(q)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            while True:
                try:
                    msg = q.get(timeout=15.0)
                except queue.Empty:
                    msg = ": keepalive\n\n"
                self.wfile.write(msg.encode())
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            with _SSE_LOCK:
                if q in _SSE_CLIENTS:
                    _SSE_CLIENTS.remove(q)

    def _sequences(self):
        """Images grouped by camera id — the reference GUI's per-rig-camera
        sequence views (lib/GUI.py rig_groups / sequence_views); one group
        where the EXIF cannot be read."""
        groups = {}
        images = sorted(
            os.listdir(os.path.join(self.dataset_path, "images"))
        )
        try:
            data = DataSet(self.dataset_path)
            for image in images:
                cam = "unknown"
                if data.exif_exists(image):
                    cam = data.load_exif(image).get("camera", "unknown")
                groups.setdefault(cam, []).append(image)
        except (OSError, ValueError, KeyError, AttributeError):
            groups = {"all": images}
        return groups

    def do_POST(self):  # noqa: N802 (stdlib API)
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        parsed = urllib.parse.urlparse(self.path)
        path = posixpath.normpath(parsed.path)
        m = self.manager
        if path == "/add_observation":
            point_id = body["point_id"]
            if point_id not in m.points:
                m.add_point(point_id)
            m.add_point_observation(
                point_id, body["shot_id"], body["projection"]
            )
            m.write_to_file()
            broadcast_sync({"point_id": point_id})
            return self._json({"ok": True})
        if path == "/remove_observation":
            m.remove_point_observation(body["point_id"], body["shot_id"])
            m.write_to_file()
            broadcast_sync({"point_id": body["point_id"]})
            return self._json({"ok": True})
        if path == "/remove_point":
            m.remove_point(body["point_id"])
            m.write_to_file()
            broadcast_sync({"point_id": body["point_id"]})
            return self._json({"ok": True})
        if path == "/set_position":
            m.set_point_position(
                body["point_id"], body["latitude"], body["longitude"],
                body.get("altitude"),
            )
            m.write_to_file()
            broadcast_sync({"point_id": body["point_id"]})
            return self._json({"ok": True})
        if path == "/cad_position":
            return self._json(set_position_from_world(
                m, self.dataset_path, body["point_id"],
                float(body["x"]), float(body["y"]),
                float(body.get("z", 0.0)),
            ))
        if path == "/analyze":
            mode = str(body.get("mode", "reproject"))
            return self._json(
                run_analysis(self.dataset_path, mode, device=self.device))
        self.send_error(404)

    def _json(self, obj):
        payload = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _serve_file(self, filepath, content_type):
        if not os.path.isfile(filepath):
            self.send_error(404)
            return
        with open(filepath, "rb") as f:
            payload = f.read()
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):  # quiet
        pass


def make_server(dataset: str, port: int = 8090, device=None,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The tool's server on `dataset` (port 0: an ephemeral port).  The
    device resolves here, so a host without CUDA fails at start unless
    `device` says otherwise."""
    AnnotationHandler.dataset_path = os.path.abspath(dataset)
    AnnotationHandler.manager = GroundControlPointManager(
        AnnotationHandler.dataset_path
    )
    AnnotationHandler.device = resolve_device(device)
    # Threading: the SSE stream endpoint holds its handler thread open.
    return ThreadingHTTPServer((host, port), AnnotationHandler)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="GCP annotation tool")
    parser.add_argument("dataset", help="dataset path")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument(
        "--device", default=None,
        help="torch device the analyses run on (default: cuda; 'cpu' to "
        "run on the CPU)",
    )
    args = parser.parse_args(argv)
    server = make_server(args.dataset, args.port, args.device)
    print(f"Annotating {args.dataset} at "
          f"http://localhost:{server.server_address[1]} "
          f"(analyses on {AnnotationHandler.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
