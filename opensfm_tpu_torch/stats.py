"""Reconstruction statistics + quality plots.

Port of `opensfm_tpu.stats` (reference `opensfm/stats.py`:
compute_all_statistics:455, reconstruction_statistics:196,
processing_statistics:288, gps_errors:74, gcp_errors:81,
save_matchgraph:501, save_residual_histogram:568, save_topview:622,
save_heatmap:795).  The numbers are the JAX package's, key for key.  The
figures need no matplotlib: each `*_figure(s)` function computes the data
the JAX package hands to matplotlib and keeps it as a small spec, which
`draw_*` rasterizes through `plot` on a device (the card unless told
otherwise) at the JAX figure's nominal size (figsize x 150 dpi) and
`save_*` writes as PNG through `io.encode_png`.
"""

from __future__ import annotations

import datetime
import json
import logging
import math
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from opensfm_tpu_torch import multiview, plot, pymap, types

logger = logging.getLogger(__name__)

RESIDUAL_PIXEL_CUTOFF = 4


def _norm2d(point: np.ndarray) -> float:
    return math.sqrt(point[0] ** 2 + point[1] ** 2)


def gps_errors(reconstructions: List[types.Reconstruction]) -> Dict[str, Any]:
    """GPS position residuals of the reconstructed shots (stats.py:74-79)."""
    errors = []
    for rec in reconstructions:
        for shot in rec.shots.values():
            if shot.metadata.gps_position.has_value:
                bias = rec.biases[shot.camera.id]
                gps = bias.transform(shot.metadata.gps_position.value)
                errors.append(np.asarray(shot.pose.get_origin() - gps))
    return _gps_gcp_errors_stats(np.array(errors))


def gcp_errors(data, reconstructions: List[types.Reconstruction],
               device=None) -> Dict[str, Any]:
    """GCP position residuals (stats.py:81-112), each GCP triangulated on
    `device`.  An absent GCP file means no GCPs; any other failure to load
    them raises."""
    all_errors = []
    try:
        gcps = data.load_ground_control_points()
    except FileNotFoundError:
        gcps = []
    if not gcps:
        return {}
    for gcp in gcps:
        if not gcp.lla:
            continue
        for rec in reconstructions:
            triangulated = multiview.triangulate_gcp(gcp, rec.shots,
                                                     device=device)
            if triangulated is None:
                continue
            gcp_enu = np.asarray(rec.reference.to_topocentric(*gcp.lla_vec))
            all_errors.append(triangulated - gcp_enu)
            break
    # GCP reports keep the 90th-percentile circular/linear errors the
    # reference's PDF report quotes.
    return _gps_gcp_errors_stats(np.array(all_errors), percentiles=True)


def _gps_gcp_errors_stats(errors: np.ndarray, percentiles: bool = False
                          ) -> Dict[str, Any]:
    if errors is None or len(errors) == 0:
        return {}
    stats_out: Dict[str, Any] = {}
    squared = errors * errors
    m_squared = np.mean(squared, 0)
    mean = np.mean(errors, 0)
    std_dev = np.std(errors, 0)
    average = np.average(np.linalg.norm(errors, axis=1))
    stats_out["mean"] = {"x": mean[0], "y": mean[1], "z": mean[2]}
    stats_out["std"] = {"x": std_dev[0], "y": std_dev[1], "z": std_dev[2]}
    stats_out["error"] = {
        "x": math.sqrt(m_squared[0]),
        "y": math.sqrt(m_squared[1]),
        "z": math.sqrt(m_squared[2]),
    }
    stats_out["average_error"] = average
    if percentiles:
        stats_out["ce90"] = _ce90(errors)
        stats_out["le90"] = _le90(errors)
    return stats_out


def _ce90(errors: np.ndarray) -> float:
    """90th percentile horizontal error."""
    horizontal = np.linalg.norm(errors[:, :2], axis=1)
    return float(np.percentile(horizontal, 90)) if len(horizontal) else 0.0


def _le90(errors: np.ndarray) -> float:
    """90th percentile vertical error."""
    vertical = np.abs(errors[:, 2])
    return float(np.percentile(vertical, 90)) if len(vertical) else 0.0


def td_grid_resolution(reconstruction: types.Reconstruction) -> float:
    return 0.0


def processing_statistics(
    data, reconstructions: List[types.Reconstruction]
) -> Dict[str, Any]:
    """Stage wall times from reports/, run date, covered area
    (stats.py:288-339)."""
    steps = {
        "Feature Extraction": "features.json",
        "Features Matching": "matches.json",
        "Tracks Merging": "tracks.json",
        "Reconstruction": "reconstruction.json",
    }

    steps_times = {}
    data_path = getattr(data, "data_path", None)
    for step_name, report_file in steps.items():
        obj: Dict[str, Any] = {}
        if data_path is not None:
            file_path = os.path.join(data_path, "reports", report_file)
            if os.path.exists(file_path):
                with open(file_path) as fin:
                    obj = json.load(fin)
        if "wall_time" in obj:
            steps_times[step_name] = obj["wall_time"]
        elif "wall_times" in obj:
            steps_times[step_name] = sum(obj["wall_times"].values())
        else:
            steps_times[step_name] = -1

    stats_out: Dict[str, Any] = {"steps_times": steps_times}
    stats_out["steps_times"]["Total Time"] = sum(
        t for t in steps_times.values() if t >= 0
    )

    stats_out["date"] = "unknown"
    if data_path is not None:
        rec_file = os.path.join(data_path, "reconstruction.json")
        if os.path.exists(rec_file):
            stats_out["date"] = datetime.datetime.fromtimestamp(
                os.path.getmtime(rec_file)
            ).strftime("%d/%m/%Y at %H:%M:%S")

    default_max = 1e30
    min_x, min_y, max_x, max_y = default_max, default_max, 0.0, 0.0
    for rec in reconstructions:
        for shot in rec.shots.values():
            o = shot.pose.get_origin()
            min_x = min(min_x, o[0])
            min_y = min(min_y, o[1])
            max_x = max(max_x, o[0])
            max_y = max(max_y, o[1])
    stats_out["area"] = (
        (max_x - min_x) * (max_y - min_y) if min_x != default_max else -1
    )
    return stats_out


def features_statistics(
    data, tracks_manager: pymap.TracksManager,
    reconstructions: List[types.Reconstruction],
) -> Dict[str, Any]:
    """Detected/reconstructed feature counts (stats.py:115-160)."""
    stats_out: Dict[str, Any] = {}
    detected = []
    images = {s for r in reconstructions for s in r.shots}
    for im in images:
        if data.features_exist(im):
            fd = data.load_features(im)
            if fd is not None:
                detected.append(len(fd.points))
    if detected:
        stats_out["detected_features"] = {
            "min": int(min(detected)),
            "max": int(max(detected)),
            "mean": int(np.mean(detected)),
            "median": int(np.median(detected)),
        }
    else:
        stats_out["detected_features"] = {
            "min": -1, "max": -1, "mean": -1, "median": -1
        }

    per_shots = defaultdict(int)
    for track_id in tracks_manager.get_track_ids():
        for shot_id in tracks_manager.get_track_observations(track_id):
            if shot_id in images:
                per_shots[shot_id] += 1
    per_shots_list = list(per_shots.values())
    if per_shots_list:
        stats_out["reconstructed_features"] = {
            "min": int(min(per_shots_list)),
            "max": int(max(per_shots_list)),
            "mean": int(np.mean(per_shots_list)),
            "median": int(np.median(per_shots_list)),
        }
    else:
        stats_out["reconstructed_features"] = {
            "min": -1, "max": -1, "mean": -1, "median": -1
        }
    return stats_out


def reconstruction_statistics(
    data, tracks_manager: pymap.TracksManager,
    reconstructions: List[types.Reconstruction],
) -> Dict[str, Any]:
    """Core quality numbers (stats.py:196-287)."""
    stats_out: Dict[str, Any] = {}
    stats_out["components"] = len(reconstructions)
    gps_count = sum(
        1
        for rec in reconstructions
        for shot in rec.shots.values()
        if shot.metadata.gps_position.has_value
    )
    stats_out["has_gps"] = gps_count > 2
    stats_out["has_gcp"] = bool(data.load_ground_control_points())

    stats_out["initial_points_count"] = tracks_manager.num_tracks()
    stats_out["initial_shots_count"] = len(data.images())

    stats_out["reconstructed_points_count"] = sum(
        len(r.points) for r in reconstructions
    )
    stats_out["reconstructed_shots_count"] = sum(
        len(r.shots) for r in reconstructions
    )

    length_histo: Dict[int, int] = defaultdict(int)
    all_errors_normalized = []
    all_errors_pixels = []
    for rec in reconstructions:
        from opensfm_tpu_torch.reconstruction import (
            compute_reprojection_errors)

        # Reconstructions loaded from JSON carry no observations; re-attach
        # them from the tracks manager before computing residuals.
        if not any(
            s.get_landmark_observations() for s in rec.shots.values()
        ):
            rec.add_correspondences_from_tracks_manager(tracks_manager)
        compute_reprojection_errors(rec)
        for point in rec.points.values():
            length_histo[point.number_of_observations()] += 1
            for shot_id, error in point.reprojection_errors.items():
                norm = _norm2d(error)
                shot = rec.shots.get(shot_id)
                if shot is None:
                    continue
                size = max(shot.camera.width, shot.camera.height)
                pixel = norm * size
                if pixel < RESIDUAL_PIXEL_CUTOFF:
                    all_errors_normalized.append(norm)
                    all_errors_pixels.append(pixel)

    stats_out["observations_count"] = int(
        sum(k * v for k, v in length_histo.items())
    )

    if all_errors_normalized:
        stats_out["reprojection_error_normalized"] = float(
            np.mean(all_errors_normalized)
        )
        stats_out["reprojection_error_pixels"] = float(np.mean(all_errors_pixels))
        hist_n, bins_n = np.histogram(all_errors_normalized, bins=30)
        hist_p, bins_p = np.histogram(all_errors_pixels, bins=30)
        stats_out["reprojection_histogram_normalized"] = (
            list(map(int, hist_n)), list(map(float, bins_n)),
        )
        stats_out["reprojection_histogram_pixels"] = (
            list(map(int, hist_p)), list(map(float, bins_p)),
        )
    else:
        stats_out["reprojection_error_normalized"] = -1.0
        stats_out["reprojection_error_pixels"] = -1.0
        stats_out["reprojection_histogram_normalized"] = ([], [])
        stats_out["reprojection_histogram_pixels"] = ([], [])

    track_lengths = [
        p.number_of_observations()
        for r in reconstructions
        for p in r.points.values()
    ]
    if stats_out["reconstructed_points_count"]:
        stats_out["average_track_length"] = float(np.mean(track_lengths))
        over_two = [t for t in track_lengths if t > 2]
        stats_out["average_track_length_over_two"] = (
            float(np.mean(over_two)) if over_two else -1
        )
    else:
        stats_out["average_track_length"] = -1
        stats_out["average_track_length_over_two"] = -1
    stats_out["histogram_track_length"] = {
        str(k): v for k, v in sorted(length_histo.items())
    }
    return stats_out


def _camera_params(camera) -> Dict[str, Any]:
    """Parameter name -> value map (stats.py:386-390)."""
    return {k: float(v) for k, v in camera.get_parameters_map().items()}


def cameras_statistics(data, reconstructions) -> Dict[str, Any]:
    """Initial vs optimized camera parameters + per-camera GPS bias
    (stats.py:393-415)."""
    from opensfm_tpu_torch import io as osfm_io

    out: Dict[str, Any] = {}
    permutation = np.argsort([-len(r.shots) for r in reconstructions])
    for camera_id, camera_model in data.load_camera_models().items():
        out[camera_id] = {"initial_values": _camera_params(camera_model)}

    for idx in permutation:
        rec = reconstructions[idx]
        for camera in rec.cameras.values():
            if camera.id not in out or "optimized_values" in out[camera.id]:
                continue
            out[camera.id]["optimized_values"] = _camera_params(camera)
            out[camera.id]["bias"] = osfm_io.bias_to_json(
                rec.biases[camera.id]
            )

    for camera_id in list(out):
        if "optimized_values" not in out[camera_id]:
            del out[camera_id]
    return out


def rig_statistics(data, reconstructions) -> Dict[str, Any]:
    """Initial vs optimized rig camera poses (stats.py:418-452); per-camera
    (leverarm) rig cameras are skipped."""
    out: Dict[str, Any] = {}
    permutation = np.argsort([-len(r.shots) for r in reconstructions])
    rig_cameras = data.load_rig_cameras()
    cameras = data.load_camera_models()
    for rig_camera_id, rig_camera in rig_cameras.items():
        if rig_camera_id in cameras:
            continue
        out[rig_camera_id] = {
            "initial_values": {
                "rotation": list(rig_camera.pose.rotation),
                "translation": list(rig_camera.pose.translation),
            }
        }

    for idx in permutation:
        rec = reconstructions[idx]
        for rig_camera in rec.rig_cameras.values():
            if rig_camera.id not in out or "optimized_values" in out[rig_camera.id]:
                continue
            out[rig_camera.id]["optimized_values"] = {
                "rotation": list(rig_camera.pose.rotation),
                "translation": list(rig_camera.pose.translation),
            }

    for rig_camera_id in list(out):
        if "optimized_values" not in out[rig_camera_id]:
            del out[rig_camera_id]
    return out


def compute_all_statistics(
    data, tracks_manager: pymap.TracksManager,
    reconstructions: List[types.Reconstruction], device=None,
) -> Dict[str, Any]:
    """The stats.json payload (stats.py:455-499); the GCPs are triangulated
    on `device`."""
    stats_out: Dict[str, Any] = {}
    stats_out["processing_statistics"] = processing_statistics(data, reconstructions)
    stats_out["features_statistics"] = features_statistics(
        data, tracks_manager, reconstructions
    )
    stats_out["reconstruction_statistics"] = reconstruction_statistics(
        data, tracks_manager, reconstructions
    )
    stats_out["camera_errors"] = cameras_statistics(data, reconstructions)
    stats_out["rig_errors"] = rig_statistics(data, reconstructions)
    stats_out["gps_errors"] = gps_errors(reconstructions)
    stats_out["gcp_errors"] = gcp_errors(data, reconstructions,
                                         device=device)
    return stats_out


# ---------------------------------------------------------------------------
# Figures (plot.py; no matplotlib)
# ---------------------------------------------------------------------------

DPI = 150  # the JAX package's savefig dpi
MATCHGRAPH_SIZE = (1800, 1800)  # figsize (12, 12)
TOPVIEW_SIZE = (1800, 1800)  # figsize (12, 12)
HEATMAP_SIZE = (1200, 900)  # figsize (8, 6)
RESIDUAL_GRID_SIZE = (1800, 1500)  # figsize (12, 10)
HISTOGRAM_SIZE = (1200, 750)  # figsize (8, 5)
RESIDUAL_GRID_SCALING = 4
MATCHGRAPH_LINEWIDTH = 0.7  # points
HISTOGRAM_BAR = (31, 119, 180)  # matplotlib's first colour, C0


def _marker_radius(s: float) -> float:
    """Pixel radius of a matplotlib scatter marker of size `s` (points^2)
    at DPI."""
    return math.sqrt(s) / 2.0 * DPI / 72.0


def _safe_id(camera_id: str) -> str:
    return camera_id.replace("/", "_").replace(" ", "_")


def _plot_box(size, left=150, top=110, right=60, bottom=110):
    w, h = size
    return (left, top, w - left - right, h - top - bottom)


def matchgraph_figure(tracks_manager, reconstructions) -> Optional[Dict[str, Any]]:
    """The match graph's data (stats.py:501-566): one segment a connected
    pair of shots, in increasing order of common tracks, with its viridis
    fraction `c`, and the shots' positions; None without a connected
    pair."""
    all_shots = {
        s: r.shots[s].pose.get_origin()
        for r in reconstructions
        for s in r.shots
    }
    connectivity = tracks_manager.get_all_pairs_connectivity(
        list(all_shots.keys()), None
    )
    if not connectivity:
        return None
    values = list(connectivity.values())
    lowest, highest = np.percentile(values, 5), np.percentile(values, 95)
    xs, ys, cs = [], [], []
    for (im1, im2), size in sorted(connectivity.items(), key=lambda x: x[1]):
        if im1 not in all_shots or im2 not in all_shots:
            continue
        o1, o2 = all_shots[im1], all_shots[im2]
        cs.append(max(0.0, min(1.0, (size - lowest) / max(highest - lowest, 1))))
        xs.append([o1[0], o2[0]])
        ys.append([o1[1], o2[1]])
    positions = np.array(list(all_shots.values()))
    return {
        "x": np.array(xs, dtype=np.float64).reshape(-1, 2),
        "y": np.array(ys, dtype=np.float64).reshape(-1, 2),
        "c": np.array(cs, dtype=np.float64),
        "points": positions[:, :2],
        "point_size": 6,
    }


def draw_matchgraph(spec: Dict[str, Any], device=None) -> np.ndarray:
    fig = plot.Figure(*MATCHGRAPH_SIZE, device=device)
    xs = np.concatenate([spec["x"].reshape(-1), spec["points"][:, 0]])
    ys = np.concatenate([spec["y"].reshape(-1), spec["points"][:, 1]])
    ax = plot.Axes(fig, _plot_box(MATCHGRAPH_SIZE), plot.data_limits(xs),
                   plot.data_limits(ys), equal=True)
    x0, y0 = ax.to_pixel(spec["x"][:, 0], spec["y"][:, 0])
    x1, y1 = ax.to_pixel(spec["x"][:, 1], spec["y"][:, 1])
    fig.segments(x0, y0, x1, y1, plot.colormap(spec["c"]),
                 MATCHGRAPH_LINEWIDTH * DPI / 72.0)
    px, py = ax.to_pixel(spec["points"][:, 0], spec["points"][:, 1])
    fig.discs(px, py, _marker_radius(spec["point_size"]), plot.RED)
    ax.frame()
    ax.title("Match graph")
    return fig.render()


def save_matchgraph(
    data, tracks_manager, reconstructions, output_path: str, io_handler=None,
    device=None,
) -> Optional[Dict[str, Any]]:
    """`matchgraph.png` (stats.py:501-566); returns the figure's spec."""
    spec = matchgraph_figure(tracks_manager, reconstructions)
    if spec is None:
        return None
    plot.write_png(draw_matchgraph(spec, device),
                   os.path.join(output_path, "matchgraph.png"))
    return spec


def topview_figure(reconstructions) -> Dict[str, Any]:
    """The top view's scatters in drawing order (stats.py:622-793): each
    reconstruction's points in their colours (size 0.5), then its shots'
    positions in red (size 12)."""
    scatters = []
    for rec in reconstructions:
        if rec.points:
            pts = np.array([p.coordinates for p in rec.points.values()])
            colors = (
                np.array([p.color for p in rec.points.values()]) / 255.0
            ).clip(0, 1)
            scatters.append({"xy": pts[:, :2], "s": 0.5, "colors": colors})
        origins = np.array(
            [s.pose.get_origin() for s in rec.shots.values()]
        )
        if len(origins):
            scatters.append({"xy": origins[:, :2], "s": 12, "colors": "red"})
    return {"scatters": scatters}


def draw_topview(spec: Dict[str, Any], device=None) -> np.ndarray:
    fig = plot.Figure(*TOPVIEW_SIZE, device=device)
    scatters = spec["scatters"]
    if scatters:
        xy = np.concatenate([s["xy"] for s in scatters])
        xlim, ylim = plot.data_limits(xy[:, 0]), plot.data_limits(xy[:, 1])
    else:
        xlim, ylim = (0.0, 1.0), (0.0, 1.0)
    ax = plot.Axes(fig, _plot_box(TOPVIEW_SIZE), xlim, ylim, equal=True)
    for s in scatters:
        colors = (plot.RED if isinstance(s["colors"], str)
                  else np.rint(np.asarray(s["colors"]) * 255.0))
        px, py = ax.to_pixel(s["xy"][:, 0], s["xy"][:, 1])
        fig.discs(px, py, _marker_radius(s["s"]), colors)
    ax.frame()
    ax.title("Top view")
    return fig.render()


def save_topview(
    data, tracks_manager, reconstructions, output_path: str, io_handler=None,
    device=None,
) -> Dict[str, Any]:
    """`topview.png` (stats.py:622-793); returns the figure's spec."""
    spec = topview_figure(reconstructions)
    plot.write_png(draw_topview(spec, device),
                   os.path.join(output_path, "topview.png"))
    return spec


def residual_histogram_figure(stats) -> Optional[Dict[str, Any]]:
    """The residual histogram's bars (stats.py:568-620), from the key
    `reprojection_histogram` as the JAX package reads it.
    `reconstruction_statistics` writes `reprojection_histogram_pixels` and
    `_normalized` and never that key, so this is None on its output."""
    histogram = stats.get("reconstruction_statistics", {}).get(
        "reprojection_histogram"
    )
    if not histogram:
        return None
    return {
        "left": np.linspace(0, 4, len(histogram) + 1)[:-1],
        "height": np.asarray(histogram, dtype=np.float64),
        "width": 4.0 / len(histogram),
    }


def draw_residual_histogram(spec: Dict[str, Any], device=None) -> np.ndarray:
    fig = plot.Figure(*HISTOGRAM_SIZE, device=device)
    left, height, width = spec["left"], spec["height"], spec["width"]
    ax = plot.Axes(fig, _plot_box(HISTOGRAM_SIZE, left=130, bottom=130),
                   plot.data_limits([left[0], left[-1] + width]),
                   (0.0, max(float(height.max()), 1.0) * 1.05))
    x0, y0 = ax.to_pixel(left, height)
    x1, y1 = ax.to_pixel(left + width, np.zeros_like(height))
    fig.rects(x0, y0, x1, y1, HISTOGRAM_BAR)
    ax.frame()
    box_l, box_t, box_w, box_h = ax.left, ax.top, ax.w, ax.h
    fig.text(box_l + box_w / 2.0, box_t + box_h + 60,
             "Reprojection error (pixels)", 2, anchor="center")
    fig.text(10, box_t - 40, "Count", 2)
    return fig.render()


def save_residual_histogram(stats, output_path: str, io_handler=None,
                            device=None) -> Optional[Dict[str, Any]]:
    """`residual_histogram.png` (stats.py:568-620) where the stats hold
    the key the JAX package reads; they never do (see
    `residual_histogram_figure`), so nothing is written."""
    spec = residual_histogram_figure(stats)
    if spec is None:
        return None
    plot.write_png(draw_residual_histogram(spec, device),
                   os.path.join(output_path, "residual_histogram.png"))
    return spec


def heatmap_figures(reconstructions) -> List[Dict[str, Any]]:
    """Per camera, in order of first appearance, the observations' 2-D
    histogram over 30 x 30 bins (stats.py:795-889: matplotlib's hist2d is
    `np.histogram2d(x, y, bins=30)`)."""
    points_per_camera = defaultdict(list)
    for rec in reconstructions:
        for shot in rec.shots.values():
            for obs in shot.get_landmark_observations().values():
                points_per_camera[shot.camera.id].append(obs.point)
    figures = []
    for camera_id, points in points_per_camera.items():
        points = np.array(points)
        counts, xedges, yedges = np.histogram2d(
            points[:, 0], points[:, 1], bins=30)
        figures.append({
            "camera_id": camera_id, "x": points[:, 0], "y": points[:, 1],
            "bins": 30, "counts": counts, "xedges": xedges,
            "yedges": yedges,
        })
    return figures


def draw_heatmap(spec: Dict[str, Any], device=None) -> np.ndarray:
    """The counts as cells coloured by viridis over [min, max] (hist2d's
    pcolormesh), the y axis inverted."""
    fig = plot.Figure(*HEATMAP_SIZE, device=device)
    xe, ye, counts = spec["xedges"], spec["yedges"], spec["counts"]
    ax = plot.Axes(fig, _plot_box(HEATMAP_SIZE, left=130, right=40),
                   (xe[0], xe[-1]), (ye[0], ye[-1]), invert_y=True)
    lo, hi = float(counts.min()), float(counts.max())
    frac = (counts - lo) / (hi - lo) if hi > lo else np.zeros_like(counts)
    ix, iy = np.meshgrid(np.arange(len(xe) - 1), np.arange(len(ye) - 1),
                         indexing="ij")
    ix, iy = ix.reshape(-1), iy.reshape(-1)
    x0, y0 = ax.to_pixel(xe[ix], ye[iy])
    x1, y1 = ax.to_pixel(xe[ix + 1], ye[iy + 1])
    fig.rects(np.minimum(x0, x1), np.minimum(y0, y1), np.maximum(x0, x1),
              np.maximum(y0, y1), plot.colormap(frac.reshape(-1)))
    ax.frame()
    ax.title(f"Feature heatmap: {spec['camera_id']}", text_scale=2)
    return fig.render()


def save_heatmap(
    data, tracks_manager, reconstructions, output_path: str, io_handler=None,
    device=None,
) -> List[Dict[str, Any]]:
    """`heatmap_<camera id>.png` for each camera (stats.py:795-889);
    returns the figures' specs."""
    figures = heatmap_figures(reconstructions)
    for spec in figures:
        plot.write_png(
            draw_heatmap(spec, device),
            os.path.join(output_path,
                         f"heatmap_{_safe_id(spec['camera_id'])}.png"))
    return figures


def _grid_buckets(camera) -> Tuple[int, int]:
    """Residual-grid bucket counts (reference stats.py:477-482)."""
    buckets = 40
    if camera.projection_type == "spherical":
        return 2 * buckets, buckets
    return buckets, buckets


def residual_grid_figures(tracks_manager, reconstructions) -> List[Dict[str, Any]]:
    """Per camera with residuals, the quiver field the JAX package draws
    (reference stats.py:891-1000): normalized reprojection residuals under
    the 4-pixel cutoff, averaged on a 40 x 40 grid (80 x 40 spherical);
    `U`, `V` the averages times RESIDUAL_GRID_SCALING, `C` their clamped
    norms over `scale`, with the colour bar's `lowest` and `highest`."""
    from opensfm_tpu_torch.reconstruction import compute_reprojection_errors

    scaling = RESIDUAL_GRID_SCALING
    all_errors: Dict[str, list] = {}
    cameras: Dict[str, Any] = {}
    for rec in reconstructions:
        for camera_id, cam in rec.cameras.items():
            all_errors.setdefault(camera_id, [])
            cameras[camera_id] = cam

    for rec in reconstructions:
        if not any(s.get_landmark_observations() for s in rec.shots.values()):
            rec.add_correspondences_from_tracks_manager(tracks_manager)
        compute_reprojection_errors(rec)
        for point in rec.points.values():
            for shot_id, error in point.reprojection_errors.items():
                shot = rec.shots.get(shot_id)
                if shot is None:
                    continue
                obs = shot.get_observation(point.id)
                if obs is None:
                    continue
                cam = shot.camera
                w, h = cam.width, cam.height
                normalizer = max(w, h)
                if _norm2d(np.asarray(error)) * normalizer > RESIDUAL_PIXEL_CUTOFF:
                    continue
                buckets_x, buckets_y = _grid_buckets(cam)
                center = np.array([w / 2.0, h / 2.0])
                bucket = np.asarray(obs.point) * normalizer + center
                x = int(np.clip(bucket[0] * buckets_x / w, 0, buckets_x - 1))
                y = int(np.clip(bucket[1] * buckets_y / h, 0, buckets_y - 1))
                all_errors[cam.id].append((x, y, np.asarray(error)))

    figures = []
    for camera_id, errors in all_errors.items():
        if not errors:
            continue
        cam = cameras[camera_id]
        buckets_x, buckets_y = _grid_buckets(cam)
        grid_res = np.zeros((buckets_y, buckets_x, 2))
        grid_count = np.full((buckets_y, buckets_x, 1), 1)
        for x, y, e in errors:
            grid_res[y, x] += e[:2]
            grid_count[y, x, 0] += 1
        grid_res = grid_res / grid_count

        clamp = 0.1
        res_colors = np.linalg.norm(grid_res, axis=2)
        lowest = np.percentile(res_colors, 0)
        highest = np.percentile(res_colors, 100 * (1 - clamp))
        res_colors = np.clip(res_colors, lowest, highest)
        scale = max(highest - lowest, 1e-12)
        res_colors = res_colors / scale
        figures.append({
            "camera_id": camera_id,
            "U": grid_res[:, :, 0] * scaling, "V": grid_res[:, :, 1] * scaling,
            "C": res_colors, "scale": scale, "scaling": scaling,
            "lowest": lowest, "highest": highest,
        })
    return figures


def _arrows(ax, x, y, u, v, width):
    """Quiver arrows in data units (matplotlib's defaults: shaft `width`,
    head 5 widths long and 3 wide, the whole arrow shrunk below one head
    length): shaft and head as segments, [n, 3] endpoint pairs each."""
    length = np.hypot(u, v)
    d = np.stack([u, v], -1) / np.maximum(length, 1e-300)[:, None]
    perp = np.stack([-d[:, 1], d[:, 0]], -1)
    shrink = np.minimum(1.0, length / (5.0 * width))
    hl, hw = 5.0 * width * shrink, 1.5 * width * shrink
    tail = np.stack([x, y], -1)
    tip = tail + np.stack([u, v], -1)
    base = tip - d * hl[:, None]
    ends = [(tail, tip), (tip, base + perp * hw[:, None]),
            (tip, base - perp * hw[:, None])]
    return [(ax.to_pixel(a[:, 0], a[:, 1]), ax.to_pixel(b[:, 0], b[:, 1]))
            for a, b in ends]


def draw_residual_grid(spec: Dict[str, Any], device=None) -> np.ndarray:
    """The quiver field (tails on the grid, `units="xy"`, `scale=1`, shaft
    0.1), coloured by viridis_r over C's range, the y axis inverted; the
    key arrow and its label above, the colour bar on the right."""
    fig = plot.Figure(*RESIDUAL_GRID_SIZE, device=device)
    U, V, C = spec["U"], spec["V"], spec["C"]
    ny, nx = U.shape
    box = _plot_box(RESIDUAL_GRID_SIZE, left=120, top=170, right=300,
                    bottom=100)
    ax = plot.Axes(fig, box, (-1.0, float(nx)), (-1.0, float(ny)),
                   invert_y=True)
    gx, gy = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ny, dtype=np.float64))
    lo, hi = float(C.min()), float(C.max())
    frac = (C - lo) / (hi - lo) if hi > lo else np.zeros_like(C)
    colors = plot.colormap(frac.reshape(-1), "viridis_r")
    width = 0.1
    u, v = U.reshape(-1), V.reshape(-1)
    short = np.hypot(u, v) < width
    width_px = width * ax.scale()
    for (x0, y0), (x1, y1) in _arrows(ax, gx.reshape(-1)[~short],
                                      gy.reshape(-1)[~short], u[~short],
                                      v[~short], width):
        fig.segments(x0, y0, x1, y1, colors[~short], width_px)
    px, py = ax.to_pixel(gx.reshape(-1)[short], gy.reshape(-1)[short])
    fig.discs(px, py, width_px / 2.0, colors[short])
    ax.frame()

    # The key: an arrow of U = scale * scaling data units and its label.
    key_u = spec["scale"] * spec["scaling"]
    kx0, ky = ax.left + 0.1 * ax.w, ax.top - 45.0
    kx1 = kx0 + key_u * ax.scale()
    head = min(5.0 * width_px, kx1 - kx0)
    fig.segments([kx0, kx1, kx1], [ky, ky, ky], [kx1, kx1 - head, kx1 - head],
                 [ky, ky - 0.3 * head, ky + 0.3 * head], plot.BLACK,
                 width_px)
    fig.text(kx1 + 20, ky - 7, f"Residual grid scale : {spec['scale']:.2f}",
             2)

    # The colour bar: viridis_r from `lowest` (bottom) to `highest` (top).
    bar_l, bar_w = ax.left + ax.w + 60.0, 50.0
    edges = ax.top + ax.h * (1.0 - np.arange(257) / 256.0)
    fig.rects(np.full(256, bar_l), edges[1:], np.full(256, bar_l + bar_w),
              edges[:-1], plot.colormap((np.arange(256) + 0.5) / 256.0,
                                        "viridis_r"))
    plot.Axes(fig, (bar_l, ax.top, bar_w, ax.h), (0, 1), (0, 1)).frame(
        ticks=False)
    for value, y in ((spec["lowest"], ax.top + ax.h - 14),
                     (spec["highest"], ax.top)):
        fig.text(bar_l + bar_w + 12, y, f"{value:.3g}", 2)
    fig.text(ax.left + ax.w / 2.0, 20, f"Residual grid: {spec['camera_id']}",
             3, anchor="center")
    return fig.render()


def save_residual_grids(
    data, tracks_manager, reconstructions, output_path: str, io_handler=None,
    device=None,
) -> List[Dict[str, Any]]:
    """`residuals_<camera id>.png` for each camera with residuals
    (reference stats.py:891-1000); returns the figures' specs."""
    figures = residual_grid_figures(tracks_manager, reconstructions)
    for spec in figures:
        plot.write_png(
            draw_residual_grid(spec, device),
            os.path.join(output_path,
                         f"residuals_{_safe_id(spec['camera_id'])}.png"))
    return figures
