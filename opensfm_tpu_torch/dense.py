"""Dense depth estimation: PatchMatch or plane sweep, consistency cleaning,
pruning and merging.

Copy of `opensfm_tpu.dense` (reference `opensfm/dense.py:15-506` and
`pydense`, dense/src/depthmap.cc): neighbours by track-angle score
(find_neighboring_images:415) and the depth range from point percentiles
(compute_depth_range:376) on the host; per-shot depth estimation
(`ops.depthmap`'s PatchMatch, or the fronto-parallel plane sweep), the
cross-view consistency cleaning (DepthmapCleaner) and the pruning to world
points (DepthmapPruner) on a device; the merge into `merged.ply` on the
host.  The images are scaled by the port's INTER_AREA (`ops.image`), so
neither OpenCV nor PIL is needed.
"""

from __future__ import annotations

import logging
from timeit import default_timer as timer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from opensfm_tpu_torch import pymap, resolve_device, types
from opensfm_tpu_torch.geometry.cameras import normalized_pixel_grid

logger = logging.getLogger(__name__)


def compute_depthmaps(udata, graph: pymap.TracksManager,
                      device=None) -> Dict[str, Any]:
    """Compute, clean and prune the depthmaps of every undistorted shot
    with more than one neighbour on `device`, and merge them into
    `merged.ply` (dense.py:15-62).  Returns the report: the neighbours of
    each shot, the seconds of each step and of each shot's raw depthmap,
    and the merged points.  The config's `processes` is not used (the
    JAX package reads it and ignores it)."""
    dev = resolve_device(device)
    logger.info("Computing neighbors")
    config = udata.config
    num_neighbors = config["depthmap_num_neighbors"]
    report: Dict[str, Any] = {"device": str(dev)}

    recs = udata.load_undistorted_reconstruction()
    if not recs:
        return report
    reconstruction = recs[0]

    t0 = timer()
    neighbors = {}
    common_tracks = common_tracks_double_dict(graph)
    for shot in reconstruction.shots.values():
        neighbors[shot.id] = find_neighboring_images(
            shot, common_tracks, reconstruction, num_neighbors
        )
    report["neighbors"] = {k: v[1:] for k, v in neighbors.items()}
    report["neighbors_s"] = timer() - t0
    todo = [s for s in reconstruction.shots.values()
            if len(neighbors[s.id]) > 1]

    # Raw depthmaps; each image is decoded and scaled once.
    t0 = timer()
    raw_s = {}
    grays: Dict[str, Any] = {}
    for shot in todo:
        if udata.raw_depthmap_exists(shot.id):
            logger.info("Using precomputed raw depthmap %s", shot.id)
            continue
        logger.info("Computing depthmap for image %s", shot.id)
        t1 = timer()
        compute_depthmap(udata, reconstruction, neighbors[shot.id], shot.id,
                         dev, grays)
        raw_s[shot.id] = timer() - t1
    report["raw_s"] = timer() - t0
    report["raw_s_per_shot"] = raw_s

    # Clean depthmaps.
    t0 = timer()
    for shot in todo:
        if udata.clean_depthmap_exists(shot.id):
            continue
        logger.info("Cleaning depthmap for image %s", shot.id)
        clean_depthmap(udata, reconstruction, neighbors[shot.id], shot.id,
                       dev)
    report["clean_s"] = timer() - t0

    # Prune depthmaps.
    t0 = timer()
    for shot in todo:
        if udata.pruned_depthmap_exists(shot.id):
            continue
        logger.info("Pruning depthmap for image %s", shot.id)
        prune_depthmap(udata, reconstruction, neighbors[shot.id], shot.id,
                       dev)
    report["prune_s"] = timer() - t0

    t0 = timer()
    report["merged_points"] = merge_depthmaps(udata, reconstruction)
    report["merge_s"] = timer() - t0
    report["shots"] = len(todo)
    return report


def common_tracks_double_dict(
    tracks_manager: pymap.TracksManager,
) -> Dict[str, Dict[str, List[str]]]:
    """im1 -> im2 -> list of common track ids (dense.py helper)."""
    common = {}
    tracks_per_pair: Dict[Tuple[str, str], List[str]] = {}
    for track_id in tracks_manager.get_track_ids():
        obs = sorted(tracks_manager.get_track_observations(track_id).keys())
        for i in range(len(obs)):
            for j in range(i + 1, len(obs)):
                tracks_per_pair.setdefault((obs[i], obs[j]), []).append(track_id)
    for (im1, im2), tracks in tracks_per_pair.items():
        common.setdefault(im1, {})[im2] = tracks
        common.setdefault(im2, {})[im1] = tracks
    return common


def find_neighboring_images(
    shot: pymap.Shot,
    common_tracks: Dict[str, Dict[str, List[str]]],
    reconstruction: types.Reconstruction,
    num_neighbors: int,
) -> List[str]:
    """Neighbours ranked by track-angle score (dense.py:415-442): the
    common tracks seen between 3 and 30 degrees apart, more than 20 of
    them; each pair's angles computed in one batch."""
    theta_min = np.pi / 60
    theta_max = np.pi / 6
    ns = []
    C1 = shot.pose.get_origin()
    others = common_tracks.get(shot.id, {})
    for other_id, tracks in others.items():
        if other_id not in reconstruction.shots:
            continue
        other = reconstruction.shots[other_id]
        C2 = other.pose.get_origin()
        points = [reconstruction.points[t].coordinates for t in tracks
                  if t in reconstruction.points]
        theta = angles_between_points(np.reshape(points, (-1, 3)), C1, C2)
        score = float(np.sum((theta_min < theta) & (theta < theta_max)))
        if score > 20:
            ns.append((other, score))
    ns.sort(key=lambda ns: ns[1], reverse=True)
    return [shot.id] + [n.id for n, s in ns[:num_neighbors]]


def angles_between_points(origins: np.ndarray, p1, p2) -> np.ndarray:
    """`angle_between_points` for every row of `origins` [K, 3], in the
    same arithmetic."""
    a = [p1[i] - origins[:, i] for i in range(3)]
    b = [p2[i] - origins[:, i] for i in range(3)]
    dot = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    la = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
    lb = b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
    ok = (la > 0) & (lb > 0)
    cos = np.clip(dot / np.sqrt(np.where(ok, la * lb, 1.0)), -1.0, 1.0)
    return np.where(ok, np.arccos(cos), 0.0)


def angle_between_points(origin, p1, p2) -> float:
    return float(angles_between_points(np.reshape(origin, (1, 3)), p1,
                                       p2)[0])


def compute_depth_range(
    reconstruction: types.Reconstruction, shot: pymap.Shot, config
) -> Tuple[float, float]:
    """Depth range from reconstructed point percentiles (dense.py:376-400)."""
    coords = np.array([p.coordinates for p in reconstruction.points.values()],
                      dtype=np.float64).reshape(-1, 3)
    r = shot.pose.get_rotation_matrix()[2]
    # One 3-vector dot a point, as the JAX package takes it: a batched
    # product rounds some depths the other way.
    depths = [d for d in (r @ v for v in coords - shot.pose.get_origin())
              if d > 0]
    if not depths:
        return 1.0, 40.0
    min_depth = np.percentile(depths, 10) * 0.9
    max_depth = np.percentile(depths, 90) * 1.1
    config_min_depth = config["depthmap_min_depth"]
    config_max_depth = config["depthmap_max_depth"]
    return (
        config_min_depth or float(min_depth),
        config_max_depth or float(max_depth),
    )


def _scaled_gray(udata, reconstruction, shot_id: str, width: int,
                 device=None):
    """Greyscale undistorted image scaled to the depthmap resolution
    (float32 in [0, 1]) and the colour image at the same size, both as
    numpy arrays."""
    from opensfm_tpu_torch.features import rgb_to_grey
    from opensfm_tpu_torch.ops.image import resize_area

    image = udata.load_undistorted_image(shot_id)
    gray = rgb_to_grey(image).astype(np.float32) / 255.0
    h, w = gray.shape
    scale = width / w
    new_w, new_h = width, max(int(round(h * scale)), 1)
    gray = resize_area(gray, new_w, new_h, device).cpu().numpy()
    color = resize_area(image, new_w, new_h, device).cpu().numpy()
    return gray, color


def _pixel_rays(camera, width: int, height: int, dev) -> torch.Tensor:
    """Camera-frame rays [height * width, 3] (f64, z = 1) of every pixel
    of a width x height image."""
    b = camera.bearings_many_torch(normalized_pixel_grid(width, height, dev))
    return b / b[:, 2:3]


def plane_sweep_depthmap(
    ref_gray: np.ndarray,
    ref_shot: pymap.Shot,
    neighbor_grays: List[np.ndarray],
    neighbor_shots: List[pymap.Shot],
    min_depth: float,
    max_depth: float,
    num_depth_planes: int = 50,
    patch_size: int = 7,
    min_patch_variance: float = 1e-5,
    device=None,
):
    """Sweep D fronto-parallel planes and score NCC against each neighbour
    (the ComputeBruteForce equivalent, depthmap.cc:184), on `device`: each
    neighbour's warp maps for all D planes at once (f64, cast to f32), then
    the bilinear samples and the box-filtered NCC in float32."""
    dev = resolve_device(device)
    H, W = ref_gray.shape
    R_ref = ref_shot.pose.get_rotation_matrix()
    o_ref = torch.as_tensor(ref_shot.pose.get_origin(), device=dev)
    # World directions of the pixels, scaled so that depth = z-depth.
    b = ref_shot.camera.bearings_many_torch(normalized_pixel_grid(W, H, dev))
    bearings_world = (b @ torch.as_tensor(R_ref, device=dev)) / b[:, 2:3]
    depths = 1.0 / np.linspace(1.0 / max_depth, 1.0 / min_depth,
                               num_depth_planes)
    depths_t = torch.as_tensor(depths, device=dev)
    half = patch_size // 2
    kernel = torch.full((1, 1, patch_size, patch_size),
                        1.0 / patch_size ** 2, dtype=torch.float32,
                        device=dev)

    def boxf(x):  # [..., H, W] zero-padded mean over the patch
        shape = x.shape
        y = F.conv2d(x.reshape(-1, 1, H, W), kernel, padding=half)
        return y.reshape(shape)

    ref = torch.as_tensor(ref_gray, dtype=torch.float32, device=dev)
    ref_mean = boxf(ref)
    ref_var = boxf(ref * ref) - ref_mean * ref_mean

    best_score = torch.full((H, W), -1.0, dtype=torch.float32, device=dev)
    best_depth = torch.zeros((H, W), dtype=torch.float32, device=dev)
    best_nghbr = torch.zeros((H, W), dtype=torch.int32, device=dev)

    for n_i, (ngray, nshot) in enumerate(zip(neighbor_grays, neighbor_shots)):
        nH, nW = ngray.shape
        R_n = torch.as_tensor(nshot.pose.get_rotation_matrix(), device=dev)
        t_n = torch.as_tensor(nshot.pose.translation, device=dev)
        X = o_ref + bearings_world[None] * depths_t[:, None, None]  # [D,HW,3]
        Xc = X @ R_n.T + t_n
        uv = nshot.camera.project_many_torch(Xc)
        size = max(nW, nH)
        npx = uv * size + torch.as_tensor(
            [(nW - 1.0) / 2.0, (nH - 1.0) / 2.0], dtype=torch.float64,
            device=dev)
        npx = torch.where((Xc[..., 2] <= 0)[..., None], -1e6, npx)
        maps = npx.to(torch.float32)
        x = maps[..., 0].reshape(-1, H, W)
        y = maps[..., 1].reshape(-1, H, W)
        nimg = torch.as_tensor(ngray, dtype=torch.float32,
                               device=dev).reshape(-1)
        x0 = torch.clamp(torch.floor(x), 0, nW - 2)
        y0 = torch.clamp(torch.floor(y), 0, nH - 2)
        fx = torch.clamp(x - x0, 0.0, 1.0)
        fy = torch.clamp(y - y0, 0.0, 1.0)
        idx = (y0 * nW + x0).long()
        warped = (
            nimg[idx] * (1 - fy) * (1 - fx)
            + nimg[idx + 1] * (1 - fy) * fx
            + nimg[idx + nW] * fy * (1 - fx)
            + nimg[idx + nW + 1] * fy * fx
        )
        inside = (x >= 0) & (x < nW - 1) & (y >= 0) & (y < nH - 1)
        warped = torch.where(inside, warped, 0.0)
        wmean = boxf(warped)
        wvar = boxf(warped * warped) - wmean * wmean
        cov = boxf(ref * warped) - ref_mean * wmean
        ncc = cov / torch.sqrt(
            torch.clamp(ref_var * wvar, min=min_patch_variance ** 2))
        scores = torch.where(inside, ncc, -1.0)  # [D, H, W]
        plane_score, plane_best = torch.max(scores, dim=0)
        better = plane_score > best_score
        best_depth = torch.where(
            better, depths_t.to(torch.float32)[plane_best], best_depth)
        best_score = torch.where(better, plane_score, best_score)
        best_nghbr = torch.where(better, n_i, best_nghbr)

    return (
        best_depth.cpu().numpy(),
        best_score.cpu().numpy(),
        best_nghbr.cpu().numpy(),
    )


def compute_depthmap(udata, reconstruction, neighbors, shot_id,
                     device=None,
                     grays: Optional[Dict[str, np.ndarray]] = None):
    """Raw depthmap for one shot (dense.py:95-167) on `device`.

    Dispatches on config depthmap_method: PATCH_MATCH / PATCH_MATCH_SAMPLE
    run the checkerboard PatchMatch (ops/depthmap.py); BRUTE_FORCE runs
    the fronto-parallel plane sweep.  `grays`, when given, keeps the
    scaled greys by shot id across calls."""
    dev = resolve_device(device)
    config = udata.config
    inputs = shot_inputs(udata, reconstruction, neighbors, shot_id,
                         int(config["depthmap_resolution"]), dev, grays)
    if inputs is None:
        return

    method = str(config.get("depthmap_method", "PATCH_MATCH_SAMPLE")).upper()
    if method in ("PATCH_MATCH", "PATCH_MATCH_SAMPLE"):
        depth, plane, score, nghbr = _patch_match(*inputs, config, dev)
    else:  # BRUTE_FORCE
        depth, score, nghbr = plane_sweep_depthmap(
            *inputs, patch_size=int(config["depthmap_patch_size"]),
            device=dev,
        )
        # Fronto-parallel plane per pixel: n = -z in camera coords.
        H, W = depth.shape
        plane = np.zeros((H, W, 3), dtype=np.float32)
        plane[..., 2] = np.where(
            depth > 0, -1.0 / np.maximum(depth, 1e-6), 0.0
        )

    good = score > config["depthmap_min_correlation_score"]
    depth = depth * good

    udata.save_raw_depthmap(shot_id, depth, plane, score, nghbr, neighbors)


def shot_inputs(udata, reconstruction, neighbors, shot_id, width: int,
                device=None, grays: Optional[Dict[str, np.ndarray]] = None):
    """(ref_gray, shot, neighbor_grays, neighbor_shots, min_depth,
    max_depth) of one shot at depthmap width `width`, the neighbours
    whose image loads; None when none does.  `neighbors[0]` is the shot
    itself."""
    shot = reconstruction.shots[shot_id]
    grays = {} if grays is None else grays

    def gray(sid):
        if sid not in grays:
            grays[sid] = _scaled_gray(udata, reconstruction, sid, width,
                                      device)[0]
        return grays[sid]

    min_depth, max_depth = compute_depth_range(reconstruction, shot,
                                               udata.config)
    ref_gray = gray(shot_id)
    neighbor_grays, neighbor_shots = [], []
    for n_id in neighbors[1:]:
        try:
            g = gray(n_id)
        except IOError:
            continue
        neighbor_grays.append(g)
        neighbor_shots.append(reconstruction.shots[n_id])
    if not neighbor_grays:
        return None
    return (ref_gray, shot, neighbor_grays, neighbor_shots, min_depth,
            max_depth)


def patch_match_inputs(ref_gray, shot, neighbor_grays, neighbor_shots,
                       min_depth, max_depth, config, device=None):
    """`ops.depthmap.patch_match_depthmap`'s positional arguments (ray
    grid, relative poses) and its options from `config` for one shot."""
    H, W = ref_gray.shape
    rays = _pixel_rays(shot.camera, W, H, resolve_device(device))
    args = (
        ref_gray, rays.reshape(H, W, 3).cpu().numpy(),
        shot.pose.get_rotation_matrix(), np.asarray(shot.pose.translation),
        neighbor_grays,
        [s.pose.get_rotation_matrix() for s in neighbor_shots],
        [np.asarray(s.pose.translation) for s in neighbor_shots],
        [float(s.camera.focal) for s in neighbor_shots],
        float(min_depth), float(max_depth),
    )
    options = dict(
        iterations=int(config.get("depthmap_patchmatch_iterations", 3)),
        patch_size=int(config["depthmap_patch_size"]),
    )
    return args, options


def _patch_match(ref_gray, shot, neighbor_grays, neighbor_shots,
                 min_depth, max_depth, config, device=None):
    """Adapter: shots -> ray grids / relative poses for ops.depthmap."""
    from opensfm_tpu_torch.ops.depthmap import patch_match_depthmap

    dev = resolve_device(device)
    args, options = patch_match_inputs(
        ref_gray, shot, neighbor_grays, neighbor_shots, min_depth,
        max_depth, config, dev)
    depth, nu, score, nghbr = patch_match_depthmap(*args, **options,
                                                   device=dev)
    return depth, nu.astype(np.float32), score, nghbr


def _world_points(shot, px: torch.Tensor, depth: torch.Tensor, W: int,
                  H: int) -> torch.Tensor:
    """World points (f64) of pixels `px` [K, 2] at z-depths `depth` [K]
    of a W x H depthmap of `shot`."""
    dev = px.device
    size = max(W, H)
    norm = (px - torch.tensor([(W - 1.0) / 2.0, (H - 1.0) / 2.0],
                              dtype=torch.float64, device=dev)) / size
    b = shot.camera.bearings_many_torch(norm)
    R = torch.as_tensor(shot.pose.get_rotation_matrix(), device=dev)
    o = torch.as_tensor(shot.pose.get_origin(), device=dev)
    return o + (b / b[:, 2:3]) @ R * depth[:, None]


def clean_depthmap(udata, reconstruction, neighbors, shot_id,
                   device=None) -> None:
    """Cross-view consistency filter (dense.py:170-213, DepthmapCleaner):
    each pixel projected into every neighbour's raw depthmap on `device`,
    kept where at least depthmap_min_consistent_views agree."""
    dev = resolve_device(device)
    config = udata.config
    same_depth_threshold = config["depthmap_same_depth_threshold"]
    min_consistent = config["depthmap_min_consistent_views"]

    depth, plane, score, nghbr, nbrs = udata.load_raw_depthmap(shot_id)
    shot = reconstruction.shots[shot_id]
    H, W = depth.shape

    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=dev),
        torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    px = torch.stack([xs.reshape(-1), ys.reshape(-1)], 1)
    d_flat = torch.as_tensor(depth.reshape(-1), device=dev)
    valid = d_flat > 0
    X = _world_points(shot, px, d_flat.to(torch.float64), W, H)
    consistent = torch.ones(H * W, dtype=torch.int32, device=dev)

    for n_id in nbrs[1:]:
        n_id = str(n_id)
        if n_id not in reconstruction.shots or not udata.raw_depthmap_exists(n_id):
            continue
        ndepth = torch.as_tensor(udata.load_raw_depthmap(n_id)[0], device=dev)
        nshot = reconstruction.shots[n_id]
        nH, nW = ndepth.shape
        R_n = torch.as_tensor(nshot.pose.get_rotation_matrix(), device=dev)
        t_n = torch.as_tensor(nshot.pose.translation, device=dev)
        Xc = X @ R_n.T + t_n
        uv = nshot.camera.project_many_torch(Xc)
        size = max(nW, nH)
        xs_n = torch.round(uv[:, 0] * size + (nW - 1.0) / 2.0)
        ys_n = torch.round(uv[:, 1] * size + (nH - 1.0) / 2.0)
        inside = ((xs_n >= 0) & (xs_n < nW) & (ys_n >= 0) & (ys_n < nH)
                  & (Xc[:, 2] > 0))
        idx = torch.where(inside, ys_n * nW + xs_n, 0).long()
        dn = ndepth.reshape(-1)[idx].to(torch.float64)
        agree = (torch.abs(dn - Xc[:, 2]) < same_depth_threshold * Xc[:, 2])
        consistent += (inside & agree & (dn > 0)).to(torch.int32)

    keep = valid & (consistent >= min_consistent)
    clean = torch.where(keep, d_flat, 0).reshape(H, W)
    udata.save_clean_depthmap(shot_id, clean.cpu().numpy().astype(np.float32),
                              plane, score)


def prune_depthmap(udata, reconstruction, neighbors, shot_id,
                   device=None) -> None:
    """Subsample to world points + normals + colours + labels
    (dense.py:216-265) on `device`."""
    from opensfm_tpu_torch.ops.image import resize_area, resize_nearest

    dev = resolve_device(device)
    depth, plane, score = udata.load_clean_depthmap(shot_id)
    shot = reconstruction.shots[shot_id]
    H, W = depth.shape

    step = 2  # subsampling as DepthmapPruner
    d = torch.as_tensor(depth[::step, ::step].reshape(-1), device=dev)
    valid = d > 0
    if not bool(valid.any()):
        udata.save_pruned_depthmap(
            shot_id, np.zeros((0, 3)), np.zeros((0, 3)),
            np.zeros((0, 3)), np.zeros((0,)),
        )
        return
    ys, xs = torch.meshgrid(
        torch.arange(0, H, step, dtype=torch.float64, device=dev),
        torch.arange(0, W, step, dtype=torch.float64, device=dev),
        indexing="ij")
    px = torch.stack([xs.reshape(-1), ys.reshape(-1)], 1)[valid]
    d = d[valid].to(torch.float64)
    points = _world_points(shot, px, d, W, H)

    # Normals from the per-pixel plane vectors (PatchMatch slanted planes;
    # the plane sweep writes fronto-parallel nu = (0, 0, -1/d), which lands
    # on -z): camera-frame n ~ nu normalised, oriented toward the camera
    # (nz < 0), then rotated to world: n_world = R^T n_cam.
    nu = torch.as_tensor(plane[::step, ::step].reshape(-1, 3),
                         device=dev)[valid].to(torch.float64)
    nu_norm = torch.linalg.norm(nu, dim=1, keepdim=True)
    n_cam = torch.where(nu_norm > 1e-12, nu / nu_norm,
                        torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64,
                                     device=dev))
    n_cam = torch.where(n_cam[:, 2:3] > 0, -n_cam, n_cam)
    R = torch.as_tensor(shot.pose.get_rotation_matrix(), device=dev)
    normals = n_cam @ R

    iy, ix = px[:, 1].long(), px[:, 0].long()
    try:
        image = udata.load_undistorted_image(shot_id)
        colors = resize_area(image, W, H, dev)[iy, ix].cpu().numpy()
    except IOError:
        colors = np.full((len(d), 3), 128)

    # Semantic labels ride into the pruned cloud and the merged PLY
    # (reference dense.py:344-352 load_segmentation_labels + :356-374
    # add_views_to_depth_pruner; zeros when no segmentation exists).
    labels = np.zeros(len(d))
    if udata.undistorted_segmentation_exists(shot_id):
        seg = udata.load_undistorted_segmentation(shot_id)
        if seg is not None:
            labels = (resize_nearest(np.asarray(seg), W, H, dev)[iy, ix]
                      .cpu().numpy().astype(np.float64))
    udata.save_pruned_depthmap(shot_id, points.cpu().numpy(),
                               normals.cpu().numpy(), colors, labels)


def merge_depthmaps(udata, reconstruction) -> int:
    """Merge the pruned depthmaps into merged.ply (dense.py:268-295);
    returns the number of points."""
    shot_ids = [
        s for s in reconstruction.shots if udata.pruned_depthmap_exists(s)
    ]
    if not shot_ids:
        logger.warning("Depthmaps contain no points.  Try using more images.")
        return 0
    points, normals, colors, labels = [], [], [], []
    for shot_id in shot_ids:
        p, n, c, l = udata.load_pruned_depthmap(shot_id)
        points.append(p)
        normals.append(n)
        colors.append(c)
        labels.append(l)
    udata.save_point_cloud(
        np.concatenate(points), np.concatenate(normals),
        np.concatenate(colors), np.concatenate(labels), "merged.ply",
    )
    logger.info("Merged depthmaps into %s", udata.point_cloud_file())
    return int(sum(len(p) for p in points))
