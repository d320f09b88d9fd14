"""Accuracy of the chain from images on a rendered scene, by package and
device.

Renders `--views` views (`synthetic_images`, seed 0) of the boxes scene,
optionally ringed by walls (`--walls D`, inner faces D metres out), on an
arc of `--step-deg` degrees between views (0: evenly around the circle),
then runs `extract_metadata`, `detect_features`, `match_features`,
`create_tracks`, `reconstruct`, `mesh`, `undistort` and
`compute_depthmaps` (the eight stages of `run_all`) at the default config
through one package: the port (`--package port`, on `--device`) or the JAX package on
the CPU (`--package jax`, for parity on a host that has it).  With
`--features-from DIR` the features, EXIF and camera models are copied from
an earlier run's dataset DIR and detection does not run, which
separates it from the rest; `--sparse` stops after `reconstruct`.  `--camera TYPE` renders every view
through `synthetic_images.CAMERA_MODELS[TYPE]` (brown, fisheye_opencv),
which the camera model overrides give the EXIF's camera; `--rig` renders
each view as an instance of `synthetic_images.RIG` (a brown camera left
and a fisheye_opencv camera right, 0.4 m apart), and `create_rig pattern`
runs after `detect_features`.  Prints one JSON line: the stages' wall
seconds and `synthetic_images.grade_reconstruction`'s grade (shots,
reconstructions, points, camera-centre RMS after a similarity fit,
reprojection RMS in pixels) with the calibrated focal, k1 and k2, and with
`--rig` the rig cameras' baseline (metres of the truth: times the
similarity's scale) and relative rotation (rad) as `create_rig`
calibrated them and as the reconstruction left them.  After the dense
stages the line also holds the merged point cloud's grade
(`synthetic_images.grade_point_cloud` through the same similarity: points,
median and 90th-percentile distance to the scene's surfaces in metres) and
the shots with depthmaps.  `--config JSON` writes those entries into the
dataset's config.yaml over the defaults.

`--diagnose` (the port, on the default pinhole render without a rig)
adds `diagnosis`: where the sparse error comes from.  The saved
reconstruction's observations, outliers removed as its last bundle left
them, are triangulated with the true cameras and reprojected
(`truth_residuals`: median and RMS within 4 px, the share beyond 4 px,
and the radial term a of obs = (1 + a) proj, which a focal bias would
show); then full bundles (`bundles`) from the result and from the truth
mapped into its frame, with and without the GPS priors, and from the
result without the observations beyond 4 px of the truth, each with its
final cost, focal and centre RMS, and from the result after the AUTO
outlier filter (`bundle_outlier_filtering_type`).  After the dense stages it adds the
sparse points' grade beside the cloud's and the median height of each
near the ground (metres; 0 on the truth).

    python3 image_chain_study.py --package port --device cpu \\
        --width 640 --height 480 --out build/study/boxes_port
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

STAGES = ("extract_metadata", "detect_features", "match_features",
          "create_tracks", "reconstruct", "mesh", "undistort",
          "compute_depthmaps")
SPARSE = STAGES[:5]


def _jax_runner():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from opensfm_tpu.actions import (compute_depthmaps, create_rig,
                                     create_tracks, detect_features,
                                     extract_metadata, match_features, mesh,
                                     reconstruct, undistort)
    from opensfm_tpu.dataset import DataSet

    actions = dict(zip(STAGES, (extract_metadata, detect_features,
                                match_features, create_tracks, reconstruct,
                                mesh, undistort, compute_depthmaps)))

    def run(stage, path, device, *args):
        if stage == "create_rig":
            # The JAX package's calibration subset links no camera model
            # overrides, and its extract_metadata would write the EXIF's
            # models through the linked camera_models.json: give the subset
            # a copy of the overrides first.
            sub = os.path.join(path, "rig_calibration")
            os.makedirs(sub, exist_ok=True)
            shutil.copy(os.path.join(path, "camera_models_overrides.json"),
                        sub)
            create_rig.run_dataset(DataSet(path), *args)
            return
        actions[stage].run_dataset(DataSet(path))
    return run


def _port_runner():
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands

    def run(stage, path, device, *args):
        command_runner(opensfm_commands,
                       argv=[stage, path, *args, "--device", device])
        if device.startswith("cuda"):
            import torch
            torch.cuda.synchronize()
    return run


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=("port", "jax"), default="port")
    p.add_argument("--device", default="cpu",
                   help="the port's device (the JAX package runs on the CPU)")
    p.add_argument("--render-device", default=None,
                   help="device of the render (default: --device)")
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1536)
    p.add_argument("--step-deg", type=float, default=10.0,
                   help="degrees between views; 0 spreads them around the "
                   "whole circle")
    p.add_argument("--walls", type=float, default=None)
    p.add_argument("--features-from", default=None)
    p.add_argument("--sparse", action="store_true",
                   help="stop after reconstruct (no mesh, undistort or "
                   "depthmaps)")
    p.add_argument("--camera", default=None,
                   choices=("brown", "fisheye_opencv"),
                   help="render through synthetic_images.CAMERA_MODELS[...]")
    p.add_argument("--rig", action="store_true",
                   help="render synthetic_images.RIG instances and run "
                   "create_rig pattern")
    p.add_argument("--config", default="{}",
                   help="JSON object of config.yaml entries over the "
                   "defaults, e.g. '{\"matching_gps_neighbors\": 8}'")
    p.add_argument("--diagnose", action="store_true",
                   help="add the sparse error's diagnosis (the port only)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.diagnose and (args.package != "port" or args.camera or args.rig):
        p.error("--diagnose runs the port on the pinhole render only")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import synthetic_images as si

    run = _jax_runner() if args.package == "jax" else _port_runner()
    from opensfm_tpu_torch.dataset import DataSet

    shutil.rmtree(args.out, ignore_errors=True)
    step = args.step_deg or None
    t0 = time.perf_counter()
    truth = si.write_image_dataset(
        args.out, args.views, args.width, args.height, seed=0,
        device=args.render_device or args.device, step_deg=step,
        walls=args.walls, config=json.loads(args.config),
        camera=si.CAMERA_MODELS[args.camera] if args.camera else None,
        rig=si.RIG if args.rig else None)
    stages = {"render": time.perf_counter() - t0}
    todo = SPARSE if args.sparse else STAGES
    if args.rig:
        todo = todo[:2] + ("create_rig",) + todo[2:]
    if args.features_from:
        for name in ("features", "exif", "camera_models.json"):
            src = os.path.join(args.features_from, name)
            dst = os.path.join(args.out, name)
            (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
        todo = tuple(t for t in todo if t not in STAGES[:2])
    for stage in todo:
        t0 = time.perf_counter()
        extra = (["pattern", json.dumps(truth["rig_patterns"])]
                 if stage == "create_rig" else [])
        run(stage, args.out, args.device, *extra)
        stages[stage] = time.perf_counter() - t0
    data = DataSet(args.out)
    recs = data.load_reconstruction()
    grade = si.grade_reconstruction(recs, truth, data.load_tracks_manager())
    best = max(recs, key=lambda r: len(r.shots))
    cam = next(iter(best.cameras.values()))
    feats = [len(data.load_features(im).points) for im in data.images()]
    out = dict(package=args.package, device=args.device,
               size=[args.width, args.height], views=args.views,
               step_deg=args.step_deg, walls=args.walls,
               camera=args.camera, rig=args.rig,
               config=json.loads(args.config),
               features_from=args.features_from, stage_s=stages,
               features_min=int(np.min(feats)),
               features_mean=float(np.mean(feats)), grade=grade,
               focal=cam.focal, k1=cam.k1, k2=cam.k2)
    if "compute_depthmaps" in todo:
        from opensfm_tpu_torch import io
        from opensfm_tpu_torch.dataset import UndistortedDataSet

        udata = UndistortedDataSet(data, os.path.join(args.out,
                                                      "undistorted"))
        with open(udata.point_cloud_file()) as f:
            points = io.point_cloud_from_ply(f)[0]
        out["point_cloud"] = si.grade_point_cloud(points, grade, args.walls)
        out["depthmap_shots"] = sum(udata.pruned_depthmap_exists(s)
                                    for s in data.images())
    if args.rig:
        # Baselines in the truth's metres: times the similarity's scale.
        for key, cams in (("rig_calibrated", data.load_rig_cameras()),
                          ("rig_reconstructed", best.rig_cameras)):
            base, angle = si.rig_reading(cams)
            out[key] = dict(baseline_m=base * grade["scale"],
                            rotation_rad=angle)
        out["cameras"] = {k: [c.projection_type, list(c.parameters)]
                          for k, c in best.cameras.items()}
    if args.diagnose:
        out["diagnosis"] = diagnose(data, truth, grade, args.step_deg or None,
                                    args.device)
        if "compute_depthmaps" in todo:
            sparse = np.array([p.coordinates for p in best.points.values()])
            out["diagnosis"].update(
                sparse_points=si.grade_point_cloud(sparse, grade),
                ground_height=dict(cloud=_ground_height(points, grade),
                                   sparse=_ground_height(sparse, grade)))
    print(json.dumps(out), flush=True)
    return out


def _to_truth(points, grade):
    return (grade["scale"] * np.asarray(points) @ np.asarray(grade["rotation"]).T
            + np.asarray(grade["translation"]))


def _ground_height(points, grade) -> float:
    """Median height (m) of the points mapped within 0.2 m of the ground."""
    z = _to_truth(points, grade)[:, 2]
    return float(np.median(z[np.abs(z) < 0.2]))


def _truth_points(rec, truth, focal, poses):
    """{point id: position} triangulated (midpoint) from the observations
    with the true pinhole cameras, in the truth's frame."""
    out = {}
    for pid, point in rec.points.items():
        A, b = np.zeros((3, 3)), np.zeros(3)
        for sid in point.get_observations():
            x, y = rec.shots[sid].get_observation(pid).point
            R, c = poses[sid], truth["centres"][sid]
            d = R.T @ np.array([x / focal, y / focal, 1.0])
            P = np.eye(3) - np.outer(d, d) / (d @ d)
            A, b = A + P, b + P @ c
        out[pid] = np.linalg.solve(A, b)
    return out


def diagnose(data, truth, grade, step_deg, device) -> dict:
    """The sparse error's diagnosis of `--diagnose` (see the docstring)."""
    import copy

    import synthetic_images as si
    from opensfm_tpu_torch import reconstruction as recmod

    tm = data.load_tracks_manager()
    rec = max(data.load_reconstruction(), key=lambda r: len(r.shots))
    rec.add_correspondences_from_tracks_manager(tm)
    config = data.config
    recmod.remove_outliers(rec, config)
    focal = si.FOCAL_35MM / 36.0
    poses = {f"view_{i:03d}.png": R
             for i, (R, _) in enumerate(si.view_poses(len(truth["centres"]),
                                                      step_deg))}
    size = max(next(iter(rec.cameras.values())).width,
               next(iter(rec.cameras.values())).height)
    xt = _truth_points(rec, truth, focal, poses)
    res, proj, far = [], [], []
    for pid, X in xt.items():
        for sid in rec.points[pid].get_observations():
            q = poses[sid] @ (X - truth["centres"][sid])
            uv = focal * q[:2] / q[2]
            r = np.asarray(rec.shots[sid].get_observation(pid).point) - uv
            res.append(r)
            proj.append(uv)
            if np.linalg.norm(r) * size > 4.0:
                far.append((pid, sid))
    res, proj = np.array(res) * size, np.array(proj)
    norm = np.linalg.norm(res, axis=1)
    near = norm <= 4.0
    radial = np.sum(res * proj, axis=1) / np.linalg.norm(proj, axis=1)
    rr = np.linalg.norm(proj, axis=1)[near] * size
    out = {"truth_residuals": dict(
        observations=len(res), median_px=float(np.median(norm)),
        rms_within_4px=float(np.sqrt(np.mean(norm[near] ** 2))),
        share_beyond_4px=float(1.0 - near.mean()),
        radial_term=float(np.sum(radial[near] * rr) / np.sum(rr * rr)))}

    camera_priors = data.load_camera_models()
    rig_priors = data.load_rig_cameras()
    Rf = np.asarray(grade["rotation"])
    s, t = grade["scale"], np.asarray(grade["translation"])

    def from_truth(r):
        cam = next(iter(r.cameras.values()))
        values = dict(zip(cam.get_parameters_types(),
                          cam.get_parameters_values()))
        values.update(focal=focal, k1=0.0, k2=0.0)
        cam.set_parameters_values([values[k] for k in
                                   cam.get_parameters_types()])
        for sid, shot in r.shots.items():
            shot.pose.set_rotation_matrix(poses[sid] @ Rf)
            shot.pose.set_origin(Rf.T @ (truth["centres"][sid] - t) / s)
        for pid, X in xt.items():
            r.points[pid].coordinates = Rf.T @ (X - t) / s
        return r

    def without_far(r):
        for pid, sid in far:
            r.remove_observation(sid, pid)
        for pid in [p for p, pt in r.points.items()
                    if pt.number_of_observations() < 2]:
            r.remove_point(pid)
        return r

    def auto_filter(r):
        recmod.remove_outliers(
            r, dict(config, bundle_outlier_filtering_type="AUTO"))
        return r

    bundles = {}
    for name, start, gps in (("auto_outlier_filter", auto_filter, True),
                             ("from_result", None, True),
                             ("from_truth", from_truth, True),
                             ("from_result_no_gps", None, False),
                             ("from_truth_no_gps", from_truth, False),
                             ("without_far_observations", without_far, True)):
        r = copy.deepcopy(rec)
        if start is not None:
            start(r)
        rep = recmod.bundle(r, camera_priors, rig_priors, None,
                            dict(config, bundle_use_gps=gps), device=device)
        cam = next(iter(r.cameras.values()))
        bundles[name] = dict(
            final_cost=rep["final_cost"], iterations=rep["iterations"],
            focal=cam.focal, k1=cam.k1, k2=cam.k2,
            centre_rms=si.grade_reconstruction([r], truth)["centre_rms"])
    out["bundles"] = bundles
    return out


if __name__ == "__main__":
    main()
