"""Accuracy of the chain from images on a rendered scene, by package and
device.

Renders `--views` views (`synthetic_images`, seed 0) of the boxes scene,
optionally ringed by walls (`--walls D`, inner faces D metres out), on an
arc of `--step-deg` degrees between views (0: evenly around the circle),
then runs `extract_metadata`, `detect_features`, `match_features`,
`create_tracks` and `reconstruct` at the default config through one
package: the port (`--package port`, on `--device`) or the JAX package on
the CPU (`--package jax`, for parity on a host that has it).  With
`--features-from DIR` the features, EXIF and camera models are copied from
an earlier run's dataset DIR and only the last three stages run, which
separates detection from the rest.  `--camera TYPE` renders every view
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
calibrated them and as the reconstruction left them.  `--config JSON`
writes those entries into the dataset's config.yaml over the defaults.

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
          "create_tracks", "reconstruct")


def _jax_runner():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from opensfm_tpu.actions import (create_rig, create_tracks,
                                     detect_features, extract_metadata,
                                     match_features, reconstruct)
    from opensfm_tpu.dataset import DataSet

    actions = dict(zip(STAGES, (extract_metadata, detect_features,
                                match_features, create_tracks, reconstruct)))

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
    p.add_argument("--camera", default=None,
                   choices=("brown", "fisheye_opencv"),
                   help="render through synthetic_images.CAMERA_MODELS[...]")
    p.add_argument("--rig", action="store_true",
                   help="render synthetic_images.RIG instances and run "
                   "create_rig pattern")
    p.add_argument("--config", default="{}",
                   help="JSON object of config.yaml entries over the "
                   "defaults, e.g. '{\"matching_gps_neighbors\": 8}'")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

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
    todo = STAGES
    if args.rig:
        todo = STAGES[:2] + ("create_rig",) + STAGES[2:]
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
    if args.rig:
        # Baselines in the truth's metres: times the similarity's scale.
        for key, cams in (("rig_calibrated", data.load_rig_cameras()),
                          ("rig_reconstructed", best.rig_cameras)):
            base, angle = si.rig_reading(cams)
            out[key] = dict(baseline_m=base * grade["scale"],
                            rotation_rad=angle)
        out["cameras"] = {k: [c.projection_type, list(c.parameters)]
                          for k, c in best.cameras.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
