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
separates detection from the rest.  Prints one JSON line: the stages' wall
seconds and `synthetic_images.grade_reconstruction`'s grade (shots,
reconstructions, points, camera-centre RMS after a similarity fit,
reprojection RMS in pixels) with the calibrated focal, k1 and k2.

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
    from opensfm_tpu.actions import (create_tracks, detect_features,
                                     extract_metadata, match_features,
                                     reconstruct)
    from opensfm_tpu.dataset import DataSet

    actions = dict(zip(STAGES, (extract_metadata, detect_features,
                                match_features, create_tracks, reconstruct)))

    def run(stage, path, device):
        actions[stage].run_dataset(DataSet(path))
    return run


def _port_runner():
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands

    def run(stage, path, device):
        command_runner(opensfm_commands, argv=[stage, path, "--device",
                                               device])
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
        walls=args.walls)
    stages = {"render": time.perf_counter() - t0}
    todo = STAGES
    if args.features_from:
        for name in ("features", "exif", "camera_models.json"):
            src = os.path.join(args.features_from, name)
            dst = os.path.join(args.out, name)
            (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, dst)
        todo = STAGES[2:]
    for stage in todo:
        t0 = time.perf_counter()
        run(stage, args.out, args.device)
        stages[stage] = time.perf_counter() - t0
    data = DataSet(args.out)
    recs = data.load_reconstruction()
    grade = si.grade_reconstruction(recs, truth, data.load_tracks_manager())
    cam = next(iter(max(recs, key=lambda r: len(r.shots)).cameras.values()))
    feats = [len(data.load_features(im).points) for im in data.images()]
    out = dict(package=args.package, device=args.device,
               size=[args.width, args.height], views=args.views,
               step_deg=args.step_deg, walls=args.walls,
               features_from=args.features_from, stage_s=stages,
               features_min=int(np.min(feats)),
               features_mean=float(np.mean(feats)), grade=grade,
               focal=cam.focal, k1=cam.k1, k2=cam.k2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
