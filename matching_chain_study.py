"""Accuracy of `match_features` -> `create_tracks` -> `reconstruct` on a
synthetic matching dataset, by package.

Writes `synthetic_bundle.write_matching_dataset` (`--shots` images of
`--features` features seeing `--points` points through their `--window`
nearest images, `--seed`; images alternate in halves between brown and
fisheye_opencv cameras with `--mixed`, as `chip_smoke.py`'s phase 17
writes them) with `--config` JSON entries in its config.yaml, then runs
the three stages through one package: the port (`--package port`, on
`--device`) or the JAX package on the CPU (`--package jax`).  Prints one
JSON line: the stages' wall seconds, the pairs matched and
`synthetic_bundle.grade_reconstruction`'s grade (shots, reconstructions,
centre and point RMS in metres after a similarity fit, reprojection RMS in
normalized units, mismatched tracks).

    python3 matching_chain_study.py --package port --device cpu --mixed \\
        --config '{"matching_gps_neighbors": 8}' --out build/study/mixed
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

STAGES = ("match_features", "create_tracks", "reconstruct")


def _runner(package):
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from opensfm_tpu.actions import (create_tracks, match_features,
                                         reconstruct)
        from opensfm_tpu.dataset import DataSet

        actions = dict(zip(STAGES, (match_features, create_tracks,
                                    reconstruct)))
        return lambda stage, path, device: actions[stage].run_dataset(
            DataSet(path))
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands

    return lambda stage, path, device: command_runner(
        opensfm_commands, argv=[stage, path, "--device", device])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=("port", "jax"), default="port")
    p.add_argument("--device", default="cpu",
                   help="the port's device (the JAX package runs on the CPU)")
    p.add_argument("--shots", type=int, default=16)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--features", type=int, default=8192)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--mixed", action="store_true",
                   help="brown cameras for the first half of the images, "
                   "fisheye_opencv for the second")
    p.add_argument("--config", default="{}",
                   help="JSON object of config.yaml entries")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import synthetic_bundle as sb
    from opensfm_tpu_torch.dataset import DataSet

    run = _runner(args.package)
    shutil.rmtree(args.out, ignore_errors=True)
    types = None
    if args.mixed:
        half = args.shots // 2
        types = ["brown"] * half + ["fisheye_opencv"] * (args.shots - half)
    tracks = sb.write_matching_dataset(
        args.out, n_shots=args.shots, n_points=args.points,
        track_window=args.window, features_per_image=args.features,
        seed=args.seed, config=json.loads(args.config), camera_types=types)
    stages = {}
    for stage in STAGES:
        t0 = time.perf_counter()
        run(stage, args.out, args.device)
        stages[stage] = time.perf_counter() - t0
    data = DataSet(args.out)
    pairs = sum(len(data.load_matches(im)) for im in data.images()
                if data.matches_exists(im))
    shots, points = sb.matching_scene(args.shots, args.points,
                                      seed=args.seed)
    grade = sb.grade_reconstruction(data.load_reconstruction(),
                                    data.load_tracks_manager(), tracks,
                                    shots, points)
    out = dict(package=args.package, device=args.device, shots=args.shots,
               points=args.points, features=args.features, mixed=args.mixed,
               config=json.loads(args.config), pairs=pairs, stage_s=stages,
               grade=grade)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
