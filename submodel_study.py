"""Accuracy of the submodel path on a rendered scene, by package.

Takes a dataset that has been through `extract_metadata`,
`detect_features` and `match_features` (`image_chain_study.py --until
match_features --out DIR` writes one: 16 views of the boxes scene, 10
degrees apart, GPS +- 0.5 m), copies its images, EXIF, features, matches
and config, and runs the submodel path through one package: the port
(`--package port`, on `--device`) or the JAX package on the CPU
(`--package jax`).  `create_submodels` splits the views into GPS clusters
of `--size` grown by their neighbours within an overlap worked out from
the views' GPS positions (`synthetic_images.submodel_overlap`: each
cluster gains its two nearest outside views), then `create_tracks` and `reconstruct` run in
each `submodels/submodel_XXXX`, then `align_submodels`.  Prints one JSON
line: the stages' wall seconds, each submodel's views and reconstructed
shots, and the camera centres graded against the render's truth in the
dataset's topocentric frame with no similarity fit
(`synthetic_images.grade_aligned`: the
reconstructions' RMS before the alignment, the aligned RMS and largest
error in metres, and the largest disagreement of a shot that two
submodels share).

    python3 submodel_study.py --from build/study/base --package port \\
        --device cpu --out build/study/sub_port
"""

from __future__ import annotations

import argparse
import json
import os
import time

import synthetic_images as si


def _runner(package: str):
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from opensfm_tpu.actions import (align_submodels, create_submodels,
                                         create_tracks, reconstruct)
        from opensfm_tpu.dataset import DataSet

        actions = {"create_submodels": create_submodels,
                   "create_tracks": create_tracks,
                   "reconstruct": reconstruct,
                   "align_submodels": align_submodels}

        def run(stage, path, device):
            actions[stage].run_dataset(DataSet(path))
        return run

    from opensfm_tpu_torch.commands import command_runner, opensfm_commands

    def run(stage, path, device):
        command_runner(opensfm_commands,
                       argv=[stage, path, "--device", device])
    return run


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--from", dest="src", required=True)
    p.add_argument("--package", choices=("port", "jax"), default="port")
    p.add_argument("--device", default="cpu")
    p.add_argument("--size", type=int, default=8)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    si.copy_submodel_inputs(args.src, args.out, {"submodel_size": args.size})
    overlap = si.submodel_overlap(args.out, args.size)
    si.copy_submodel_inputs(args.src, args.out, {
        "submodel_size": args.size, "submodel_overlap": overlap})
    run = _runner(args.package)
    walls = {}
    t0 = time.perf_counter()
    run("create_submodels", args.out, args.device)
    walls["create_submodels"] = time.perf_counter() - t0
    subs = sorted(os.listdir(os.path.join(args.out, "submodels")))
    for sub in subs:
        sp = os.path.join(args.out, "submodels", sub)
        for stage in ("create_tracks", "reconstruct"):
            t0 = time.perf_counter()
            run(stage, sp, args.device)
            walls[f"{sub}/{stage}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run("align_submodels", args.out, args.device)
    walls["align_submodels"] = time.perf_counter() - t0
    out = {"package": args.package, "overlap_m": overlap, "wall_s": walls,
           **si.grade_aligned(args.out, si.true_centres(args.out))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
