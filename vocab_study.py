"""Vocabularies, vocabulary pair selection and guided matching through both
packages on the CPU, on the datasets `image_chain_study.py` writes.

    python3 image_chain_study.py --package port --device cpu --jpeg \\
        --width 640 --height 480 --until reconstruct \\
        --config '{"bundle_outlier_filtering_type": "AUTO"}' --out H
    python3 image_chain_study.py --package port --device cpu --jpeg \\
        --width 640 --height 480 --views 8 --until detect_features \\
        --config '{"feature_type": "AKAZE"}' --out A
    python3 vocab_study.py --hahog H --akaze A --out DIR

On copies of the first VIEWS views of H (features, EXIF and camera models;
`synthetic_bundle.subset_dataset`), each package in turn (the port on the
CPU, the JAX package on the CPU) runs:
- `detect_features` with `matcher_type: WORDS` and BoW pair selection
  (`matching_bow_neighbors`, GPS selection off), which only assigns words,
  then `match_features`;
- `match_features` with VLAD pair selection instead, on those words;
- BoW pair selection on the AKAZE (M-SURF) views of A, whose float domain
  trains a 1,024-word vocabulary;
- `match_images_with_pairs(poses=...)` over GUIDED_PAIRS of H's
  reconstructed shots, each pair's relative pose from the reconstruction.
Prints one JSON line: per package the selected pairs, the inliers a pair,
the seconds of each step and the largest epipolar angle of a guided
match; and between the packages the share of equal word ids, of equal
pairs, and of trained centres within CENTRE_TOL of each other with the
largest difference.  Chip runs use the same steps (`chip_smoke.py`'s phase
20); this script gives their bounds a reading of both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

VIEWS = 8
NEIGHBORS = 2  # matching_bow_neighbors / matching_vlad_neighbors
GUIDED_PAIRS = 8  # consecutive reconstructed shots
CENTRE_TOL = 1e-4  # trained centres (AKAZE's unit-norm floats)
BOW = {"matcher_type": "WORDS", "matching_bow_neighbors": NEIGHBORS,
       "matching_gps_distance": 0}
VLAD = {"matcher_type": "WORDS", "matching_bow_neighbors": 0,
        "matching_vlad_neighbors": NEIGHBORS, "matching_gps_distance": 0}
TRAIN = {"matching_bow_neighbors": NEIGHBORS, "matching_gps_distance": 0}


def _package(name):
    """(DataSet, detect_features, match_features, pairs_selection,
    matching, run keyword arguments) of one package."""
    if name == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from opensfm_tpu import matching, pairs_selection
        from opensfm_tpu.actions import detect_features, match_features
        from opensfm_tpu.dataset import DataSet
        return DataSet, detect_features, match_features, pairs_selection, \
            matching, {}
    from opensfm_tpu_torch import matching, pairs_selection
    from opensfm_tpu_torch.actions import detect_features, match_features
    from opensfm_tpu_torch.dataset import DataSet
    return DataSet, detect_features, match_features, pairs_selection, \
        matching, {"device": "cpu"}


def _pairs_and_inliers(data):
    out = {}
    for im in data.images():
        if data.matches_exists(im):
            for other, m in data.load_matches(im).items():
                out["|".join(sorted((im, other)))] = len(m)
    return out


def guided_pose(rec, im1, im2):
    """The relative pose of `im2`'s camera from `im1`'s in `rec`."""
    return rec.shots[im2].pose.compose(rec.shots[im1].pose.inverse())


def run_package(name, args):
    import synthetic_bundle as sb
    from opensfm_tpu_torch.dataset import DataSet as PortDataSet

    DataSet, detect, match, pairs_selection, matching, kw = _package(name)
    hahog = PortDataSet(args.hahog)
    images = hahog.images()[:VIEWS]
    out = {}

    bow = os.path.join(args.out, f"{name}_bow")
    sb.subset_dataset(args.hahog, bow, images, BOW)
    t0 = time.perf_counter()
    detect.run_dataset(DataSet(bow), **kw)
    t1 = time.perf_counter()
    match.run_dataset(DataSet(bow), **kw)
    out["bow"] = dict(words_s=t1 - t0, match_s=time.perf_counter() - t1,
                      pairs=_pairs_and_inliers(DataSet(bow)))

    vlad = os.path.join(args.out, f"{name}_vlad")
    sb.subset_dataset(bow, vlad, images, VLAD)
    t0 = time.perf_counter()
    match.run_dataset(DataSet(vlad), **kw)
    out["vlad"] = dict(match_s=time.perf_counter() - t0,
                       pairs=_pairs_and_inliers(DataSet(vlad)))

    akaze = os.path.join(args.out, f"{name}_akaze")
    sb.subset_dataset(args.akaze, akaze, PortDataSet(args.akaze).images(),
                      TRAIN)
    data = DataSet(akaze)
    exifs = {im: data.load_exif(im) for im in data.images()}
    t0 = time.perf_counter()
    pairs, report = pairs_selection.match_candidates_from_metadata(
        data.images(), data.images(), exifs, data, {}, **kw)
    out["train"] = dict(seconds=time.perf_counter() - t0,
                        pairs=sorted("|".join(sorted(p)) for p in pairs),
                        num_pairs_bow=report["num_pairs_bow"])

    rec = hahog.load_reconstruction()[0]
    shots = sorted(rec.shots)
    gpairs = [(a, b) for a, b in zip(shots, shots[1:])][:GUIDED_PAIRS]
    poses = {p: guided_pose(rec, *p) for p in gpairs}
    data = DataSet(args.hahog)
    exifs = {im: data.load_exif(im) for im in data.images()}
    t0 = time.perf_counter()
    guided = matching.match_images_with_pairs(data, {}, exifs, gpairs,
                                              poses, **kw)
    seconds = time.perf_counter() - t0
    out["guided"] = dict(seconds=seconds, pairs={
        "|".join(p): len(m) for p, m in guided.items()},
        max_angle=_max_epipolar_angle(args.hahog, guided, poses))
    matching.clear_cache()
    return out


def _max_epipolar_angle(path, guided, poses):
    import torch

    from opensfm_tpu_torch import feature_loader
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.geometry.triangulation import (
        epipolar_angle_two_bearings_many,
    )

    data = DataSet(path)
    cams = data.load_camera_models()
    worst = 0.0
    for (im1, im2), m in guided.items():
        if not len(m):
            continue
        m = np.asarray(m)
        b = [cams[data.load_exif(im)["camera"]].bearings_many(
            feature_loader.instance.load_all_data(data, im, False)
            .points[idx, :2]) for im, idx in ((im1, m[:, 0]), (im2, m[:, 1]))]
        pose = poses[im1, im2]
        angles = epipolar_angle_two_bearings_many(
            *(torch.as_tensor(np.asarray(a, np.float64)) for a in
              (b[0], b[1], pose.get_rotation_matrix(), pose.translation)))
        worst = max(worst, float(torch.diagonal(angles).max()))
    return worst


def compare(args):
    """Port against JAX package: equal word ids, pairs, trained centres."""
    from opensfm_tpu_torch.dataset import DataSet

    port, ref = (DataSet(os.path.join(args.out, f"{p}_bow"))
                 for p in ("port", "jax"))
    equal = [float((port.load_words(im) == ref.load_words(im)).mean())
             for im in port.images()]
    c = [np.load(os.path.join(args.out, f"{p}_akaze", "bow_vocabulary.npz"))
         ["words"] for p in ("port", "jax")]
    diff = np.abs(c[0] - c[1]).max(axis=1)
    return dict(words_equal_min=min(equal),
                centres_within_tol=float((diff <= CENTRE_TOL).mean()),
                centres_max_abs=float(diff.max()))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hahog", required=True)
    p.add_argument("--akaze", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(args.out, exist_ok=True)
    out = {name: run_package(name, args) for name in ("port", "jax")}
    out["compare"] = compare(args)
    for step in ("bow", "vlad"):
        out["compare"][f"{step}_pairs_equal"] = (
            sorted(out["port"][step]["pairs"])
            == sorted(out["jax"][step]["pairs"]))
    out["compare"]["train_pairs_equal"] = (out["port"]["train"]["pairs"]
                                           == out["jax"]["train"]["pairs"])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
