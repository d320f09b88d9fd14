"""`extract_metadata` and `detect_features` end to end on rendered images,
against the JAX package on the CPU, then the port's own chain to a
reconstruction.

Six views 12 degrees apart on a circle around two textured boxes on a
textured ground (`synthetic_images`, seed 0, 400 x 300 PNGs with an eXIf
chunk: Make, Model, FocalLengthIn35mmFilm, GPS) go through both packages'
`extract_metadata` and `detect_features` (HAHOG, the default feature type,
with `feature_min_frames` 600, which the first detector pass exceeds, so
neither package anneals).  `camera_models.json` and every `exif/*.exif` are
equal; each image's features agree at tests/test_torch_features.py's
tolerances (positions in pixels of the larger side).  Then the port's
`match_features`, `create_tracks` and `reconstruct` run on its features:
all six shots in one reconstruction, camera centres within CENTRE_RMS of
the truth after a similarity fit (measured 0.011 m) and a reprojection RMS
under REPROJ_RMS_PX (measured 0.20 px)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import synthetic_images as si
from opensfm_tpu.actions import detect_features as ref_detect
from opensfm_tpu.actions import extract_metadata as ref_extract
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from test_torch_features import (ANGLE_TOL, POS_REL_TOL, POS_TOL, UNMATCHED,
                                 _partners)

N_VIEWS, WIDTH, HEIGHT = 6, 400, 300
CONFIG = {"feature_min_frames": 600, "feature_process_size": WIDTH}
CENTRE_RMS = 0.05  # m, after a similarity fit to the true centres
REPROJ_RMS_PX = 1.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("detect")
    ours, ref = str(root / "ours"), str(root / "ref")
    truth = si.write_image_dataset(ours, N_VIEWS, WIDTH, HEIGHT, seed=0,
                                   step_deg=12.0, config=CONFIG)
    shutil.copytree(ours, ref)
    ref_extract.run_dataset(RefDataSet(ref))
    ref_detect.run_dataset(RefDataSet(ref))
    command_runner(opensfm_commands,
                   argv=["extract_metadata", ours, "--device", "cpu"])
    report = command_runner(opensfm_commands, argv=[
        "detect_features", ours, "--device", "cpu"])
    return ours, ref, truth, report


def test_metadata_equals_reference(both):
    ours, ref, _, _ = both
    with open(os.path.join(ours, "camera_models.json")) as f:
        a = json.load(f)
    with open(os.path.join(ref, "camera_models.json")) as f:
        b = json.load(f)
    assert a == b and len(a) == 1
    images = sorted(os.listdir(os.path.join(ours, "images")))
    assert len(images) == N_VIEWS
    for im in images:
        da, db = DataSet(ours).load_exif(im), RefDataSet(ref).load_exif(im)
        assert da == db
        assert da["make"] == si.MAKE and da["gps"]["latitude"] > 0


def test_features_match_reference(both):
    ours, ref, _, report = both
    size = max(WIDTH, HEIGHT)
    for im in DataSet(ours).images():
        fa = DataSet(ours).load_features(im)
        fb = RefDataSet(ref).load_features(im)
        assert report["images"][im]["features"] == len(fa) >= 600
        assert fa.descriptors.dtype == fb.descriptors.dtype == np.uint8
        pa, pb = fa.points.copy(), fb.points.copy()
        pa[:, :3] *= size
        pb[:, :3] *= size
        j = _partners(pb, pa)
        ok = j >= 0
        assert (~ok).mean() <= UNMATCHED
        assert len(pa) - ok.sum() <= UNMATCHED * len(pa)
        a, b = pb[ok], pa[j[ok]]
        dxy = np.abs(a[:, :2] - b[:, :2]).max(axis=1)
        assert np.quantile(dxy, 0.99) <= POS_TOL
        assert (dxy <= POS_REL_TOL * a[:, 2] + 1e-4).all()
        same = np.abs((a[:, 3] - b[:, 3] + 180.0) % 360.0 - 180.0) \
            <= ANGLE_TOL
        assert (~same).mean() <= UNMATCHED
        diff = np.abs(fb.descriptors[ok][same].astype(int)
                      - fa.descriptors[j[ok]][same].astype(int))
        assert (diff <= 1).mean() >= 0.999
        # Colours are read at the rounded position: a keypoint on a
        # half-pixel may round to the other neighbour.
        assert (fa.colors[j[ok]] == fb.colors[ok]).all(axis=1).mean() >= 0.99


def test_port_chain_reconstructs_the_views(both):
    ours, _, truth, _ = both
    for cmd in ("match_features", "create_tracks", "reconstruct"):
        command_runner(opensfm_commands, argv=[cmd, ours, "--device", "cpu"])
    data = DataSet(ours)
    grade = si.grade_reconstruction(data.load_reconstruction(), truth,
                                    data.load_tracks_manager())
    assert grade["shots"] == N_VIEWS and grade["reconstructions"] == 1
    assert grade["centre_rms"] < CENTRE_RMS
    assert grade["reprojection_rms_px"] < REPROJ_RMS_PX
