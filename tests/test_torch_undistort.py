"""The port's `undistort` against the JAX package's on the CPU.

- Every `perspective_camera_from_*` gives the JAX package's camera.
- `compute_camera_mapping` from each of the ten camera models to its
  ideal perspective camera, and from a spherical panorama to each cube
  face, within 1e-3 px of the JAX package's maps (both f64, cast to f32;
  measured: equal, 0 px, for every model).
- `undistort_image` on a brown image against the JAX package's (cv2.remap)
  at `test_torch_image_io`'s remap bound: >= 99.9 % of pixels equal and
  every pixel within 1 level (measured: equal everywhere).
- `undistort_reconstruction` on a brown map and on a spherical map: the
  same shot ids, cameras, rig cameras and instances, and track
  observations within 1e-12.
- The `undistort` command on a rendered 3-view brown dataset with its true
  reconstruction, through both packages: the same files, reconstructions,
  tracks within 1e-12 and images at the remap bound.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import synthetic_images as si
from opensfm_tpu import pymap as ref_pymap
from opensfm_tpu import types as ref_types
from opensfm_tpu import undistort as ref_undistort
from opensfm_tpu.actions import undistort as ref_action
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.geometry.cameras import Camera as RefCamera
from opensfm_tpu.geometry.pose import Pose as RefPose
from opensfm_tpu_torch import io, pymap, types, undistort
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet, UndistortedDataSet
from opensfm_tpu_torch.geometry.cameras import PARAMS, Camera
from opensfm_tpu_torch.geometry.pose import Pose
from test_torch_image_io import REMAP_EQUAL_SHARE
from test_undistort import _MemData, _MemUdata

MAP_TOL = 1e-3  # px
OBS_TOL = 1e-12  # normalized units
# Parameters of each model (PARAMS order): mild distortion, off-centre
# principal points, aspect ratios away from 1.
MODEL_PARAMS = {
    "perspective": (-0.08, 0.01, 0.8),
    "brown": (-0.06, 0.012, 0.001, 0.0015, -0.001, 0.82, 1.02, 0.01, -0.008),
    "fisheye": (-0.03, 0.004, 0.7),
    "fisheye_opencv": (-0.02, 0.003, 0.0005, -0.0001, 0.72, 0.99, -0.004,
                       0.002),
    "fisheye62": (-0.02, 0.003, 0.0005, -0.0001, 0.0002, 0.0001, 0.001,
                  -0.0005, 0.7, 1.01, 0.003, -0.002),
    "fisheye624": (-0.02, 0.003, 0.0005, -0.0001, 0.0002, 0.0001, 0.001,
                   -0.0005, 0.0004, -0.0002, 0.0003, 0.0001, 0.7, 1.01,
                   0.003, -0.002),
    "spherical": (),
    "dual": (0.6, -0.03, 0.004, 0.75),
    "radial": (-0.05, 0.008, 0.81, 1.01, 0.006, -0.004),
    "simple_radial": (-0.05, 0.8, 0.98, -0.005, 0.007),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cameras(ptype, width=96, height=72):
    out = []
    for cls in (Camera, RefCamera):
        cam = cls(ptype, np.array(MODEL_PARAMS[ptype], dtype=np.float64))
        cam.id = f"cam_{ptype}"
        cam.width, cam.height = width, height
        out.append(cam)
    return out


def _same_camera(a, b):
    assert a.projection_type == b.projection_type
    assert (a.id, a.width, a.height) == (b.id, b.width, b.height)
    assert np.array_equal(np.asarray(a.parameters), np.asarray(b.parameters))


def test_perspective_cameras_from_every_model():
    assert set(undistort._PERSPECTIVE_FROM) == set(
        ref_undistort._PERSPECTIVE_FROM)
    for ptype, make in undistort._PERSPECTIVE_FROM.items():
        port, ref = _cameras(ptype)
        _same_camera(make(port), ref_undistort._PERSPECTIVE_FROM[ptype](ref))


@pytest.mark.parametrize("ptype", sorted(PARAMS))
def test_camera_mapping_every_model(ptype):
    port, ref = _cameras(ptype)
    if ptype == "spherical":  # each cube face of a 128 x 64 panorama
        port.width, port.height = ref.width, ref.height = 128, 64
        face = Camera.create_perspective(0.5, 0.0, 0.0)
        ref_face = RefCamera.create_perspective(0.5, 0.0, 0.0)
        for cam in (face, ref_face):
            cam.width = cam.height = 40
        for rotation in undistort.PANORAMA_ROTATIONS:
            r = np.asarray(rotation, dtype=np.float64)
            mx, my = undistort.compute_camera_mapping(port, face, 40, 40, r,
                                                      device="cpu")
            rx, ry = ref_undistort.compute_camera_mapping(ref, ref_face, 40,
                                                          40, r)
            assert np.abs(mx.numpy() - rx).max() <= MAP_TOL
            assert np.abs(my.numpy() - ry).max() <= MAP_TOL
        return
    target = Camera.create_perspective(0.8, 0.0, 0.0)
    ref_target = RefCamera.create_perspective(0.8, 0.0, 0.0)
    for cam in (target, ref_target):
        cam.width, cam.height = 96, 72
    mx, my = undistort.compute_camera_mapping(port, target, 96, 72,
                                              device="cpu")
    rx, ry = ref_undistort.compute_camera_mapping(ref, ref_target, 96, 72)
    assert mx.dtype == torch.float32 and mx.shape == (72, 96)
    assert np.abs(mx.numpy() - rx).max() <= MAP_TOL
    assert np.abs(my.numpy() - ry).max() <= MAP_TOL


def _assert_images_close(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(int) - b.astype(int))
    assert (diff.max(axis=-1) == 0).mean() >= REMAP_EQUAL_SHARE
    assert diff.max() <= 1


def test_undistort_image_against_reference():
    port, ref = _cameras("brown")
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)
    out = undistort.undistort_image(
        image, port, undistort.perspective_camera_from_brown(port),
        device="cpu")
    expected = ref_undistort.undistort_image(
        image, ref, ref_undistort.perspective_camera_from_brown(ref))
    _assert_images_close(out, expected)


def _maps(ptype, n_shots, seed):
    """The same map in both packages: n_shots shots of one `ptype` camera
    at random poses, 60 points, each observed where it projects."""
    rng = np.random.default_rng(seed)
    poses = [(rng.normal(0, 0.2, 3), rng.normal(0, 1.0, 3))
             for _ in range(n_shots)]
    points = rng.normal(0, 1.0, (60, 3)) + [0.0, 0.0, 6.0]
    out = []
    for cam, T, P, PoseT in (
            (_cameras(ptype)[0], types, pymap, Pose),
            (_cameras(ptype)[1], ref_types, ref_pymap, RefPose)):
        rec, tm = T.Reconstruction(), P.TracksManager()
        rec.add_camera(cam)
        for i, (rot, trans) in enumerate(poses):
            shot = rec.create_shot(f"im{i}", cam.id, PoseT(rot, trans))
            for j, X in enumerate(points):
                xc = shot.pose.transform(X)
                if ptype != "spherical" and xc[2] <= 0:
                    continue
                uv = shot.camera.project(xc)
                tm.add_observation(f"im{i}", str(j), P.Observation(
                    uv[0], uv[1], 0.01, 10, 20, 30, j))
        for j, X in enumerate(points):
            rec.create_point(str(j), X)
        out.append((rec, tm))
    return out


@pytest.mark.parametrize("ptype", ["brown", "spherical"])
def test_undistort_reconstruction_against_reference(ptype):
    (rec, tm), (ref_rec, ref_tm) = _maps(ptype, 3, seed=6)
    images = [f"im{i}" for i in range(3)]
    udata, ref_udata = _MemUdata(), _MemUdata()
    shots = undistort.undistort_reconstruction(tm, rec, _MemData(images),
                                               udata)
    ref_shots = ref_undistort.undistort_reconstruction(
        ref_tm, ref_rec, _MemData(images), ref_udata)
    assert {k: [s.id for s in v] for k, v in shots.items()} == \
        {k: [s.id for s in v] for k, v in ref_shots.items()}
    assert udata.saved["ids"] == ref_udata.saved["ids"]
    urec, ref_urec = udata.saved["rec"][0], ref_udata.saved["rec"][0]
    assert sorted(urec.shots) == sorted(ref_urec.shots)
    assert sorted(urec.cameras) == sorted(ref_urec.cameras)
    for cid in urec.cameras:
        _same_camera(urec.cameras[cid], ref_urec.cameras[cid])
    assert sorted(urec.rig_cameras) == sorted(ref_urec.rig_cameras)
    for rid, rc in urec.rig_cameras.items():
        assert np.array_equal(rc.pose.rotation,
                              ref_urec.rig_cameras[rid].pose.rotation)
    assert sorted(urec.rig_instances) == sorted(ref_urec.rig_instances)
    for iid, inst in urec.rig_instances.items():
        ref_inst = ref_urec.rig_instances[iid]
        assert sorted(inst.shots) == sorted(ref_inst.shots)
        assert np.allclose(inst.pose.rotation, ref_inst.pose.rotation,
                           atol=1e-15)
    for sid, shot in urec.shots.items():
        assert np.allclose(shot.pose.get_origin(),
                           ref_urec.shots[sid].pose.get_origin(), atol=1e-12)
    utm, ref_utm = udata.saved["tracks"], ref_udata.saved["tracks"]
    assert sorted(utm.get_shot_ids()) == sorted(ref_utm.get_shot_ids())
    n_obs = 0
    for sid in ref_utm.get_shot_ids():
        obs, ref_obs = (utm.get_shot_observations(sid),
                        ref_utm.get_shot_observations(sid))
        assert list(obs) == list(ref_obs)
        for tid, o in obs.items():
            assert np.abs(o.point - ref_obs[tid].point).max() <= OBS_TOL
            assert o.id == ref_obs[tid].id
            n_obs += 1
    assert n_obs > 30


@pytest.fixture(scope="module")
def brown_views(tmp_path_factory):
    """3 views of 96 x 72 rendered through the brown model, with their true
    reconstruction and tracks."""
    path = str(tmp_path_factory.mktemp("brown_views") / "data")
    camera = si.CAMERA_MODELS["brown"]
    si.write_image_dataset(path, 3, 96, 72, seed=0, step_deg=10.0,
                           camera=camera)
    si.write_true_reconstruction(path, 3, 96, 72, step_deg=10.0,
                                 camera=camera, n_points=200)
    return path


@pytest.fixture(scope="module")
def brown_dataset(brown_views, tmp_path_factory):
    """`brown_views` undistorted by the JAX package's action and by the
    port's command on two copies."""
    root = tmp_path_factory.mktemp("undistort")
    path, port = str(root / "ref"), str(root / "port")
    shutil.copytree(brown_views, path)
    shutil.copytree(brown_views, port)
    ref_action.run_dataset(RefDataSet(path))
    report = command_runner(opensfm_commands,
                            argv=["undistort", port, "--device", "cpu"])
    return path, port, report


def test_undistort_command_against_reference(brown_dataset):
    path, port, report = brown_dataset
    assert report["shots"] == report["subshots"] == report["images_written"] \
        == 3
    ref_dir, port_dir = (os.path.join(p, "undistorted") for p in (path, port))
    for sub in ("", "images"):
        assert sorted(os.listdir(os.path.join(port_dir, sub))) == \
            sorted(os.listdir(os.path.join(ref_dir, sub)))
    with open(os.path.join(ref_dir, "undistorted_shot_ids.json")) as f:
        ref_ids = json.load(f)
    udata = UndistortedDataSet(DataSet(port), port_dir)
    assert udata.load_undistorted_shot_ids() == ref_ids
    for image in os.listdir(os.path.join(ref_dir, "images")):
        ref_img = io.imread(os.path.join(ref_dir, "images", image))
        _assert_images_close(udata.load_undistorted_image(image), ref_img)
    (urec,) = udata.load_undistorted_reconstruction()
    ref_udata = UndistortedDataSet(DataSet(path), ref_dir)
    (ref_urec,) = ref_udata.load_undistorted_reconstruction()
    assert io.reconstruction_to_json(urec) == \
        io.reconstruction_to_json(ref_urec)
    utm = udata.load_undistorted_tracks_manager()
    ref_utm = ref_udata.load_undistorted_tracks_manager()
    for sid in ref_utm.get_shot_ids():
        obs = utm.get_shot_observations(sid)
        for tid, o in ref_utm.get_shot_observations(sid).items():
            assert np.abs(obs[tid].point - o.point).max() <= OBS_TOL


def test_undistort_skip_images(brown_views, tmp_path):
    path = str(tmp_path / "skip")
    shutil.copytree(brown_views, path)
    report = command_runner(opensfm_commands, argv=[
        "undistort", path, "--device", "cpu", "--skip-images",
        "--output", "und2"])
    assert report["shots"] == 3 and "images_written" not in report
    assert os.path.isfile(os.path.join(path, "und2", "reconstruction.json"))
    assert not os.path.isdir(os.path.join(path, "und2", "images"))
