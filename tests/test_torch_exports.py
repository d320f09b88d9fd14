"""The port's seven export commands against the JAX package's actions on
the CPU, on one small reconstruction: 3 rendered views of 240 x 180
(`synthetic_images.write_image_dataset`) at their true poses with projected
tracks (`write_true_reconstruction`), undistorted by the port.  Each
command runs the JAX package's action, then the port's command (`python -m
opensfm_tpu_torch <command> <dataset> --device cpu`, in this process
through the command runner) in the same directory: every output is equal,
byte for byte, text and binary alike (the `.mvs` scene, PMVS's JPEGs)."""

import os
import subprocess
import sys

import pytest
import torch

import synthetic_images as si
from opensfm_tpu.actions import (export_bundler, export_colmap,
                                 export_geocoords, export_openmvs,
                                 export_ply, export_pmvs, export_visualsfm)
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import io, io_openmvs
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWS, W, H = 3, 240, 180

# command -> (the JAX package's action, its outputs under the dataset)
COMMANDS = {
    "export_ply": (export_ply, ["reconstruction.ply"]),
    "export_colmap": (export_colmap, [
        "colmap_export/cameras.txt", "colmap_export/images.txt",
        "colmap_export/points3D.txt"]),
    "export_bundler": (export_bundler, ["bundler/bundle.rd.out",
                                        "bundler/list.txt"]),
    "export_visualsfm": (export_visualsfm, ["reconstruction.nvm"]),
    "export_geocoords": (export_geocoords, ["image_geocoords.csv"]),
    "export_pmvs": (export_pmvs, ["pmvs/pmvs_options.txt"] + [
        f"pmvs/{kind}/{i:08d}.{ext}" for i in range(VIEWS)
        for kind, ext in (("visualize", "jpg"), ("txt", "txt"))]),
    "export_openmvs": (export_openmvs, ["undistorted/openmvs/scene.mvs"]),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("exports") / "data")
    si.write_image_dataset(path, VIEWS, W, H, step_deg=10.0)
    si.write_true_reconstruction(path, VIEWS, W, H, step_deg=10.0)
    for stage in ("extract_metadata", "undistort"):
        command_runner(opensfm_commands, argv=[stage, path, "--device",
                                               "cpu"])
    DataSet(path).init_reference()  # the GPS frame of export_geocoords
    return path


def _read(path, names):
    out = {}
    for name in names:
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _remove(path, names):
    for name in names:
        os.remove(os.path.join(path, name))


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_export_matches_reference(dataset, command):
    action, outputs = COMMANDS[command]
    action.run_dataset(RefDataSet(dataset))
    want = _read(dataset, outputs)
    _remove(dataset, outputs)
    command_runner(opensfm_commands, argv=[command, dataset, "--device",
                                           "cpu"])
    got = _read(dataset, outputs)
    for name in outputs:
        assert got[name] == want[name], name

    data = DataSet(dataset)
    rec = data.load_reconstruction()[0]
    if command == "export_colmap":
        points = got["colmap_export/points3D.txt"].decode().splitlines()
        assert len(points) == 1 + len(rec.points)
    elif command == "export_bundler":
        head = got["bundler/bundle.rd.out"].decode().splitlines()[1]
        assert head == f"{len(rec.shots)} {len(rec.points)}"
    elif command == "export_pmvs":
        for i in range(VIEWS):
            jpg = io.imread(os.path.join(dataset, f"pmvs/visualize/"
                                         f"{i:08d}.jpg"))
            assert jpg.shape == (H, W, 3)
    elif command == "export_openmvs":
        scene = io_openmvs.read_mvs(os.path.join(
            dataset, "undistorted/openmvs/scene.mvs"))
        assert len(scene["images"]) == VIEWS
        assert 0 < len(scene["vertices"]) <= len(rec.points)
        assert all(os.path.isfile(im["name"]) for im in scene["images"])


def test_geocoords_options_match_reference(dataset):
    """The transform and the reconstruction in latitude, longitude and
    altitude, which the command does not ask for."""
    from opensfm_tpu_torch.actions import export_geocoords as port_geocoords

    outputs = ["geocoords_transformation.txt",
               "reconstruction.geocoords.json"]
    export_geocoords.run_dataset(RefDataSet(dataset), transformation=True,
                                 reconstruction=True)
    want = _read(dataset, outputs)
    _remove(dataset, outputs)
    port_geocoords.run_dataset(DataSet(dataset), transformation=True,
                               reconstruction=True, device="cpu")
    assert _read(dataset, outputs) == want


def test_export_cli_runs(dataset):
    """`python -m opensfm_tpu_torch export_ply <dataset>` runs on CUDA
    unless told otherwise, as every entry point: without a card it raises
    unless `--device cpu` is given."""
    out = os.path.join(dataset, "reconstruction.ply")
    os.remove(out)
    argv = [sys.executable, "-m", "opensfm_tpu_torch", "export_ply", dataset]
    if not torch.cuda.is_available():
        proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
        assert not os.path.isfile(out)
    proc = subprocess.run(argv + ["--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(out) as f:
        header = f.read().split("end_header")[0]
    n_points = len(DataSet(dataset).load_reconstruction()[0].points)
    assert int(header.split("element vertex")[1].split()[0]) > n_points


def test_read_mvs_rejects_other_files(tmp_path):
    bad = tmp_path / "bad.mvs"
    bad.write_bytes(b"NOPE" + bytes(12))
    with pytest.raises(ValueError, match="bad magic"):
        io_openmvs.read_mvs(str(bad))
