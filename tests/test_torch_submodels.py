"""The port's submodel path against the JAX package on the CPU:
`create_submodels` (`opensfm_tpu_torch.large.metadataset`, `large.tools`,
the action and command) and `align_submodels` (`large.tools`' constraints,
the similarity RANSAC of `add_point_constraints` and the alignment solve).

- `create_submodels` through both packages' commands on a 12-image GPS
  dataset from `synthetic_bundle.write_matching_dataset` (a circle of
  radius 10 m; submodels of 6 grown by neighbours within 6 m): the same
  `image_list_with_gps.tsv` and `clusters.geojson` byte for byte, the same
  labels, centres within 1e-12, the same neighbour lists and the same
  symlinks (targets relative to each dataset); and the `image_groups.txt`
  route alike.  The dataset names `images/...` files it never writes, so
  both packages link dangling image paths.
- `align_submodels` on two submodel reconstructions built from the
  generator's truth, each moved by its own similarity and written with the
  JAX package's writers, the port's similarity RANSAC taking the JAX
  package's draws (tests/test_torch_merge.py's `jax_draws`): the centres in
  `reconstruction.aligned.json` agree within 1e-8 m, and the shots the two
  submodels share agree after the alignment.
- Without `--device` both commands run on CUDA, so here they raise.
"""

import argparse
import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu import pymap as ref_pymap
from opensfm_tpu import types as ref_types
from opensfm_tpu.actions import align_submodels as ref_align_action
from opensfm_tpu.commands import create_submodels as ref_create_cmd
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.geometry.pose import Pose as RefPose
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from test_torch_merge import jax_draws  # noqa: F401  (fixture)

# Aligned camera centres, port against the JAX package, under the same
# RANSAC draws (metres).
TOL_ALIGNED = 1e-8
N_SHOTS = 12
CONFIG = {"submodel_size": 6, "submodel_overlap": 6.0}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("submodels") / "data")
    tracks = sb.write_matching_dataset(path, n_shots=N_SHOTS, n_points=400,
                                       track_window=4, features_per_image=200,
                                       config=CONFIG)
    return path, tracks


def _copy(src, dst):
    shutil.copytree(src, dst, symlinks=True)
    return dst


def _run_port(command, path):
    return command_runner(opensfm_commands,
                          argv=[command, path, "--device", "cpu"])


def _run_ref(module, path):
    return module.Command().run(RefDataSet(path), argparse.Namespace())


def _links(root):
    """{relative link path: target relative to `root`} under submodels/."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(os.path.join(root,
                                                             "submodels")):
        for name in dirnames + filenames:
            p = os.path.join(dirpath, name)
            if os.path.islink(p):
                out[os.path.relpath(p, root)] = os.path.relpath(
                    os.readlink(p), os.path.abspath(root))
    return out


def _same_submodels(ref_path, port_path):
    for name in ("image_list_with_gps.tsv", "clusters.geojson"):
        assert filecmp.cmp(os.path.join(ref_path, name),
                           os.path.join(port_path, name), shallow=False), name
    ref_c = np.load(os.path.join(ref_path, "clusters.npz"), allow_pickle=True)
    port_c = np.load(os.path.join(port_path, "clusters.npz"),
                     allow_pickle=True)
    assert list(ref_c["images"]) == list(port_c["images"])
    np.testing.assert_array_equal(port_c["labels"], ref_c["labels"])
    np.testing.assert_array_equal(port_c["positions"], ref_c["positions"])
    np.testing.assert_allclose(port_c["centers"], ref_c["centers"], rtol=0,
                               atol=1e-12)
    ref_n = np.load(os.path.join(ref_path, "clusters_with_neighbors.npz"),
                    allow_pickle=True)["clusters"]
    port_n = np.load(os.path.join(port_path, "clusters_with_neighbors.npz"),
                     allow_pickle=True)["clusters"]
    assert [list(c) for c in port_n] == [list(c) for c in ref_n]
    links = _links(port_path)
    assert links == _links(ref_path)
    return links, [list(c) for c in port_n]


def test_create_submodels_matches_reference(dataset, tmp_path):
    path, _ = dataset
    ref_path = _copy(path, str(tmp_path / "ref"))
    port_path = _copy(path, str(tmp_path / "port"))
    _run_ref(ref_create_cmd, ref_path)
    _run_port("create_submodels", port_path)
    links, clusters = _same_submodels(ref_path, port_path)
    # Two submodels of 6 shots grown by their two neighbours each side.
    assert len(clusters) == 2
    assert [len(c) for c in clusters] == [8, 8]
    assert len(set(clusters[0]) & set(clusters[1])) == 4
    sub = os.path.join(port_path, "submodels", "submodel_0000")
    for name in ("config.yaml", "camera_models.json", "reference_lla.json",
                 "exif", "features"):
        assert os.path.islink(os.path.join(sub, name))
    # The image links dangle (the dataset has no image files), in both.
    image_links = [k for k in links if "/images/" in k]
    assert len(image_links) == 16
    assert not os.path.exists(os.path.join(port_path, image_links[0]))
    assert DataSet(sub).images() == sorted(
        os.path.basename(k) for k in image_links
        if k.startswith("submodels/submodel_0000/"))


def test_create_submodels_image_groups_matches_reference(dataset, tmp_path):
    path, _ = dataset
    ref_path = _copy(path, str(tmp_path / "ref"))
    port_path = _copy(path, str(tmp_path / "port"))
    images = DataSet(path).images()
    for p in (ref_path, port_path):
        # init_reference is the k-means route's; the groups route reads it.
        DataSet(p).init_reference()
        with open(os.path.join(p, "image_groups.txt"), "w") as f:
            for i, image in enumerate(images):
                f.write(f"{image} g{(i // 4) % 3}\n")
    _run_ref(ref_create_cmd, ref_path)
    _run_port("create_submodels", port_path)
    _, clusters = _same_submodels(ref_path, port_path)
    assert len(clusters) == 3


def _random_similarity(rng):
    from opensfm_tpu.geometry.pose import _rotvec_to_matrix_np
    # Scales within 1.15 of each other: add_point_constraints keeps the
    # common points of submodels whose relative scale is within 1.3.
    return (float(rng.uniform(0.87, 1.15)),
            _rotvec_to_matrix_np(rng.normal(size=3) * 0.3),
            rng.normal(size=3) * 3.0)


def _write_submodel(sub, tracks, truth_points, sim, rng):
    """The submodel's shots at their true poses and the points they see,
    all moved by the similarity `sim` (with 1 mm of pose noise), GPS from
    the EXIF, and its tracks (one per point, ids named by the submodel):
    written with the JAX package's writers."""
    data = RefDataSet(sub)
    reference = data.load_reference()
    camera = next(iter(data.load_camera_models().values()))
    rec = ref_types.Reconstruction()
    rec.reference = reference
    rec.add_camera(camera)
    s, A, b = sim
    insts = sb.circle_shots(N_SHOTS)
    name = os.path.basename(sub)
    tm = ref_pymap.TracksManager()
    seen = set()
    for image in data.images():
        i = int(image.split("_")[1].split(".")[0])
        pose = RefPose(insts[i, :3], insts[i, 3:])
        origin = s * A @ pose.get_origin() + b + rng.normal(size=3) * 1e-3
        moved = RefPose()
        moved.set_rotation_matrix(pose.get_rotation_matrix() @ A.T)
        moved.set_origin(origin)
        shot = rec.create_shot(image, camera.id, moved)
        gps = data.load_exif(image)["gps"]
        shot.metadata.gps_position.value = np.array(reference.to_topocentric(
            gps["latitude"], gps["longitude"], gps["altitude"]))
        shot.metadata.gps_accuracy.value = 1.0
        feats = data.load_features(image)
        for fid, pid in enumerate(tracks[image]):
            if pid < 0:
                continue
            track = f"{name}_{pid}"
            x, y = feats.points[fid, :2]
            tm.add_observation(image, track, ref_pymap.Observation(
                float(x), float(y), 0.004, 128, 128, 128, fid))
            seen.add(int(pid))
    for pid in sorted(seen):
        rec.create_point(f"{name}_{pid}", s * A @ truth_points[pid] + b)
    data.save_reconstruction([rec])
    data.save_tracks_manager(tm)


def test_align_submodels_matches_reference(dataset, tmp_path, jax_draws):
    path, tracks = dataset
    base = _copy(path, str(tmp_path / "base"))
    _run_port("create_submodels", base)
    rng = np.random.default_rng(0)
    truth_points = np.random.default_rng(0).uniform(-4, 4, (400, 3))
    subs = sorted(os.listdir(os.path.join(base, "submodels")))
    assert len(subs) == 2
    for sub in subs:
        _write_submodel(os.path.join(base, "submodels", sub), tracks,
                        truth_points, _random_similarity(rng), rng)
    ref_path = _copy(base, str(tmp_path / "ref"))
    port_path = _copy(base, str(tmp_path / "port"))
    np.random.seed(0)
    ref_align_action.run_dataset(RefDataSet(ref_path))
    np.random.seed(0)
    report = _run_port("align_submodels", port_path)
    assert report["partials"] == 2
    rows, cols = report["jacobian_shape"]
    assert cols == 2 * 7 + 12 * 6
    assert rows > 16 * 6 + 12 * 3  # relative motions, GPS, common points
    centres = {}
    for sub in subs:
        got = DataSet(os.path.join(port_path, "submodels", sub)) \
            .load_reconstruction("reconstruction.aligned.json")[0]
        want = RefDataSet(os.path.join(ref_path, "submodels", sub)) \
            .load_reconstruction("reconstruction.aligned.json")[0]
        assert sorted(got.shots) == sorted(want.shots)
        for sid, shot in got.shots.items():
            np.testing.assert_allclose(shot.pose.get_origin(),
                                       want.shots[sid].pose.get_origin(),
                                       rtol=0, atol=TOL_ALIGNED)
            centres.setdefault(sid, []).append(shot.pose.get_origin())
    shared = [c for c in centres.values() if len(c) == 2]
    assert len(shared) == 4
    # The shared shots agree after the alignment (each submodel's frame
    # was moved by its own similarity: scale 0.87-1.15, metres of shift).
    assert max(np.linalg.norm(a - b) for a, b in shared) < 0.05


@pytest.mark.parametrize("command", ["create_submodels", "align_submodels"])
def test_cuda_less_call_raises(dataset, tmp_path, command):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    path = _copy(dataset[0], str(tmp_path / "data"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        command_runner(opensfm_commands, argv=[command, path])
