"""The port's `mesh` against the JAX package's on the CPU: `triangle_mesh`
on a perspective shot and on a spherical shot of the same maps
(`test_torch_undistort._maps`), vertices within 1e-12 and faces equal
(scipy's Delaunay and ConvexHull on the same inputs), and the `mesh`
command writing `reconstruction.meshed.json` as the JAX package's action
does."""

import json
import os
import shutil

import numpy as np
import pytest

from opensfm_tpu import mesh as ref_mesh
from opensfm_tpu.actions import mesh as ref_action
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import mesh
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from test_torch_undistort import _maps, brown_views  # noqa: F401

VERTEX_TOL = 1e-12


@pytest.mark.parametrize("ptype", ["brown", "spherical"])
def test_triangle_mesh_against_reference(ptype):
    (rec, tm), (ref_rec, ref_tm) = _maps(ptype, 2, seed=8)
    for shot_id in ("im0", "im1"):
        vertices, faces = mesh.triangle_mesh(shot_id, rec, tm)
        ref_vertices, ref_faces = ref_mesh.triangle_mesh(shot_id, ref_rec,
                                                         ref_tm)
        assert len(faces) > 10
        assert faces == ref_faces
        assert np.abs(np.asarray(vertices)
                      - np.asarray(ref_vertices)).max() <= VERTEX_TOL
    assert mesh.triangle_mesh("absent", rec, tm) == ([], [])


def test_mesh_command_against_reference(brown_views, tmp_path):
    path, ref_path = str(tmp_path / "port"), str(tmp_path / "ref")
    shutil.copytree(brown_views, path)
    shutil.copytree(brown_views, ref_path)
    report = command_runner(opensfm_commands,
                            argv=["mesh", path, "--device", "cpu"])
    assert report["shots"] == 3 and report["faces_min"] > 0
    ref_action.run_dataset(RefDataSet(ref_path))
    with open(os.path.join(path, "reconstruction.meshed.json")) as f:
        port = json.load(f)
    with open(os.path.join(ref_path, "reconstruction.meshed.json")) as f:
        ref = json.load(f)
    for sid, shot in ref[0]["shots"].items():
        assert port[0]["shots"][sid]["faces"] == shot["faces"]
        assert np.abs(np.asarray(port[0]["shots"][sid]["vertices"])
                      - shot["vertices"]).max() <= VERTEX_TOL
