"""The `bundle` action end to end: one synthetic dataset, two copies, the
reference's `actions.bundle.run_dataset` on one and the port's command (on
the CPU) on the other; the bundled poses and points agree within 1e-6."""

import json
import os
import shutil

import numpy as np
import pytest

import synthetic_bundle as sb
from opensfm_tpu.actions import bundle as ref_bundle
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import geo
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.geometry import cameras as cl
from opensfm_tpu_torch.geometry.pose import Pose


def _write_gcps(path, problem, seed=0):
    """Two ground control points seen from three shots each: one with an
    LLA position (a prior row), one without (projections only)."""
    rng = np.random.default_rng(seed)
    ref = geo.TopocentricConverter(0.0, 0.0, 0.0)
    points = []
    for k, X in enumerate([np.array([0.5, -0.3, 0.2]),
                           np.array([-1.0, 0.8, -0.4])]):
        obs = []
        for i in (k, k + 3, k + 6):
            pose = Pose(problem.inst[i, :3], problem.inst[i, 3:])
            pc = pose.get_rotation_matrix() @ X + pose.translation
            uv = cl.project("perspective", pc, problem.cam[0], xp=np)
            obs.append({"shot_id": sb.shot_id(i),
                        "projection": list(uv + rng.normal(0, 1e-4, 2))})
        point = {"id": f"g{k}", "observations": obs}
        if k == 0:
            lat, lon, alt = ref.to_lla(*(X + 0.02))
            point["position"] = {"latitude": lat, "longitude": lon,
                                 "altitude": alt}
        points.append(point)
    with open(os.path.join(path, "ground_control_points.json"), "w") as f:
        json.dump({"points": points}, f)


@pytest.mark.parametrize("with_gcp", [False, True], ids=["plain", "gcp"])
def test_bundle_command_matches_reference(tmp_path, with_gcp):
    problem = sb.make_problem(12, 300, seed=3, track_window=5)
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    # Below bundle_distributed_min_shots, and pinned off: the reference
    # would otherwise route to its sharded solver on the test mesh.
    sb.write_dataset(a, problem, {"bundle_distributed": "no"})
    if with_gcp:
        _write_gcps(a, problem)
    shutil.copytree(a, b)

    ref_bundle.run_dataset(RefDataSet(a))
    reports = command_runner(opensfm_commands,
                             argv=["bundle", b, "--device", "cpu"])
    assert len(reports) == 1
    assert reports[0]["final_cost"] < reports[0]["initial_cost"]

    want = RefDataSet(a).load_reconstruction()[0]
    got = DataSet(b).load_reconstruction()[0]
    assert set(got.points) == set(want.points)
    assert set(got.shots) == set(want.shots)
    for k, p in want.points.items():
        np.testing.assert_allclose(got.points[k].coordinates, p.coordinates,
                                   rtol=0, atol=1e-6)
    for k, s in want.shots.items():
        np.testing.assert_allclose(got.shots[k].pose.rotation,
                                   s.pose.rotation, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.shots[k].pose.translation,
                                   s.pose.translation, rtol=0, atol=1e-6)
    cam_got = next(iter(got.cameras.values()))
    cam_want = next(iter(want.cameras.values()))
    np.testing.assert_allclose(cam_got.parameters, cam_want.parameters,
                               rtol=0, atol=1e-6)
    tracks = DataSet(b).load_tracks_manager()
    assert sb.reprojection_rms(got, tracks) < 2 * sb.NOISE
