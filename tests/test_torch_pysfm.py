"""The port's `pysfm` surface (`opensfm_tpu_torch.pysfm`) on the CPU: the
three cases of tests/test_pysfm.py run as written with the port's
`pymap`, `pysfm`, `types`, topocentric converter, camera and pose in place
of the JAX package's (tracks surgery and `realign_maps`, host code in both
packages), and the port's re-exports checked against the JAX package's
names."""

import pytest
import torch

import test_pysfm as ref_cases
from opensfm_tpu import pysfm as ref_pysfm
from opensfm_tpu_torch import pymap, pysfm, types
from opensfm_tpu_torch.geo import TopocentricConverter
from opensfm_tpu_torch.geometry.cameras import Camera
from opensfm_tpu_torch.geometry.pose import Pose

CASES = ["test_add_remove_connections",
         "test_realign_maps_shifts_shots_and_points",
         "test_realign_maps_respects_reference_offset"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, monkeypatch):
    for name, value in (("pymap", pymap), ("pysfm", pysfm), ("types", types),
                        ("TopocentricConverter", TopocentricConverter),
                        ("Camera", Camera), ("Pose", Pose)):
        monkeypatch.setattr(ref_cases, name, value)
    getattr(ref_cases, case)()


def test_same_names_as_reference():
    assert pysfm.__all__ == ref_pysfm.__all__
    for name in pysfm.__all__:
        assert callable(getattr(pysfm, name))
        assert getattr(pysfm, name).__module__.startswith("opensfm_tpu_torch")
