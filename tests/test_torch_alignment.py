"""The port's submodel alignment solve (`opensfm_tpu_torch.ba.alignment`)
against the JAX package's (`opensfm_tpu.ba.alignment`) on the CPU.

- The four cases of tests/test_reconstruction_alignment.py, run as written
  with the port's classes, and the JAX package's run of each beside it.
- A seeded problem of 3 submodels and 30 shots with all four constraint
  families (relative motions with scale matrices, GPS positions, common
  points and common cameras), one submodel and one shot constant.
- Against the JAX package: parameters within 1e-9 absolute, the same
  number of accepted steps (each loop's trial costs recorded; a
  zero-residual case's steps below 1e-20 of the start cost are decided by
  rounding and not counted), constant entities unchanged bit for bit.
- The forward-mode Jacobian at zero rotations (every submodel starts
  there in `large/tools.align_reconstructions`): finite and equal to the
  JAX package's `jax.jacfwd`, and at rotations of angle near pi.
"""

import numpy as np
import pytest
import torch

import test_reconstruction_alignment as ref_cases
from opensfm_tpu.ba import alignment as ref_alignment
from opensfm_tpu_torch.ba import alignment
from opensfm_tpu_torch.geometry.pose import Pose

import jax

# Parameters, port against the JAX package (the same steps; rounding only).
TOL_PARAMS = 1e-9
# The Jacobian at a zero rotation and near pi.
TOL_JAC = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(cls, made, **kw):
    class Recorded(cls):
        def __init__(self):
            super().__init__(**kw)
            made.append(self)
    return Recorded


class _TrialCosts:
    """Stands in for a module's numpy and records the cost of every trial
    (each package's loop asks np.isfinite of it once a trial)."""

    def __init__(self):
        self.costs = []

    def __getattr__(self, name):
        return getattr(np, name)

    def isfinite(self, x):
        self.costs.append(float(x))
        return np.isfinite(x)


def _accepted(costs, initial):
    """The accepted trials' costs, in order, of a loop that started at
    `initial`."""
    out, cost = [], initial
    for c in costs:
        if np.isfinite(c) and c < cost:
            out.append(c)
            cost = c
    return out


@pytest.fixture
def trials(monkeypatch):
    """Each package's trial costs (JAX package first, then the port)."""
    rec = (_TrialCosts(), _TrialCosts())
    monkeypatch.setattr(ref_alignment, "np", rec[0])
    monkeypatch.setattr(alignment, "np", rec[1])
    return rec


def _initial(ra):
    return ({k: e.parameters.copy() for k, e in ra._recs.items()},
            {k: e.parameters.copy() for k, e in ra._shots.items()})


# Accepted steps are compared while the cost is above this share of its
# start: below it each accept is decided by rounding alone (a zero-residual
# case reads 4.9e-26 -> 0 in the JAX package, 4.9e-26 -> 1.4e-32 -> 0 in
# the port, parameters equal to 1e-15).
ROUNDING_FLOOR = 1e-20


def _check_parity(ref, port, trials, initial):
    ref_acc = _accepted(trials[0].costs, ref_cost0 := port.initial_cost)
    port_acc = _accepted(trials[1].costs, ref_cost0)
    assert port.iterations == len(port_acc)
    floor = ROUNDING_FLOOR * port.initial_cost
    assert len([c for c in ref_acc if c > floor]) \
        == len([c for c in port_acc if c > floor])
    if min(ref_acc[-1:] + port_acc[-1:], default=np.inf) > floor:
        assert len(ref_acc) == len(port_acc)
    # The report string as the JAX package's, its costs equal above the
    # rounding floor.
    assert port.brief_report() == (
        f"ReconstructionAlignment: cost {port.initial_cost:.4g} -> "
        f"{port.final_cost:.4g}")
    assert ref.brief_report().split(" -> ")[0] \
        == port.brief_report().split(" -> ")[0]
    ref_final = ref_acc[-1] if ref_acc else port.initial_cost
    assert abs(port.final_cost - ref_final) <= max(1e-8 * ref_final, floor)
    recs0, shots0 = initial
    for table, table0, ref_table in ((port._recs, recs0, ref._recs),
                                     (port._shots, shots0, ref._shots)):
        assert list(table) == list(ref_table)
        for key, entity in table.items():
            np.testing.assert_allclose(entity.parameters,
                                       ref_table[key].parameters, rtol=0,
                                       atol=TOL_PARAMS)
            if entity.constant:
                assert np.array_equal(entity.parameters, table0[key])


CASES = ["test_single_shot", "test_singleton_reconstruction",
         "test_two_shots_one_reconstruction",
         "test_two_reconstructions_common_point"]


@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, monkeypatch, trials):
    """tests/test_reconstruction_alignment.py's case as written, on each
    package, then the port held to the JAX package."""
    made_ref, made_port = [], []
    monkeypatch.setattr(ref_cases, "ReconstructionAlignment", _recording(
        ref_alignment.ReconstructionAlignment, made_ref))
    getattr(ref_cases, case)()
    monkeypatch.setattr(ref_cases, "ReconstructionAlignment", _recording(
        alignment.ReconstructionAlignment, made_port, device="cpu"))
    monkeypatch.setattr(ref_cases, "RARelativeMotionConstraint",
                        alignment.RARelativeMotionConstraint)
    monkeypatch.setattr(ref_cases, "Pose", Pose)
    getattr(ref_cases, case)()
    (ref,), (port,) = made_ref, made_port
    _check_parity(ref, port, trials, ({}, {}))


def _seeded(mod, seed=3, n_shots=30, **kw):
    """3 submodels, `n_shots` shots: every shot has a GPS position and a
    relative motion (scale matrix diag 1..1.5) to submodel shot % 3; 10
    common points between submodels 0 and 1; 5 common cameras between 1
    and 2.  Submodel 2 and shot 7 are constant."""
    rng = np.random.default_rng(seed)
    ra = mod.ReconstructionAlignment(**kw)
    for r in range(3):
        sim = np.concatenate([rng.normal(size=3) * 0.1, rng.normal(size=3),
                              [1.0 + 0.1 * r]])
        ra.add_reconstruction(f"r{r}", *sim, r == 2)
    for s in range(n_shots):
        ra.add_shot(f"s{s}", *(rng.normal(size=6) * [0.3, 0.3, 0.3, 2, 2, 2]),
                    s == 7)
        ra.add_absolute_position_constraint(f"s{s}", *(rng.normal(size=3) * 2),
                                            0.5)
    for s in range(n_shots):
        rmc = mod.RARelativeMotionConstraint(
            f"r{s % 3}", f"s{s}",
            *(rng.normal(size=6) * [0.3, 0.3, 0.3, 2, 2, 2]))
        for i in range(6):
            rmc.set_scale_matrix(i, i, 1.0 + 0.1 * i)
        ra.add_relative_motion_constraint(rmc)
    for _ in range(10):
        ra.add_common_point_constraint("r0", *rng.normal(size=3), "r1",
                                       *rng.normal(size=3), 0.1)
    for s in range(5):
        ra.add_common_camera_constraint("r1", f"s{s}", "r2", f"s{s + 5}", 1.0)
    return ra


def test_seeded_three_submodels_all_families(trials):
    ref = _seeded(ref_alignment)
    ref.run(max_iterations=20)
    port = _seeded(alignment, device="cpu")
    initial = _initial(port)
    port.run(max_iterations=20)
    _check_parity(ref, port, trials, initial)
    assert len(_accepted(trials[0].costs, port.initial_cost)) \
        == port.iterations > 5
    assert port.jacobian_shape == (30 * 6 + 30 * 3 + 10 * 3 + 5 * 3,
                                   3 * 7 + 30 * 6)
    assert port.final_cost < port.initial_cost


def _recorded_jacobians(monkeypatch, ra, jacfwd_module):
    """The first Jacobian that `ra.run(max_iterations=1)` forms, recorded
    by wrapping its module's jacfwd (inside the JAX package's jit through
    a debug callback)."""
    seen = []
    orig = jacfwd_module.jacfwd

    def jacfwd(fn, *a, **k):
        inner = orig(fn, *a, **k)

        def wrapped(x):
            J = inner(x)
            if jacfwd_module is jax:
                jax.debug.callback(lambda j: seen.append(np.asarray(j)), J)
            else:
                seen.append(J.numpy())
            return J
        return wrapped

    monkeypatch.setattr(jacfwd_module, "jacfwd", jacfwd)
    ra.run(max_iterations=1)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("angle", [0.0, np.pi - 1e-7])
def test_jacobian_at_zero_and_near_pi(monkeypatch, angle):
    """Every submodel and shot at the same rotation: 0 (as
    `align_reconstructions` starts every submodel) or an angle near pi."""
    axis = np.array([0.6, 0.0, 0.8]) * angle

    def build(mod, **kw):
        ra = _seeded(mod, n_shots=10, **kw)
        for e in list(ra._recs.values()) + list(ra._shots.values()):
            e.parameters[:3] = axis
            e.constant = False
        for c in ra._relative_motions:
            c.parameters[:3] = axis
        return ra

    want = _recorded_jacobians(monkeypatch, build(ref_alignment), jax)
    got = _recorded_jacobians(monkeypatch, build(alignment, device="cpu"),
                              torch.func)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL_JAC * max(1.0, np.abs(want).max()))
