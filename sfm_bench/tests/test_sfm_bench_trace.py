"""The trace reader's arithmetic on a made-up profile: device time by
kernel, the union of device intervals, and the idle gaps named by the
harness's span and the innermost host operation."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from sfm_bench import trace


def _ev(name, start, end, device=False):
    """One raw profiler event (times in microseconds)."""
    kind = DeviceType.CUDA if device else DeviceType.CPU
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start * 1000,
        duration_ns=lambda: (end - start) * 1000, device_type=lambda: kind,
        is_user_annotation=lambda: False)


class _Prof:
    """What `trace` reads of a finished `torch.profiler.profile`."""

    def __init__(self, events):
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: events))


def test_busy_gaps_and_kernels():
    prof = _Prof([
        _ev("sfm_bench.window", 0, 1000), _ev("step", 0, 600),
        _ev("step", 600, 1000), _ev("aten::mm", 100, 200),
        _ev("aten::item", 700, 900),
        _ev("k1", 100, 300, True), _ev("k1", 250, 400, True),
        _ev("Memcpy HtoD", 500, 550, True), _ev("k2", 950, 1100, True),
        _ev("step", 0, 600, True), _ev("sfm_bench.window", 0, 1000, True)])
    s = trace.summarise(prof, "sfm_bench.window", {"step"})
    assert s.window_s == pytest.approx(1e-3)
    # Union inside the window: [100, 400], [500, 550], [950, 1000].
    assert s.busy_s == pytest.approx(400e-6)
    assert s.kernels["k1"] == (2, pytest.approx(350e-6))
    assert s.launches() == 4
    assert s.device_ops[0][0] == "k1"
    gaps = dict(s.idle_gaps)
    # [550, 950] mid 750 under aten::item; [0, 100] and [400, 500] in
    # python between operations of the first step.
    assert gaps["step/aten::item"] == pytest.approx(400e-6)
    assert gaps["step/python"] == pytest.approx(200e-6)


def test_no_device_events():
    prof = _Prof([_ev("sfm_bench.window", 0, 10), _ev("step", 0, 10)])
    s = trace.summarise(prof, "sfm_bench.window", {"step"})
    assert s.busy_s == 0.0 and not s.kernels
