"""The port's `run_all`: the eight stages in the JAX package's order
(`opensfm_tpu/commands/run_all.py`), each action called with the dataset
and the `--device` given, and a report with every stage's wall seconds and
the stage's own report (each stage's `run_dataset` recorded by
monkeypatch; the whole chain runs on the card in `chip_smoke.py`'s phase
15); without `--device` it needs CUDA."""

import importlib

import pytest
import torch

from opensfm_tpu.commands import run_all as ref_run_all
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.commands.run_all import STAGES


def _record(monkeypatch):
    calls = []
    for stage in STAGES:
        module = importlib.import_module(f"opensfm_tpu_torch.actions.{stage}")

        def fake(data, device=None, _stage=stage):
            calls.append((_stage, data.data_path, device))
            return {"stage": _stage}

        monkeypatch.setattr(module, "run_dataset", fake)
    return calls


def test_run_all_stages_in_reference_order(tmp_path, monkeypatch):
    ref_order = [line.strip().split(".")[0]
                 for line in open(ref_run_all.__file__)
                 if line.strip().endswith(".run_dataset(data)")]
    assert list(STAGES) == ref_order
    (tmp_path / "images").mkdir()
    calls = _record(monkeypatch)
    report = command_runner(opensfm_commands,
                            argv=["run_all", str(tmp_path), "--device", "cpu"])
    assert [c[0] for c in calls] == list(STAGES)
    assert all(c[1] == str(tmp_path) for c in calls)
    assert calls[0][2] is None  # extract_metadata runs on the host
    assert all(c[2] == torch.device("cpu") for c in calls[1:])
    assert list(report) == list(STAGES)
    for stage, entry in report.items():
        assert entry["report"] == {"stage": stage}
        assert entry["wall_s"] >= 0.0


def test_run_all_without_device_needs_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    (tmp_path / "images").mkdir()
    calls = _record(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        command_runner(opensfm_commands, argv=["run_all", str(tmp_path)])
    assert calls == []
