"""The port's `report` and the `compute_statistics` / `export_report`
commands against the JAX package on the CPU.

A dataset is written to disk from the seed-42 circle scene (exif, camera
models, features, tracks, the truth as reconstruction.json, its GCPs and
two stage reports).  The port's two commands run on one copy through the
command runner with `--device cpu`, the JAX package's actions on another
copy (the same mtimes, so the same `date`):

- stats/stats.json equal to the JAX action's (as in test_torch_stats.py),
  the same figure files, and stats/report.pdf;
- the same section helper calls in the same order (`_make_section`,
  `_make_subsection`, `_make_table` with its columns and rows,
  `_make_centered_image` with its file, `add_page_break`), recorded with
  monkeypatch on both packages' `Report` fed the same statistics; pages
  the port breaks for room are not helper calls;
- a well-formed PDF: `chip_smoke.read_pdf` (the reader the card's run
  uses) follows every xref offset to its `n 0 obj` and each stream to its
  /Length, and inflates each page's content stream; every section title
  and table cell is found in order, and each image XObject's size and
  pixels equal its PNG's;
- without stats.json, `export_report` alone writes it and the PDF.
"""

import copy
import inspect
import json
import os
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import read_pdf
from opensfm_tpu import report as ref_report
from opensfm_tpu.actions import compute_statistics as ref_compute_statistics
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import io, report
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from test_torch_stats import assert_same_stats
from test_torch_synthetic_data import scenes

HELPERS = ("_make_section", "_make_subsection", "_make_table",
            "_make_centered_image", "add_page_break")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_scene_dataset(root):
    """The port's seed-42 circle scene as a dataset on disk."""
    inp = scenes("circle", 42)[1][1]
    os.makedirs(root)
    with open(os.path.join(root, "image_list.txt"), "w") as f:
        f.write("".join(f"images/{s}\n"
                        for s in sorted(inp.reconstruction.shots)))
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write("{}\n")
    data = DataSet(root)
    for image, exif in inp.exifs.items():
        data.save_exif(image, exif)
    data.save_camera_models(inp.reconstruction.cameras)
    for image, features in inp.features.items():
        data.save_features(image, features)
    data.save_tracks_manager(inp.tracks_manager)
    data.save_reference_lla({"latitude": 47.0, "longitude": 6.0,
                             "altitude": 0.0})
    data.save_reconstruction([copy.deepcopy(inp.reconstruction)])
    with open(os.path.join(root, "ground_control_points.json"), "w") as f:
        io.write_ground_control_points(list(inp.gcps.values()), f)
    os.makedirs(os.path.join(root, "reports"))
    for name, obj in (("features.json", {"wall_time": 12.5}),
                      ("reconstruction.json",
                       {"wall_times": {"a": 1.25, "b": 30.0}})):
        with open(os.path.join(root, "reports", name), "w") as f:
            json.dump(obj, f)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    base = tmp_path_factory.mktemp("report")
    # One base name: the report's first table names the dataset.
    port, jax = str(base / "port" / "scene"), str(base / "jax" / "scene")
    write_scene_dataset(port)
    shutil.copytree(port, jax)  # copy2: the same mtimes
    result = command_runner(opensfm_commands, argv=[
        "compute_statistics", port, "--device", "cpu"])
    command_runner(opensfm_commands, argv=[
        "export_report", port, "--device", "cpu"])
    ref_compute_statistics.run_dataset(RefDataSet(jax))
    return port, jax, result


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_compute_statistics_command_equals_jax_action(datasets):
    port, jax, result = datasets
    got = _load(os.path.join(port, "stats", "stats.json"))
    want = _load(os.path.join(jax, "stats", "stats.json"))
    assert_same_stats(got, want)
    assert got["processing_statistics"]["date"] != "unknown"
    assert got["processing_statistics"]["steps_times"]["Total Time"] == 43.75
    assert "ce90" in got["gcp_errors"]
    assert result["device"] == "cpu"
    assert set(result["figures_s"]) == {"residual_histogram", "matchgraph",
                                        "topview", "heatmap",
                                        "residual_grids"}
    names = sorted(os.listdir(os.path.join(port, "stats")))
    assert names == sorted(os.listdir(os.path.join(jax, "stats"))
                           + ["report.pdf"])
    assert "residual_histogram.png" not in names


def _record(monkeypatch, cls, calls):
    for name in HELPERS:
        original = getattr(cls, name)
        signature = inspect.signature(original)

        def wrapper(self, *args, _name=name, _orig=original,
                    _sig=signature, **kwargs):
            bound = _sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            values = dict(bound.arguments)
            del values["self"]
            if _name == "_make_centered_image":
                values["image_path"] = os.path.basename(values["image_path"])
            calls.append((_name, values))
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(cls, name, wrapper)


@pytest.fixture(scope="module")
def recorded(datasets):
    port, jax, _ = datasets
    stats = _load(os.path.join(port, "stats", "stats.json"))
    mp = pytest.MonkeyPatch()
    want, got = [], []
    try:
        _record(mp, ref_report.Report, want)
        _record(mp, report.Report, got)
        ref = ref_report.Report(RefDataSet(jax), stats)
        ref.generate_report()
        ref._pages = []
        ours = report.Report(DataSet(port), stats)
        ours.generate_report()
    finally:
        mp.undo()
        import matplotlib.pyplot as plt

        plt.close("all")
    return want, got, ours


def test_same_helper_calls_in_the_same_order(recorded):
    want, got, _ = recorded
    assert got == want
    names = [c[0] for c in got]
    assert names.count("add_page_break") == 3
    assert ("_make_section", {"title": "GPS/GCP Errors Details"}) in got
    images = [c[1]["image_path"] for c in got
              if c[0] == "_make_centered_image"]
    assert images == ["topview.png", "heatmap_1.png",
                      "residual_histogram.png", "matchgraph.png",
                      "residuals_1.png"]


def _expected_texts(calls):
    out = []
    for name, values in calls:
        if name in ("_make_section", "_make_subsection"):
            out.append(values["title"])
        elif name == "_make_table":
            if values["columns_names"]:
                out.extend(str(c) for c in values["columns_names"])
            for row in values["rows"]:
                out.extend(str(c) for c in row)
    return out


def _in_order(needles, haystack):
    it = iter(haystack)
    return all(any(n == h for h in it) for n in needles)


def test_pdf_well_formed_text_and_images(datasets, recorded, tmp_path):
    port = datasets[0]
    _, got, ours = recorded
    path = str(tmp_path / "report.pdf")
    ours.doc.save(path)
    pages, texts, images = read_pdf(path)
    assert pages >= 4
    assert texts[:2] == ["OpenSfM Quality Report",
                         "Processed with OpenSfM-TPU"]
    expected = _expected_texts(got)
    assert _in_order(expected, texts)
    assert any(t.endswith(" km²") for t in texts)
    assert "-1.00000" in " ".join(texts)  # no angular error (as the JAX's)
    pngs = [c[1]["image_path"] for c in got if c[0] == "_make_centered_image"
            and os.path.isfile(os.path.join(port, "stats",
                                            c[1]["image_path"]))]
    assert len(images) == len(pngs) == 4
    for (w, h, pixels), name in zip(images, pngs):
        png = io.imread(os.path.join(port, "stats", name))
        assert (h, w) == png.shape[:2]
        assert np.array_equal(pixels, png.reshape(-1))
    # The command's own file is the same document.
    with open(path, "rb") as a, \
            open(os.path.join(port, "stats", "report.pdf"), "rb") as b:
        assert a.read() == b.read()


def test_export_report_alone_writes_stats_and_pdf(datasets, tmp_path):
    port = datasets[0]
    fresh = str(tmp_path / "fresh")
    shutil.copytree(port, fresh)
    shutil.rmtree(os.path.join(fresh, "stats"))
    command_runner(opensfm_commands, argv=[
        "export_report", fresh, "--device", "cpu"])
    assert _load(os.path.join(fresh, "stats", "stats.json")) == \
        _load(os.path.join(port, "stats", "stats.json"))
    pages, texts, _ = read_pdf(os.path.join(fresh, "stats", "report.pdf"))
    assert pages >= 4 and "Dataset Summary" in texts


def test_commands_need_cuda_without_device(datasets):
    """No quiet fallback: without `--device` the commands run on CUDA and
    raise where it is absent."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    for command in ("compute_statistics", "export_report"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            command_runner(opensfm_commands, argv=[command, datasets[0]])
