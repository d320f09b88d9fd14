"""The port's statistics figures against what the JAX package hands to
matplotlib, on the CPU.

The JAX package's `save_*` functions run with matplotlib's `Axes.plot`,
`Axes.scatter`, `Axes.hist2d`, `pyplot.quiver` and `pyplot.quiverkey`
recorded (monkeypatch; the calls go through, so it writes its PNGs).  The
port's figure specs of the same scene must hold the same data: the match
graph's segments, in the same order, with the same viridis fractions and
the same shot positions; the top view's points, sizes and colours; each
heatmap's hist2d inputs and counts; each residual grid's quiver U, V and C
and its key's scale.  The port's PNGs have the JAX figures' nominal sizes
(figsize x 150 dpi) and the same file names (no residual_histogram.png:
the JAX package reads a key its statistics never write), and drawing twice
gives equal bytes.  `plot`'s primitives are checked on their own too.
"""

import copy
import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.axes  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from opensfm_tpu import stats as ref_stats  # noqa: E402
from opensfm_tpu.synthetic_data import synthetic_dataset as ref_sd  # noqa: E402,E501
from opensfm_tpu_torch import io, plot, stats  # noqa: E402
from opensfm_tpu_torch.synthetic_data import synthetic_dataset as sd  # noqa: E402,E501
from test_torch_synthetic_data import scenes  # noqa: E402

SIZES = {"matchgraph.png": (1800, 1800), "topview.png": (1800, 1800),
         "heatmap_1.png": (1200, 900), "residuals_1.png": (1800, 1500)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prepared(package):
    """A copy of the seed-42 circle scene's truth with its observations
    attached, as `compute_statistics` leaves it before the figures."""
    inp = scenes("circle", 42)[0 if package == "jax" else 1][1]
    rec = copy.deepcopy(inp.reconstruction)
    rec.add_correspondences_from_tracks_manager(inp.tracks_manager)
    return rec, inp.tracks_manager


@pytest.fixture(scope="module")
def jax_calls(tmp_path_factory):
    """Every recorded matplotlib call of the JAX package's four figures
    (and the histogram, which draws nothing), with the files it wrote."""
    out = str(tmp_path_factory.mktemp("jax_stats"))
    rec, tm = _prepared("jax")
    calls = []
    mp = pytest.MonkeyPatch()

    def record(owner, name, keep_result=False):
        original = getattr(owner, name)

        def wrapper(*args, **kwargs):
            result = original(*args, **kwargs)
            calls.append((name, args, kwargs,
                          result if keep_result else None))
            return result

        mp.setattr(owner, name, wrapper)

    record(matplotlib.axes.Axes, "plot")
    record(matplotlib.axes.Axes, "scatter")
    record(matplotlib.axes.Axes, "hist2d", keep_result=True)
    record(plt, "quiver")
    record(plt, "quiverkey")
    inp = scenes("circle", 42)[0][1]
    data = ref_sd.SyntheticDataSet(inp.reconstruction, inp.exifs,
                                   inp.features, tm)
    try:
        ref_stats.save_residual_histogram(
            ref_stats.compute_all_statistics(data, tm, [copy.deepcopy(rec)]),
            out)
        ref_stats.save_matchgraph(None, tm, [rec], out)
        ref_stats.save_topview(None, tm, [rec], out)
        ref_stats.save_heatmap(None, tm, [rec], out)
        ref_stats.save_residual_grids(None, tm, [rec], out)
    finally:
        mp.undo()
        plt.close("all")
    return calls, out


@pytest.fixture(scope="module")
def port_figures(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_stats"))
    rec, tm = _prepared("port")
    inp = scenes("circle", 42)[1][1]
    data = sd.SyntheticDataSet(inp.reconstruction, inp.exifs, inp.features,
                               tm)
    specs = {
        "histogram": stats.save_residual_histogram(
            stats.compute_all_statistics(data, tm, [copy.deepcopy(rec)],
                                         device="cpu"),
            out, device="cpu"),
        "matchgraph": stats.save_matchgraph(None, tm, [rec], out,
                                            device="cpu"),
        "topview": stats.save_topview(None, tm, [rec], out, device="cpu"),
        "heatmap": stats.save_heatmap(None, tm, [rec], out, device="cpu"),
        "residual_grids": stats.save_residual_grids(None, tm, [rec], out,
                                                    device="cpu"),
    }
    return specs, out


def _calls(jax_calls, name):
    return [c for c in jax_calls[0] if c[0] == name]


def test_matchgraph_segments_colours_and_points(jax_calls, port_figures):
    spec = port_figures[0]["matchgraph"]
    lines = _calls(jax_calls, "plot")
    assert len(lines) == len(spec["c"]) > 0
    viridis = matplotlib.colormaps["viridis"]
    for (_, args, kwargs, _), x, y, c in zip(lines, spec["x"], spec["y"],
                                             spec["c"]):
        assert list(args[1]) == list(x) and list(args[2]) == list(y)
        assert kwargs["color"] == viridis(c)
        assert kwargs["linewidth"] == stats.MATCHGRAPH_LINEWIDTH
    scatter = _calls(jax_calls, "scatter")[0]
    assert np.array_equal(scatter[1][1], spec["points"][:, 0])
    assert np.array_equal(scatter[1][2], spec["points"][:, 1])
    assert scatter[2]["s"] == spec["point_size"] and \
        scatter[2]["c"] == "red"


def test_topview_scatters(jax_calls, port_figures):
    spec = port_figures[0]["topview"]
    scatters = _calls(jax_calls, "scatter")[1:]  # [0] is the match graph's
    assert len(scatters) == len(spec["scatters"]) == 2
    for (_, args, kwargs, _), s in zip(scatters, spec["scatters"]):
        assert np.array_equal(args[1], s["xy"][:, 0])
        assert np.array_equal(args[2], s["xy"][:, 1])
        assert kwargs["s"] == s["s"]
        if isinstance(s["colors"], str):
            assert kwargs["c"] == s["colors"] == "red"
        else:
            assert np.array_equal(kwargs["c"], s["colors"])


def test_heatmap_inputs_and_counts(jax_calls, port_figures):
    figures = port_figures[0]["heatmap"]
    hists = _calls(jax_calls, "hist2d")
    assert len(hists) == len(figures) == 1
    (_, args, kwargs, result), spec = hists[0], figures[0]
    assert np.array_equal(args[1], spec["x"])
    assert np.array_equal(args[2], spec["y"])
    assert kwargs["bins"] == spec["bins"] == 30
    assert np.array_equal(result[0], spec["counts"])
    assert np.array_equal(result[1], spec["xedges"])
    assert np.array_equal(result[2], spec["yedges"])


def test_residual_grid_quiver(jax_calls, port_figures):
    figures = port_figures[0]["residual_grids"]
    quivers = _calls(jax_calls, "quiver")
    keys = _calls(jax_calls, "quiverkey")
    assert len(quivers) == len(keys) == len(figures) == 1
    (_, args, kwargs, _), spec = quivers[0], figures[0]
    assert spec["U"].shape == (40, 40)
    assert np.array_equal(args[0], spec["U"])
    assert np.array_equal(args[1], spec["V"])
    assert np.array_equal(args[2], spec["C"])
    assert kwargs["cmap"] == "viridis_r" and kwargs["scale"] == 1
    assert keys[0][2]["U"] == spec["scale"] * spec["scaling"]
    assert keys[0][2]["label"] == \
        f"Residual grid scale : {spec['scale']:.2f}"


def test_files_sizes_and_names(jax_calls, port_figures):
    specs, out = port_figures
    assert specs["histogram"] is None
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_calls[1])) \
        == sorted(SIZES)
    for name, (w, h) in SIZES.items():
        assert io.imread(os.path.join(out, name)).shape == (h, w, 3)


def test_drawing_twice_gives_equal_bytes(port_figures, tmp_path):
    out = port_figures[1]
    rec, tm = _prepared("port")
    stats.save_matchgraph(None, tm, [rec], str(tmp_path), device="cpu")
    stats.save_topview(None, tm, [rec], str(tmp_path), device="cpu")
    stats.save_heatmap(None, tm, [rec], str(tmp_path), device="cpu")
    stats.save_residual_grids(None, tm, [rec], str(tmp_path), device="cpu")
    for name in SIZES:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(tmp_path, name), "rb") as b:
            assert a.read() == b.read(), name


def test_residual_histogram_drawn_where_its_key_is_present(tmp_path):
    """The histogram the JAX package would draw from the key it reads:
    bars over [0, 4) px at HISTOGRAM_SIZE."""
    st = {"reconstruction_statistics": {
        "reprojection_histogram": [5, 9, 3, 0, 1]}}
    spec = stats.save_residual_histogram(st, str(tmp_path), device="cpu")
    assert np.array_equal(spec["left"], np.linspace(0, 4, 6)[:-1])
    image = io.imread(os.path.join(tmp_path, "residual_histogram.png"))
    assert image.shape == (750, 1200, 3)
    assert (image == stats.HISTOGRAM_BAR).all(axis=2).sum() > 1000


def test_residual_grid_buckets_by_camera_type():
    from opensfm_tpu.geometry.cameras import Camera as RefCamera
    from opensfm_tpu_torch.geometry.cameras import Camera

    assert stats._grid_buckets(Camera.create_spherical()) == \
        ref_stats._grid_buckets(RefCamera.create_spherical()) == (80, 40)
    assert stats._grid_buckets(Camera.create_perspective(0.7, 0, 0)) == \
        (40, 40)


# -- plot.py ------------------------------------------------------------------


def test_colormap_is_matplotlibs_lookup():
    c = np.concatenate([np.linspace(-0.1, 1.1, 1001), [0.5 - 1e-12, 1.0]])
    for name in ("viridis", "viridis_r"):
        want = matplotlib.colormaps[name](c)[:, :3] * 255.0
        assert np.abs(plot.colormap(c, name) - want).max() <= 0.5


def test_painters_order_and_primitives():
    fig = plot.Figure(40, 30, device="cpu")
    fig.rects([0, 10], [0, 10], [20, 30], [20, 25], [(255, 0, 0),
                                                     (0, 0, 255)])
    fig.discs([15.0], [15.0], 2.0, (0, 255, 0))
    fig.segments([0.0], [29.5], [39.0], [29.5], (9, 9, 9), 1.0)
    fig.text(30, 0, "A", 1, (1, 2, 3))
    image = fig.render()
    assert image.shape == (30, 40, 3) and image.dtype == np.uint8
    assert tuple(image[5, 5]) == (255, 0, 0)
    assert tuple(image[12, 12]) == (0, 0, 255)  # drawn later, on top
    assert tuple(image[15, 15]) == (0, 255, 0)  # the disc, last of three
    assert tuple(image[29, 20]) == (9, 9, 9)
    assert tuple(image[25, 35]) == (255, 255, 255)
    a_bits = plot.text_mask("A")
    assert (image[0:7, 30:35].sum(axis=2) == 6).sum() == a_bits.sum()
    again = plot.Figure(40, 30, device="cpu")
    assert again.render().min() == 255


def test_font_covers_printable_ascii():
    masks = [plot.text_mask(chr(c)) for c in range(33, 127)]
    assert all(m.shape == (7, 5) and m.any() for m in masks)
    assert len({m.tobytes() for m in masks}) == len(masks)
    assert np.array_equal(plot.text_mask("é"), plot.text_mask("?"))


def test_figure_on_the_default_device_needs_cuda():
    """No quiet fallback: without CUDA a figure on the default device
    raises instead of drawing on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plot.Figure(10, 10)
