"""The `match_features` command end to end on the CPU: one synthetic dataset
(6 images x 600 features, `synthetic_bundle.write_matching_dataset`), two
copies, the JAX package's `actions.match_features.run_dataset` on one and
the port on the other.

- `python -m opensfm_tpu_torch match_features <copy> --device cpu` (the
  port's own random draws): the same pairs survive, and each pair's inlier
  count is within 5 % of the reference's.
- The port's command in this process with the JAX package's draws
  injected: the same robust matches, and the same descriptor matches.

Pairs are compared without regard to orientation: `ordered_pairs` orients
them by `set.pop()`, which depends on the process's string hashing.  One
case has the distorted camera (essential-matrix RANSAC), one the
undistorted camera (fundamental-matrix RANSAC)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_bundle as sb
from opensfm_tpu import matching as ref_matching
from opensfm_tpu.actions import match_features as ref_action
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu.robust import ransac as ref_ransac
from opensfm_tpu_torch import matching
from opensfm_tpu_torch.commands import command_runner, opensfm_commands
from opensfm_tpu_torch.dataset import DataSet
from opensfm_tpu_torch.robust import ransac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes at once, and multi-threaded small ops then
    wait on each other's cores (tens of times slower); one thread is within
    2x of eight when the module runs alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matches(data):
    """{(a, b) with a < b: sorted [K, 2] matches with a's feature first}."""
    out = {}
    for im1 in data.images():
        if not data.matches_exists(im1):
            continue
        for im2, m in data.load_matches(im1).items():
            m = np.asarray(m, dtype=np.int64).reshape(-1, 2)
            if im2 < im1:
                im1_, im2_, m = im2, im1, m[:, ::-1]
            else:
                im1_, im2_ = im1, im2
            out[im1_, im2_] = m[np.lexsort((m[:, 1], m[:, 0]))]
    return out


def _jax_draws(seed, chunk, counts, k, s):
    """The JAX package's draws in place of `ransac.draw_subsets`: for each
    problem of n rows (all valid, so ranks are rows), its padded size's
    sample indices from the reference's key for the chunk."""
    out = []
    for n in counts:
        n_pad = max(64, 1 << int(n - 1).bit_length())
        p = np.zeros(n_pad)
        p[:n] = 1.0 / n
        out.append(np.array(ref_ransac._sample_indices(
            jax.random.PRNGKey(seed + chunk * 7919), n_pad, k, s,
            jnp.asarray(p))))
    return np.stack(out)


@pytest.mark.parametrize("undistorted", [False, True],
                         ids=["essential", "fundamental"])
def test_match_features_matches_reference(tmp_path, monkeypatch,
                                          undistorted):
    src = str(tmp_path / "src")
    tracks = sb.write_matching_dataset(
        src, n_shots=6, n_points=600, track_window=3, features_per_image=600,
        seed=1, undistorted=undistorted)
    a, b, c = (str(tmp_path / name) for name in ("ref", "port", "inject"))
    for path in (a, b, c):
        shutil.copytree(src, path)

    ref_action.run_dataset(RefDataSet(a))
    proc = subprocess.run(
        [sys.executable, "-m", "opensfm_tpu_torch", "match_features", b,
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setattr(ransac, "draw_subsets", _jax_draws)
    command_runner(opensfm_commands,
                   argv=["match_features", c, "--device", "cpu"])

    want = _matches(RefDataSet(a))
    own = _matches(DataSet(b))
    injected = _matches(DataSet(c))
    survived = {k for k, m in want.items() if len(m)}
    assert len(survived) >= 9  # the pairs that share points
    assert set(want) == set(own) == set(injected)
    assert {k for k, m in own.items() if len(m)} == survived
    for key in survived:
        assert abs(len(own[key]) - len(want[key])) <= 0.05 * len(want[key])
        np.testing.assert_array_equal(injected[key], want[key])
    precision, recall, _ = sb.match_scores(DataSet(c), tracks)
    assert precision > 0.99 and recall > 0.9

    # The descriptor matches of every pair, before the robust filter.
    ref_data, data = RefDataSet(a), DataSet(c)
    ref_cams = ref_data.load_camera_models()
    cams = data.load_camera_models()
    images = data.images()
    for i, im1 in enumerate(images):
        for im2 in images[i + 1:]:
            want_m = ref_matching.match_descriptors(
                im1, im2, ref_cams["synthetic_camera"],
                ref_cams["synthetic_camera"], ref_data, {})
            got_m = matching.match_descriptors(
                im1, im2, cams["synthetic_camera"],
                cams["synthetic_camera"], data, {}, device="cpu")
            np.testing.assert_array_equal(got_m, want_m)
    ref_matching.clear_cache()
    matching.clear_cache()

    report = json.loads(DataSet(b).load_report("matches.json"))
    want_report = json.loads(RefDataSet(a).load_report("matches.json"))
    assert report["num_pairs"] == want_report["num_pairs"] == 15
    assert {k for k in report} == {k for k in want_report}
