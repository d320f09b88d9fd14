"""The files between stages are the contract: `tracks.csv`,
`reconstruction.json` and `camera_models.json` written by the port are
byte-identical to the reference's, and the default config is the same."""

import os

import numpy as np

import synthetic_bundle as sb
from opensfm_tpu import config as ref_config
from opensfm_tpu import io as ref_io
from opensfm_tpu import pymap as ref_pymap
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import config as port_config
from opensfm_tpu_torch import io as port_io
from opensfm_tpu_torch import pymap as port_pymap
from opensfm_tpu_torch.dataset import DataSet


def _tracks(pymap, seed=0):
    rng = np.random.default_rng(seed)
    tm = pymap.TracksManager()
    values = np.concatenate([
        rng.normal(0, 0.3, 200), [0.0, -0.0, 1e-7, 123456.789, 1.5e-5,
                                  -2.5e10, 0.1 + 0.2]])
    for k in range(len(values) // 2):
        obs = pymap.Observation(
            values[2 * k], values[2 * k + 1], abs(values[k]) + 1e-3,
            int(rng.integers(0, 256)), int(rng.integers(0, 256)),
            int(rng.integers(0, 256)), k,
            int(rng.integers(-1, 5)), int(rng.integers(-1, 5)),
        )
        tm.add_observation(f"im{k % 7}.jpg", str(k % 23 + 100 * (k % 3)), obs)
    return tm


def test_tracks_csv_bytes_match(tmp_path):
    ref_file = tmp_path / "ref.csv"
    port_file = tmp_path / "port.csv"
    _tracks(ref_pymap).write_to_file(str(ref_file))
    _tracks(port_pymap).write_to_file(str(port_file))
    assert port_file.read_bytes() == ref_file.read_bytes()
    # Read the reference's file, write it again: the same bytes.
    again = tmp_path / "again.csv"
    port_pymap.TracksManager.instanciate_from_file(str(ref_file)) \
        .write_to_file(str(again))
    assert again.read_bytes() == ref_file.read_bytes()


def test_reconstruction_json_bytes_match(tmp_path):
    path = str(tmp_path / "data")
    problem = sb.make_problem(6, 40, seed=2, track_window=3)
    sb.write_dataset(path, problem, {"bundle_use_gps": True})
    written = {}
    for name in ("reconstruction.json", "camera_models.json", "tracks.csv"):
        with open(os.path.join(path, name), "rb") as f:
            written[name] = f.read()

    # The reference reads what the port wrote and writes the same bytes.
    ref_data = RefDataSet(path)
    recs = ref_data.load_reconstruction()
    ref_data.save_reconstruction(recs, "ref_reconstruction.json")
    ref_data.save_camera_models(ref_data.load_camera_models())
    ref_data.save_tracks_manager(ref_data.load_tracks_manager(),
                                 "ref_tracks.csv")
    with open(os.path.join(path, "ref_reconstruction.json"), "rb") as f:
        assert f.read() == written["reconstruction.json"]
    with open(os.path.join(path, "camera_models.json"), "rb") as f:
        assert f.read() == written["camera_models.json"]
    with open(os.path.join(path, "ref_tracks.csv"), "rb") as f:
        assert f.read() == written["tracks.csv"]

    # And the port reads the reference's file back to the same bytes.
    data = DataSet(path)
    data.save_reconstruction(
        data.load_reconstruction("ref_reconstruction.json"),
        "port_reconstruction.json")
    with open(os.path.join(path, "port_reconstruction.json"), "rb") as f:
        assert f.read() == written["reconstruction.json"]

    # The JSON encoders agree on a reconstruction built in memory too.
    assert port_io.json_dumps(port_io.reconstructions_to_json(
        data.load_reconstruction())) == ref_io.json_dumps(
        ref_io.reconstructions_to_json(recs))


def test_default_config_matches_reference():
    port, ref = port_config.default_config(), ref_config.default_config()
    assert list(port) == list(ref)
    for key, value in ref.items():
        assert port[key] == value, key
