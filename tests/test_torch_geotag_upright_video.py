"""The port's `geotag_from_gpx`, `upright` and `video` against the JAX
package's on the CPU.

- GPX: a GPX 1.1 file written here, two segments with a trackpoint gap
  and elevations (one point without): the parsed samples, `compute_bearing`,
  `interpolate_lat_lon` (inside, in the gap, at both ends, out of range
  within and beyond `max_dt`), `gpx_lerp`, `sample_gpx` with and without
  `dt`, and `add_gps_to_exif_overrides` on a dataset, equal within
  GPX_TOL and the JSON equal.  The JAX package turns UTC into local time
  with two clock readings (`utcnow() - now()`), microseconds apart; the
  port reads one.  The UTC parse is held within a millisecond, and the
  overrides case gives the JAX package the port's `utc_to_localtime`.
- Upright: `opensfm_to_upright` for orientations 1, 3, 6 and 8, with and
  without new sizes, and the doctest's values.
- Video: a 10-frame MJPG AVI written by `cv2.VideoWriter`; the same frame
  files from both packages, with the JAX package's bytes (the port writes
  them through its own JPEG codec, which writes cv2.imwrite's bytes:
  tests/test_torch_jpeg.py).  Skipped only where cv2 cannot open the
  writer.
"""

import datetime
import json
import os
import shutil

import numpy as np
import pytest
import torch

from opensfm_tpu import geotag_from_gpx as ref_gpx
from opensfm_tpu import upright as ref_upright
from opensfm_tpu import video as ref_video
from opensfm_tpu.dataset import DataSet as RefDataSet
from opensfm_tpu_torch import geotag_from_gpx, io, upright, video
from opensfm_tpu_torch.dataset import DataSet

# Interpolated positions, bearings and elevations (measured: equal bits,
# the same float expressions).
GPX_TOL = 1e-12
T0 = datetime.datetime(2024, 5, 1, 12, 0, 0)
# (seconds after T0, lat, lon, elevation or None): a gap from 3 s to 10 s.
TRACK = [(0, 47.00000, 6.00000, 410.0), (1, 47.00004, 6.00003, 410.5),
         (2, 47.00009, 6.00005, 411.5), (3, 47.00013, 6.00009, None),
         (10, 47.00041, 6.00030, 415.0), (11, 47.00045, 6.00031, 415.25),
         (12, 47.00050, 6.00036, 414.0)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_gpx(path, track=TRACK, split=4):
    segments = [track[:split], track[split:]]
    body = []
    for seg in segments:
        pts = []
        for s, lat, lon, ele in seg:
            when = (T0 + datetime.timedelta(seconds=s)).strftime(
                "%Y-%m-%dT%H:%M:%SZ")
            ele_tag = f"<ele>{ele}</ele>" if ele is not None else ""
            pts.append(f'<trkpt lat="{lat}" lon="{lon}">{ele_tag}'
                       f"<time>{when}</time></trkpt>")
        body.append("<trkseg>" + "".join(pts) + "</trkseg>")
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n'
                '<gpx version="1.1" creator="test" '
                'xmlns="http://www.topografix.com/GPX/1/1"><trk>'
                + "".join(body) + "</trk></gpx>\n")


def assert_tuple_close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, datetime.datetime):
            assert x == y
        else:
            assert abs(x - y) <= GPX_TOL * max(abs(x), abs(y), 1.0)


@pytest.fixture(scope="module")
def gpx_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gpx") / "track.gpx")
    write_gpx(path)
    return path


def test_gpx_parse(gpx_file):
    ours = geotag_from_gpx.get_lat_lon_time(gpx_file, "local")
    theirs = ref_gpx.get_lat_lon_time(gpx_file, "local")
    assert ours == theirs and len(ours) == len(TRACK)
    assert ours[3][3] == 0.0 and ours[0][0] == T0
    utc_ours = geotag_from_gpx.get_lat_lon_time(gpx_file)
    utc_theirs = ref_gpx.get_lat_lon_time(gpx_file)
    for a, b in zip(utc_ours, utc_theirs):
        assert abs((a[0] - b[0]).total_seconds()) < 1e-3
        assert a[1:] == b[1:]


@pytest.mark.parametrize("seconds", [0.0, 0.25, 1.5, 2.999, 3.0, 6.5, 11.75,
                                     12.0, -0.5, 12.9, -1.5, 13.5])
def test_interpolate_lat_lon(gpx_file, seconds):
    points = geotag_from_gpx.get_lat_lon_time(gpx_file, "local")
    t = T0 + datetime.timedelta(seconds=seconds)
    if seconds < -1.0 or seconds > 13.0:
        for module in (geotag_from_gpx, ref_gpx):
            with pytest.raises(ValueError, match="out of track range"):
                module.interpolate_lat_lon(points, t)
        return
    got = geotag_from_gpx.interpolate_lat_lon(points, t)
    assert_tuple_close(got, ref_gpx.interpolate_lat_lon(points, t))
    assert len(got) == 4


def test_bearing_lerp_and_sampling(gpx_file):
    points = geotag_from_gpx.get_lat_lon_time(gpx_file, "local")
    for a, b in zip(points[:-1], points[1:]):
        assert_tuple_close(
            [geotag_from_gpx.compute_bearing(a[1], a[2], b[1], b[2])],
            [ref_gpx.compute_bearing(a[1], a[2], b[1], b[2])])
    assert geotag_from_gpx.compute_bearing(0, 179.9, 0, -179.9) == \
        ref_gpx.compute_bearing(0, 179.9, 0, -179.9)
    for alpha in (0.0, 0.3, 1.0):
        assert_tuple_close(geotag_from_gpx.gpx_lerp(alpha, points[1],
                                                    points[4]),
                           ref_gpx.gpx_lerp(alpha, points[1], points[4]))
    for dx, dt in ((5.0, None), (12.0, None), (12.0, 2.0), (1e6, 1.0)):
        assert geotag_from_gpx.sample_gpx(points, dx, dt) == \
            ref_gpx.sample_gpx(points, dx, dt)
    assert len(geotag_from_gpx.sample_gpx(points, 12.0)) < len(points)
    assert geotag_from_gpx.sample_gpx([], 1.0) == []


def test_add_gps_to_exif_overrides(gpx_file, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_gpx, "utc_to_localtime",
                        geotag_from_gpx.utc_to_localtime)
    base = float((T0 - datetime.datetime(1970, 1, 1)).total_seconds())
    root = tmp_path / "ours"
    os.makedirs(root / "exif")
    images = {"a.jpg": base + 0.5, "b.jpg": base + 7.25, "c.jpg": base + 40,
              "d.jpg": None}
    (root / "image_list.txt").write_text(
        "".join(f"images/{name}\n" for name in images))
    (root / "config.yaml").write_text("{}\n")
    for name, when in images.items():
        exif = {"width": 640, "height": 480}
        if when is not None:
            exif["capture_time"] = when
        (root / "exif" / f"{name}.exif").write_text(json.dumps(exif))
    shutil.copytree(root, tmp_path / "theirs")
    got = geotag_from_gpx.add_gps_to_exif_overrides(DataSet(str(root)),
                                                    gpx_file, 0.25)
    want = ref_gpx.add_gps_to_exif_overrides(
        RefDataSet(str(tmp_path / "theirs")), gpx_file, 0.25)
    assert sorted(got) == ["a.jpg", "b.jpg"]
    assert got == want
    assert (root / "exif_overrides.json").read_text() == \
        (tmp_path / "theirs" / "exif_overrides.json").read_text()


def test_utc_from_timestamp():
    for ts in (0.0, 1714564800.25, 1e9 + 0.5, 1714564800.0000004):
        assert geotag_from_gpx.utc_from_timestamp(ts) == \
            datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=ts)


# -- upright -----------------------------------------------------------------


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
@pytest.mark.parametrize("new_size", [None, (100, 75)])
def test_opensfm_to_upright(orientation, new_size):
    coords = np.random.RandomState(orientation).uniform(-0.5, 0.5, (9, 2))
    kw = {} if new_size is None else {"new_width": new_size[0],
                                      "new_height": new_size[1]}
    got = upright.opensfm_to_upright(coords, 320, 240, orientation, **kw)
    want = ref_upright.opensfm_to_upright(coords, 320, 240, orientation,
                                          **kw)
    assert np.array_equal(got, want)


def test_opensfm_to_upright_doctest():
    sfm = np.array([[-0.5, -0.375], [-0.5, 0.375], [0.5, -0.375],
                    [0.5, 0.375]])
    assert upright.opensfm_to_upright(sfm, 320, 240, 1).tolist() == [
        [0.0, 0.0], [0.0, 240.0], [320.0, 0.0], [320.0, 240.0]]
    # Orientation 6 turns the 320 x 240 image upright as 240 x 320.
    assert upright.opensfm_to_upright(sfm, 320, 240, 6).tolist() == [
        [240.0, 0.0], [0.0, 0.0], [240.0, 320.0], [0.0, 320.0]]


# -- video -------------------------------------------------------------------


def test_import_video_with_gpx(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 1.0,
                             (160, 120))
    if not writer.isOpened():
        pytest.skip("cv2 cannot open an MJPG writer here")
    rng = np.random.RandomState(0)
    for k in range(10):
        frame = rng.randint(0, 256, (120, 160, 3), dtype=np.uint8)
        frame[:, : 16 * (k + 1)] //= 2
        writer.write(frame)
    writer.release()
    track = [(s, 47.0 + 4e-5 * s, 6.0 + 3e-5 * s, 400.0 + s)
             for s in range(12)]
    gpx = str(tmp_path / "clip.gpx")
    write_gpx(gpx, track, split=6)
    start = (T0 + datetime.timedelta(seconds=1)).strftime("%Y-%m-%dT%H:%M:%S")
    ours = video.import_video_with_gpx(path, gpx, str(tmp_path / "ours"),
                                       4.0, start_time=start)
    theirs = ref_video.import_video_with_gpx(path, gpx,
                                             str(tmp_path / "theirs"), 4.0,
                                             start_time=start)
    names = [os.path.basename(p) for p in ours]
    assert names == [os.path.basename(p) for p in theirs]
    assert len(names) >= 5
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        assert io.imread(a).shape == (120, 160, 3)
    assert video.video_orientation(path) == ref_video.video_orientation(path)


def test_video_without_cv2_raises_naming_it(monkeypatch, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="cv2"):
        video.import_video_with_gpx("clip.avi", "clip.gpx", str(tmp_path),
                                    1.0)
    assert video.video_orientation("clip.avi") == 1
