"""The port's `synthetic_data` against the JAX package's on the CPU.

The circle, cube and rig scenes are built by both packages from one seed:
the JAX package under `np.random.seed(s)`, as its own tests build them, the
port with `rng=np.random.RandomState(s)`.  The draws are the same calls in
the same order, so the scenes must be the same:

- shot ids, camera parameters, point ids, the tracks manager's
  observations and the features' descriptors equal;
- shot poses, point coordinates, EXIF GPS / OPK and the GCPs within
  REL_TOL relative (measured: equal bits);
- `synthetic_metrics` / `synthetic_scene.compare` give the same
  alignment and errors on one pair of reconstructions (COMPARE_TOL);
- `SyntheticDataSet`'s read API gives the same answers.

Parameters: tests/test_stats.py:19-26 and
tests/test_reconstruction_incremental.py:33-38 (circle, with GCPs),
:106-111 (rig), tests/test_reconstruction_resect.py:44-53 (cube).
"""

import functools

import numpy as np
import pytest
import torch

from opensfm_tpu import geo as ref_geo
from opensfm_tpu.synthetic_data import synthetic_dataset as ref_sd
from opensfm_tpu.synthetic_data import synthetic_examples as ref_ex
from opensfm_tpu.synthetic_data import synthetic_metrics as ref_sm
from opensfm_tpu.synthetic_data import synthetic_scene as ref_ss
from opensfm_tpu_torch import geo
from opensfm_tpu_torch.synthetic_data import synthetic_dataset as sd
from opensfm_tpu_torch.synthetic_data import synthetic_examples as ex
from opensfm_tpu_torch.synthetic_data import synthetic_metrics as sm
from opensfm_tpu_torch.synthetic_data import synthetic_scene as ss

# Floats of the two packages' scenes, relative (measured: 0, the same
# NumPy calls on the same draws).
REL_TOL = 1e-12
# compare(): the port's Umeyama runs in torch f64, the JAX package's in
# jnp f64; the GCP triangulation in torch against jnp.  Measured at most
# 4.3e-11 relative, key by key, over both seeds.
COMPARE_TOL = 1e-10

SEEDS = (42, 7)
KINDS = ("circle", "cube", "rig")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(package, kind, seed):
    """(truth reconstruction, SyntheticInputData) of one package."""
    jax = package == "jax"
    if jax:
        np.random.seed(seed)
        rng = None
        reference = ref_geo.TopocentricConverter(47.0, 6.0, 0)
        examples, scene_mod = ref_ex, ref_ss
    else:
        rng = np.random.RandomState(seed)
        reference = geo.TopocentricConverter(47.0, 6.0, 0)
        examples, scene_mod = ex, ss
    kw = {} if jax else {"rng": rng}
    if kind == "circle":
        scene = examples.synthetic_circle_scene(reference, **kw)
        args = (40, 1.0, 5.0, 0.1, (0.01, 0.1), False, 10,
                [10.0, 0.0, 100.0])
    elif kind == "rig":
        scene = examples.synthetic_rig_scene(reference, **kw)
        args = (40, 1.0, 0.1, 0.1, (0.0, 0.0), False)
    else:
        scene = examples.synthetic_cube_scene(**kw)
        args = (40, 0.0, 0.0, 0.0, (0.0, 0.0), False)
    truth = scene.get_reconstruction()
    data = scene_mod.SyntheticInputData(truth, reference, *args, **kw)
    return scene, data


@functools.lru_cache(maxsize=None)
def scenes(kind, seed):
    """The JAX package's and the port's inputs for one scene and seed."""
    return _inputs("jax", kind, seed), _inputs("port", kind, seed)


def assert_close(a, b, rel=REL_TOL, what=""):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    scale = max(float(np.max(np.abs(a), initial=0.0)), 1e-300)
    assert float(np.max(np.abs(a - b), initial=0.0)) <= rel * scale, what


def assert_same_reconstruction(ra, rb, rel=REL_TOL):
    assert list(ra.shots) == list(rb.shots)
    assert list(ra.points) == list(rb.points)
    assert sorted(ra.cameras) == sorted(rb.cameras)
    for cid in ra.cameras:
        assert (ra.cameras[cid].get_parameters_map()
                == rb.cameras[cid].get_parameters_map())
        assert ra.cameras[cid].projection_type == \
            rb.cameras[cid].projection_type
    for sid in ra.shots:
        assert_close(ra.shots[sid].pose.rotation, rb.shots[sid].pose.rotation,
                     rel, sid)
        assert_close(ra.shots[sid].pose.translation,
                     rb.shots[sid].pose.translation, rel, sid)
    assert_close([p.coordinates for p in ra.points.values()],
                 [p.coordinates for p in rb.points.values()], rel)
    assert np.array_equal([p.color for p in ra.points.values()],
                          [p.color for p in rb.points.values()])
    assert sorted(ra.rig_instances) == sorted(rb.rig_instances)
    assert sorted(ra.rig_cameras) == sorted(rb.rig_cameras)
    for rid in ra.rig_cameras:
        assert_close(ra.rig_cameras[rid].pose.translation,
                     rb.rig_cameras[rid].pose.translation, rel)


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_scene_equal_under_equal_seeds(kind, seed):
    (ref_scene, ref_in), (scene, inp) = scenes(kind, seed)
    assert_same_reconstruction(ref_scene.get_reconstruction(),
                               scene.get_reconstruction())
    assert_same_reconstruction(ref_in.reconstruction, inp.reconstruction)

    # EXIF: the same keys, strings and ints equal, floats within REL_TOL.
    assert list(ref_in.exifs) == list(inp.exifs)
    for image in ref_in.exifs:
        a, b = dict(_flat(ref_in.exifs[image])), dict(_flat(inp.exifs[image]))
        assert list(a) == list(b)
        for key in a:
            if isinstance(a[key], (float, np.floating)):
                assert_close(a[key], b[key], what=f"{image} {key}")
            else:
                assert a[key] == b[key], (image, key)

    # Tracks: every observation equal.
    ta, tb = ref_in.tracks_manager, inp.tracks_manager
    assert sorted(ta.get_shot_ids()) == sorted(tb.get_shot_ids())
    assert list(ta.get_track_ids()) == list(tb.get_track_ids())
    for track in ta.get_track_ids():
        oa, ob = ta.get_track_observations(track), \
            tb.get_track_observations(track)
        assert list(oa) == list(ob)
        for shot in oa:
            assert np.array_equal(oa[shot].point, ob[shot].point)
            assert oa[shot].scale == ob[shot].scale
            assert np.array_equal(oa[shot].color, ob[shot].color)
            assert oa[shot].id == ob[shot].id

    # Features: points and colours equal, descriptors equal.
    assert list(ref_in.features) == list(inp.features)
    for image, fa in ref_in.features.items():
        fb = inp.features[image]
        assert np.array_equal(fa.points, fb.points)
        assert np.array_equal(fa.descriptors, fb.descriptors)
        assert np.array_equal(fa.colors, fb.colors)

    # GCPs (the circle scene's 10).
    assert list(ref_in.gcps) == list(inp.gcps)
    assert len(inp.gcps) == (10 if kind == "circle" else 0)
    for gid, ga in ref_in.gcps.items():
        gb = inp.gcps[gid]
        assert_close(ga.lla_vec, gb.lla_vec, what=gid)
        assert ga.has_altitude == gb.has_altitude
        assert [o.shot_id for o in ga.observations] == \
            [o.shot_id for o in gb.observations]
        assert_close([o.projection for o in ga.observations],
                     [o.projection for o in gb.observations], what=gid)


def test_rng_none_draws_from_the_global_state():
    """`rng=None` draws from NumPy's global legacy state, as the JAX
    package does: seeding `np.random` gives the seed's scene."""
    np.random.seed(3)
    a = ex.synthetic_cube_scene().get_reconstruction()
    b = ex.synthetic_cube_scene(rng=np.random.RandomState(3)) \
        .get_reconstruction()
    assert_same_reconstruction(a, b, rel=0.0)


def _perturbed(reconstruction, rng, similarity):
    """A copy of `reconstruction` moved by a similarity, with noise on the
    points and shot centres, and without its first shot and every tenth
    point: a stand-in for a reconstruction to grade."""
    import copy

    s, A, b = similarity
    rec = copy.deepcopy(reconstruction)
    rec.remove_shot(sorted(rec.shots)[0])
    for pid in list(rec.points)[::10]:
        rec.remove_point(pid)
    for point in rec.points.values():
        point.coordinates = s * A @ (point.coordinates
                                     + rng.normal(0, 0.01, 3)) + b
    for instance in rec.rig_instances.values():
        origin = instance.pose.get_origin() + rng.normal(0, 0.02, 3)
        R = instance.pose.get_rotation_matrix() @ A.T
        instance.pose.set_rotation_matrix(R)
        instance.pose.set_origin(s * A @ origin + b)
    return rec


@pytest.mark.parametrize("seed", SEEDS)
def test_compare_same_alignment_and_errors(seed):
    """`compare` (completeness, absolute and aligned errors, GPS and GCP
    errors) and `find_alignment` give the same numbers in both packages
    on the same pair of reconstructions."""
    (_, ref_in), (_, inp) = scenes("circle", seed)
    angle = 0.3
    A = np.array([[np.cos(angle), -np.sin(angle), 0.0],
                  [np.sin(angle), np.cos(angle), 0.0], [0.0, 0.0, 1.0]])
    similarity = (1.2, A, np.array([3.0, -2.0, 0.5]))
    cand_ref = _perturbed(ref_in.reconstruction,
                          np.random.RandomState(seed + 1), similarity)
    cand = _perturbed(inp.reconstruction, np.random.RandomState(seed + 1),
                      similarity)
    assert_same_reconstruction(cand_ref, cand)

    want = ref_ss.compare(ref_in.reconstruction, ref_in.gcps, cand_ref)
    got = ss.compare(inp.reconstruction, inp.gcps, cand, device="cpu")
    assert list(want) == list(got)
    for key in want:
        assert_close(got[key], want[key], COMPARE_TOL, key)
    assert got["ratio_cameras"] == 19 / 20
    assert got["aligned_position_rmse"] < 0.05

    coords = [p.coordinates for p in cand.points.values()]
    truth = [inp.reconstruction.points[p].coordinates for p in cand.points]
    s, A_got, b = sm.find_alignment(coords, truth)
    s_ref, A_ref, b_ref = ref_sm.find_alignment(coords, truth)
    assert_close(s, s_ref, COMPARE_TOL)
    assert_close(A_got, A_ref, COMPARE_TOL)
    assert_close(b, b_ref, COMPARE_TOL)
    assert abs(s - 1 / 1.2) < 1e-3


@pytest.mark.parametrize("kind", ("circle", "rig"))
def test_synthetic_dataset_read_api(kind):
    """The in-memory dataset answers its read calls alike in both
    packages."""
    (ref_scene, ref_in), (scene, inp) = scenes(kind, 42)

    def build(module, s, i):
        return module.SyntheticDataSet(i.reconstruction, i.exifs, i.features,
                                       i.tracks_manager, i.gcps)

    a, b = build(ref_sd, ref_scene, ref_in), build(sd, scene, inp)
    assert a.images() == b.images()
    image = a.images()[3]
    assert a.load_exif(image) == b.load_exif(image)
    assert sorted(a.load_camera_models()) == sorted(b.load_camera_models())
    assert a.features_exist(image) and b.features_exist(image)
    assert np.array_equal(a.load_features(image).points,
                          b.load_features(image).points)
    assert a.load_tracks_manager().num_tracks() == \
        b.load_tracks_manager().num_tracks()
    assert a.load_reconstruction() == b.load_reconstruction() == []
    assert a.load_reference().lat == b.load_reference().lat == 47.0
    assert sorted(a.load_rig_cameras()) == sorted(b.load_rig_cameras())
    assert a.load_rig_assignments() == b.load_rig_assignments()
    assert [g.id for g in a.load_ground_control_points()] == \
        [g.id for g in b.load_ground_control_points()]
    assert a.config == b.config
    b.save_reconstruction([inp.reconstruction])
    assert b.load_reconstruction()[0] is inp.reconstruction
    with pytest.raises(IOError):
        b.load_image(image)
