"""Raw depthmaps as the `compute_depthmaps` stage makes them.

Set-up renders the configuration's orbit of views on the device from the
seed, writes them as the undistorted images of a dataset (PNG, so that the
reference reads the very pixels the program decodes), builds the
undistorted reconstruction and its tracks in memory, and finds each
shot's neighbours with the program's own functions, as the stage does.
The window then runs the stage's raw loop: `dense.compute_depthmap` shot
after shot in the stage's order, one grey cache a pass over the shots.
Each step is one depthmap, saved by the program as the stage saves it.

The check samples saved depthmaps from the seed and holds each against the
reference's (`reference.patchmatch`): the neighbour list exactly, and the
share of pixels whose depth, plane, score or best neighbour differ.
`control` judges the reference with bfloat16 values by that comparison.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np
import torch

from sfm_bench import pngio
from sfm_bench import scene as scene_lib
from sfm_bench.reference import patchmatch as ref


def _ids(nbrs: List[str], index: np.ndarray) -> np.ndarray:
    """Names of the neighbours `index` points at ("" outside the list)."""
    names = np.asarray(nbrs[1:] + [""])
    index = np.asarray(index)
    ok = (index >= 0) & (index < len(nbrs) - 1)
    return names[np.where(ok, index, len(nbrs) - 1)]


def view_name(i: int) -> str:
    return f"v{i:03d}.png"


class Cell:
    span = "depthmap"

    def __init__(self, spec: Dict[str, Any], seed: int, device):
        self.spec = spec
        self.sizes = spec["config"]["sizes"]
        self.settings = spec["config"]["settings"]
        self.params = spec["params"]
        self.limits = spec["limits"]
        self.seed = seed
        self.device = torch.device(device)
        self.facts: Dict[str, Any] = {}

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from opensfm_tpu_torch import dense, pymap, types
        from opensfm_tpu_torch.dataset import DataSet
        from opensfm_tpu_torch.geometry.cameras import Camera
        from opensfm_tpu_torch.geometry.pose import Pose

        self.work = tempfile.mkdtemp(prefix="sfm_bench_depthmaps_")
        with open(os.path.join(self.work, "config.yaml"), "w") as f:
            json.dump(self.settings, f)  # JSON is YAML
        sc = scene_lib.orbit_scene(self.sizes, self.seed, self.device)
        self.scene = sc
        n = len(sc["poses"])
        self.names = [view_name(i) for i in range(n)]
        images = os.path.join(self.work, "undistorted", "images")
        os.makedirs(images)
        self.rgb: Dict[int, np.ndarray] = {}
        with ThreadPoolExecutor(self.params["writers"]) as pool:
            futures = []
            for i in range(n):
                rgb = scene_lib.render_view(
                    sc["R"][i], sc["centres"][i], sc["width"], sc["height"],
                    sc["focal"], sc["walls"], sc["grids"],
                    self.params["supersample"]).cpu().numpy()
                self.rgb[i] = rgb
                futures.append(pool.submit(
                    pngio.write_png, os.path.join(images, self.names[i]),
                    rgb))
            self.image_bytes = sum(f.result() for f in futures)

        cam = Camera.create_perspective(sc["focal"], 0.0, 0.0)
        cam.id = "orbit_camera"
        cam.width, cam.height = sc["width"], sc["height"]
        rec = types.Reconstruction()
        rec.add_camera(cam)
        for i, (r, t) in enumerate(sc["poses"]):
            rec.create_shot(self.names[i], cam.id, Pose(r, t))
        for j, X in enumerate(sc["points"]):
            rec.create_point(str(j), X)
        tracks = pymap.TracksManager()
        feature = np.zeros(n, dtype=np.int64)
        for j, v, (x, y) in zip(sc["obs_point"].tolist(),
                                sc["obs_view"].tolist(), sc["obs_xy"]):
            tracks.add_observation(self.names[v], str(j), pymap.Observation(
                float(x), float(y), 0.004, 128, 128, 128, int(feature[v])))
            feature[v] += 1
        self.rec = rec
        self.udata = DataSet(self.work).undistorted_dataset()
        k = int(self.settings["depthmap_num_neighbors"])
        common = dense.common_tracks_double_dict(tracks)
        self.neighbours = {
            s.id: dense.find_neighboring_images(s, common, rec, k)
            for s in rec.shots.values()}
        self.todo = [s for s in rec.shots if len(self.neighbours[s]) > 1]
        self.facts = dict(shots=len(self.todo),
                          neighbours=float(np.mean([
                              len(self.neighbours[s]) - 1
                              for s in self.todo])),
                          image_bytes=self.image_bytes)
        self._compute = dense.compute_depthmap
        # Warm-up: one depthmap with a cache of its own.
        self._compute(self.udata, rec, self.neighbours[self.todo[0]],
                      self.todo[0], self.device, {})
        self.grays: Dict[str, Any] = {}

    # -- the window ------------------------------------------------------------
    def step(self, k: int) -> Dict[str, Any]:
        i = k % len(self.todo)
        if i == 0:
            self.grays = {}  # a new pass over the shots
        shot = self.todo[i]
        t0 = time.perf_counter()
        self._compute(self.udata, self.rec, self.neighbours[shot], shot,
                      self.device, self.grays)
        return {"kind": "depthmap", "shot": shot,
                "seconds": time.perf_counter() - t0}

    def end_to_end(self, items: List[Dict], window_s: float) -> Dict:
        return {"depthmaps_per_s": len(items) / window_s}

    def notes(self, items, window_s) -> List[str]:
        return [f"depthmaps {len(items)} in {window_s:.3f} s; "
                f"{self.facts['shots']} shots, "
                f"{self.facts['neighbours']:.2f} neighbours a shot, "
                f"images {self.image_bytes / 2**20:.1f} MiB, "
                f"{len(self.grays)} decoded in the window; seconds "
                f"{[round(it['seconds'], 3) for it in items]}"]

    def release(self) -> None:
        self.grays = {}
        self.rec = self.udata = None

    # -- the check -------------------------------------------------------------
    def check(self, items: List[Dict]) -> List[Dict]:
        """Sampled saved depthmaps against the reference's."""
        try:
            return self._check(items)
        finally:
            shutil.rmtree(self.work, ignore_errors=True)

    def _check(self, items: List[Dict]) -> List[Dict]:
        sc, k = self.scene, int(self.settings["depthmap_num_neighbors"])
        done = sorted({it["shot"] for it in items})
        lists_differ, worst = 0, 0.0
        dmaps = os.path.join(self.work, "undistorted", "depthmaps")
        for shot in _sample(done, self.seed, self.params["reference_shots"]):
            path = os.path.join(dmaps, shot + ".raw.npz")
            if not os.path.exists(path):  # never saved: every pixel differs
                worst = 1.0
                continue
            o = np.load(path)
            v = self.names.index(shot)
            nbrs = _reference_neighbours(sc, self.names, v, k)
            got = [str(x) for x in o["nghbrs"]]
            if got != [self.names[x] for x in nbrs]:
                lists_differ += 1
                continue
            want = _reference_map(sc, self.rgb, v, nbrs, self.settings,
                                  torch.float32, self.device)
            worst = max(worst, _share(
                (o["depth"], o["plane"], o["score"], o["nghbr"]), want, got,
                self.limits["pixel_rtol"]))
        return [
            {"name": "neighbour_lists_differ", "value": lists_differ,
             "limit": 0},
            {"name": "pixels_disagree", "value": worst if not lists_differ
             else 1.0, "limit": self.limits["pixels_disagree"]}]


def _sample(shots: List[str], seed: int, n: int) -> List[str]:
    """The shots a check compares: `n` of `shots`, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    n = min(int(n), len(shots))
    return [shots[i] for i in rng.choice(len(shots), n, replace=False)]


def _reference_neighbours(sc, names: List[str], v: int, k: int) -> List[int]:
    return ref.neighbours(v, names, sc["centres"], sc["points"],
                          sc["obs_point"], sc["obs_view"], k)


def _reference_map(sc, rgb, v: int, nbrs: List[int], settings, dtype,
                   device):
    return ref.depthmap(rgb, v, nbrs, sc["focal"], sc["R"], sc["t"],
                        sc["centres"], sc["points"], settings, dtype, device)


def _share(got, want, nbr_names: List[str], rtol: float) -> float:
    """Share of the pixels at which two raw depthmaps (depth, plane, score,
    best neighbour's index into `nbr_names[1:]`) disagree."""
    return ref.disagreement(
        (got[0], got[1], got[2], _ids(nbr_names, got[3])),
        (want[0], want[1], want[2], _ids(nbr_names, want[3])), rtol)


def control(spec: Dict[str, Any], seed: int, device) -> List[Dict]:
    """The cell's control: the reference with bfloat16 values put in the
    program's place on the shots a run's check would draw, judged by the
    check's own comparison against the float32 reference."""
    sizes, settings = spec["config"]["sizes"], spec["config"]["settings"]
    sc = scene_lib.orbit_scene(sizes, seed, device)
    names = [view_name(i) for i in range(len(sc["poses"]))]
    k = int(settings["depthmap_num_neighbors"])
    worst = 0.0
    for shot in _sample(names, seed, spec["params"]["reference_shots"]):
        v = names.index(shot)
        nbrs = _reference_neighbours(sc, names, v, k)
        rgb = {i: scene_lib.render_view(
            sc["R"][i], sc["centres"][i], sc["width"], sc["height"],
            sc["focal"], sc["walls"], sc["grids"],
            spec["params"]["supersample"]).cpu().numpy() for i in nbrs}
        got, want = (_reference_map(sc, rgb, v, nbrs, settings, dt, device)
                     for dt in (torch.bfloat16, torch.float32))
        worst = max(worst, _share(got, want, [names[x] for x in nbrs],
                                  spec["limits"]["pixel_rtol"]))
    return [{"name": "pixels_disagree", "value": worst,
             "limit": spec["limits"]["pixels_disagree"]}]
