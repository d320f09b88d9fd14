"""How far the card's PatchMatch agrees with the CPU's, by shot and seed.

Reads a dataset on which `run_all` has run (for example
`image_chain_study.py`'s output at the default 16 views of 2,048 x 1,536,
the scene of `chip_smoke.py`'s phase 15), finds each undistorted shot's
neighbours as `compute_depthmaps` does, and runs
`chip_smoke.pm_card_vs_cpu` (one shot's `patch_match_depthmap` on the card
and on the CPU with the same draws, at depthmap width `--width`) for every
shot with a neighbour over `--shot-seeds` seeds, and for phase 15's shot
(the one with the most neighbours) over `--seeds` seeds.  Seeds count up
from 42, the main path's.  Prints one JSON line per run, then one with the
spread of the agreement share (the share of the pixels confident on both
whose depths agree within 1 %): over all runs, by shot, and of phase 15's
mean over four seeds.

    python3 image_chain_study.py --package port --device cuda \\
        --out build/pm_study/chain
    python3 patchmatch_agreement_study.py --dataset build/pm_study/chain
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _spread(xs) -> dict:
    xs = np.asarray(xs, dtype=np.float64)
    return dict(n=int(len(xs)), mean=float(xs.mean()),
                sd=float(xs.std(ddof=1)) if len(xs) > 1 else 0.0,
                min=float(xs.min()), max=float(xs.max()))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--seeds", type=int, default=16,
                   help="seeds of phase 15's shot")
    p.add_argument("--shot-seeds", type=int, default=3,
                   help="seeds of every other shot")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke
    from opensfm_tpu_torch import dense
    from opensfm_tpu_torch.dataset import DataSet, UndistortedDataSet

    data = DataSet(args.dataset)
    udata = UndistortedDataSet(data, os.path.join(args.dataset,
                                                  "undistorted"))
    (rec,) = udata.load_undistorted_reconstruction()
    common = dense.common_tracks_double_dict(
        udata.load_undistorted_tracks_manager())
    num = udata.config["depthmap_num_neighbors"]
    neighbours = {s.id: dense.find_neighboring_images(s, common, rec,
                                                      num)[1:]
                  for s in rec.shots.values()}
    shots = sorted(s for s, n in neighbours.items() if n)
    smoke_shot = max(shots, key=lambda s: len(neighbours[s]))

    runs = []
    for sid in shots:
        a, o = chip_smoke._pm_inputs(udata, rec, sid, neighbours[sid],
                                     args.width, args.device)
        n_seeds = args.seeds if sid == smoke_shot else args.shot_seeds
        for seed in range(42, 42 + n_seeds):
            r = chip_smoke.pm_card_vs_cpu(a, o, seed, args.device)
            r.update(shot=sid, neighbours=len(neighbours[sid]))
            runs.append(r)
            print(json.dumps(r), flush=True)

    share = lambda rs: [r["agree_share"] for r in rs]  # noqa: E731
    by_shot = {sid: _spread(share(r for r in runs if r["shot"] == sid))
               for sid in shots}
    smoke = share(r for r in runs if r["shot"] == smoke_shot)
    fours = [float(np.mean(smoke[i:i + 4]))
             for i in range(0, len(smoke) - 3, 4)]
    out = dict(width=args.width, smoke_shot=smoke_shot,
               all_runs=_spread(share(runs)),
               first_seed=_spread(share(r for r in runs if r["seed"] == 42)),
               by_shot=by_shot, smoke_shot_runs=_spread(smoke),
               smoke_shot_means_of_4=fours)
    print(json.dumps({"patchmatch_agreement": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
