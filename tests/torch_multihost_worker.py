"""Worker of tests/test_torch_multihost_ba.py: one rank of a two-process
gloo group, each rank holding 4 shards on its CPU, so the port's sharded
CG step sums across the process boundary.  Imports no JAX.

Usage: python torch_multihost_worker.py <port> <rank> <world_size>
Prints the replicated outputs' checksums (CHECKSUM lines) and the plain
reprojection cost after each of three fixed-lambda steps (COST lines).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import synthetic_bundle as sb  # noqa: E402
from opensfm_tpu_torch.geometry import cameras as cam_lib  # noqa: E402
from opensfm_tpu_torch.geometry import rotation as rot  # noqa: E402
from opensfm_tpu_torch.parallel import distributed_ba as dba  # noqa: E402
from opensfm_tpu_torch.parallel.mesh import Mesh  # noqa: E402

LOCAL_SHARDS = 4
CG_ITERS = 200


def prepare(n_shards):
    """The problem (8 shots x 16 points a shard), its layout and the CG
    step's arguments in its signature's order."""
    problem = dba.shard_problem(sb.make_problem(8, 16 * n_shards, seed=0),
                                n_shards)
    a = dba._cg_args(problem, n_shards, np.float64)
    a["lam"] = torch.tensor(1e-4, dtype=torch.float64)
    win = problem.cg_window
    names = dba._cg_step_names("none", False, False, False, win=win > 0)
    return problem, a, names, win


def reprojection_cost(problem, inst, cam, points):
    """Plain whitened reprojection SSE over the valid observations."""
    w = problem.obs_inv_sd > 0
    ii, pi = problem.obs_inst[w], problem.obs_point[w]
    X = torch.as_tensor(points[pi])
    Xc = rot.rotate(torch.as_tensor(inst[ii, :3]), X).numpy() + inst[ii, 3:]
    pred = cam_lib.project("perspective", Xc, cam[0], xp=np)
    r = (pred - problem.obs_uv[w]) * problem.obs_inv_sd[w][:, None]
    return float((r * r).sum())


def run(mesh, steps=3, report=None):
    """Three fixed-lambda CG steps over `mesh`; returns (inst, cam)."""
    problem, a, names, win = prepare(mesh.n_shards)
    ni, nr, nc = len(problem.inst), len(problem.rigcam), len(problem.cam)
    step = dba.make_sharded_cg_lm_step(mesh, "points", "perspective", 3, ni,
                                       nc, cg_iters=CG_ITERS, win=win)
    for i in range(steps):
        a["inst"], a["cam"], a["points"] = step(*(a[k] for k in names))
        if report is not None:
            report(i, reprojection_cost(problem, a["inst"].numpy(),
                                        a["cam"].numpy(),
                                        a["points"].numpy()))
    return a["inst"].numpy(), a["cam"].numpy()


def main():
    port, rank, world = (int(x) for x in sys.argv[1:4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = Mesh(["cpu"] * LOCAL_SHARDS, group=dist.group.WORLD)
        inst, cam = run(mesh, report=lambda i, c: print(
            f"COST {i} {c:.12e}", flush=True))
        assert np.all(np.isfinite(inst))
        print(f"CHECKSUM inst {np.abs(inst).sum():.12e}", flush=True)
        print(f"CHECKSUM cam {np.abs(cam).sum():.12e}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
