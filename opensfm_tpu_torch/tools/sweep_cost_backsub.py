"""Sweep the plans of `fused_cost`, `fused_cost_dense` and
`fused_back_substitute` on the card.

    python -m opensfm_tpu_torch.tools.sweep_cost_backsub [--out FILE]

What each plan's choices buy, in f64 and f32 (SoftLOneLoss):

- `fused_cost` at the bundle lane (256 shots x 32,768 points x tracks of 8,
  O = 262,144): the plan's grid (`cost_plan`, 2 blocks per SM) beside 1, 3
  and 4 blocks per SM, and the instance table walked in tiles of 64 and 128
  instances beside one table of all 256;
- `fused_cost_dense` on the dense 64 x 8,192 grid: the plan's grid
  (`cost_dense_plan`, 2 blocks per SM) beside 1, 3 and 4 blocks per SM, and
  the instance table walked in tiles of 16 and 32 instances beside one
  table of all 64;
- `fused_back_substitute` on the dense 64 x 8,192 grid: the plan's chunk
  (`backsub_plan`) beside the other chunks of 1 to 12 points that fit the
  block's shared memory;
- the timer's floor (a one-element fill) and the three kernels at three
  sizes (O = 2,048 to 262,144; the dense grids 64 x 128 to 64 x 8,192),
  each timed as `time_ms` times it (L2 flushed, one call) and back to back
  (warm, 20 calls).

Times are device milliseconds (microseconds for the sizes), median of 25
CUDA-event timings with the L2 flushed before each (`profile_kernel_variants
.time_ms`).  Every launch goes through the kernels' launch functions and
counts in the wrappers' `.launches`.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from opensfm_tpu_torch.ba import lm
from opensfm_tpu_torch.ops.kernels import _build
from opensfm_tpu_torch.ops.kernels import ba_assemble as A
from opensfm_tpu_torch.ops.kernels import ba_resjac as K
from opensfm_tpu_torch.tools.profile_kernel_variants import time_ms

LOSS = "SoftLOneLoss"


def _problem(n_shots, n_points, track_window=None):
    repo = str(_build.CSRC.parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import synthetic_bundle

    return synthetic_bundle.make_problem(n_shots, n_points,
                                         track_window=track_window)


def cost_inputs(problem, dtype, dev):
    """The eight tensors of `fused_cost` in the problem's own layout."""
    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=dev)

    return (f(problem.inst), f(problem.cam), f(problem.points),
            i32(problem.obs_inst), i32(problem.obs_cam),
            i32(problem.obs_point), f(problem.obs_uv), f(problem.obs_inv_sd))


def backsub_inputs(problem, dtype, dev, seed=13):
    """(args of `_launch_back_substitute`, dx_p) on the problem's dense grid:
    its own free instances, camera and points, no priors, out_pt from the
    kernel's own assembly, a random pose and camera update."""
    p, dense = lm.canonicalize_problem_dense(problem)
    if not dense:
        raise ValueError("the problem does not fit the dense layout")
    rng = np.random.default_rng(seed)

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def b8(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.bool, device=dev)

    ni, n_p = len(p.inst), len(p.points)
    base = (f(p.inst), f(p.cam), f(p.points), f(p.obs_uv), f(p.obs_inv_sd))
    extras = (b8(p.opt_inst), b8(p.opt_cam), b8(p.opt_points),
              f(np.zeros((n_p, 3))), f(np.zeros((n_p, 3))), 1e-3)
    out_pt = A.fused_schur_assembly(*base, *extras, LOSS, 1.0)[0]
    dx = (f(1e-3 * rng.normal(size=(ni, 6))),
          f(1e-3 * rng.normal(size=(1, 3))))
    dx_p = torch.empty((n_p, 3), dtype=dtype, device=dev)
    return base + (out_pt,) + dx, dx_p


def back_to_back_us(fn, calls: int = 20) -> float:
    """Device microseconds per call of `fn` run `calls` times back to back,
    warm (no L2 flush): CUDA events around the calls, queued behind a sleep
    kernel so that the card runs them without waiting on the host."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms: longer than queueing the calls
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls * 1e3


def sweep_cost(args, dev):
    """{label: (plan, tile rows, ms)} of the cost kernel."""
    suffix, loss_id = K._check_cuda(*args, LOSS)
    n_inst, O = args[0].shape[0], args[6].shape[0]
    full = K.cost_table_rows(n_inst, args[6].element_size())

    def plan_for(per_sm):
        per_thread = max(1, -(-O // (K.COST_BLOCK * K.SMS * per_sm)))
        return -(-O // (K.COST_BLOCK * per_thread)), per_thread

    cases = {"plan": (K.cost_plan(O), full)}
    cases.update({f"{n} blocks/SM": (plan_for(n), full) for n in (1, 3, 4)})
    cases.update({f"tiles of {r}": (K.cost_plan(O), r) for r in (64, 128)})
    return {label: (plan, rows, time_ms(
        lambda: K._launch_cost(args, loss_id, 1.0, suffix, plan, rows), dev))
        for label, (plan, rows) in cases.items()}


def sweep_cost_dense(args, dev):
    """{label: (plan, ms)} of the dense cost kernel; args are the five
    tensors of `fused_cost_dense`."""
    suffix, loss_id = A._check_cuda(*args, LOSS)
    ni, n_p = args[0].shape[0], args[2].shape[0]
    plan = A.cost_dense_plan(ni, n_p, args[3].element_size())

    def plan_for(per_sm):
        pts = min(K.COST_BLOCK, -(-n_p // (K.SMS * per_sm)))
        return -(-n_p // pts), pts, plan[2]

    cases = {"plan": plan}
    cases.update({f"{n} blocks/SM": plan_for(n) for n in (1, 3, 4)})
    cases.update({f"tiles of {r}": plan[:2] + (r,) for r in (16, 32)})
    return {label: (p, time_ms(lambda p=p: A._launch_cost_dense(
        args, suffix, loss_id, 1.0, p), dev)) for label, p in cases.items()}


def sweep_backsub(args, dx_p, dev):
    """{chunk: ms} of the back-substitution."""
    suffix, loss_id = A._check_cuda(*args[:5], LOSS, *args[5:])
    ni, n_p = args[0].shape[0], args[2].shape[0]
    chunks = {1, 2, 4, 8, 12, A.backsub_plan(ni, n_p)[0]}
    return {c: time_ms(lambda: A._launch_back_substitute(
        args, suffix, loss_id, 1.0, c, -(-n_p // c), dx_p), dev)
        for c in sorted(chunks) if A.backsub_smem(ni, c) <= A.BACKSUB_SMEM}


def sizes(dtype, dev, cost_big, dense_big):
    """{kernel: [(size, time_ms us, back-to-back us)]} at three sizes."""
    out = {"fused_cost": [], "fused_back_substitute": [],
           "fused_cost_dense": []}
    for n in (2048, 32768, cost_big[6].shape[0]):
        a = cost_big[:3] + tuple(t[:n].contiguous() for t in cost_big[3:])

        def fn(a=a):
            return K.fused_cost(*a, LOSS, 1.0)

        out["fused_cost"].append((n, time_ms(fn, dev) * 1e3,
                                  back_to_back_us(fn)))
    for n_p in (128, 1024, 8192):
        args, dx_p = dense_big if n_p == 8192 else backsub_inputs(
            _problem(64, n_p), dtype, dev)

        def fn(args=args):
            return A.fused_back_substitute(*args, LOSS, 1.0)

        out["fused_back_substitute"].append(
            (n_p, time_ms(fn, dev) * 1e3, back_to_back_us(fn)))

        def dense_cost(args=args):
            return A.fused_cost_dense(*args[:5], LOSS, 1.0)

        out["fused_cost_dense"].append(
            (n_p, time_ms(dense_cost, dev) * 1e3,
             back_to_back_us(dense_cost)))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Sweep fused_cost's and fused_cost_dense's grids and "
                    "table tiles and fused_back_substitute's chunk on the "
                    "card.")
    parser.add_argument("--out", default=None, help="also write JSON here")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_cost_backsub: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(dev)}; {LOSS}", flush=True)
    bundle, dense = _problem(256, 32768, 8), _problem(64, 8192)
    one = torch.zeros(1, device=dev)
    result = {"timer_floor_us": (time_ms(lambda: one.zero_(), dev) * 1e3,
                                 back_to_back_us(lambda: one.zero_()))}
    print("timer floor, a one-element fill (time_ms us, back to back us): "
          "%.2f, %.2f" % result["timer_floor_us"], flush=True)
    for dtype in (torch.float64, torch.float32):
        key = str(dtype)[6:]
        cost_args = cost_inputs(bundle, dtype, dev)
        dense_args = backsub_inputs(dense, dtype, dev)
        r = result[key] = dict(
            cost=sweep_cost(cost_args, dev),
            cost_dense=sweep_cost_dense(dense_args[0][:5], dev),
            backsub=sweep_backsub(*dense_args, dev),
            sizes=sizes(dtype, dev, cost_args, dense_args))
        print(f"{key} fused_cost O={cost_args[6].shape[0]}: " + "; ".join(
            f"{k} {p} rows {t}: {ms:.4f} ms"
            for k, (p, t, ms) in r["cost"].items()), flush=True)
        print(f"{key} fused_cost_dense 64 x 8192 (blocks, points a block, "
              f"table rows): " + "; ".join(
                  f"{k} {p}: {ms:.4f} ms"
                  for k, (p, ms) in r["cost_dense"].items()), flush=True)
        print(f"{key} fused_back_substitute 64 x 8192 chunk (plan "
              f"{A.backsub_plan(64, 8192)}): " + "; ".join(
                  f"{c}: {ms:.4f} ms" for c, ms in r["backsub"].items()),
              flush=True)
        for name, rows in r["sizes"].items():
            print(f"{key} {name} (size, time_ms us, back to back us): "
                  + "; ".join(f"{n}: {t:.2f}, {b:.2f}" for n, t, b in rows),
                  flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
