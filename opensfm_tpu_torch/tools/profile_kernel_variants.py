"""Time the five ablation variants of the dense assembly kernel.

    python -m opensfm_tpu_torch.tools.profile_kernel_variants full nopush nomatmul noout fwdonly
    python -m opensfm_tpu_torch.tools.profile_kernel_variants full --device cpu

Port of the JAX package's root script `profile_kernel_variants.py`: it
builds the 64 shots x 8,192 points dense problem (`synthetic_bundle.make_problem`,
seed 0, laid out by `canonicalize_problem_dense`) and prints the time of one
`assembly_variant` call per mode (`ops/kernels/assembly_variants`), so that
leaving out the Jacobian pushes, the product or the out_obs writes shows
what each costs.  On the card (the default) each time is the median of 25
CUDA-event timings with the L2 cache flushed before each; with
`--device cpu` the plain PyTorch versions run, timed by the host clock.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device
from opensfm_tpu_torch.ops.kernels import _build
from opensfm_tpu_torch.ops.kernels import assembly_variants as V

L2_FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2


def dense_problem(n_shots: int = 64, n_points: int = 8192, seed: int = 0):
    """The synthetic circle-scene problem on the dense [NP, NI] grid."""
    repo = str(_build.CSRC.parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import synthetic_bundle

    from opensfm_tpu_torch.ba import lm

    problem, dense = lm.canonicalize_problem_dense(
        synthetic_bundle.make_problem(n_shots, n_points, seed=seed))
    if not dense:
        raise ValueError("the problem does not fit the dense layout")
    return problem


def variant_inputs(problem, device) -> tuple:
    """(u, v, isd [NP, NI], points [NP, 3], inst_t [8, NI], cam_row [1, 8])
    in float32 from a dense-layout problem, as the TPU script builds them:
    inst_t holds the poses in rows 0-5, then a row of ones and one of zeros;
    cam_row the camera's k1, k2, f, then 1e-4, 1, 1, 1, 0."""
    ni, n_p = len(problem.inst), len(problem.points)

    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    uv = np.asarray(problem.obs_uv)
    inst_t = np.concatenate([np.asarray(problem.inst)[:, :6].T,
                             np.ones((1, ni)), np.zeros((1, ni))])
    cam_row = np.concatenate([np.asarray(problem.cam)[0, :3],
                              [1e-4, 1.0, 1.0, 1.0, 0.0]])[None]
    return (f(uv[:, 0].reshape(n_p, ni)), f(uv[:, 1].reshape(n_p, ni)),
            f(np.asarray(problem.obs_inv_sd).reshape(n_p, ni)),
            f(problem.points), f(inst_t), f(cam_row))


def time_ms(fn, device: torch.device, reps: int = 25,
            backlog: bool = True) -> float:
    """Median milliseconds of `reps` calls of `fn` after one warm-up: CUDA
    events around each call with the L2 cache flushed before it on the
    card, the host clock on the CPU.

    On the card with `backlog`, a sleep kernel queued ahead of the first
    event keeps the card busy while the host enqueues `fn`, so the events
    bracket device time only; without it they also take in the host's time
    to launch, as a caller that waits on each call sees."""
    fn()
    times = []
    if device.type == "cuda":
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        torch.cuda.synchronize(device)
        for _ in range(reps):
            flush.zero_()
            if backlog:
                torch.cuda._sleep(2_000_000)  # ~1 ms at the H100's clock
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile(modes: Sequence[str], device=None, n_shots: int = 64,
            n_points: int = 8192, reps: int = 25) -> Dict[str, float]:
    """{mode: ms per call} of `assembly_variant` at n_shots x n_points."""
    dev = resolve_device(device)
    for mode in modes:
        if mode not in V.MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {V.MODES}")
    args = variant_inputs(dense_problem(n_shots, n_points), dev)
    return {mode: time_ms(lambda m=mode: V.assembly_variant(m, *args), dev,
                          reps)
            for mode in modes}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Time the ablation variants of the dense assembly "
                    "kernel (ms per call).")
    parser.add_argument("modes", nargs="*", default=list(V.MODES),
                        help=f"any of {', '.join(V.MODES)} (default: all)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (the plain versions)")
    parser.add_argument("--shots", type=int, default=64)
    parser.add_argument("--points", type=int, default=8192)
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"assembly variants, {args.shots} x {args.points}, float32, on "
          f"{where}; median of {args.reps}", flush=True)
    times = profile(args.modes, dev, args.shots, args.points, args.reps)
    for mode, ms in times.items():
        print(f"{mode:14s} {ms:8.3f} ms/call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
