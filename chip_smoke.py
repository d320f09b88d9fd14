#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`opensfm_tpu_torch`) on one card.

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits non-zero; nothing is caught and ignored):
 1. build the CUDA kernels of opensfm_tpu_torch/csrc/ with nvcc (sm_90a),
    one nvcc per source, all at once;
 2. hold every kernel against its plain PyTorch version on the card, in f32
    and f64, for all five losses: the residual/Jacobian and cost kernels in
    the canonical T=8 layout at O = 262,144 and in a ragged gathered layout,
    with padded slots; the dense-layout assembly, back-substitution and cost
    kernels on the 64 x 8,192 dense grid with dead slots, fixed instances and
    points and point priors;
 3. the `bundle` command, through the command runner, on a synthetic mono
    perspective map of 256 shots x 32,768 points x tracks of 8 (f64, the
    product default), with the kernels' launch counts read around it;
 4. bundle_adjust on the dense instance-slot layout (64 x 8,192), f32 and
    f64: the fused dense route, with its kernels' launch counts;
 5. bundle_adjust on the card against the same solve on the CPU (plain
    versions): 128 shots x 40,000 points x tracks of 4 (canonical) and
    32 x 4,096 (dense, fused route), 3 iterations;
 6. kernel timings (CUDA events, median of 25 runs, L2 flushed before
    each) beside their memory/compute bound, the plain version and a
    PyTorch yardstick where there is one;
 7. torch.profiler: device time by kernel over one warm LM trial at the
    bundle shape and at the dense shape, and a warm solve's time per trial.
Then the card's name and power limit, one {"kernels": [...]} JSON line, and
as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # no tensor cores
# Matrix products: f32 stays off the tensor cores (no TF32), f64 may use
# them (H100 SXM data sheet: 67 TFLOP/s FP64 tensor core).
PEAK_MMA_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
# Floating-point operations per observation slot, counted from csrc/
# (sin/cos/sqrt/div counted as one each): the forward chain and cost; the
# forward chain with the 24 Jacobian entries; that plus the assembly's
# weighting, masks, per-point sums, Schur factor and 81 slot sums; and the
# chain plus the back-substitution's products.
FLOPS_COST_OBS = 75
FLOPS_RESJAC_OBS = 330
FLOPS_ASSEMBLE_SLOT = 830
FLOPS_BACKSUB_SLOT = 400
REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

LOSSES = ("TrivialLoss", "SoftLOneLoss", "CauchyLoss", "HuberLoss",
          "TukeyLoss")
TOL = {  # kernel vs plain, see check_kernels
    torch.float64: dict(rel=1e-10, total=1e-10),
    torch.float32: dict(r=(2e-4, 2e-5), J=(2e-3, 2e-3), total=1e-5),
}
# Dense-layout kernels vs plain, as the largest difference over the largest
# entry of each output.  f64: 1e-10.  f32: the assembly's sums run over 64
# slots and 8,192 points in another order than the plain einsums and
# product, 1e-4 (tests/test_pallas_kernels.py's tolerance for the assembled
# system); the point updates 1e-3 (bp - u cancels); the cost 1e-5.
TOL_DENSE = {
    torch.float64: dict(out=1e-10, dx=1e-10, total=1e-10),
    torch.float32: dict(out=1e-4, dx=1e-3, total=1e-5),
}
KERNELS = {  # name -> (CUDA source, the Pallas kernel it replaces)
    "fused_residual_jacobian": (
        "opensfm_tpu_torch/csrc/ba_resjac.cu",
        "opensfm_tpu/ops/pallas_kernels/ba_resjac.py:260"),
    "fused_cost": (
        "opensfm_tpu_torch/csrc/ba_resjac.cu",
        "opensfm_tpu/ops/pallas_kernels/ba_resjac.py:389"),
    "fused_cost_dense": (
        "opensfm_tpu_torch/csrc/ba_assemble.cu",
        "opensfm_tpu/ops/pallas_kernels/ba_assemble.py:533"),
    "fused_schur_assembly": (
        "opensfm_tpu_torch/csrc/ba_assemble.cu",
        "opensfm_tpu/ops/pallas_kernels/ba_assemble.py:619"),
    "fused_back_substitute": (
        "opensfm_tpu_torch/csrc/ba_assemble.cu",
        "opensfm_tpu/ops/pallas_kernels/ba_assemble.py:429"),
}
DENSE_KERNELS = ("fused_cost_dense", "fused_schur_assembly",
                 "fused_back_substitute")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_inputs(problem, dtype, device, ragged: bool, seed: int):
    """The kernels' inputs from a problem: the canonical layout as it is,
    with ~5% of the slots padded (inv_sd = 0, uv = 0); or, `ragged`, a
    random gathered subset of 100,003 observations (fewer for a small
    problem)."""
    rng = np.random.default_rng(seed)
    O = len(problem.obs_uv)
    if ragged:
        sel = np.sort(rng.choice(O, size=min(100_003, O // 2 + 1),
                                 replace=False))
    else:
        sel = np.arange(O)
    uv = np.asarray(problem.obs_uv)[sel].copy()
    isd = np.asarray(problem.obs_inv_sd)[sel].copy()
    pad = rng.random(len(sel)) < 0.05
    uv[pad] = 0.0
    isd[pad] = 0.0

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)

    return (f(problem.inst), f(problem.cam), f(problem.points),
            i32(np.asarray(problem.obs_inst)[sel]),
            i32(np.asarray(problem.obs_cam)[sel]),
            i32(np.asarray(problem.obs_point)[sel]), f(uv), f(isd))


def _rel(a, b) -> float:
    """max|a - b| / max|b| (0 when both are 0)."""
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / scale if scale else float((a - b).abs().max())


def check_kernels(problem, dev="cuda"):
    """Phase 2: every kernel against its plain version on the card."""
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K

    worst = {"fused_residual_jacobian": {}, "fused_cost": {}}
    dev = torch.device(dev)
    for dtype in (torch.float64, torch.float32):
        tol = TOL[dtype]
        for ragged in (False, True):
            args = kernel_inputs(problem, dtype, dev, ragged, seed=7)
            for loss in LOSSES:
                out = K.fused_residual_jacobian(*args, loss, 1.0)
                ref = K.fused_residual_jacobian_plain(*args, loss, 1.0)
                tot = K.fused_cost(*args, loss, 1.0)
                tot_ref = K.fused_cost_plain(*args, loss, 1.0)
                torch.cuda.synchronize()
                names = ("r", "Jc", "Jp", "cost")
                for name, a, b in zip(names, out, ref):
                    check(bool(torch.isfinite(a).all()),
                          f"{name} finite ({loss}, {dtype})")
                    err = float((a - b).abs().max())
                    key = str(dtype).split(".")[-1]
                    wk = worst["fused_residual_jacobian"]
                    wk[key] = max(wk.get(key, 0.0), err)
                    if dtype == torch.float64:
                        check(_rel(a, b) <= tol["rel"],
                              f"{name} f64 rel {_rel(a, b):.3g} ({loss})")
                    else:
                        rtol, atol = tol["J" if name.startswith("J") else "r"]
                        check(torch.allclose(a, b, rtol=rtol, atol=atol),
                              f"{name} f32 beyond rtol {rtol} atol {atol} "
                              f"({loss}, max err {err:.3g})")
                rel = abs(float(tot) - float(tot_ref)) / abs(float(tot_ref))
                check(rel <= tol["total"],
                      f"total cost rel {rel:.3g} ({loss}, {dtype})")
                key = str(dtype).split(".")[-1]
                wc = worst["fused_cost"]
                wc[key] = max(wc.get(key, 0.0), abs(float(tot) - float(tot_ref)))
                # Determinism: the same inputs give the same bits.
                check(float(K.fused_cost(*args, loss, 1.0)) == float(tot),
                      "fused_cost is deterministic")
            layout = "ragged" if ragged else "canonical"
            log(f"  {str(dtype)[6:]} {layout} O={args[6].shape[0]}: "
                f"5 losses within tolerance")
    # An empty problem costs 0 and launches nothing.
    empty = kernel_inputs(problem, torch.float64, dev, False, 0)
    empty = empty[:3] + tuple(t[:0] for t in empty[3:])
    check(float(K.fused_cost(*empty, "SoftLOneLoss", 1.0)) == 0.0,
          "empty fused_cost is 0")
    return worst


def dense_kernel_inputs(problem, dtype, device, seed: int):
    """The dense-layout kernels' inputs from a problem laid out on the dense
    grid: ~5% more dead slots (inv_sd = 0, uv = 0), the first instance and
    64 points fixed, point priors on 512 points, a damping and a pose
    update.  Returns (base, assembly extras, (dx_i, dx_cam))."""
    from opensfm_tpu_torch.ba import lm

    p, dense = lm.canonicalize_problem_dense(problem)
    check(dense, "the problem densifies")
    rng = np.random.default_rng(seed)
    uv = np.asarray(p.obs_uv).copy()
    isd = np.asarray(p.obs_inv_sd).copy()
    dead = rng.random(len(isd)) < 0.05
    uv[dead] = 0.0
    isd[dead] = 0.0
    opt_inst = np.asarray(p.opt_inst).copy()
    opt_inst[0] = False
    opt_points = np.asarray(p.opt_points).copy()
    opt_points[:64] = False
    prior = np.asarray(p.points) + rng.normal(0.0, 0.02, p.points.shape)
    prior_inv_sd = np.zeros_like(prior)
    prior_inv_sd[:512] = 2.0

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def b8(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.bool, device=device)

    base = (f(p.inst), f(p.cam), f(p.points), f(uv), f(isd))
    extras = (b8(opt_inst), b8(p.opt_cam), b8(opt_points), f(prior),
              f(prior_inv_sd), 1e-3)
    dx = (f(1e-3 * rng.normal(size=(len(p.inst), 6))),
          f(1e-3 * rng.normal(size=(1, 3))))
    return base, extras, dx


def check_dense_kernels(problem, dev="cuda"):
    """Phase 2, dense layout: the assembly, back-substitution and dense cost
    kernels against their plain versions on the card; the same inputs give
    the same bits twice."""
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A

    worst = {name: {} for name in DENSE_KERNELS}
    for dtype in (torch.float64, torch.float32):
        tol = TOL_DENSE[dtype]
        key = str(dtype)[6:]
        base, extras, dx = dense_kernel_inputs(problem, dtype,
                                               torch.device(dev), seed=11)
        for loss in LOSSES:
            got = A.fused_schur_assembly(*base, *extras, loss, 1.0)
            want = A.fused_schur_assembly_plain(*base, *extras, loss, 1.0)
            again = A.fused_schur_assembly(*base, *extras, loss, 1.0)
            torch.cuda.synchronize()
            for name, a, b, c in zip(("out_pt", "S_II", "aux"), got, want,
                                     again):
                check(bool(torch.isfinite(a).all()), f"{name} finite "
                      f"({loss}, {key})")
                rel = _rel(a, b)
                check(rel <= tol["out"], f"{name} {key} rel {rel:.3g} ({loss})")
                check(torch.equal(a, c), f"{name} is deterministic")
                w = worst["fused_schur_assembly"]
                w[key] = max(w.get(key, 0.0), float((a - b).abs().max()))
            check(torch.equal(got[1], got[1].T), "S_II is symmetric")
            # Both back-substitutions read the plain assembly's rows.
            dxp = A.fused_back_substitute(*base, want[0], *dx, loss, 1.0)
            dxp_ref = A.fused_back_substitute_plain(*base, want[0], *dx, loss,
                                                    1.0)
            rel = _rel(dxp, dxp_ref)
            check(rel <= tol["dx"], f"dx_p {key} rel {rel:.3g} ({loss})")
            w = worst["fused_back_substitute"]
            w[key] = max(w.get(key, 0.0), float((dxp - dxp_ref).abs().max()))
            tot = float(A.fused_cost_dense(*base, loss, 1.0))
            tot_ref = float(A.fused_cost_dense_plain(*base, loss, 1.0))
            rel = abs(tot - tot_ref) / abs(tot_ref)
            check(rel <= tol["total"], f"dense cost {key} rel {rel:.3g} "
                  f"({loss})")
            check(float(A.fused_cost_dense(*base, loss, 1.0)) == tot,
                  "fused_cost_dense is deterministic")
            w = worst["fused_cost_dense"]
            w[key] = max(w.get(key, 0.0), abs(tot - tot_ref))
        log(f"  {key} dense {base[2].shape[0]} x {base[0].shape[0]}: "
            f"5 losses within tolerance")
    return worst


def _wrappers():
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K

    return {name: getattr(K if hasattr(K, name) else A, name)
            for name in KERNELS}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def run_bundle_command(problem, dev="cuda"):
    """Phase 3: the `bundle` command on the synthetic map, on the card."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch import pymap
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    path = os.path.join(WORK, "bundle_256x32768")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    # The single-device solve on any host (on one card it is so anyway).
    sb.write_dataset(path, problem, {"bundle_distributed": False})
    log(f"  dataset written in {time.perf_counter() - t0:.1f} s: "
        f"{len(problem.inst)} shots, {len(problem.points)} points, "
        f"{len(problem.obs_uv)} observations")
    reset_launches()
    t0 = time.perf_counter()
    reports = command_runner(opensfm_commands,
                             argv=["bundle", path, "--device", dev])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    check(len(reports) == 1, "one reconstruction bundled")
    rep = reports[0]
    log(f"  bundle command: {wall:.2f} s; {rep['brief_report']}; "
        f"wall_times {json.dumps(rep['wall_times'])}; launches {counts}")
    check(rep["final_cost"] < rep["initial_cost"], "bundle reduced the cost")
    data = DataSet(path)
    rec = data.load_reconstruction()[0]
    tracks = pymap.TracksManager.instanciate_from_file(
        os.path.join(path, "tracks.csv"))
    rms = sb.reprojection_rms(rec, tracks)
    log(f"  reprojection RMS {rms:.3e} (injected noise {sb.NOISE:.1e})")
    check(0.5 * sb.NOISE < rms < 2.0 * sb.NOISE,
          f"reprojection RMS {rms:.3e} on the order of the noise")
    for name in ("fused_residual_jacobian", "fused_cost"):
        check(counts[name] > 0, f"{name} launched on the bundle path")
    return counts, rep


def run_dense(problem):
    """Phase 4: the dense instance-slot layout's fused route, f32 and f64.
    Returns the f64 run's launch counts."""
    from opensfm_tpu_torch.ba import lm

    _, dense = lm.canonicalize_problem_dense(problem)
    check(dense, "64 x 8192 densifies")
    for dtype in (torch.float32, torch.float64):
        reset_launches()
        t0 = time.perf_counter()
        res = lm.bundle_adjust(problem, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        counts = launches()
        log(f"  dense {str(dtype)[6:]}: {time.perf_counter() - t0:.2f} s, "
            f"cost {res.initial_cost:.6g} -> {res.final_cost:.6g} in "
            f"{res.iterations} iterations; launches {counts}")
        check(np.isfinite(res.final_cost)
              and res.final_cost < res.initial_cost, "dense cost reduced")
        for name in DENSE_KERNELS:
            check(counts[name] > 0, f"{name} launched on the dense path")
    return counts


def run_vs_cpu(make_problem, max_iterations: int = 3):
    """Phase 5: the whole solve on the card against the CPU (plain), on a
    canonical problem and on a dense one (the fused route)."""
    from opensfm_tpu_torch.ba import lm

    cases = (("canonical 128 x 40000 x K=4",
              make_problem(128, 40000, track_window=4), False),
             ("dense 32 x 4096", make_problem(32, 4096), True))
    for label, problem, want_dense in cases:
        _, dense = lm.canonicalize_problem_dense(problem)
        check(dense == want_dense, f"{label}: layout")
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out[dev] = lm.bundle_adjust(problem, max_iterations=max_iterations,
                                        device=dev)
            log(f"  {label} {dev}: {time.perf_counter() - t0:.2f} s, cost "
                f"{out[dev].initial_cost:.12g} -> {out[dev].final_cost:.12g} "
                f"in {out[dev].iterations} iterations")
        g, c = out["cuda"], out["cpu"]
        rel = abs(g.final_cost - c.final_cost) / abs(c.final_cost)
        dstate = max(float(np.abs(g.inst - c.inst).max()),
                     float(np.abs(g.points - c.points).max()))
        log(f"  {label}: final cost rel diff {rel:.3e}, max state diff "
            f"{dstate:.3e}")
        check(g.iterations == c.iterations, f"{label}: same iterations")
        check(rel <= 1e-8, f"{label}: final cost within 1e-8 relative")


def _time_ms(fn, reps: int = 25, backlog: bool = True) -> float:
    """Median of `reps` CUDA-event timings, the L2 flushed before each.

    With `backlog`, a sleep kernel queued ahead of the first event keeps the
    card busy while the host enqueues `fn`, so the events bracket device
    time only; without it they also take in the host's time to launch (the
    wrapper's Python checks), as a caller that waits on each call sees."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if backlog:
            torch.cuda._sleep(2_000_000)  # ~1 ms at the H100's clock
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _yardstick(args, loss, with_jac: bool):
    """The same function as one eager expression of PyTorch calls, in the
    reference's XLA form: Rodrigues rotate, perspective projection, robust
    cost, and for the Jacobian 12 forward-mode pushes (torch.func.jvp)."""
    from opensfm_tpu_torch.ba.lm import LOSSES
    from opensfm_tpu_torch.geometry import rotation as rot
    from opensfm_tpu_torch.geometry.cameras import project_torch

    inst, cam, points, oi, oc, op, uv, isd = args
    rho, drho = LOSSES[loss]
    combo = torch.cat([inst[oi], cam[oc, :3]], dim=1)
    X = points[op]

    def res(c, x):
        Xc = rot.rotate(c[:, 0:3], x) + c[:, 3:6]
        return (project_torch("perspective", Xc, c[:, 6:9]) - uv) * isd[:, None]

    if not with_jac:
        r = res(combo, X)
        return torch.sum(0.5 * rho(torch.sum(r * r, dim=-1)))
    cols = []
    for k in range(12):
        tc = torch.zeros_like(combo)
        tx = torch.zeros_like(X)
        (tc if k < 9 else tx)[:, k if k < 9 else k - 9] = 1.0
        r, jv = torch.func.jvp(res, (combo, X), (tc, tx))
        cols.append(jv)
    s = torch.sum(r * r, dim=-1)
    sw = torch.sqrt(torch.clamp_min(drho(s), 1e-12))[:, None]
    J = torch.stack(cols, dim=-1) * sw[..., None]
    return r * sw, J[:, :, :9], J[:, :, 9:], 0.5 * rho(s)


def _time_row(rows, name, dtype, kern, plain, lib, nbytes, flops,
              mma_flops=0):
    """Times one kernel, its plain version and its yardstick (lib, or None)
    and records them beside the bound: the larger of the bytes over the
    memory rate and the operations over the peak rates."""
    ms = _time_ms(kern)
    ms_call = _time_ms(kern, backlog=False)
    ms_plain = _time_ms(plain)
    ms_lib = _time_ms(lib) if lib is not None else None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FLOPS[dtype] + mma_flops / PEAK_MMA_FLOPS[dtype]) * 1e3
    key = str(dtype)[6:]
    rows.setdefault(name, {})[key] = dict(
        ms=ms, call_ms=ms_call, plain_ms=ms_plain, library_ms=ms_lib,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops + mma_flops,
    )
    lib_txt = f"{ms_lib:.4f} ms" if ms_lib is not None else "none"
    log(f"  {name} {key}: kernel {ms:.4f} ms (call with host launch "
        f"{ms_call:.4f} ms), bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {(flops + mma_flops) / 1e9:.2f} GFLOP), "
        f"plain {ms_plain:.4f} ms, yardstick {lib_txt}")


def time_dense_kernels(problem, rows):
    """Phase 6, dense layout: the three fused-route kernels at the 64 x 8192
    grid of phase 4.  No single PyTorch call computes any of them."""
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A

    loss = "SoftLOneLoss"
    for dtype in (torch.float64, torch.float32):
        base, extras, dx = dense_kernel_inputs(problem, dtype,
                                               torch.device("cuda"), seed=13)
        ni, n_p = base[0].shape[0], base[2].shape[0]
        slots = ni * n_p
        fb = torch.finfo(dtype).bits // 8
        tables = sum(t.numel() * t.element_size() for t in base[:3])
        obs = slots * 3 * fb + tables  # uv, inv_sd; instance, camera, points
        out_pt = A.fused_schur_assembly_plain(*base, *extras, loss, 1.0)[0]
        n6 = 6 * ni
        masks = ni + 3 + n_p  # bool
        asm_bytes = (obs + masks + n_p * 6 * fb  # priors, their inv_sd
                     + n_p * A.PT_COLS * fb + n6 * n6 * fb
                     + A.AUX_ROWS * ni * fb)
        syrk = n6 * (n6 + 1) // 2 * 3 * n_p * 2  # the symmetric product
        _time_row(rows, "fused_schur_assembly", dtype,
                  lambda: A.fused_schur_assembly(*base, *extras, loss, 1.0),
                  lambda: A.fused_schur_assembly_plain(*base, *extras, loss,
                                                       1.0),
                  None, asm_bytes, slots * FLOPS_ASSEMBLE_SLOT, syrk)
        bs_bytes = (obs + n_p * A.PT_COLS * fb + (ni * 6 + 3) * fb
                    + n_p * 3 * fb)
        _time_row(rows, "fused_back_substitute", dtype,
                  lambda: A.fused_back_substitute(*base, out_pt, *dx, loss,
                                                  1.0),
                  lambda: A.fused_back_substitute_plain(*base, out_pt, *dx,
                                                        loss, 1.0),
                  None, bs_bytes, slots * FLOPS_BACKSUB_SLOT)
        _time_row(rows, "fused_cost_dense", dtype,
                  lambda: A.fused_cost_dense(*base, loss, 1.0),
                  lambda: A.fused_cost_dense_plain(*base, loss, 1.0),
                  None, obs + fb, slots * FLOPS_COST_OBS)


def time_kernels(problem):
    """Phase 6: kernel, plain and yardstick times at the bundle shape."""
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K

    rows = {}
    loss = "SoftLOneLoss"
    for dtype in (torch.float64, torch.float32):
        args = kernel_inputs(problem, dtype, torch.device("cuda"), False, 3)
        O = args[6].shape[0]
        fb = torch.finfo(dtype).bits // 8
        tables = sum(t.numel() * t.element_size() for t in args[:3])
        read = O * (3 * fb + 3 * 4) + tables  # uv, inv_sd, 3 indices
        specs = {
            "fused_residual_jacobian": (
                lambda: K.fused_residual_jacobian(*args, loss, 1.0),
                lambda: K.fused_residual_jacobian_plain(*args, loss, 1.0),
                lambda: _yardstick(args, loss, True),
                read + O * 27 * fb, O * FLOPS_RESJAC_OBS),
            "fused_cost": (
                lambda: K.fused_cost(*args, loss, 1.0),
                lambda: K.fused_cost_plain(*args, loss, 1.0),
                lambda: _yardstick(args, loss, False),
                read + fb, O * FLOPS_COST_OBS),
        }
        log(f"  O = {O}")
        for name, (kern, plain, lib, nbytes, flops) in specs.items():
            _time_row(rows, name, dtype, kern, plain, lib, nbytes, flops)
    return rows


def profile_trial(problem, label):
    """Phase 7: device time by kernel over one warm LM trial (step + cost),
    f64, and a warm solve's time per trial."""
    from opensfm_tpu_torch.ba import lm

    p, dense, state, data = lm.device_problem(
        problem, torch.float64, torch.device("cuda"))
    ni, nr, nc = len(p.inst), len(p.rigcam), len(p.cam)

    def trial():
        st = lm._lm_step(state, data, 1e-4, "SoftLOneLoss", 1.0, 3, ni, nr,
                         nc, dense=dense)
        return lm._total_cost(st, data, "SoftLOneLoss", 1.0, dense=dense)

    trial()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trial().item()
    wall = (time.perf_counter() - t0) * 1e3

    def self_dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Device kernels only (the aten ops above them carry the same time).
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")),
                  key=self_dev, reverse=True)
    busy = sum(self_dev(e) for e in rows) / 1e3
    log(f"  {label}: one LM trial (step + cost), f64, dense={dense}: host wall "
        f"{wall:.2f} ms under the profiler, device busy {busy:.2f} ms in "
        f"{sum(e.count for e in rows)} kernels")
    for e in rows[:14]:
        log(f"    {self_dev(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")

    # The whole solve again, warm: seconds per LM trial without profiler.
    reset_launches()
    t0 = time.perf_counter()
    res = lm.bundle_adjust(problem, device="cuda")
    wall = time.perf_counter() - t0
    n = launches()
    # One cost per trial and one for the start.
    trials = n["fused_cost"] + n["fused_cost_dense"] - 1
    log(f"  {label}: warm bundle_adjust {wall:.3f} s, {res.iterations} accepted of "
        f"{trials} trials, {wall / max(trials, 1) * 1e3:.1f} ms per trial")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import synthetic_bundle as sb
    from opensfm_tpu_torch.ops.kernels import _build
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    os.makedirs(WORK, exist_ok=True)

    log("phase 1: build (one nvcc per source, all at once)")
    t0 = time.perf_counter()
    libs = _build.build_all([K.SOURCE, A.SOURCE])
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for source, lib in libs.items():
        secs, ptxas = _build.BUILD_LOG[source]
        log(f"  {source} -> {os.path.relpath(lib, REPO)} (nvcc {secs:.1f} s)")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")

    log("phase 2: kernels vs plain on the card")
    t0 = time.perf_counter()
    big = sb.make_problem(256, 32768, track_window=8)
    dense64 = sb.make_problem(64, 8192)
    worst = check_kernels(big)
    worst.update(check_dense_kernels(dense64))
    log(f"  done in {time.perf_counter() - t0:.1f} s; worst abs err {worst}")

    log("phase 3: bundle command, 256 x 32768 x K=8, f64")
    t0 = time.perf_counter()
    counts, _ = run_bundle_command(big)
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log("phase 4: dense layout, 64 x 8192, the fused route")
    t0 = time.perf_counter()
    dense_counts = run_dense(dense64)
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log("phase 5: card vs CPU, 3 iterations, f64")
    t0 = time.perf_counter()
    run_vs_cpu(sb.make_problem)
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 6: kernel timings ({card})")
    rows = time_kernels(big)
    time_dense_kernels(dense64, rows)

    log("phase 7: profile of one LM trial")
    profile_trial(big, "bundle 256 x 32768 x K=8")
    profile_trial(dense64, "dense 64 x 8192")

    paths = {name: ("bundle command 256x32768xK=8, f64", counts)
             for name in ("fused_residual_jacobian", "fused_cost")}
    paths.update({name: ("bundle_adjust dense 64x8192, f64", dense_counts)
                  for name in DENSE_KERNELS})
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        f64, f32 = rows[name]["float64"], rows[name]["float32"]
        path, n = paths[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=n[name], path=path,
            max_abs_err=worst[name]["float64"], ms=f64["ms"],
            plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"],
            bound_by=f64["bound_by"], library_ms=f64["library_ms"],
            dtype="float64", max_abs_err_f32=worst[name]["float32"],
            ms_f32=f32["ms"], plain_ms_f32=f32["plain_ms"],
            bound_ms_f32=f32["bound_ms"], library_ms_f32=f32["library_ms"],
        ))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
