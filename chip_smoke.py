#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (`opensfm_tpu_torch`) on one card.

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits non-zero; nothing is caught and ignored):
 1. build the CUDA kernels of opensfm_tpu_torch/csrc/ with nvcc (sm_90a),
    one nvcc per source, all at once, beside a probe of the f64 mma.sync
    shapes ptxas takes; print ptxas's registers and spills (the tensor-core
    top-2 kernels, the f64 tensor-core product, the residual/Jacobian
    kernels, both cost kernels, the back-substitution and the ablation
    product must not spill; the registers and stack frames of the last
    four and of the f64 tensor-core product are printed);
 2. hold every kernel against its plain PyTorch version on the card, in f32
    and f64, for all five losses: the residual/Jacobian and cost kernels in
    the canonical T=8 layout at O = 262,144, in a ragged gathered layout,
    at O = 262,147 (a partial last block) and at O = 255 and 1, with
    padded slots, the cost bit-equal across two calls and also within
    tolerance when its instance table is walked in tiles of 64 rows, NaN
    for an index outside its table; the cost on a map of 3,000 shots (its
    table in tiles) x 65,536 points x tracks of 8 (two batches a thread);
    the dense-layout assembly, back-substitution and cost kernels on the
    64 x 8,192 dense grid and the ragged grids DENSE_RAGGED, with dead
    slots, fixed instances and points and point priors, bit-equal across
    two calls; the dense cost also with its instance table walked in tiles
    of 16 rows, NaN from a NaN point whose slots are all dead, and on grids
    of more instances than one table holds (COST_DENSE_WIDE: two tiles);
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
    PyTorch yardstick where there is one (the grid and chunk sweeps of
    rows 1 and 5 are `python -m opensfm_tpu_torch.tools.sweep_cost_backsub`);
 7. torch.profiler: device time by kernel over one warm LM trial at the
    bundle shape and at the dense shape, and a warm solve's time per trial;
    the dense assembly's four sub-kernels per call (f64 and f32) and the
    product step's yardstick, torch.mm(bmat.T, bmat) on the same f64 bmat;
 8. the top-2 descriptor search kernel against its plain version on the
    card: unmasked and masked, at 8,192 x 8,192 x 128 on uint8 descriptors
    (the tensor-core kernel, bitwise equal), on uint8 ones of width 200
    and 258 (the FP32 kernel, bitwise equal), on float descriptors and
    uint8 ones wider than 258 (the FP32 kernel, within 1e-4 of
    sq1 + sq2), at ragged sizes and with fewer than 16 rows; and its
    device launches per call at 8,192^2 (a trace of 20 calls, which must
    read the wrapper's 2); then the two cost kernels' and the
    back-substitution's device launches per call (one trace of 20 calls
    each, which must read each wrapper's 1);
 9. the `match_features` command, through the command runner, on a
    synthetic dataset of 32 images x 8,192 features (4,096 true, 4,096
    distractors; 496 pairs), with the kernel's launches read around it and
    the written matches scored against the true correspondences;
10. the WORDS matcher (the masked kernel) on a 6-image subset with words,
    the whole command under torch.profiler for its device busy share;
11. descriptor matching and RANSAC on the card against the CPU on 4 pairs,
    the same random draws injected into both;
12. the top-2 kernel's timings beside its bound, the plain version and two
    eager PyTorch expressions (addmm + topk in FP32; torch._int_mm + topk on
    the descriptors shifted to int8), and a torch.profiler breakdown of
    one pair's `match` (two searches and RANSAC);
13. the dense-assembly ablation profiler (`python -m
    opensfm_tpu_torch.tools.profile_kernel_variants`): each of its five
    modes' kernels against its plain version at 64 x 8,192 and on a ragged
    37 x 1,000 grid (f32), bit-equal across two calls, then the tool's
    timings beside each mode's bound, and the product step alone beside
    torch.mm(op_a.T, op_g) on the same operands (FP32, no TF32);
14. `create_tracks` and `reconstruct`, through the command runner, on phase
    9's dataset and matches (32 images): the result graded against the
    generator's truth (all 32 shots in one reconstruction, camera-centre,
    point and reprojection RMS within the bounds below), where the time
    went (image pairs, bootstrap, growth loop, each kind of bundle with its
    LM routes, resection rounds, triangulation calls), every kernel's
    launches over `reconstruct` (rows 1 and 2 must launch), one resection
    round traced at 1 and at 8 candidates and one triangulation at two
    sizes (their device launches must not grow), one growth step traced for
    the device's busy share, and `reconstruct` of a 4-image subset on the
    card against the CPU;
15. the chain from images: IMAGE_VIEWS views of 2,048 x 1,536 rendered on
    the card (synthetic_images: two textured boxes on a textured ground,
    views on a circle) and written as JPEGs by the port's codec at
    cv2.imwrite's defaults with the EXIF in an APP1 segment, then `run_all`
    through the command runner at IMAGE_CONFIG (the defaults with the AUTO
    outlier filter; its eight stages: `extract_metadata`,
    `detect_features`, `match_features`, `create_tracks`, `reconstruct`,
    `mesh`, `undistort`, `compute_depthmaps`): every view has >=
    feature_min_frames features, all views land in one reconstruction
    within the centre and reprojection bounds below, each stage's wall time
    from run_all's report, the detector's per-image wall time, device busy
    time and kernels (one image traced), rows 1, 2 and 6's launches over
    the chain (all must launch), one image's detection on the card against
    the CPU at the CPU tests' tolerances; the codec's decode and encode ms
    an image on the host, decoding's share of `detect_features`, and view
    0 decoded against its render (PSNR >= JPEG_MIN_PSNR_DB); every shot's
    mesh has a face, 16 undistorted JPEGs of 2,048 x 1,536 and the
    undistorted reconstruction, raw, clean and pruned depthmaps of every
    shot with a neighbour, `merged.ply` graded against the scene within the
    DENSE_ bounds below; one shot's PatchMatch at 640 x 480 (wall, peak
    device memory < 8 GiB), the same shot's at 160 wide on the card against
    the CPU with the same draws of four seeds (their mean share held), all
    from the inputs that `dense.compute_depthmap` builds, and one
    half-iteration traced at widths 320, 640 and 1280 with the main path's
    chunks of neighbours (its device launches may grow with the chunk count
    only; busy share);
16. phase 14's reconstruction split into a thin-bridge pair and reunited by
    the seeded merge on the card within the JAX test's bounds, then
    `reconstruct --algorithm triangulation` and `reconstruct_from_prior`
    through the command runner on a copy whose metadata poses are the
    truth plus noise, graded against the truth, with wall times and the
    bundle kernels' launches (rows 1-2 or, where a problem densifies, 3-5).
17. the generic route (every problem the kernels do not take): bundle
    adjustment at phase 3's 256 x 32,768 x tracks of 8, f64, on brown,
    fisheye_opencv, fisheye624 and spherical maps, a brown /
    fisheye_opencv mixed map, a 64-instance x 4-camera rig with optimized
    rig cameras and a perspective map with depth rows, each with a warm LM
    trial's ms, device busy share and kernels beside the kernel route's on
    phase 3's problem, its solve lowering the cost with none of rows 1-5
    launched; the same problems at 32 x 4,096 on the card against the CPU
    (3 iterations: the same count, states within 1e-9); then 16 images x
    8,192 features (brown and fisheye_opencv cameras), pairs from each
    image's 8 nearest by GPS, through `match_features` (row 6),
    `create_tracks` and `reconstruct`, graded within the MIXED_ bounds
    below, and a 4-image subset (MIXED_SUBSET) on the card against the
    CPU;
18. a rig from images: 8 instances of a two-camera rig (a brown camera
    left, a fisheye_opencv camera right, 0.4 m apart) at 1,024 x 768
    rendered on the card through their models as PNGs, pairs from each image's 8
    nearest by GPS, then `extract_metadata`
    (the camera model overrides give each rig camera its model),
    `detect_features`, `create_rig pattern`, `match_features`,
    `create_tracks` and `reconstruct`: all 16 shots in one reconstruction,
    the centre RMS and the rig cameras' baseline and relative rotation
    (as calibrated and as reconstructed) within the bounds below;
19. AKAZE: 8 of phase 15's JPEG views through `extract_metadata`,
    `detect_features` and `match_features` with `feature_type` AKAZE
    (M-SURF), and 2 of them with M-LDB: features an image, inliers a pair
    and pairs within the bounds below, row 6 launched on float and on wide
    uint8 descriptors (its FP32 route), M-LDB saved as 486 uint8 bits, one
    image's AKAZE traced at two feature budgets (kernels, busy share; its
    launches must not grow with the keypoints), and one view at 512 x 384
    on the card against the CPU for both descriptors;
20. vocabularies and guided matching: on 8 of phase 15's views (copies
    with `synthetic_bundle.subset_dataset`), `detect_features` with
    `matcher_type: WORDS` assigns each image 50 words of the packaged
    10,000-word vocabulary on the card (ms an image; one image's words
    against the CPU's), then `match_features` with BoW pair selection
    (GPS off, 2 neighbours) and again with VLAD pair selection, each with
    the WORDS matcher (row 6's masked route must launch; the pairs equal
    the CPU's selection; matches within the bounds below; the VLAD sums
    bit-equal twice); BoW pair selection on phase 19's AKAZE views trains
    a 1,024-word vocabulary (twice on the card, equal bits; against the
    CPU's centres; its seconds); guided matching on 8 pairs of phase 15's
    reconstruction from its relative poses (two masked row-6 searches a
    pair, every match within the threshold of its epipolar geometry, one
    pair's mask, descriptor matches and robust matches against the CPU);
    and the seven export commands on phase 15's dataset, each output
    parsed against the reconstruction;
21. the submodel path and the pose-graph bundle.  (a) On a copy of phase
    15's views, EXIF, features and matches: `create_submodels` with
    `submodel_size` SUB_SIZE and a `submodel_overlap` worked out from the
    views' GPS positions (`synthetic_images.submodel_overlap`: each cluster
    gains its two nearest outside views), then `create_tracks` and
    `reconstruct` in each submodel and `align_submodels`, all through the
    command runner on the card: 2 submodels of 9-11 views sharing >= 4,
    each reconstructed whole, rows 1 and 2 launched, the aligned centres
    graded against the render's truth in the shared topocentric frame with
    no similarity fit, the shots two submodels share agreeing after the
    alignment (the SUB_ bounds below: 3.5 times the larger CPU reading of
    the two packages, half the smaller count),
    the alignment's seconds, steps, costs, Jacobian shape and peak device
    memory, and the alignment solve of the same constraints on the card
    against the CPU (SUB_ALIGN_STEPS steps, 1e-9 relative on the
    parameters).  (b) Phase 3's map
    (256 x 32,768 x tracks of 8, f64) through the BundleAdjuster facade
    with relative motions to each instance's next 4, relative rotations,
    common positions, linear motions, up vectors, a 64 x 64 heatmap prior
    on 16 instances, two reconstructions' scale variables (one shared) and
    a gauge fix, solved once with `compute_covariances=True`: the cost
    falls, rows 1-2 (or 3-5) launch, the covariances are symmetric, finite
    and positive on the diagonal; the same at phase 5's 32 x 4,096 on the
    card against the CPU (phase 5's tolerance, covariances within 1e-8);
    one LM step of the 64 x 8,192 dense problem with every pose-graph
    family on the fused dense assembly against the canonical route's.
22. statistics, the report and the synthetic circle scene.  (a) The
    port's `synthetic_data` builds tests/test_reconstruction_incremental.py's
    circle scene (seed 42 from a `RandomState`: 20 shots, ~5,000 points,
    10 GCPs, a GPS bias of (10, 0, 100) m) and
    `reconstruction.incremental_reconstruction` runs on the card with that
    test's three config keys, graded by `synthetic_scene.compare` within
    upstream's bounds (CIRCLE_BOUNDS) with the GPS bias recovered; rows 1
    and 2 must launch (a mono perspective map); its statistics and the four
    figures on the card against the CPU (bit-equal images; drawing ms).
    (b) `compute_statistics` and `export_report` through the command runner
    on a copy of phase 15's dataset on the card, `compute_statistics
    --device cpu` on a second copy: stats.json card = CPU (STATS_REL),
    every figure bit-equal, report.pdf well formed (`read_pdf`: xref
    offsets, streams, >= 4 A4 pages, the section titles in order, each
    image its PNG's pixels); each command's seconds and the figures'.
23. the sharded bundle (`opensfm_tpu_torch.parallel`) on a virtual mesh
    of SHARDS shards on the card.  (a) Phase 3's map (256 x 32,768 x
    tracks of 8) on the dense-grid route, f64, against the single-device
    `bundle_adjust` (the SHARD_ gates below: relative final cost, every
    parameter, equal iterations), and f32 against the f64 solve; rows 3,
    4 and 5 launch shards x trials (row 3 once more a shard, the initial
    cost).  (b) The assembled-Schur route at SHARD_SMALL on an optimized
    rig camera with up-vector rows and on relative motions with scale
    variables (the pose-graph gates), row 1 on the Schur cost.  (c) One
    fixed-lambda CG step against the replicated-dense step
    (SHARD_CG_TOL), and a short CG solve (row 1 on its cost).  (d)
    SHARD_RANKS processes of a gloo group, each with 2 shards on the card:
    their replicated outputs equal each other and one process's mesh of 4.
    (e) With more than one card, the map on `default_mesh()` and through
    the `bundle` command; on one card the phase says that this run did
    not happen.  Each run's seconds, trials and peak device memory.
24. the GCP annotation tool (`opensfm_tpu_torch.annotation`) on phase 22's
    circle as reconstructed on the card, split by shot id into two
    sequences of 10 shots (`write_annotation_dataset`), the second moved by
    ANNOT_SIMILARITY: every GCP clear of the triangulation's thresholds,
    the similarity recovered from the common GCPs within the ANNOT_ bounds,
    `run_ba.align` in rigid, flex and full on the card (seconds, GCP RMS
    within ANNOT_MAX_RMS, the bundle's route with its rows launched, full's
    covariances valid), full on the CPU (card vs CPU within ANNOT_REL) and
    one POST /analyze full through the tool's server.
Then the {"reconstruct": {...}}, {"image_chain": {...}},
{"merge_and_algorithms": {...}}, {"models": {...}}, {"rig_chain": {...}},
{"akaze_chain": {...}}, {"vocab_chain": {...}}, {"pose_graph": {...}},
{"statistics": {...}}, {"sharded": {...}} and {"annotation": {...}} JSON
lines, the card's name and power limit, one {"kernels": [...]} JSON line
(each row's `launches_sharded` read over phase 23's sharded runs, each BA
row's `launches_annotation` over phase 24's three modes on the card), and
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
# uint8 inputs: the exact u8 x u8 -> s32 tensor-core product (H100 SXM data
# sheet: 1,979 TOP/s INT8, dense), the card's rate for that type.
PEAK_INT8_OPS = 1979e12
# Floating-point operations per observation slot, counted from csrc/
# (sin/cos/sqrt/div counted as one each, a fused multiply-add as two): the
# forward chain and cost (with a rotation per observation); the forward
# chain with the 24 Jacobian entries; that plus the assembly's weighting,
# masks, per-point sums, Schur factor and 81 slot sums; and the
# back-substitution's contracted chain (backsub_u, 133 with SoftLOne's
# weight) and its three slot sums.  The dense cost (cost_dense_kernel) does
# the chain from the table's rotation coefficients (chain_fwd's overload:
# 48), SoftLOne's cost (13) and its sum (1) per slot, and a rotation
# (Rodrigues without derivatives: 13, as in FLOPS_COST_OBS) per instance.
FLOPS_COST_OBS = 75
FLOPS_COST_DENSE_SLOT = 62
FLOPS_ROTATION = 13
FLOPS_RESJAC_OBS = 330
FLOPS_ASSEMBLE_SLOT = 830
FLOPS_BACKSUB_SLOT = 136
REPO = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()  # phase lines carry the seconds since start
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
    "top2_sqdist": (
        "opensfm_tpu_torch/csrc/top2.cu",
        "opensfm_tpu/ops/pallas_kernels/top2.py:195"),
    "assembly_variant": (
        "opensfm_tpu_torch/csrc/assembly_variants.cu",
        "profile_kernel_variants.py:115"),
}
DENSE_KERNELS = ("fused_cost_dense", "fused_schur_assembly",
                 "fused_back_substitute")
BA_KERNELS = ("fused_residual_jacobian", "fused_cost") + DENSE_KERNELS


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    if msg.startswith("phase"):
        msg += f"  [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def kernel_inputs(problem, dtype, device, ragged, seed: int):
    """The kernels' inputs from a problem: the canonical layout as it is,
    with ~5% of the slots padded (inv_sd = 0, uv = 0); or, `ragged` True, a
    random gathered subset of 100,003 observations (fewer for a small
    problem); or, `ragged` "tail", the canonical layout and 3 more
    observations drawn from it (O = 262,147 at the bundle shape: not a
    multiple of the residual/Jacobian kernel's 128-observation block); or,
    `ragged` an int n (not a bool), the canonical layout's first n
    observations."""
    rng = np.random.default_rng(seed)
    O = len(problem.obs_uv)
    if type(ragged) is int:
        sel = np.arange(ragged)
    elif ragged == "tail":
        sel = np.concatenate([np.arange(O), rng.choice(O, 3)])
    elif ragged:
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


def check_kernels(problem, large, dev="cuda"):
    """Phase 2: every kernel against its plain version on the card; the cost
    also on `large`, a map whose instances exceed the cost block's table."""
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K

    worst = {"fused_residual_jacobian": {}, "fused_cost": {}}
    dev = torch.device(dev)
    for dtype in (torch.float64, torch.float32):
        tol = TOL[dtype]
        for ragged in (False, True, "tail", 255, 1):
            args = kernel_inputs(problem, dtype, dev, ragged, seed=7)
            suffix, _ = K._check_cuda(*args, "TrivialLoss")
            plan = K.cost_plan(args[6].shape[0])
            tiled = 0.0
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
                rel = abs(float(tot) - float(tot_ref)) / max(
                    abs(float(tot_ref)), 1e-300)
                check(rel <= tol["total"],
                      f"total cost rel {rel:.3g} ({loss}, {dtype})")
                key = str(dtype).split(".")[-1]
                wc = worst["fused_cost"]
                wc[key] = max(wc.get(key, 0.0), abs(float(tot) - float(tot_ref)))
                # Determinism: the same inputs give the same bits.
                check(float(K.fused_cost(*args, loss, 1.0)) == float(tot),
                      "fused_cost is deterministic")
                # The instance table walked in tiles of 64 rows (the path of
                # a map larger than one table) sums in another order.
                tile = K._launch_cost(args, K.LOSS_IDS[loss], 1.0, suffix,
                                      plan, 64)
                rel = abs(float(tile) - float(tot_ref)) / max(
                    abs(float(tot_ref)), 1e-300)
                check(rel <= tol["total"], f"fused_cost in tiles of 64 "
                      f"instances, rel {rel:.3g} ({loss}, {dtype})")
                tiled = max(tiled, rel)
            layout = ("canonical head" if type(ragged) is int else
                      {False: "canonical", True: "ragged gathered",
                       "tail": "canonical + 3"}[ragged])
            check(ragged != "tail" or args[6].shape[0] % 128 != 0,
                  "the tail layout ends in a partial block")
            log(f"  {str(dtype)[6:]} {layout} O={args[6].shape[0]}: "
                f"5 losses within tolerance; fused_cost bit-equal twice "
                f"(plan {plan}), in tiles of 64 instances rel <= {tiled:.3g}")
        # An index outside its table gives NaN (on the card; the plain
        # version's indexing raises).
        if dev.type != "cuda":
            continue
        args = kernel_inputs(problem, dtype, dev, False, seed=7)
        for which, bad in ((3, args[0].shape[0]), (4, args[1].shape[0]),
                           (5, -1)):
            broken = list(args)
            broken[which] = args[which].clone()
            broken[which][args[6].shape[0] // 2] = bad
            tot = float(K.fused_cost(*broken, "SoftLOneLoss", 1.0))
            check(np.isnan(tot), f"fused_cost NaN for index {bad} in "
                  f"argument {which} ({dtype})")
        log(f"  {str(dtype)[6:]}: an instance, camera or point index outside "
            f"its table gives a NaN cost")
    # A map beyond one table: its instances in tiles, two batches a thread.
    for dtype in (torch.float64, torch.float32):
        args = kernel_inputs(large, dtype, dev, False, seed=7)
        n_inst, n_obs = args[0].shape[0], args[6].shape[0]
        rows = K.cost_table_rows(n_inst, args[6].element_size())
        plan = K.cost_plan(n_obs)
        check(rows < n_inst and plan[1] > K.COST_BATCH,
              f"the large map takes tiles and batches ({rows}, {plan})")
        for loss in LOSSES:
            tot = float(K.fused_cost(*args, loss, 1.0))
            tot_ref = float(K.fused_cost_plain(*args, loss, 1.0))
            rel = abs(tot - tot_ref) / abs(tot_ref)
            check(rel <= TOL[dtype]["total"], f"fused_cost on {n_inst} "
                  f"instances rel {rel:.3g} ({loss}, {dtype})")
            check(float(K.fused_cost(*args, loss, 1.0)) == tot,
                  "fused_cost is deterministic")
            wc = worst["fused_cost"]
            key = str(dtype)[6:]
            wc[key] = max(wc.get(key, 0.0), abs(tot - tot_ref))
        log(f"  {str(dtype)[6:]} {n_inst} instances O={n_obs}: fused_cost "
            f"in tiles of {rows} instances (plan {plan}), 5 losses within "
            f"tolerance, bit-equal twice")
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


# Ragged dense grids for phase 2 beside the 64 x 8,192 lane, as (NI, NP):
# 6 NI = 222 (not a multiple of the 64-wide product tile) with K = 3,000
# (not a multiple of the 16-row stage or of the split); the largest accepted
# NI (6 NI = 1,536); one instance.
DENSE_RAGGED = ((37, 1000), (256, 1280), (1, 128))


def check_dense_kernels(problems, dev="cuda"):
    """Phase 2, dense layout: the assembly, back-substitution and dense cost
    kernels against their plain versions on the card, on each problem's
    grid; the same inputs give the same bits twice, and S_II is exactly
    symmetric."""
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A

    worst = {name: {} for name in DENSE_KERNELS}
    for problem, dtype in [(p, d) for p in problems
                           for d in (torch.float64, torch.float32)]:
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
            check(bool(torch.isfinite(dxp).all()), f"dx_p finite ({loss})")
            check(torch.equal(dxp, A.fused_back_substitute(
                *base, want[0], *dx, loss, 1.0)),
                "fused_back_substitute is deterministic")
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
            # The instance table walked in tiles of 16 rows (the path of a
            # grid wider than one table) sums in another order.
            plan = A.cost_dense_plan(base[0].shape[0], base[2].shape[0],
                                     base[3].element_size())
            tiled = float(A._launch_cost_dense(
                base, *A._check_cuda(*base, loss), 1.0, plan[:2] + (16,)))
            rel = abs(tiled - tot_ref) / abs(tot_ref)
            check(rel <= tol["total"], f"dense cost in tiles of 16 instances "
                  f"{key} rel {rel:.3g} ({loss})")
        # Dead slots count: a NaN point whose slots are all dead gives NaN
        # in both versions.
        ni = base[0].shape[0]
        pts, isd = base[2].clone(), base[4].clone()
        pts[1] = float("nan")
        isd[ni:2 * ni] = 0.0
        nan_args = (base[0], base[1], pts, base[3], isd)
        check(np.isnan(float(A.fused_cost_dense(*nan_args, "SoftLOneLoss",
                                                1.0)))
              and np.isnan(float(A.fused_cost_dense_plain(
                  *nan_args, "SoftLOneLoss", 1.0))),
              f"dense cost NaN from a dead NaN slot ({key})")
        log(f"  {key} dense {base[2].shape[0]} x {ni}: 5 losses within "
            f"tolerance; dense cost bit-equal twice (plan {plan}), in tiles "
            f"of 16 instances, NaN from dead NaN slots")
    return worst


# Dense grids wider than the dense cost's instance table, as (NI, NP,
# dtype): two tiles of cost_table_rows (1,365 instances f64, 2,730 f32).
COST_DENSE_WIDE = ((1500, 128, torch.float64), (3000, 128, torch.float32))


def check_cost_dense_wide(make_problem, worst, dev="cuda"):
    """Phase 2: the dense cost on COST_DENSE_WIDE, within TOL_DENSE of its
    plain version, bit-equal across two calls."""
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A

    for ni, n_p, dtype in COST_DENSE_WIDE:
        key = str(dtype)[6:]
        base, _, _ = dense_kernel_inputs(make_problem(ni, n_p), dtype,
                                         torch.device(dev), seed=11)
        plan = A.cost_dense_plan(ni, n_p, base[3].element_size())
        check(plan[2] < ni < 2 * plan[2] + 1,
              f"{ni} instances take two table tiles ({plan})")
        for loss in LOSSES:
            tot = float(A.fused_cost_dense(*base, loss, 1.0))
            tot_ref = float(A.fused_cost_dense_plain(*base, loss, 1.0))
            rel = abs(tot - tot_ref) / abs(tot_ref)
            check(rel <= TOL_DENSE[dtype]["total"], f"dense cost on {ni} "
                  f"instances {key} rel {rel:.3g} ({loss})")
            check(float(A.fused_cost_dense(*base, loss, 1.0)) == tot,
                  "fused_cost_dense is deterministic")
            w = worst["fused_cost_dense"]
            w[key] = max(w.get(key, 0.0), abs(tot - tot_ref))
        log(f"  {key} dense {n_p} x {ni}: dense cost in two table tiles "
            f"(plan {plan}), 5 losses within tolerance, bit-equal twice")


def check_launches_1_3_5(big, dense64, calls: int = 20):
    """Rows 1, 3 and 5's device kernels per call at the path's shapes (f64):
    one torch.profiler trace of `calls` calls of each, its kernels counted
    by name (and no other device activity); each count must read the
    wrapper's stated one.  Run after phase 8's traces, which then see the
    profiler as before, and before phase 10's long trace, after which the
    profiler may miss events."""
    from torch.profiler import ProfilerActivity, profile

    from opensfm_tpu_torch.ops.kernels import ba_assemble as A
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K

    args = kernel_inputs(big, torch.float64, torch.device("cuda"), False, 3)
    base, extras, dx = dense_kernel_inputs(dense64, torch.float64,
                                           torch.device("cuda"), seed=13)
    out_pt = A.fused_schur_assembly(*base, *extras, "SoftLOneLoss", 1.0)[0]
    fns = {"fused_cost": lambda: K.fused_cost(*args, "SoftLOneLoss", 1.0),
           "fused_cost_dense": lambda: A.fused_cost_dense(
               *base, "SoftLOneLoss", 1.0),
           "fused_back_substitute": lambda: A.fused_back_substitute(
               *base, out_pt, *dx, "SoftLOneLoss", 1.0)}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    _, n_dev, rows = device_time(prof)
    per_call = {name: sum(n for _, n, k in rows
                          if f"::{ROW_KERNEL[name]}<" in k) / calls
                for name in fns}
    stated = {"fused_cost": K.KERNELS_PER_CALL["fused_cost"],
              "fused_cost_dense": A.KERNELS_PER_CALL["fused_cost_dense"],
              "fused_back_substitute":
                  A.KERNELS_PER_CALL["fused_back_substitute"]}
    check(n_dev == sum(per_call.values()) * calls,
          f"rows 1, 3 and 5's trace holds only their kernels ({n_dev} "
          f"events)")
    for name, n in per_call.items():
        check(n == stated[name], f"{name}: {n} launches per call traced, "
              f"{stated[name]} stated")
    log(f"  rows 1, 3 and 5, launches per call ({calls} calls each traced): "
        f"{per_call}")
    return per_call


def _wrappers():
    from opensfm_tpu_torch.ops.kernels import assembly_variants as V
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K
    from opensfm_tpu_torch.ops.kernels import top2 as T

    return {name: next(getattr(m, name) for m in (K, A, T, V)
                       if hasattr(m, name))
            for name in KERNELS}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0
    top2 = _wrappers()["top2_sqdist"]
    top2.launches_masked = 0
    for key in top2.launches_by_input:
        top2.launches_by_input[key] = 0


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


def _time_ms(fn, backlog: bool = True) -> float:
    """Median of 25 CUDA-event timings on the card, the L2 flushed before
    each: the port's one timer (`time_ms` of the ablation profiler), so
    every row of the kernels line is timed alike.  Without `backlog` the
    time takes in the host's launch (the wrapper's Python checks)."""
    from opensfm_tpu_torch.tools.profile_kernel_variants import time_ms

    return time_ms(fn, torch.device("cuda"), backlog=backlog)


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
                  None, obs + fb,
                  slots * FLOPS_COST_DENSE_SLOT + ni * FLOPS_ROTATION)


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


def device_time(prof):
    """(busy ms, count, [(ms, count, name)] largest first) of the device
    activity (kernels and copies) in a torch.profiler trace, summed from its
    raw events: parsing ~10^6 of them into key_averages() takes minutes."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows


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

    # Device kernels only (the aten ops above them carry the same time).
    busy, count, rows = device_time(prof)
    log(f"  {label}: one LM trial (step + cost), f64, dense={dense}: host wall "
        f"{wall:.2f} ms under the profiler, device busy {busy:.2f} ms in "
        f"{count} kernels")
    for ms, n, name in rows[:14]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {name[:90]}")

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


def trace_schur_assembly(problem, calls: int = 5):
    """Phase 7: `fused_schur_assembly`'s four sub-kernels, device ms per call
    from a trace of `calls` calls, f64 and f32; and the product step's
    yardstick on the same f64 bmat: torch.mm(bmat.T, bmat) (cuBLAS on the
    f64 tensor cores), traced alike and timed with `_time_ms`.  The port
    never calls it, and it is no library form of row 4: it computes the
    product step alone.  Returns {dtype: {sub-kernel: ms}} and the
    yardstick's ms."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from opensfm_tpu_torch.ops.kernels import ba_assemble as A

    loss = "SoftLOneLoss"

    def traced(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        _, _, rows = device_time(prof)
        out = {}
        for ms, _, name in rows:
            hit = re.search(r"(\w+_kernel)\b", name)
            key = hit.group(1) if hit else name[:60]
            out[key] = out.get(key, 0.0) + ms / calls
        return out

    split = {}
    for dtype in (torch.float64, torch.float32):
        base, extras, _ = dense_kernel_inputs(problem, dtype,
                                              torch.device("cuda"), seed=13)
        key = str(dtype)[6:]
        split[key] = traced(
            lambda: A.fused_schur_assembly(*base, *extras, loss, 1.0))
        log(f"  fused_schur_assembly {key}, device ms per call ({calls} "
            f"calls traced): " + ", ".join(
                f"{k} {v:.4f}" for k, v in split[key].items()))
        check(any("syrk_dmma_kernel" in k for k in split[key])
              == (dtype == torch.float64),
              f"{key}: the product runs on the f64 tensor cores in f64 only")
    base, extras, _ = dense_kernel_inputs(problem, torch.float64,
                                          torch.device("cuda"), seed=13)
    bmat = A.schur_terms_plain(*base, *extras, loss, 1.0)[1].contiguous()
    s_ii = A.fused_schur_assembly(*base, *extras, loss, 1.0)[1]
    rel = _rel(torch.mm(bmat.T, bmat), s_ii)
    check(rel <= TOL_DENSE[torch.float64]["out"],
          f"S_II against torch.mm(bmat.T, bmat): rel {rel:.3g}")
    mm_trace = sum(traced(lambda: torch.mm(bmat.T, bmat)).values())
    mm_ms = _time_ms(lambda: torch.mm(bmat.T, bmat))
    log(f"  product yardstick, f64 bmat {list(bmat.shape)}: syrk_dmma_kernel "
        f"{split['float64']['syrk_dmma_kernel']:.4f} ms per call (trace); "
        f"torch.mm(bmat.T, bmat) {mm_trace:.4f} ms (trace), {mm_ms:.4f} ms "
        f"(L2 flushed, median of 25); S_II within {rel:.3g} of it")
    return split, mm_ms


# --------------------------------------------------------------------------
# match_features: the top-2 descriptor search and the command
# --------------------------------------------------------------------------

MATCH_SHOTS = 32  # images of the matching dataset (496 pairs)
MATCH_POINTS = 16384  # 3D points, each seen from its 8 nearest images
MATCH_FEATURES = 8192  # per image: ~4,096 true, the rest distractors
# The WORDS subset: 6 images, 15 pairs (cut from 8 images and 28 pairs for
# the script's time: 61 s under the profiler on a slower host; its checks
# are rates and counts of these pairs).
WORDS_IMAGES = 6
# Floor of the written matches' precision and recall against the true
# correspondences.  The generator's descriptor noise (+-3 per byte, ~1,000
# of squared distance) is far below the distance between unrelated uint8
# descriptors (~1.4 M), and its image noise (5e-4) far below the RANSAC
# thresholds (0.004), so a correct matcher loses almost nothing.
MIN_PRECISION = 0.99
MIN_RECALL = 0.95
TOP2_FLOAT_TOL = 1e-4  # float descriptors: |dist - plain| / (sq1 + max sq2)


def _top2_inputs(n, m, d, seed, dtype=torch.uint8, near=True):
    """Random descriptors on the card; with `near`, half of the database
    rows are noisy copies of query rows, so the best candidates are decided
    by small gaps."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randint(0, 256, (n, d), generator=g, device="cuda",
                      dtype=torch.int32)
    b = torch.randint(0, 256, (m, d), generator=g, device="cuda",
                      dtype=torch.int32)
    if near:
        k = min(n, m) // 2
        noise = torch.randint(-3, 4, (k, d), generator=g, device="cuda",
                              dtype=torch.int32)
        b[:k] = torch.clamp(a[:k] + noise, 0, 255)
    mask = torch.rand((n, m), generator=g, device="cuda") < 0.25
    if dtype == torch.uint8:
        return a.to(torch.uint8), b.to(torch.uint8), mask
    return (torch.randn((n, d), generator=g, device="cuda"),
            torch.randn((m, d), generator=g, device="cuda"), mask)


def top2_launches_per_call(a, b, msk):
    """Device kernels per `top2_sqdist` call, from a trace of 20 calls (None
    when the trace holds no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    from opensfm_tpu_torch.ops.kernels import top2 as T

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            T.top2_sqdist(a, b, b.shape[0], msk)
        torch.cuda.synchronize()
    _, n_dev, _ = device_time(prof)
    return n_dev / 20 if n_dev else None


def check_top2():
    """Phase 8: the top-2 kernel against its plain version on the card.
    Returns the worst absolute distance error (uint8: must be 0; float) and
    the launches per call at the path's shape, unmasked and masked (traced
    here, before phase 10's long trace, after which the profiler may miss
    events)."""
    from opensfm_tpu_torch.ops.kernels import top2 as T

    worst = {"uint8": 0.0, "float32": 0.0}  # max |kernel - plain| over cases
    # Ragged N, M and D; N < 16 (part of one warp's rows); uint8 D = 200
    # (the FP32 kernel, still bitwise) and D = 300 (the FP32 kernel, where
    # products may round).
    cases = [(8192, 8192, 128), (1000, 777, 129), (5, 3, 128),
             (300, 4099, 128), (129, 1, 64), (9, 2000, 96), (513, 1500, 200),
             (700, 900, 300)]
    for n, m, d in cases:
        for dtype in (torch.uint8, torch.float32):
            a, b, mask = _top2_inputs(n, m, d, seed=n + m + d, dtype=dtype)
            exact = dtype == torch.uint8 and d <= T.U8_BITWISE_MAX_D
            for n2 in (m, max(m - 37, 0)):
                for msk in (None, mask):
                    got = T.top2_sqdist(a, b, n2, msk)
                    want = T.top2_sqdist_plain(a, b, n2, msk)
                    again = T.top2_sqdist(a, b, n2, msk)
                    torch.cuda.synchronize()
                    tag = (f"{n}x{m}x{d} {str(dtype)[6:]} n2={n2} "
                           f"{'masked' if msk is not None else 'plain'}")
                    check(torch.equal(got[0], again[0])
                          and torch.equal(got[1], again[1]),
                          f"top2 deterministic ({tag})")
                    fin = torch.isfinite(want[1])
                    check(torch.equal(torch.isfinite(got[1]), fin),
                          f"top2 inf pattern ({tag})")
                    err = (got[1] - want[1]).abs()[fin]
                    if exact:
                        e8 = float(err.max()) if err.numel() else 0.0
                        worst["uint8"] = max(worst["uint8"], e8)
                        check(e8 == 0.0 and torch.equal(got[1], want[1]),
                              f"top2 distances bitwise, err {e8} ({tag})")
                        check(torch.equal(got[0], want[0]),
                              f"top2 indices bitwise ({tag})")
                        continue
                    af, bf = a.float(), b[:max(n2, 1)].float()
                    scale = ((af * af).sum(1, keepdim=True)
                             + (bf * bf).sum(1).max()).expand_as(fin)
                    rel = float((err / scale[fin]).max()) if err.numel() else 0.0
                    check(rel <= TOP2_FLOAT_TOL, f"top2 float rel {rel:.3g} "
                          f"({tag})")
                    worst["float32"] = max(worst["float32"], float(err.max())
                                           if err.numel() else 0.0)
                    gap = (want[1][:, 1] - want[1][:, 0]) > \
                        TOP2_FLOAT_TOL * scale[:, 0]
                    check(torch.equal(got[0][gap], want[0][gap]),
                          f"top2 float indices where the gap is clear ({tag})")
        u8_txt = "bitwise" if d <= T.U8_BITWISE_MAX_D else \
            f"within {TOP2_FLOAT_TOL:g}"
        route = "tensor cores" if d <= T.U8_MAX_D else "FP32 route"
        log(f"  {n} x {m} x {d}: uint8 {u8_txt} ({route}), float within "
            f"{TOP2_FLOAT_TOL:g}, unmasked and masked")
    # Ties: the lowest column wins and the second distance equals the first.
    a = torch.zeros((3, 128), dtype=torch.uint8, device="cuda")
    b = torch.full((3000, 128), 9, dtype=torch.uint8, device="cuda")
    b[2100] = 0
    b[2900] = 0
    idx, dist = T.top2_sqdist(a, b, 3000)
    check(idx[:, 0].tolist() == [2100] * 3 and float(dist.abs().max()) == 0,
          "top2 ties go to the lowest column with d2 == d1")
    # Norms near 255^2 * 258: their float32 sum rounds above 2^24, which the
    # FP32 kernel (the route of uint8 sets wider than U8_MAX_D) must round
    # as the plain version does.
    g = torch.Generator(device="cuda").manual_seed(3)
    a = 255 - torch.randint(0, 4, (600, 258), generator=g, device="cuda",
                            dtype=torch.int32)
    b = torch.cat([a[:300] ^ 1, 255 - torch.randint(
        0, 4, (700, 258), generator=g, device="cuda", dtype=torch.int32)])
    a, b = a.to(torch.uint8), b.to(torch.uint8)
    check(float((a.float() ** 2).sum(1).min() * 2) > 2 ** 24,
          "the wide case's norm sums exceed 2^24")
    for msk in (None, torch.rand((600, 1000), generator=g, device="cuda")
                < 0.5):
        got = T.top2_sqdist(a, b, 1000, msk)
        want = T.top2_sqdist_plain(a, b, 1000, msk)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              "top2 bitwise where the norms' float32 sum rounds")
    a, b, mask = _top2_inputs(MATCH_FEATURES, MATCH_FEATURES, 128, seed=21)
    splits, _ = T.split_columns(MATCH_FEATURES, MATCH_FEATURES)
    expect = 1 if splits == 1 else 2  # the search, and the slice merge
    per_call = {}
    for key, msk in (("unmasked", None), ("masked", mask)):
        per_call[key] = top2_launches_per_call(a, b, msk)
        check(per_call[key] == expect,
              f"top2 {key}: {per_call[key]} launches per call traced, "
              f"{expect} expected")
    log(f"  launches per call at {MATCH_FEATURES}^2 x 128: {per_call}")
    return worst, per_call


def write_matching_dataset(path, **kw):
    import synthetic_bundle as sb

    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    tracks = sb.write_matching_dataset(
        path, n_shots=MATCH_SHOTS, n_points=MATCH_POINTS, track_window=8,
        features_per_image=MATCH_FEATURES, seed=5, **kw)
    log(f"  dataset written in {time.perf_counter() - t0:.1f} s: "
        f"{MATCH_SHOTS} images x {MATCH_FEATURES} features")
    return tracks


def _timed(owner, name, acc):
    """Wraps owner.name to add its wall time to acc[name]; returns the
    original.  The wrapped calls end in host copies of their results, so
    the host clock measures the device work too."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(owner, name, wrapper)
    return fn


def run_match_command(path, tracks, label, n_images, trace=False):
    """Runs `match_features` on the card through the command runner and
    scores the written matches; returns (top2 launches, scores, wall,
    seconds by stage: feature IO, descriptor matching with its IO, RANSAC,
    saving the matches).  With `trace`, the whole command runs under
    torch.profiler (device activity only) and the stages also hold the
    device busy seconds over its wall."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    import synthetic_bundle as sb
    from opensfm_tpu_torch import matching
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.ops.kernels import top2 as T

    stages = {}
    wrapped = [(DataSet, "load_features"), (DataSet, "save_matches"),
               (matching, "_match_descriptors_impl"),
               (matching, "robust_match")]
    originals = [_timed(owner, name, stages) for owner, name in wrapped]
    prof = profile(activities=[ProfilerActivity.CUDA]) if trace else \
        contextlib.nullcontext()
    reset_launches()
    try:
        with prof:
            t0 = time.perf_counter()
            pairs = command_runner(opensfm_commands,
                                   argv=["match_features", path, "--device",
                                         "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (owner, name), fn in zip(wrapped, originals):
            setattr(owner, name, fn)
    if trace:
        t1 = time.perf_counter()
        busy_ms, n_dev, rows = device_time(prof)
        check(n_dev > 0, f"{label}: the trace holds device activity")
        stages["device_busy"] = busy = busy_ms / 1e3
        log(f"  {label} under the profiler (device activity): {wall:.2f} s "
            f"of wall, device busy {busy:.3f} s ({100 * busy / wall:.2f} %) "
            f"in {n_dev} kernels and copies (read in "
            f"{time.perf_counter() - t1:.1f} s)")
        for ms, n, name in rows[:8]:
            log(f"    {ms:10.3f} ms  x{n:<7d} {name[:80]}")
    launches_top2 = T.top2_sqdist.launches
    n_pairs = n_images * (n_images - 1) // 2
    check(len(pairs) == n_pairs, f"{label}: {len(pairs)} pairs matched")
    check(launches_top2 == 2 * n_pairs,
          f"{label}: {launches_top2} top2 launches, two per pair")
    data = DataSet(path)
    precision, recall, total = sb.match_scores(data, tracks)
    survived = sum(1 for m in pairs.values() if len(m))
    log(f"  {label}: {wall:.2f} s, {n_pairs} pairs, {survived} with robust "
        f"matches, {total} matches, precision {precision:.5f}, recall "
        f"{recall:.5f}; top2 launches {launches_top2}; seconds in "
        f"load_features {stages.get('load_features', 0):.2f}, descriptor "
        f"matching (with its loads) "
        f"{stages.get('_match_descriptors_impl', 0):.2f}, RANSAC "
        f"{stages.get('robust_match', 0):.2f}, save_matches "
        f"{stages.get('save_matches', 0):.2f}")
    check(precision >= MIN_PRECISION, f"{label}: precision {precision:.4f}")
    check(recall >= MIN_RECALL, f"{label}: recall {recall:.4f}")
    report = json.loads(data.load_report("matches.json"))
    check(report["num_pairs"] == n_pairs, f"{label}: report pairs")
    return launches_top2, (precision, recall, total, survived), wall, stages


def _jaccard(a, b) -> float:
    a, b = set(map(int, a)), set(map(int, b))
    return len(a & b) / max(len(a | b), 1)


def run_match_vs_cpu(path, n_pairs=4):
    """Phase 11: the descriptor matches and RANSAC of a few pairs on the card
    and on the CPU, the same draws (from one CPU generator) injected into
    both."""
    from opensfm_tpu_torch import feature_loader, matching
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.robust import ransac

    data = DataSet(path)
    cam = data.load_camera_models()["synthetic_camera"]
    images = data.images()
    thr = data.config["robust_matching_calib_threshold"]
    for j in range(1, n_pairs + 1):
        im1, im2 = images[0], images[j]
        desc = {}
        for dev in ("cuda", "cpu"):
            desc[dev] = matching._match_descriptors_impl(
                im1, im2, cam, cam, data, data.config,
                device=torch.device(dev))[2]
        check(np.array_equal(desc["cuda"], desc["cpu"]),
              f"{im1}-{im2}: card and CPU descriptor matches identical")
        p1 = feature_loader.instance.load_all_data(data, im1, True).points
        p2 = feature_loader.instance.load_all_data(data, im2, True).points
        m = desc["cpu"]
        b1 = cam.bearings_many(p1[m[:, 0], :2])
        b2 = cam.bearings_many(p2[m[:, 1], :2])
        n = len(m)
        samples = np.concatenate([ransac.draw_subsets(99, ci, [n],
                                                      ransac.CHUNK, 5)[0]
                                  for ci in range(2)])
        res = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = ransac.ransac_essential(b1, b2, thr, iterations=1000,
                                               device=dev, samples=samples)
            res[dev + "_s"] = time.perf_counter() - t0
        jac = _jaccard(res["cuda"].inliers_indices, res["cpu"].inliers_indices)
        log(f"  {im1}-{im2}: {n} descriptor matches (identical); inliers "
            f"card {res['cuda'].num_inliers}, CPU {res['cpu'].num_inliers}, "
            f"Jaccard {jac:.5f}; RANSAC card {res['cuda_s']:.3f} s, CPU "
            f"{res['cpu_s']:.3f} s")
        check(jac >= 0.99, f"{im1}-{im2}: inlier Jaccard {jac:.4f}")
    feature_loader.instance.clear_cache()


def time_top2(rows, per_call):
    """Phase 12: the top-2 kernel at the path's shape, 8,192 x 8,192 x 128
    uint8, unmasked and masked, beside its bound, its plain version and one
    eager PyTorch expression (addmm for the distances, then topk)."""
    from opensfm_tpu_torch.ops.kernels import top2 as T

    n = m = MATCH_FEATURES
    d = 128
    a, b, mask = _top2_inputs(n, m, d, seed=21)

    def library():
        af, bf = a.float(), b.float()
        sq = (bf * bf).sum(1)
        dist = torch.addmm((af * af).sum(1, keepdim=True) + sq, af, bf.T,
                           beta=1.0, alpha=-2.0)
        return torch.topk(dist, 2, dim=1, largest=False)

    def library_masked():
        af, bf = a.float(), b.float()
        dist = torch.addmm((af * af).sum(1, keepdim=True) + (bf * bf).sum(1),
                           af, bf.T, beta=1.0, alpha=-2.0)
        dist.masked_fill_(~mask, float("inf"))
        return torch.topk(dist, 2, dim=1, largest=False)

    # The INT8 library form (timed only; the port never calls it): both sets
    # shifted by -128 to int8 (distances do not change under a common
    # shift), torch._int_mm for the dot products, int32 distances, topk.
    a8 = (a.to(torch.int16) - 128).to(torch.int8)
    b8 = (b.to(torch.int16) - 128).to(torch.int8)
    sq_a8 = (a8.to(torch.int32) ** 2).sum(1, keepdim=True)
    sq_b8 = (b8.to(torch.int32) ** 2).sum(1)
    imax = torch.iinfo(torch.int32).max

    def library_int8(msk=None):
        dist = sq_a8 + sq_b8 - 2 * torch._int_mm(a8, b8.T)
        if msk is not None:
            dist.masked_fill_(~msk, imax)
        return torch.topk(dist, 2, dim=1, largest=False)

    check(torch.equal(library_int8()[0].to(torch.float32),
                      T.top2_sqdist_plain(a, b, m)[1]),
          "the INT8 library form gives the same distances")

    flops = 2 * n * m * d
    out_bytes = n * (2 * 4 + 4)
    for key, msk, lib in (("unmasked", None, library),
                          ("masked", mask, library_masked)):
        nbytes = (n + m) * d + out_bytes + (n * m if msk is not None else 0)
        ms = _time_ms(lambda: T.top2_sqdist(a, b, m, msk))
        ms_call = _time_ms(lambda: T.top2_sqdist(a, b, m, msk), backlog=False)
        ms_plain = _time_ms(lambda: T.top2_sqdist_plain(a, b, m, msk))
        ms_lib = _time_ms(lib)
        ms_int8 = _time_ms(lambda: library_int8(msk))
        n_launch = per_call[key]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_INT8_OPS * 1e3  # uint8 descriptors
        rows.setdefault("top2_sqdist", {})[key] = dict(
            ms=ms, call_ms=ms_call, plain_ms=ms_plain, library_ms=ms_lib,
            library_int8_ms=ms_int8, launches_per_call=n_launch,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, flops=flops)
        log(f"  top2_sqdist {key} {n}x{m}x{d} uint8: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TOP/s, {n_launch} launches; call "
            f"with host launch {ms_call:.4f} ms), bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GOP), plain {ms_plain:.4f} ms, addmm + topk "
            f"{ms_lib:.4f} ms, _int_mm + topk {ms_int8:.4f} ms")


def profile_match_pair(path):
    """Phase 12: torch.profiler over one warm pair's `match` on the card
    (the two searches and RANSAC): device time by kernel, host wall, and
    the search and RANSAC shares of the wall."""
    from torch.profiler import ProfilerActivity, profile

    from opensfm_tpu_torch import matching
    from opensfm_tpu_torch.dataset import DataSet

    data = DataSet(path)
    cam = data.load_camera_models()["synthetic_camera"]
    im1, im2 = data.images()[0], data.images()[1]
    dev = torch.device("cuda")
    matching.match(im1, im2, cam, cam, data, data.config, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1, p2, m, _ = matching._match_descriptors_impl(im1, im2, cam, cam, data,
                                                    data.config, device=dev)
    t_desc = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = matching.robust_match(p1, p2, cam, cam, m, data.config, device=dev)
    t_rob = time.perf_counter() - t0
    log(f"  one pair ({im1}, {im2}), warm, no profiler: descriptor matching "
        f"{t_desc * 1e3:.1f} ms ({len(m)} matches), RANSAC "
        f"{t_rob * 1e3:.1f} ms ({len(r)} inliers)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        matching.match(im1, im2, cam, cam, data, data.config, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    busy, count, rows = device_time(prof)
    log(f"  one pair's match under the profiler: host wall {wall:.1f} ms, "
        f"device busy {busy:.2f} ms in {count} kernels")
    for ms, n, name in rows[:12]:
        log(f"    {ms:9.3f} ms  x{n:<6d} {name[:90]}")
    return dict(desc_ms=t_desc * 1e3, ransac_ms=t_rob * 1e3,
                profiled_wall_ms=wall, device_busy_ms=busy)


# --------------------------------------------------------------------------
# create_tracks + reconstruct: the main path on the card (phase 14)
# --------------------------------------------------------------------------

# Images of the card-vs-CPU subset: 4 (cut from 8 for the script's time:
# card 9.3 s and CPU 33.6 s at 8, 6.7 and 21.3 s at 6 on a slower host;
# the check, the same shots within CARD_CPU_CENTRE_TOL, keeps its bound).
RECON_SUBSET = 4
# Bounds on the reconstruction of phase 9's dataset against the generator's
# truth (synthetic_bundle.grade_reconstruction), set from CPU runs of the
# same chain before the first card run (truth matches, track windows of 3
# and 8): 6 images x 600 points read centre RMS 4.1e-3 m, point RMS
# 8.2e-3 m, reprojection RMS 4.1e-4; 16 x 4,096 read 1.5e-3 m, 5.4e-3 m,
# 5.09e-4 (NOISE is 5e-4).
MAX_CENTRE_RMS = 0.01  # m, after a similarity fit to the true centres
MAX_POINT_RMS = 0.02  # m, same fit, over the tracks of one true point
MAX_REPROJ_RMS = 1.5  # x NOISE, over the observations the map keeps
MAX_MISMATCHED = 0.01  # share of points whose track mixes true points
# Card vs CPU on the subset, the same draws (CPU generators): the largest
# camera-centre difference, in the same (GPS) frame.
CARD_CPU_CENTRE_TOL = 1e-4  # m
# A resection round of 8 candidates against 1: device launches may grow by
# this factor at most (one batched computation per chunk).
ROUND_LAUNCH_GROWTH = 1.1


def _trace(fn):
    """(result, kernels, copies, device busy ms, wall ms) of one call of
    `fn` under torch.profiler (device activity), after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n, rows = device_time(prof)
    copies = sum(k for _, k, name in rows
                 if name.startswith(("Memcpy", "Memset")))
    return out, n - copies, copies, busy, wall


def recon_breakdown(report):
    """Where `reconstruct`'s time went, from its report: the stages, the
    bundles of each kind (count, setup s, run s, LM routes), the resection
    rounds and the triangulation calls with their sizes."""
    from collections import Counter

    out = {"compute_image_pairs_s": report["wall_times"]["compute_image_pairs"],
           "compute_reconstructions_s":
               report["wall_times"]["compute_reconstructions"],
           "bootstrap_s": 0.0, "grow_s": 0.0}
    bundles = {k: [] for k in ("global", "local", "shot_poses")}
    rounds, tri, retri = [], [], []
    resection_s = 0.0
    for rec in report["reconstructions"]:
        out["bootstrap_s"] += rec.get("bootstrap_time", 0.0)
        boot = rec["bootstrap"]
        bundles["shot_poses"] += boot.get("bundle_shot_poses", [])
        if "retriangulation" in boot:
            retri.append(boot["retriangulation"])
        if "grow" not in rec:
            continue
        out["grow_s"] += rec["grow_time"]
        grow = rec["grow"]
        bundles["global"] += [grow["bundle_initial"], grow["bundle_final"]]
        for step in grow["steps"]:
            bundles["shot_poses"].append(step["bundle_shot_poses"])
            bundles["global"] += [step[k] for k in (
                "bundle", "bundle_after_retriangulation") if k in step]
            if "local_bundle" in step:
                bundles["local"].append(step["local_bundle"])
            rounds += step["resection_rounds"]
            resection_s += step["resection_time"]
            tri.append(step["triangulation"])
            if "retriangulation" in step:
                retri.append(step["retriangulation"])
    out["bundles"] = {k: dict(
        count=len(v), setup_s=sum(b["wall_times"]["setup"] for b in v),
        run_s=sum(b["wall_times"]["run"] for b in v),
        routes=dict(Counter(b["route"] for b in v)))
        for k, v in bundles.items()}
    out["resection"] = dict(rounds=len(rounds), seconds=resection_s,
                            candidates=dict(Counter(rounds)))
    out["triangulation"] = dict(
        calls=len(tri), seconds=sum(t["time"] for t in tri),
        tracks=[t["tracks"] for t in tri], rays=max(
            (t["rays"] for t in tri), default=0))
    out["retriangulation"] = dict(
        calls=len(retri), seconds=sum(r["wall_time"] for r in retri),
        tracks=[r["triangulation"]["tracks"] for r in retri])
    return out


def _subset_card_vs_cpu(match_path, dev="cuda", images=None, base=None):
    """Phase 14's card-vs-CPU check: `reconstruct` of a RECON_SUBSET-image
    subset (the first RECON_SUBSET images by default; the dataset's matches among them, one
    tracks.csv) on the card and on the CPU; the RANSAC draws come from CPU
    generators, so both see the same samples."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    base = base or os.path.join(WORK, "recon_subset")
    images = images or [sb.shot_id(i) for i in range(RECON_SUBSET)]
    sb.subset_dataset(match_path, base, images, matches=True)
    command_runner(opensfm_commands,
                   argv=["create_tracks", base, "--device", dev])
    recs, secs = {}, {}
    for name, on in (("card", dev), ("cpu", "cpu")):
        path = f"{base}_{name}"
        shutil.rmtree(path, ignore_errors=True)
        shutil.copytree(base, path)
        t0 = time.perf_counter()
        command_runner(opensfm_commands,
                       argv=["reconstruct", path, "--device", on])
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        recs[name] = DataSet(path).load_reconstruction()
    card, cpu = recs["card"], recs["cpu"]
    check(len(card) == len(cpu) == 1, "subset: one reconstruction each")
    check(set(card[0].shots) == set(cpu[0].shots) == set(images),
          f"subset: the card and the CPU reconstruct the same "
          f"{len(images)} shots")
    diff = max(float(np.linalg.norm(card[0].shots[s].pose.get_origin()
                                    - cpu[0].shots[s].pose.get_origin()))
               for s in images)
    log(f"  card vs CPU, {len(images)}-image subset: card "
        f"{secs['card']:.2f} s, CPU {secs['cpu']:.2f} s; points "
        f"{len(card[0].points)} / {len(cpu[0].points)}; largest centre "
        f"difference {diff:.3e} m (bound {CARD_CPU_CENTRE_TOL:g})")
    check(diff < CARD_CPU_CENTRE_TOL, f"subset centres within "
          f"{CARD_CPU_CENTRE_TOL:g} m of the CPU's ({diff:.3e})")
    return dict(card_s=secs["card"], cpu_s=secs["cpu"],
                max_centre_diff_m=diff)


def run_reconstruct(match_path, feature_points, dev="cuda"):
    """Phase 14: `create_tracks` then `reconstruct` on phase 9's dataset and
    matches, on the card through the command runner; the result graded
    against the generator's truth, the time broken down, the kernels'
    launches read around `reconstruct`, a resection round (B = 1, 8) and a
    triangulation (two sizes) traced for their launches, one growth step
    traced for the device's busy share, and a 4-image subset on the card
    against the CPU."""
    import copy

    import synthetic_bundle as sb
    from opensfm_tpu_torch import multiview
    from opensfm_tpu_torch import reconstruction as R
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    path = match_path
    t0 = time.perf_counter()
    command_runner(opensfm_commands,
                   argv=["create_tracks", path, "--device", dev])
    tracks_s = time.perf_counter() - t0
    data = DataSet(path)
    trep = json.loads(data.load_report("tracks.json"))
    log(f"  create_tracks: {tracks_s:.2f} s ({json.dumps(trep['wall_times'])}); "
        f"{trep['num_tracks']} tracks over {trep['num_images']} images; "
        f"paths {trep['paths']}")

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = command_runner(opensfm_commands,
                            argv=["reconstruct", path, "--device", dev])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    log(f"  reconstruct: {wall:.2f} s; kernel launches {counts}")
    for name in ("fused_residual_jacobian", "fused_cost"):
        check(counts[name] > 0, f"{name} launched during reconstruct")

    recs = DataSet(path).load_reconstruction()
    tm = DataSet(path).load_tracks_manager()
    shots, points = sb.matching_scene(MATCH_SHOTS, MATCH_POINTS, seed=5)
    grade = sb.grade_reconstruction(recs, tm, feature_points, shots, points)
    log(f"  graded against the truth: {json.dumps(grade)}")
    check(grade["reconstructions"] == 1, "one reconstruction")
    check(grade["shots"] == MATCH_SHOTS, f"{grade['shots']} of "
          f"{MATCH_SHOTS} shots reconstructed")
    check(grade["centre_rms"] < MAX_CENTRE_RMS,
          f"centre RMS {grade['centre_rms']:.3e} m")
    check(grade["point_rms"] < MAX_POINT_RMS,
          f"point RMS {grade['point_rms']:.3e} m")
    check(grade["reprojection_rms"] < MAX_REPROJ_RMS * sb.NOISE,
          f"reprojection RMS {grade['reprojection_rms']:.3e}")
    check(grade["points_mismatched"] <= MAX_MISMATCHED * grade["points"],
          f"{grade['points_mismatched']} points mix true points")

    brk = recon_breakdown(report)
    log(f"  where the time went: image pairs "
        f"{brk['compute_image_pairs_s']:.2f} s, bootstrap "
        f"{brk['bootstrap_s']:.2f} s, growth loop {brk['grow_s']:.2f} s")
    for kind, b in brk["bundles"].items():
        log(f"    {kind} bundles: {b['count']}, setup {b['setup_s']:.2f} s, "
            f"run {b['run_s']:.2f} s, LM routes {b['routes']}")
    log(f"    resection: {brk['resection']['rounds']} rounds "
        f"(candidates per round: {brk['resection']['candidates']}), "
        f"{brk['resection']['seconds']:.2f} s")
    log(f"    triangulation: {brk['triangulation']['calls']} calls of "
        f"{brk['triangulation']['tracks']} tracks (up to "
        f"{brk['triangulation']['rays']} rays), "
        f"{brk['triangulation']['seconds']:.2f} s; retriangulation "
        f"{brk['retriangulation']['calls']} calls of "
        f"{brk['retriangulation']['tracks']} tracks, "
        f"{brk['retriangulation']['seconds']:.2f} s")

    # Launches of one resection round at B = 1 and B = 8 candidates.
    rec = recs[0]
    dev = torch.device(dev)
    cfg = data.config
    gathered = [R._resect_gather(data, tm, rec, s)[0]
                for s in sorted(rec.shots)[:8]]
    per_b = {}
    for B in (1, 8):
        _, k, c, busy, ms = _trace(lambda: multiview.absolute_pose_ransac_batched(
            [g[0] for g in gathered[:B]], [g[1] for g in gathered[:B]],
            cfg["resection_threshold"], 1000, device=dev))
        per_b[B] = dict(kernels=k, copies=c, busy_ms=busy, wall_ms=ms,
                        rows=[len(g[0]) for g in gathered[:B]])
    log(f"  resection round, traced: {json.dumps(per_b)}")
    check(per_b[8]["kernels"] <= ROUND_LAUNCH_GROWTH * per_b[1]["kernels"],
          "a round of 8 candidates launches no more than one of 1 "
          f"({per_b[8]['kernels']} vs {per_b[1]['kernels']})")

    # Launches of one triangulate_tracks call at two sizes.
    tri_rec = copy.deepcopy(rec)
    track_ids = sorted(rec.points)
    per_n = {}
    for n in (1000, len(track_ids)):
        def run(n=n):
            tri_rec.points = {}
            return R.triangulate_tracks(track_ids[:n], tm, tri_rec, cfg,
                                        device=dev)
        size, k, c, busy, ms = _trace(run)
        per_n[n] = dict(size, kernels=k, copies=c, busy_ms=busy, wall_ms=ms)
    log(f"  triangulate_tracks, traced: {json.dumps(per_n)}")
    k_small, k_big = (per_n[n]["kernels"] for n in per_n)
    check(k_big <= ROUND_LAUNCH_GROWTH * k_small,
          f"triangulation launches do not grow with the tracks "
          f"({k_big} vs {k_small})")

    # The device's busy share over one growth step: the last shot taken
    # out and added back (resection, pose bundle, triangulation, local
    # bundle).
    camera_priors = data.load_camera_models()
    step_shot = sorted(rec.shots)[MATCH_SHOTS // 2]

    def growth_step():
        r = copy.deepcopy(rec)
        r.remove_shot(step_shot)
        ok, new_shots, _, _ = R.resect_candidates_batched(
            data, tm, r, [step_shot], cfg["resection_threshold"],
            cfg["resection_min_inliers"], device=dev)
        check(ok, "the traced growth step resects its shot")
        R.bundle_shot_poses(r, new_shots, camera_priors, {}, cfg, device=dev)
        R.triangulate_shot_features(tm, r, new_shots, cfg, device=dev)
        R.bundle_local(r, camera_priors, {}, None, step_shot, cfg,
                       device=dev)

    _, k, c, busy, ms = _trace(growth_step)
    step = dict(kernels=k, copies=c, busy_ms=busy, wall_ms=ms,
                busy_share=busy / ms)
    log(f"  one growth step, traced: {ms:.1f} ms of wall, device busy "
        f"{busy:.1f} ms ({100 * busy / ms:.2f} %), {k} kernels, {c} copies")

    vs_cpu = _subset_card_vs_cpu(match_path, str(dev))
    return dict(create_tracks_s=tracks_s, reconstruct_s=wall,
                launches=counts, grade=grade, breakdown=brk,
                resection_round=per_b, triangulation=per_n,
                growth_step=step, subset_vs_cpu=vs_cpu)


# --------------------------------------------------------------------------
# From images to a reconstruction (phase 15)
# --------------------------------------------------------------------------

IMAGE_VIEWS, IMAGE_W, IMAGE_H = 16, 2048, 1536  # feature_process_size 2048
IMAGE_STEP_DEG = 10.0  # degrees between neighbouring views on the circle
# Phase 15's configuration over the defaults: the JAX package's own AUTO
# outlier filter.  The default FIXED threshold (0.006 of the image size) is
# 12.3 px at 2,048 x 1,536, where it keeps the ~1.5 % of observations that
# pull the bundle's optimum, and which of them survive moves with the hash
# seed (PERF.md §6); AUTO drops them.
IMAGE_CONFIG = {"bundle_outlier_filtering_type": "AUTO"}
# Bounds on phase 15's reconstruction against the render's truth
# (synthetic_images.grade_reconstruction), set from CPU runs of smaller
# renders of the same 16 views through both packages
# (image_chain_study.py, the default config otherwise): centre RMS 5.8e-3
# m (the port) and 5.6e-3 m (the JAX package) at 640 x 480, 6.2e-3 m and
# 1.38e-2 m at 1,024 x 768; reprojection RMS 0.27-0.39 px.  The bound is
# 3.5 times the larger, the JAX package's 1.38e-2 m.  A run's reading
# depends on Python's per-process string-hash seed (set iteration order)
# in both packages: at 640 x 480 on fixed features, hash seeds 1 and 2 read
# 5.4e-3 and 7.6e-3 m through the port, 6.0e-3 and 6.4e-3 m through the
# JAX package; at 2,048 x 1,536 separate runs read 1.36e-2 and 1.85e-2 m
# on the CPU (the second on the card's features) and 1.38e-2 to 1.70e-2 m
# on the card (H100).  A broken reconstruction (a wrong basin, a flipped
# pair) reads decimetres to metres.
IMAGE_MAX_CENTRE_RMS = 0.05  # m, after a similarity fit to the true centres
IMAGE_MAX_REPROJ_PX = 1.0  # px of the larger side, observations within 0.006
# Card vs CPU detector tolerances: tests/test_torch_features.py's, the JAX
# package's CPU run there standing in for the CPU here.
DETECT_POS_TOL, DETECT_POS_REL_TOL = 1e-3, 1e-3  # px (99 %), of the size
DETECT_ANGLE_TOL, DETECT_UNMATCHED = 2.5, 0.005
# View 0 decoded by the port's JPEG codec against its render: this bound was
# set before the first card run from a CPU reading of the same view at
# 2,048 x 1,536 (image_chain_study.py --codec-only: 47.268 dB, 371,060
# bytes at cv2.imwrite's defaults), 1 dB below it; the card's render
# rounds a little otherwise, its codec is the same host code.
JPEG_MIN_PSNR_DB = 46.27


# Phase 15's dense stages (run_all's mesh, undistort, compute_depthmaps).
# Bounds on merged.ply against the render's scene
# (synthetic_images.grade_point_cloud through grade_reconstruction's
# similarity), re-derived for this configuration (JPEG views, IMAGE_CONFIG's
# AUTO outlier filter) before its first card run, by the rule that set the
# PNG / FIXED ones: CPU runs of the same 16 views at 640 x 480 through both
# packages (image_chain_study.py --jpeg --config
# '{"bundle_outlier_filtering_type": "AUTO"}', PYTHONHASHSEED=1; the
# depthmaps are 640 wide there as here, so the readings carry over), 3.5
# times the larger distance reading, half the smaller point count.  The
# port read 442,523 points, median 1.0558e-2 m, 90th percentile 2.996e-2
# m; the JAX package (cv2 reading the same JPEGs) 442,449, 7.958e-3 m and
# 2.609e-2 m (all 16 shots with depthmaps in both; centre RMS 5.68e-3 and
# 4.47e-3 m, reprojection 0.224 and 0.221 px, under the sparse bounds
# above, which keep their 1,024 x 768 derivation).
DENSE_MAX_MEDIAN_M = 0.0370  # m, median distance to the nearest surface
DENSE_MAX_P90_M = 0.1049  # m, 90th percentile
DENSE_MIN_POINTS = 221224
DENSE_MAX_PEAK_BYTES = 8 << 30  # one shot's PatchMatch on the card
DENSE_PM_WIDTH = 160  # the card-vs-CPU PatchMatch (the CPU's time)
DENSE_TRACE_WIDTHS = (320, 640, 1280)  # one half-iteration traced at each
# Card vs CPU PatchMatch at DENSE_PM_WIDTH: the mean over PM_SEEDS of the
# share of the pixels confident on both whose depths agree within 1 %.
# Near-ties flip with each device's rounding, so the share moves by seed and
# shot: patchmatch_agreement_study.py on this scene (H100 80GB HBM3, 700 W;
# 61 runs, all 16 shots, 16 seeds of this phase's shot) read 98.76 % on
# average, 98.20 % to 99.19 %, a shot's mean 98.35 % to 99.13 % and a
# shot's single-run sd at most 0.29 points.  The bound is the lowest shot
# mean less three such sds of a mean of four seeds (3 x 0.288 / 2).
PM_SEEDS = (42, 43, 44, 45)  # 42 is the main path's
PM_AGREE_MEAN = 0.979


def _detector_partners(pa, pb):
    """For each keypoint of pa, the index of pb's keypoint of the same
    position and scale (within 1e-2) with the nearest angle, each used
    once; -1 where none is."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pb[:, :3])
    used = np.zeros(len(pb), bool)
    out = np.full(len(pa), -1)
    for i, cand in enumerate(tree.query_ball_point(pa[:, :3], 1e-2,
                                                   p=np.inf)):
        cand = [j for j in cand if not used[j]]
        if cand:
            ang = np.abs((pb[cand, 3] - pa[i, 3] + 180.0) % 360.0 - 180.0)
            j = cand[int(np.argmin(ang))]
            out[i] = j
            used[j] = True
    return out


def detect_card_vs_cpu(image_gray, config, dev="cuda"):
    """One image's HAHOG detection (extract_dog_features at the config's
    first peak threshold and budget) on the card and on the CPU, held to
    the CPU tests' tolerances: keypoint sets, positions, scales, angles,
    uint8 descriptors within +-1 on >= 99.9 % of entries."""
    from opensfm_tpu_torch.ops import features as ops

    kw = dict(peak_threshold=max(float(config["hahog_peak_threshold"]), 1e-7),
              target_features=config["feature_min_frames"], root_uchar=True,
              detector="hessian", n_orientations=2,
              edge_threshold=float(config["hahog_edge_threshold"]))
    t0 = time.perf_counter()
    pc, dc = ops.extract_dog_features(image_gray, device=dev, **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp, dp = ops.extract_dog_features(image_gray, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    j = _detector_partners(pp, pc)
    ok = j >= 0
    a, b = pp[ok], pc[j[ok]]
    dxy = np.abs(a[:, :2] - b[:, :2]).max(axis=1)
    same = np.abs((a[:, 3] - b[:, 3] + 180.0) % 360.0 - 180.0) \
        <= DETECT_ANGLE_TOL
    diff = np.abs(dp[ok][same].astype(int) - dc[j[ok]][same].astype(int))
    out = dict(card_keypoints=len(pc), cpu_keypoints=len(pp),
               unmatched_cpu=int((~ok).sum()),
               unmatched_card=int(len(pc) - ok.sum()),
               pos_p99_px=float(np.quantile(dxy, 0.99)),
               pos_max_rel=float((dxy / a[:, 2]).max()),
               scale_max_rel=float((np.abs(a[:, 2] - b[:, 2]) / a[:, 2]).max()),
               angle_flips=int((~same).sum()),
               desc_within_1=float((diff <= 1).mean()),
               card_s=card_s, cpu_s=cpu_s)
    log(f"  detector card vs CPU, one {image_gray.shape[1]} x "
        f"{image_gray.shape[0]} image: {json.dumps(out)}")
    check(out["unmatched_cpu"] <= DETECT_UNMATCHED * len(pp)
          and out["unmatched_card"] <= DETECT_UNMATCHED * len(pc),
          "card and CPU keypoint sets agree")
    check(out["pos_p99_px"] <= DETECT_POS_TOL
          and out["pos_max_rel"] <= DETECT_POS_REL_TOL,
          "card and CPU keypoint positions agree")
    check(out["scale_max_rel"] <= 1e-6, "card and CPU scales agree")
    check(out["angle_flips"] <= DETECT_UNMATCHED * int(ok.sum()),
          "card and CPU angles agree")
    check(out["desc_within_1"] >= 0.999, "card and CPU descriptors agree")
    return out


def _pm_inputs(udata, rec, shot_id, neighbours, width, dev):
    """patch_match_depthmap's arguments and options for one undistorted
    shot and its neighbours at depthmap width `width`, from the builders
    that `dense.compute_depthmap` calls."""
    from opensfm_tpu_torch import dense

    inputs = dense.shot_inputs(udata, rec, [shot_id] + list(neighbours),
                               shot_id, width, dev)
    return dense.patch_match_inputs(*inputs, udata.config, dev)


def pm_card_vs_cpu(args, options, seed, dev="cuda"):
    """One shot's patch_match_depthmap on the card and on the CPU with the
    draws of `seed`: the seconds of each, the share of pixels each scores
    above 0.7 (confident), and the share of the pixels confident on both
    whose depths agree within 1 %."""
    from opensfm_tpu_torch.ops import depthmap

    t0 = time.perf_counter()
    card = depthmap.patch_match_depthmap(*args, **options, seed=seed,
                                         device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = depthmap.patch_match_depthmap(*args, **options, seed=seed,
                                        device="cpu")
    cpu_s = time.perf_counter() - t0
    conf = (card[2] > 0.7) & (cpu[2] > 0.7)
    agree = np.abs(card[0] - cpu[0]) <= 0.01 * np.abs(cpu[0])
    return dict(seed=seed, card_s=card_s, cpu_s=cpu_s,
                confident_card=float((card[2] > 0.7).mean()),
                confident_cpu=float((cpu[2] > 0.7).mean()),
                confident_both=float(conf.mean()),
                agree_share=float(agree[conf].mean()) if conf.any() else 0.0)


def dense_figures(udata, rec, neighbours, dev="cuda"):
    """Phase 15's PatchMatch figures on its shot with the most neighbours,
    all through the inputs that `dense.compute_depthmap` builds: one
    shot's patch_match_depthmap at the default width on the card (wall s,
    peak device memory above what was allocated before), the same at
    DENSE_PM_WIDTH on the card and on the CPU with the draws of each of
    PM_SEEDS (their mean share held to PM_AGREE_MEAN), and one
    half-iteration traced at each of DENSE_TRACE_WIDTHS with the main
    path's chunks of neighbours (its launches may grow with the chunk
    count, and with nothing else) for its busy share."""
    from opensfm_tpu_torch.ops import depthmap

    sid = max(sorted(neighbours), key=lambda s: len(neighbours[s]))
    nbs = neighbours[sid]
    n = len(nbs)
    width = int(udata.config["depthmap_resolution"])
    out = {"shot": sid, "neighbours": n, "width": width}
    args, options = _pm_inputs(udata, rec, sid, nbs, width, dev)
    p2 = options["patch_size"] ** 2
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depthmap.patch_match_depthmap(*args, **options, device=dev)
    torch.cuda.synchronize()
    out["patch_match_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    H, W = args[0].shape
    out["chunk"] = depthmap.neighbour_chunk(p2, H, W, n)
    out["half_iteration_chunk"] = depthmap.neighbour_chunk(
        p2, (H * W + 1) // 2, 1, n)
    log(f"  PatchMatch of {sid} ({n} neighbours, {W} x {H}, "
        f"{options['iterations']} iterations, chunks of {out['chunk']}, of "
        f"{out['half_iteration_chunk']} in half-iterations): "
        f"{out['patch_match_s']:.3f} s, peak "
        f"{out['peak_bytes'] / 2**30:.3f} GiB")
    check(out["peak_bytes"] < DENSE_MAX_PEAK_BYTES,
          f"one shot's PatchMatch peak {out['peak_bytes'] / 2**30:.2f} GiB "
          f"< {DENSE_MAX_PEAK_BYTES / 2**30:.0f} GiB")

    small, small_options = _pm_inputs(udata, rec, sid, nbs, DENSE_PM_WIDTH,
                                      dev)
    runs = [pm_card_vs_cpu(small, small_options, seed, dev)
            for seed in PM_SEEDS]
    for r in runs:
        log(f"  PatchMatch card vs CPU at {DENSE_PM_WIDTH} wide: "
            f"{json.dumps(r)}")
        check(r["confident_both"] > 0.5 * r["confident_cpu"],
              f"seed {r['seed']}: the card and the CPU confident at "
              "mostly the same pixels")
    shares = [r["agree_share"] for r in runs]
    out["vs_cpu"] = dict(width=DENSE_PM_WIDTH, runs=runs,
                         agree_mean=float(np.mean(shares)),
                         agree_min=float(np.min(shares)))
    check(out["vs_cpu"]["agree_mean"] >= PM_AGREE_MEAN,
          f"PatchMatch card vs CPU: depths within 1 % at a mean "
          f"{out['vs_cpu']['agree_mean']:.4f} of confident pixels over "
          f"{len(PM_SEEDS)} seeds (>= {PM_AGREE_MEAN})")

    trace = {}
    for w in DENSE_TRACE_WIDTHS:
        a, o = _pm_inputs(udata, rec, sid, nbs, w, dev)
        H, W = a[0].shape
        rays, arrays = depthmap.prepare(*a[:8], o["patch_size"], dev)
        statics = (a[8], a[9], depthmap.MIN_PATCH_VARIANCE)
        rng = np.random.default_rng(0)
        nu = torch.as_tensor(depthmap.random_init(rng, a[1], a[8], a[9]),
                             dtype=torch.float32, device=dev)
        s, k, d = depthmap._score_candidate(nu, *arrays, *statics)
        nd, nn = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                  for x in depthmap.random_refinements(rng, H, W))
        _, kernels, c, busy, ms = _trace(
            lambda: depthmap._pm_half_iteration(
                (nu, d, s, k), 0, nd, nn, rays, *arrays, *statics))
        chunk = depthmap.neighbour_chunk(p2, (H * W + 1) // 2, 1, n)
        trace[w] = dict(height=H, chunk=chunk, chunks=-(-n // chunk),
                        kernels=kernels, copies=c, busy_ms=busy, wall_ms=ms,
                        busy_share=busy / ms)
        log(f"  one half-iteration at {W} x {H}: {json.dumps(trace[w])}")
    out["half_iteration"] = trace
    first = trace[DENSE_TRACE_WIDTHS[0]]
    for w in DENSE_TRACE_WIDTHS[1:]:
        t = trace[w]
        check(t["kernels"] * first["chunks"] <= first["kernels"] * t["chunks"],
              f"half-iteration launches grow with the chunk count only "
              f"({first['kernels']} in {first['chunks']} chunks at "
              f"{DENSE_TRACE_WIDTHS[0]} wide, {t['kernels']} in "
              f"{t['chunks']} at {w})")
    check(max(t["chunks"] for t in trace.values()) > 1,
          "a traced width splits the neighbours into chunks")
    return out


def jpeg_figures(path, truth_rgb, detect_s):
    """The port's JPEG codec on the card's host: every view decoded and
    encoded again (ms an image), the share of `detect_features` decoding
    took, and view 0 decoded against its render (PSNR, held to
    JPEG_MIN_PSNR_DB)."""
    from opensfm_tpu_torch import io

    images = sorted(os.listdir(os.path.join(path, "images")))
    decode_ms, encode_ms = [], []
    for name in images:
        t0 = time.perf_counter()
        rgb = io.imread(os.path.join(path, "images", name))
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        io.encode_jpeg(rgb)
        encode_ms.append(1e3 * (time.perf_counter() - t0))
    view0 = io.imread(os.path.join(path, "images", images[0]))
    err = view0.astype(np.float64) - truth_rgb
    psnr = float(10 * np.log10(255.0**2 / np.mean(err**2)))
    out = dict(decode_ms_mean=float(np.mean(decode_ms)),
               decode_ms_max=float(np.max(decode_ms)),
               encode_ms_mean=float(np.mean(encode_ms)),
               encode_ms_max=float(np.max(encode_ms)),
               decode_share_of_detect_features=float(
                   sum(decode_ms) / 1e3 / detect_s),
               view0_psnr_db=psnr, bytes_mean=float(np.mean([
                   os.path.getsize(os.path.join(path, "images", n))
                   for n in images])),
               decode_ms=decode_ms, encode_ms=encode_ms)
    log(f"  JPEG codec on the host, {len(images)} views of {IMAGE_W} x "
        f"{IMAGE_H}: {json.dumps(out)}")
    check(psnr >= JPEG_MIN_PSNR_DB,
          f"view 0 decoded by the port at {psnr:.2f} dB PSNR against its "
          f"render (>= {JPEG_MIN_PSNR_DB})")
    return out


def run_image_chain(dev="cuda"):
    """Phase 15: IMAGE_VIEWS views rendered on the card and written as
    JPEGs (the port's codec) with EXIF in APP1, then `run_all` through the
    command runner at IMAGE_CONFIG (its eight stages); the sparse result
    graded against the render's truth, each stage's wall time, the
    detector's per-image figures (one image traced), the kernels' launches
    over the chain, one image's detection on the card against the CPU, the
    codec's figures (`jpeg_figures`); then the dense outputs: every shot's
    mesh, the undistorted JPEGs and reconstruction, every shot's
    depthmaps, `merged.ply` graded against the scene, and
    `dense_figures`."""
    import synthetic_images as si
    from opensfm_tpu_torch import features, io
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet, UndistortedDataSet

    path = os.path.join(WORK, "image_chain")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    truth = si.write_image_dataset(path, IMAGE_VIEWS, IMAGE_W, IMAGE_H,
                                   seed=0, device=dev,
                                   step_deg=IMAGE_STEP_DEG,
                                   config=IMAGE_CONFIG, image_format="jpg")
    render_s = time.perf_counter() - t0
    log(f"  rendered and wrote {IMAGE_VIEWS} JPEGs of {IMAGE_W} x {IMAGE_H} "
        f"in {render_s:.1f} s")

    reset_launches()
    t0 = time.perf_counter()
    run_all = command_runner(opensfm_commands,
                             argv=["run_all", path, "--device", dev])
    torch.cuda.synchronize()
    run_all_s = time.perf_counter() - t0
    counts = launches()
    stages = {k: v["wall_s"] for k, v in run_all.items()}
    reports = {k: v["report"] for k, v in run_all.items()}
    log(f"  run_all {run_all_s:.1f} s; stage wall s: {json.dumps(stages)}")
    log(f"  kernel launches over the chain: {counts}")
    for name in ("top2_sqdist", "fused_residual_jacobian", "fused_cost"):
        check(counts[name] > 0, f"{name} launched in the image chain")

    data = DataSet(path)
    config = data.config
    per_image = reports["detect_features"]["images"]
    n_feat = {im: r["features"] for im, r in per_image.items()}
    detect_ms = [1e3 * r["detect_s"] for r in per_image.values()]
    log(f"  features per image: {n_feat}")
    check(len(n_feat) == IMAGE_VIEWS and min(n_feat.values())
          >= config["feature_min_frames"],
          f"every view has >= {config['feature_min_frames']} features")
    exif = data.load_exif(data.images()[0])
    check(exif["make"] == si.MAKE and exif["gps"]
          and exif["focal_ratio"] == si.FOCAL_35MM / 36.0,
          "EXIF read through the port's parser")

    # One image's detection traced: device busy time and kernels.
    image = data.load_image(data.images()[0])
    _, k, c, busy, ms = _trace(lambda: features.extract_features(
        image, config, False, device=dev))
    detect = dict(wall_ms_mean=float(np.mean(detect_ms)),
                  wall_ms_min=float(np.min(detect_ms)),
                  wall_ms_max=float(np.max(detect_ms)),
                  traced_wall_ms=ms, traced_busy_ms=busy,
                  busy_share=busy / ms, kernels_per_image=k,
                  copies_per_image=c)
    log(f"  detect_features per image: {json.dumps(detect)}")

    recs = data.load_reconstruction()
    grade = si.grade_reconstruction(recs, truth, data.load_tracks_manager())
    cam = next(iter(max(recs, key=lambda r: len(r.shots)).cameras.values()))
    grade.update(focal=cam.focal, k1=cam.k1, k2=cam.k2)
    log(f"  graded against the render's truth (true focal "
        f"{si.FOCAL_35MM / 36.0:.6f}, k1 = k2 = 0): "
        f"{json.dumps({k: v for k, v in grade.items() if k != 'rotation'})}")
    check(grade["reconstructions"] == 1 and grade["shots"] == IMAGE_VIEWS,
          f"all {IMAGE_VIEWS} views in one reconstruction "
          f"({grade['shots']} shots, {grade['reconstructions']} "
          "reconstructions)")
    check(grade["centre_rms"] < IMAGE_MAX_CENTRE_RMS,
          f"centre RMS {grade['centre_rms']:.3e} m")
    check(grade["reprojection_rms_px"] < IMAGE_MAX_REPROJ_PX,
          f"reprojection RMS {grade['reprojection_rms_px']:.3f} px")

    vs_cpu = detect_card_vs_cpu(features.rgb_to_grey(image), config, dev)
    R0, c0 = si.view_poses(IMAGE_VIEWS, IMAGE_STEP_DEG)[0]
    codec = jpeg_figures(path, si.render_view(R0, c0, IMAGE_W, IMAGE_H,
                                              seed=0, device=dev),
                         stages["detect_features"])

    # The dense stages' outputs.
    meshed = data.load_reconstruction("reconstruction.meshed.json")[0]
    faces = {sid: len(s.mesh.faces) for sid, s in meshed.shots.items()}
    check(len(faces) == IMAGE_VIEWS and min(faces.values()) >= 1,
          f"every shot has a mesh (faces {min(faces.values())} to "
          f"{max(faces.values())})")
    udata = UndistortedDataSet(data, os.path.join(path, "undistorted"))
    und = sorted(os.listdir(os.path.join(path, "undistorted", "images")))
    sizes = {io.image_size(os.path.join(path, "undistorted", "images", f))
             for f in und}
    check(len(und) == IMAGE_VIEWS and all(f.endswith(".jpg") for f in und)
          and sizes == {(IMAGE_H, IMAGE_W)}
          and os.path.isfile(os.path.join(path, "undistorted",
                                          "reconstruction.json")),
          f"{IMAGE_VIEWS} undistorted {IMAGE_W} x {IMAGE_H} JPEGs and the "
          "undistorted reconstruction")
    dense_report = reports["compute_depthmaps"]
    neighbours = dense_report["neighbors"]
    with_depth = [s for s, n in neighbours.items() if n]
    check(len(with_depth) == IMAGE_VIEWS and all(
        udata.raw_depthmap_exists(s) and udata.clean_depthmap_exists(s)
        and udata.pruned_depthmap_exists(s) for s in with_depth),
        f"raw, clean and pruned depthmaps of all {len(with_depth)} shots "
        "with neighbours")
    with open(udata.point_cloud_file()) as f:
        cloud = io.point_cloud_from_ply(f)[0]
    cloud_grade = si.grade_point_cloud(cloud, grade)
    log(f"  merged.ply graded against the scene: {json.dumps(cloud_grade)}")
    check(cloud_grade["points"] >= DENSE_MIN_POINTS,
          f"merged.ply has {cloud_grade['points']} >= {DENSE_MIN_POINTS} "
          "points")
    check(cloud_grade["median_m"] <= DENSE_MAX_MEDIAN_M
          and cloud_grade["p90_m"] <= DENSE_MAX_P90_M,
          f"merged.ply within {DENSE_MAX_MEDIAN_M} m (median) and "
          f"{DENSE_MAX_P90_M} m (90th percentile) of the scene")
    (urec,) = udata.load_undistorted_reconstruction()
    dense = dense_figures(udata, urec, neighbours, dev)
    dense.update({k: dense_report[k] for k in (
        "neighbors_s", "raw_s", "clean_s", "prune_s", "merge_s",
        "merged_points")})
    dense["raw_s_per_shot_mean"] = float(np.mean(list(
        dense_report["raw_s_per_shot"].values())))
    dense["new_stages_s"] = sum(stages[k] for k in (
        "mesh", "undistort", "compute_depthmaps"))
    log(f"  mesh, undistort and compute_depthmaps: "
        f"{dense['new_stages_s']:.1f} s; compute_depthmaps: raw "
        f"{dense['raw_s']:.1f} s ({dense['raw_s_per_shot_mean']:.3f} s a "
        f"shot), clean {dense['clean_s']:.1f} s, prune "
        f"{dense['prune_s']:.1f} s, merge {dense['merge_s']:.1f} s")
    return dict(render_s=render_s, run_all_s=run_all_s, stage_s=stages,
                launches=counts, features=n_feat, detect=detect,
                grade={k: v for k, v in grade.items() if k != "rotation"},
                detect_vs_cpu=vs_cpu, jpeg=codec,
                mesh_faces_min=min(faces.values()),
                undistort=reports["undistort"], point_cloud=cloud_grade,
                dense=dense)


# --------------------------------------------------------------------------
# The merge and the other algorithms (phase 16)
# --------------------------------------------------------------------------

# The merge's bounds: tests/test_reconstruction_incremental.py:233-234's.
MERGE_MAX_CENTRE_RMS = 0.05  # m, after a similarity fit to the truth
MERGE_MAX_ROTATION_RMS = 0.005  # rad, the same fit
# GPS and attitude noise of phase 16's metadata poses.
PRIOR_GPS_NOISE = 0.1  # m
PRIOR_ANGLE_NOISE = 0.1  # degrees
# Bounds on the triangulation and prior runs against the generator's truth,
# set from a CPU run of the same code on 12 images x 800 points before the
# first card run (merge: centre RMS 2.9e-3 m, rotation RMS 3.8e-4 rad;
# triangulation and prior: centre RMS 6.7e-3 m, point RMS 6.6e-3 m,
# reprojection RMS 1.02 x NOISE).
PRIOR_MAX_CENTRE_RMS = 0.02  # m
PRIOR_MAX_POINT_RMS = 0.03  # m
PRIOR_MAX_REPROJ_RMS = 1.5  # x NOISE


def _rotation_rms(rec, ids, shots):
    """RMS angle (rad) between each shot's rotation and the truth's after
    the rotation of the similarity that best maps the centres."""
    from opensfm_tpu_torch.geometry.pose import Pose

    est = np.array([rec.shots[s].pose.get_origin() for s in ids])
    idx = [int(s.split("_")[1].split(".")[0]) for s in ids]
    true_poses = [Pose(shots[i, :3], shots[i, 3:]) for i in idx]
    true = np.array([p.get_origin() for p in true_poses])
    e, t = est - est.mean(0), true - true.mean(0)
    U, _, Vt = np.linalg.svd(t.T @ e)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    Rf = U @ D @ Vt
    ang = []
    for s, p in zip(ids, true_poses):
        Re = rec.shots[s].pose.get_rotation_matrix()  # world to camera
        M = p.get_rotation_matrix() @ Rf @ Re.T
        ang.append(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1)))
    return float(np.sqrt(np.mean(np.square(ang))))


def _prior_dataset(match_path, out, n_shots, n_points, seed, rng):
    """A copy of a matching dataset (features, matches, tracks) whose EXIF
    carries metadata poses: the true centres plus PRIOR_GPS_NOISE and the
    true attitudes plus PRIOR_ANGLE_NOISE, as omega/phi/kappa."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch import geo
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.geometry import angles
    from opensfm_tpu_torch.geometry.pose import Pose

    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(match_path, out, ignore=shutil.ignore_patterns(
        "reconstruction*.json", "reports", "reference_lla.json"))
    data = DataSet(out)
    shots, _ = sb.matching_scene(n_shots, n_points, seed=seed)
    ref = geo.TopocentricConverter(*sb.GPS_ORIGIN)
    for i, image in enumerate(data.images()):
        pose = Pose(shots[i, :3], shots[i, 3:])
        noise = Pose(np.radians(rng.normal(0, PRIOR_ANGLE_NOISE, 3)))
        R = noise.get_rotation_matrix() @ pose.get_rotation_matrix()
        opk = angles.opk_from_rotation(R)
        check(np.abs(angles.rotation_from_opk(*opk) - R).max() < 1e-9,
              "the metadata attitude survives omega/phi/kappa")
        exif = data.load_exif(image)
        lat, lon, alt = ref.to_lla(
            *(pose.get_origin() + rng.normal(0, PRIOR_GPS_NOISE, 3)))
        exif["gps"] = {"latitude": lat, "longitude": lon, "altitude": alt,
                       "dop": PRIOR_GPS_NOISE}
        exif["opk"] = {"omega": float(np.degrees(opk[0])),
                       "phi": float(np.degrees(opk[1])),
                       "kappa": float(np.degrees(opk[2])), "accuracy": 0.1}
        data.save_exif(image, exif)
    return data


def run_merge_and_algorithms(match_path, feature_points, n_shots, n_points,
                             seed, dev="cuda"):
    """Phase 16: phase 14's reconstruction split into a thin-bridge pair as
    tests/test_reconstruction_incremental.py:167-236 splits its own, and
    reunited by merge_two_reconstructions on the card within that test's
    bounds; then `reconstruct --algorithm triangulation` and
    `reconstruct_from_prior` (on the triangulation's reconstruction)
    through the command runner on a copy whose metadata poses are the
    truth plus noise, graded against the truth.  Wall times, the bundles'
    LM routes and the bundle kernels' (rows 1-5) launches for each; each
    must launch some, on whichever route its problems take."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch import reconstruction as R
    from opensfm_tpu_torch.align import apply_similarity
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    shots_true, points_true = sb.matching_scene(n_shots, n_points, seed=seed)
    out = {}
    data = DataSet(match_path)
    tm = data.load_tracks_manager()
    rec = data.load_reconstruction()[0]
    shots = sorted(rec.shots)
    n = len(shots)
    r1, r2 = R._copy_reconstruction(rec), R._copy_reconstruction(rec)
    for s in shots:
        if s not in shots[: n * 2 // 3]:
            r1.remove_shot(s)
        if s not in shots[n // 2:]:
            r2.remove_shot(s)
    rng = np.random.default_rng(7)
    apply_similarity(r2, 1.0, np.eye(3), np.array([1.5, -0.9, 0.6]))
    pids = sorted(r2.points)
    keep = set(pids[:: max(1, len(pids) // 12)][:12])
    for pid in pids:
        if pid not in keep:
            r2.remove_point(pid)
    for i, pid in enumerate(sorted(keep)):
        if i % 3 != 0:  # 8 of 12 scattered, 4 clean
            r2.points[pid].coordinates = (
                np.asarray(r2.points[pid].coordinates)
                + rng.normal(0.0, 3.0, 3))
    reset_launches()
    t0 = time.perf_counter()
    merged = R.merge_two_reconstructions(r1, r2, data.config,
                                         tracks_manager=tm, data=data,
                                         device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    check(len(merged) == 1 and set(merged[0].shots) == set(shots),
          "the seeded merge reunites the thin-bridge pair")
    grade = sb.grade_reconstruction(merged, tm, feature_points, shots_true,
                                    points_true)
    grade["rotation_rms"] = _rotation_rms(merged[0], shots, shots_true)
    grade["settle_moved_m"] = merged[0].merge_settle_moved
    out["merge"] = dict(wall_s=wall, grade=grade, launches={
        k: counts[k] for k in BA_KERNELS})
    log(f"  seeded merge of {n * 2 // 3} + {n - n // 2} shots: "
        f"{json.dumps(out['merge'])}")
    check(grade["centre_rms"] < MERGE_MAX_CENTRE_RMS,
          f"merged centre RMS {grade['centre_rms']:.3e} m")
    check(grade["rotation_rms"] < MERGE_MAX_ROTATION_RMS,
          f"merged rotation RMS {grade['rotation_rms']:.3e} rad")
    check(sum(counts[k] for k in BA_KERNELS) > 0,
          "the bundle kernels launched in the merge")

    prior_path = os.path.join(WORK, "prior")
    _prior_dataset(match_path, prior_path, n_shots, n_points, seed,
                   np.random.default_rng(3))
    # The triangulation starts from the metadata poses; reconstruct_from_
    # prior then retriangulates and bundles its reconstruction.json.
    for name, argv, output in (
            ("triangulation", ["reconstruct", prior_path, "--algorithm",
                               "triangulation"], "reconstruction.json"),
            ("prior", ["reconstruct_from_prior", prior_path],
             "reconstruction.prior.json")):
        reset_launches()
        t0 = time.perf_counter()
        report = command_runner(opensfm_commands,
                                argv=argv + ["--device", dev])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        recs = DataSet(prior_path).load_reconstruction(output)
        grade = sb.grade_reconstruction(recs, tm, feature_points, shots_true,
                                        points_true)
        bundles = [report["bundle"]] if "bundle" in report else [
            b for step in report["steps"] for k, b in step.items()
            if k.startswith("bundle_")] + [report["bundle_final"]]
        out[name] = dict(wall_s=wall, grade=grade, launches={
            k: counts[k] for k in BA_KERNELS}, routes=sorted(
                {b["route"] for b in bundles}))
        log(f"  {name}: {json.dumps(out[name])}")
        check(grade["reconstructions"] == 1 and grade["shots"] == n_shots,
              f"{name}: all {n_shots} shots")
        check(grade["centre_rms"] < PRIOR_MAX_CENTRE_RMS,
              f"{name}: centre RMS {grade['centre_rms']:.3e} m")
        check(grade["point_rms"] < PRIOR_MAX_POINT_RMS,
              f"{name}: point RMS {grade['point_rms']:.3e} m")
        check(grade["reprojection_rms"] < PRIOR_MAX_REPROJ_RMS * sb.NOISE,
              f"{name}: reprojection RMS {grade['reprojection_rms']:.3e}")
        check(sum(counts[k] for k in BA_KERNELS) > 0,
              f"the bundle kernels launched in {name}")
    return out


# --------------------------------------------------------------------------
# Camera models, mixed maps, rigs and depth priors: the generic route
# (phase 17), and a rig from images (phase 18)
# --------------------------------------------------------------------------

MODEL_LABELS = ("brown", "fisheye_opencv", "fisheye624", "spherical",
                "brown+fisheye_opencv", "rig 4 cameras, optimized",
                "perspective+depth")
MODEL_SIZE = (256, 32768, 8)  # shots, points, track window: phase 3's
MODELS_VS_CPU_SHOTS, MODELS_VS_CPU_POINTS = 32, 4096  # phase 5's dense size
# Card vs CPU on each problem, 3 iterations: the states within this much
# of their largest entry (the sums run in other orders on the two).
MODELS_STATE_REL = 1e-9
MIXED_SHOTS, MIXED_POINTS = 16, 8192  # images 0-7 brown, 8-15 fisheye_opencv
# Pairs from each image's 8 nearest by GPS, as phase 18 takes them.
MIXED_CONFIG = {"matching_gps_neighbors": 8}
# Bounds on its reconstruction, set before its first card run on
# MIXED_CONFIG's pairs from CPU runs of the same dataset through both
# packages (matching_chain_study.py --mixed --config
# '{"matching_gps_neighbors": 8}', PYTHONHASHSEED=1; 64 pairs): 3.5 times
# the larger of the two packages' readings.  Both read centre RMS
# 1.7806e-3 m, point RMS 7.5473e-3 m and reprojection RMS 5.169e-4 (all
# 16 shots, 8,192 points, none mismatched).
MIXED_MAX_CENTRE_RMS = 0.00623  # m, after a similarity fit to the truth
MIXED_MAX_POINT_RMS = 0.0264  # m
MIXED_MAX_REPROJ_RMS = 3.62  # x NOISE
# The card-vs-CPU subset: 2 brown and 2 fisheye_opencv images (cut from 4
# and 4 for the script's time: its CPU side read 52.3 s at 8 images and
# 25.6-52.1 s at 6, the host's CPU setting it; its check, card = CPU on
# the same shots, keeps its bound).
MIXED_SUBSET = range(6, 10)


def model_problem(label, n_shots, n_points, track_window):
    """synthetic_bundle.make_model_problem for one of MODEL_LABELS: a
    camera type for every shot, a brown / fisheye_opencv map alternating
    shot by shot, a rig of 4 cameras (n_shots / 4 instances) with
    optimized rig cameras, or perspective with radial depth rows."""
    import synthetic_bundle as sb

    kw = {"brown+fisheye_opencv": dict(
              camera_types=["brown", "fisheye_opencv"] * (n_shots // 2)),
          "rig 4 cameras, optimized": dict(
              camera_types="perspective", rig_cameras=4, optimize_rig=True),
          "perspective+depth": dict(camera_types="perspective",
                                    depth="radial")}.get(
        label, dict(camera_types=label))
    return sb.make_model_problem(n_shots, n_points, seed=7,
                                 track_window=track_window, **kw)


def lm_trial_profile(problem, dev="cuda"):
    """One warm LM trial (step + cost), f64, of `problem` on its route:
    the mean wall ms of 3 trials, one trial traced for its device busy ms
    and kernels, and one residual/Jacobian evaluation traced for its
    kernels and busy ms."""
    from opensfm_tpu_torch.ba import lm

    p, dense, state, data = lm.device_problem(problem, torch.float64,
                                              torch.device(dev))
    st = lm.solver_statics(p, dense)
    pmax = st.pop("pmax")
    ni, nr, nc = len(p.inst), len(p.rigcam), len(p.cam)
    kw = dict(loss=p.loss, loss_threshold=float(p.loss_threshold),
              dense=dense, pmax=pmax, **st)

    def trial():
        new = lm._lm_step(state, data, 1e-4, ni=ni, nr=nr, nc=nc, **kw)
        return lm._total_cost(new, data, **kw).item()

    trial()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        trial()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    _, k, c, busy, ms = _trace(trial)

    def residuals():
        r = lm._residual_data(state, data, p.loss, float(p.loss_threshold),
                              pmax=pmax, **{key: st[key] for key in (
                                  "ptype", "with_depth", "rig_transform",
                                  "rig_jac", "generic")})
        return r[0].sum().item()

    _, k_res, _, busy_res, _ = _trace(residuals)
    return dict(warm_trial_ms=warm_ms, traced_wall_ms=ms, busy_ms=busy,
                busy_share=busy / ms, kernels_per_trial=k,
                copies_per_trial=c, kernels_per_residual_eval=k_res,
                residual_eval_busy_ms=busy_res)


def run_models(dev="cuda"):
    """Phase 17: the generic route on every problem of MODEL_LABELS at
    phase 3's size (a warm trial profiled, then the whole solve, which must
    lower the cost and launch none of rows 1-5), beside the kernel route
    on phase 3's problem; the same problems at 32 x 4,096 on the card
    against the CPU, 3 iterations; then a brown + fisheye_opencv matching
    dataset (pairs from each image's 8 nearest by GPS) through
    `match_features`, `create_tracks` and `reconstruct`, graded within the
    MIXED_ bounds, and a 4-image subset of it (MIXED_SUBSET) on the card
    against the CPU."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch.ba import lm
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    out = {"bundle": {}, "vs_cpu": {}}
    n_shots, n_points, window = MODEL_SIZE
    size = f"{n_shots} x {n_points} x K={window}"
    kernel_problem = sb.make_problem(n_shots, n_points, track_window=window)
    out["bundle"]["perspective (kernel route)"] = dict(
        lm_trial_profile(kernel_problem, dev), route="canonical")
    log(f"  kernel route, {size}: "
        f"{json.dumps(out['bundle']['perspective (kernel route)'])}")
    for label in MODEL_LABELS:
        problem = model_problem(label, n_shots, n_points, window)
        prof = lm_trial_profile(problem, dev)
        reset_launches()
        t0 = time.perf_counter()
        res = lm.bundle_adjust(problem, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        row = dict(prof, route=res.route, initial_cost=res.initial_cost,
                   final_cost=res.final_cost, iterations=res.iterations,
                   solve_s=wall, observations=len(problem.obs_uv),
                   kernel_launches=sum(counts[k] for k in BA_KERNELS))
        out["bundle"][label] = row
        log(f"  {label}, {size}: {json.dumps(row)}")
        check(res.route == "generic", f"{label}: the generic route")
        check(np.isfinite(res.final_cost)
              and res.final_cost < res.initial_cost, f"{label}: cost down")
        check(row["kernel_launches"] == 0,
              f"{label}: no BA kernel launched on the generic route")

    for label in MODEL_LABELS:
        problem = model_problem(label, MODELS_VS_CPU_SHOTS,
                                MODELS_VS_CPU_POINTS, None)
        res, secs = {}, {}
        for on in (dev, "cpu"):
            t0 = time.perf_counter()
            res[on] = lm.bundle_adjust(problem, max_iterations=3, device=on)
            secs[on] = time.perf_counter() - t0
        g, c = res[dev], res["cpu"]
        rel = max(float(np.abs(getattr(g, k) - getattr(c, k)).max()
                        / max(np.abs(getattr(c, k)).max(), 1e-300))
                  for k in ("inst", "rigcam", "cam", "points"))
        out["vs_cpu"][label] = dict(card_s=secs[dev], cpu_s=secs["cpu"],
                                    iterations=g.iterations,
                                    cpu_iterations=c.iterations,
                                    max_state_rel=rel)
        log(f"  {label}, {MODELS_VS_CPU_SHOTS} x {MODELS_VS_CPU_POINTS} card "
            f"vs CPU: {json.dumps(out['vs_cpu'][label])}")
        check(g.iterations == c.iterations, f"{label}: same iterations")
        check(rel <= MODELS_STATE_REL,
              f"{label}: states within {MODELS_STATE_REL:g} ({rel:.3g})")

    path = os.path.join(WORK, "match_mixed")
    shutil.rmtree(path, ignore_errors=True)
    types = ["brown"] * (MIXED_SHOTS // 2) \
        + ["fisheye_opencv"] * (MIXED_SHOTS // 2)
    tracks = sb.write_matching_dataset(
        path, n_shots=MIXED_SHOTS, n_points=MIXED_POINTS, track_window=8,
        features_per_image=MATCH_FEATURES, seed=5, camera_types=types,
        config=MIXED_CONFIG)
    stages = {}
    reset_launches()
    for cmd in ("match_features", "create_tracks", "reconstruct"):
        t0 = time.perf_counter()
        command_runner(opensfm_commands, argv=[cmd, path, "--device", dev])
        torch.cuda.synchronize()
        stages[cmd] = time.perf_counter() - t0
    counts = launches()
    log(f"  {MIXED_SHOTS} images (brown, fisheye_opencv) x {MATCH_FEATURES} "
        f"features: stage wall s {json.dumps(stages)}; launches {counts}")
    check(counts["top2_sqdist"] > 0, "top2_sqdist launched in phase 17")
    check(all(counts[k] == 0 for k in BA_KERNELS),
          "no BA kernel launched on the brown / fisheye map")
    data = DataSet(path)
    recs = data.load_reconstruction()
    shots, points = sb.matching_scene(MIXED_SHOTS, MIXED_POINTS, seed=5)
    grade = sb.grade_reconstruction(recs, data.load_tracks_manager(), tracks,
                                    shots, points)
    log(f"  graded against the truth: {json.dumps(grade)}")
    check(grade["reconstructions"] == 1 and grade["shots"] == MIXED_SHOTS,
          f"all {MIXED_SHOTS} shots in one reconstruction")
    check(grade["centre_rms"] < MIXED_MAX_CENTRE_RMS,
          f"centre RMS {grade['centre_rms']:.3e} m")
    check(grade["point_rms"] < MIXED_MAX_POINT_RMS,
          f"point RMS {grade['point_rms']:.3e} m")
    check(grade["reprojection_rms"] < MIXED_MAX_REPROJ_RMS * sb.NOISE,
          f"reprojection RMS {grade['reprojection_rms']:.3e}")
    check(grade["points_mismatched"] <= MAX_MISMATCHED * grade["points"],
          f"{grade['points_mismatched']} points mix true points")
    vs_cpu = _subset_card_vs_cpu(
        path, dev, images=[sb.shot_id(i) for i in MIXED_SUBSET],
        base=os.path.join(WORK, "mixed_subset"))
    out.update(chain_stage_s=stages, launches=counts, grade=grade,
               subset_vs_cpu=vs_cpu)
    return out


RIG_VIEWS = 8  # instances of synthetic_images.RIG on phase 15's arc
RIG_W, RIG_H = 1024, 768  # a cut of depth: phase 15 keeps 2,048 x 1,536
# Pairs from each image's 8 nearest by GPS (itself included), as survey
# rig datasets select them: 76 of the 120 pairs, in the main dataset and
# in create_rig's calibration subset alike.
RIG_CONFIG = {"matching_gps_neighbors": 8}
# Bounds on phase 18's reconstruction against the render's truth,
# re-derived for RIG_VIEWS instances (12 until the script outgrew 1,000 s
# with phase 20) before their first card run by the rule that set them
# before: 3.5 times the larger of the two packages' readings on CPU runs
# of the same instances at RIG_W x RIG_H (image_chain_study.py --rig
# --views 8 --width 1024 --height 768 --until reconstruct --config
# '{"matching_gps_neighbors": 8}', PYTHONHASHSEED=1).  The port read centre
# RMS 2.01e-3 m, the rig cameras' baseline 0.39987 m as `create_rig`
# calibrated it and as reconstructed, and their relative rotation
# 1.39e-3 rad; the JAX package read 2.47e-3 m, 0.39989 m and 1.79e-3 rad.
# (At 12 instances: 2.99e-3 / 2.64e-3 m, calibrated baselines 0.39686 /
# 0.39695 m, 1.54e-3 / 1.50e-3 rad, which gave 0.0105 m, 0.0110 m and
# 0.0054 rad.)
RIG_MAX_CENTRE_RMS = 0.00866  # m, after a similarity fit to the true centres
RIG_MAX_BASELINE_ERR = 0.000447  # m, |baseline x the fit's scale - 0.4|
RIG_MAX_ROTATION = 0.00628  # rad, the rig cameras' relative rotation


def run_rig_chain(dev="cuda"):
    """Phase 18: RIG_VIEWS instances of the two-camera rig rendered on the
    card (RIG_CONFIG's pairs), `extract_metadata` (the overrides give each rig camera its
    model), `detect_features`, `create_rig pattern`, `match_features`,
    `create_tracks` and `reconstruct` through the command runner; the
    reconstruction and the rig cameras (as calibrated and as
    reconstructed) graded against the truth."""
    import synthetic_images as si
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    path = os.path.join(WORK, "rig_chain")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    truth = si.write_image_dataset(path, RIG_VIEWS, RIG_W, RIG_H,
                                   seed=0, device=dev,
                                   step_deg=IMAGE_STEP_DEG, rig=si.RIG,
                                   config=RIG_CONFIG)
    stages = {"render": time.perf_counter() - t0}
    reset_launches()
    for cmd in ("extract_metadata", "detect_features", "create_rig",
                "match_features", "create_tracks", "reconstruct"):
        extra = (["pattern", json.dumps(truth["rig_patterns"])]
                 if cmd == "create_rig" else [])
        t0 = time.perf_counter()
        command_runner(opensfm_commands,
                       argv=[cmd, path, *extra, "--device", dev])
        torch.cuda.synchronize()
        stages[cmd] = time.perf_counter() - t0
    counts = launches()
    log(f"  stage wall s: {json.dumps(stages)}; launches {counts}")
    check(counts["top2_sqdist"] > 0, "top2_sqdist launched in phase 18")
    check(all(counts[k] == 0 for k in BA_KERNELS),
          "no BA kernel launched on the brown / fisheye rig")

    data = DataSet(path)
    types = sorted(c.projection_type
                   for c in data.load_camera_models().values())
    check(types == ["brown", "fisheye_opencv"],
          f"the overrides give the rig cameras their models ({types})")
    check(len(data.load_rig_assignments()) == RIG_VIEWS,
          f"create_rig found {RIG_VIEWS} instances")
    recs = data.load_reconstruction()
    grade = si.grade_reconstruction(recs, truth, data.load_tracks_manager())
    rec = max(recs, key=lambda r: len(r.shots))
    rig_out = {}
    for key, cams in (("calibrated", data.load_rig_cameras()),
                      ("reconstructed", rec.rig_cameras)):
        base, angle = si.rig_reading(cams)
        rig_out[key] = dict(baseline_m=base * grade["scale"],
                            rotation_rad=angle)
    log(f"  graded against the render's truth: {json.dumps(grade)}; rig "
        f"cameras {json.dumps(rig_out)} (true baseline 0.4 m, rotation 0)")
    check(grade["reconstructions"] == 1 and grade["shots"] == 2 * RIG_VIEWS,
          f"all {2 * RIG_VIEWS} shots in one reconstruction")
    check(grade["centre_rms"] < RIG_MAX_CENTRE_RMS,
          f"centre RMS {grade['centre_rms']:.3e} m")
    for key, r in rig_out.items():
        check(abs(r["baseline_m"] - 0.4) < RIG_MAX_BASELINE_ERR,
              f"{key} baseline {r['baseline_m']:.5f} m")
        check(r["rotation_rad"] < RIG_MAX_ROTATION,
              f"{key} relative rotation {r['rotation_rad']:.3e} rad")
    return dict(stage_s=stages, launches=counts, grade=grade, rig=rig_out)


# --------------------------------------------------------------------------
# AKAZE on the card (phase 19)
# --------------------------------------------------------------------------

AKAZE_VIEWS = 8  # phase 15's first 8 JPEG views; all 28 pairs, as there
AKAZE_CONFIG = {"feature_type": "AKAZE"}  # akaze_descriptor MSURF
MLDB_CONFIG = {"feature_type": "AKAZE", "akaze_descriptor": "MLDB"}
AKAZE_SMALL_W = 512  # the card-vs-CPU view (512 x 384, for the CPU's time)
# Bounds on phase 19, set before its first card run from CPU runs of the
# same views through both packages at 640 x 480 (image_chain_study.py
# --jpeg --views 8 (2 for M-LDB) --until match_features --config
# '{"feature_type": "AKAZE"}', PYTHONHASHSEED=1): half the smaller of the
# two packages' readings.  M-SURF, both packages alike: 2,043 features in
# the poorest view, 11 of the 28 pairs matched (the far ones fail at that
# size), 80.8 inliers a pair on average over all 28.  M-LDB: 2,043
# features in the poorer view; the pair's inliers 120 (the port), 119 (the
# JAX package).
AKAZE_MIN_FEATURES = 1021  # features of the poorest view
AKAZE_MIN_PAIRS = 5  # pairs with matches
AKAZE_MIN_MEAN_INLIERS = 40  # inliers a pair, mean over all the pairs
MLDB_MIN_FEATURES = 1021
MLDB_MIN_INLIERS = 59  # the one pair's
# Card vs CPU at AKAZE_SMALL_W: tests/test_torch_akaze.py's tolerances.
AKAZE_MATCHED_SHARE, AKAZE_POS_TOL, AKAZE_ANGLE_TOL = 0.99, 1e-3, 0.01
AKAZE_MSURF_TOL, AKAZE_MLDB_EQUAL_SHARE = 1e-4, 0.995


def _akaze_dataset(path, images, sources, config):
    """A dataset at `path` of the JPEG files `images` copied from
    `sources`, with `config` over the defaults."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(os.path.join(path, "images"))
    for name in images:
        shutil.copy(os.path.join(sources, name),
                    os.path.join(path, "images", name))
    with open(os.path.join(path, "config.yaml"), "w") as f:
        json.dump(config, f)


def _match_readings(data):
    inliers = [len(m) for im in data.images() if data.matches_exists(im)
               for m in data.load_matches(im).values()]
    feats = {im: len(data.load_features(im).points) for im in data.images()}
    return feats, inliers


def akaze_card_vs_cpu(image_gray, descriptor, dev="cuda"):
    """One image's AKAZE (`extract_akaze_features`) on the card and on the
    CPU, held to tests/test_torch_akaze.py's tolerances."""
    from opensfm_tpu_torch.ops import akaze

    config = {"akaze_descriptor": descriptor}
    t0 = time.perf_counter()
    pc, dc = akaze.extract_akaze_features(image_gray, config, 4000, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp, dp = akaze.extract_akaze_features(image_gray, config, 4000, "cpu")
    cpu_s = time.perf_counter() - t0
    dist = np.linalg.norm(pp[:, None, :2] - pc[None, :, :2], axis=2)
    dist[np.abs(pp[:, None, 2] - pc[None, :, 2]) > 1e-6] = np.inf
    nn = dist.argmin(1)
    near = dist[np.arange(len(pp)), nn] <= AKAZE_POS_TOL
    angle = np.abs(pp[near, 3] - pc[nn[near], 3])
    out = dict(card_keypoints=len(pc), cpu_keypoints=len(pp),
               matched_share=float(near.mean()),
               angle_max_deg=float(np.minimum(angle, 360 - angle).max()),
               card_s=card_s, cpu_s=cpu_s)
    if descriptor == "MLDB":
        out["bits_equal"] = float((dp[near] == dc[nn[near]]).mean())
        desc_ok = out["bits_equal"] >= AKAZE_MLDB_EQUAL_SHARE
    else:
        out["desc_max_abs"] = float(np.abs(dp[near] - dc[nn[near]]).max())
        desc_ok = out["desc_max_abs"] <= AKAZE_MSURF_TOL
    log(f"  AKAZE {descriptor} card vs CPU, one {image_gray.shape[1]} x "
        f"{image_gray.shape[0]} image: {json.dumps(out)}")
    check(abs(len(pc) - len(pp)) <= 0.01 * len(pp)
          and out["matched_share"] >= AKAZE_MATCHED_SHARE
          and out["angle_max_deg"] <= AKAZE_ANGLE_TOL and desc_ok,
          f"AKAZE {descriptor}: card and CPU agree")
    return out


def run_akaze_chain(sources, dev="cuda"):
    """Phase 19: AKAZE through `extract_metadata`, `detect_features` and
    `match_features` (the command runner) on AKAZE_VIEWS of phase 15's JPEG
    views with M-SURF, and on two of them with M-LDB; features an image,
    inliers a pair, row 6's launches by descriptor type (the FP32 route on
    float and on wide uint8 descriptors must launch), one image's AKAZE
    traced at two feature budgets (its launches must not grow with the
    keypoints), and one view at AKAZE_SMALL_W on the card against the
    CPU."""
    from opensfm_tpu_torch import features
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    top2 = _wrappers()["top2_sqdist"]
    images = sorted(os.listdir(sources))[:AKAZE_VIEWS]
    out = {}
    reset_launches()
    for key, config, names in (("msurf", AKAZE_CONFIG, images),
                               ("mldb", MLDB_CONFIG, images[:2])):
        path = os.path.join(WORK, f"akaze_{key}")
        _akaze_dataset(path, names, sources, config)
        stages = {}
        for cmd in ("extract_metadata", "detect_features", "match_features"):
            t0 = time.perf_counter()
            report = command_runner(opensfm_commands,
                                    argv=[cmd, path, "--device", dev])
            torch.cuda.synchronize()
            stages[cmd] = time.perf_counter() - t0
            if cmd == "detect_features":
                per_image = report["images"]
        feats, inliers = _match_readings(DataSet(path))
        out[key] = dict(
            stage_s=stages, features=feats, pairs=len(inliers),
            pairs_matched=int(np.count_nonzero(inliers)),
            inliers_min=int(min(inliers, default=0)),
            inliers_mean=float(np.mean(inliers)) if inliers else 0.0,
            detect_ms_mean=float(np.mean([1e3 * r["detect_s"]
                                          for r in per_image.values()])),
            wait_ms_mean=float(np.mean([1e3 * r["wait_s"]
                                        for r in per_image.values()])))
        log(f"  {key}: {json.dumps(out[key])}")
    out["launches"] = launches()
    out["top2_by_input"] = dict(top2.launches_by_input)
    log(f"  launches {out['launches']}; top2_sqdist by descriptors "
        f"{out['top2_by_input']}")
    check(all(out["launches"][k] == 0 for k in BA_KERNELS),
          "no BA kernel launched by detect_features and match_features")
    check(out["top2_by_input"]["float"] > 0,
          "top2_sqdist launched on float (M-SURF) descriptors")
    check(out["top2_by_input"]["uint8_wide"] > 0,
          "top2_sqdist launched on wide uint8 (M-LDB) descriptors")
    ms, ml = out["msurf"], out["mldb"]
    check(min(ms["features"].values()) >= AKAZE_MIN_FEATURES,
          f"M-SURF: every view has >= {AKAZE_MIN_FEATURES} features")
    check(ms["pairs_matched"] >= AKAZE_MIN_PAIRS
          and ms["inliers_mean"] >= AKAZE_MIN_MEAN_INLIERS,
          f"M-SURF: >= {AKAZE_MIN_PAIRS} pairs matched, >= "
          f"{AKAZE_MIN_MEAN_INLIERS} inliers a pair on average")
    check(min(ml["features"].values()) >= MLDB_MIN_FEATURES
          and ml["pairs_matched"] == 1
          and ml["inliers_min"] >= MLDB_MIN_INLIERS,
          f"M-LDB: >= {MLDB_MIN_FEATURES} features a view, the pair's "
          f">= {MLDB_MIN_INLIERS} inliers")
    mldb = DataSet(os.path.join(WORK, "akaze_mldb"))
    saved = mldb.load_features(mldb.images()[0]).descriptors
    check(saved.dtype == np.uint8 and saved.shape[1] == 486,
          "M-LDB descriptors saved as 486 uint8 bits")

    # One image's AKAZE traced at two feature budgets.
    data = DataSet(os.path.join(WORK, "akaze_msurf"))
    image = data.load_image(data.images()[0])
    trace = {}
    for budget in (data.config["feature_min_frames"], 1000):
        config = dict(data.config, feature_min_frames=budget)
        feats_out, k, c, busy, ms = _trace(lambda: features.extract_features(
            image, config, False, device=dev))
        trace[budget] = dict(keypoints=len(feats_out.points), kernels=k,
                             copies=c, busy_ms=busy, wall_ms=ms,
                             busy_share=busy / ms)
    out["trace"] = trace
    log(f"  one image's AKAZE ({IMAGE_W} x {IMAGE_H}) traced at two "
        f"budgets: {json.dumps(trace)}")
    lo, hi = sorted(trace)
    check(trace[hi]["kernels"] <= 1.05 * trace[lo]["kernels"],
          f"AKAZE's launches do not grow with the keypoints "
          f"({trace[lo]['kernels']} at {lo} features, "
          f"{trace[hi]['kernels']} at {hi})")

    small = features.rgb_to_grey(features.resized_image(
        image, AKAZE_SMALL_W, device="cpu"))
    out["vs_cpu"] = {d: akaze_card_vs_cpu(small, d, dev)
                     for d in ("MSURF", "MLDB")}
    return out


# --------------------------------------------------------------------------
# Vocabularies, vocabulary pair selection and guided matching (phase 20)
# --------------------------------------------------------------------------

VOCAB_VIEWS = 8  # phase 15's first 8 views: root-uchar HAHOG descriptors
VOCAB_NEIGHBORS = 2  # matching_bow_neighbors / matching_vlad_neighbors
VOCAB_BOW = {"matcher_type": "WORDS", "matching_bow_neighbors":
             VOCAB_NEIGHBORS, "matching_gps_distance": 0}
VOCAB_VLAD = {"matcher_type": "WORDS", "matching_bow_neighbors": 0,
              "matching_vlad_neighbors": VOCAB_NEIGHBORS,
              "matching_gps_distance": 0}
VOCAB_TRAIN = {"matching_bow_neighbors": VOCAB_NEIGHBORS,
               "matching_gps_distance": 0}
VOCAB_MAX_PAIRS = 24  # VOCAB_VIEWS x VOCAB_NEIGHBORS at most (16)
GUIDED_PAIRS = 8  # consecutive shots of phase 15's reconstruction
# Card against CPU: tests/test_torch_bow.py's rules.  Word ids: a share of
# equal ids, every flip a near-tie (its words' float64 distances within
# WORDS_NEAR_TIE_REL of |x|^2 + |c|^2); trained centres within
# CENTRE_TOL_REL of the descriptors' largest magnitude; the epipolar mask
# equal but within 1e-12 rad of the threshold (tests/test_torch_guided.py).
WORDS_MIN_SHARE, WORDS_NEAR_TIE_REL = 0.999, 1e-6
CENTRE_TOL_REL = 2e-6
EPIPOLAR_NEAR = 1e-12
# Bounds on the written matches, set by ISSUE 10's rule (half the smaller
# count) from `vocab_study.py` on both packages on the CPU at 640 x 480
# (PYTHONHASHSEED=1, before the first card run): BoW 9 of 9 pairs matched,
# 648.9 inliers a pair in both; VLAD 9 of 9, 657.3 / 657.2; guided 8 of
# 8, 1,641.1 matches a pair in both; trained centres within 8.9e-8 of
# each other, the same pairs, words 99.97 % equal.
VOCAB_BOW_MIN_PAIRS, VOCAB_BOW_MIN_INLIERS = 4, 324.4
VOCAB_VLAD_MIN_PAIRS, VOCAB_VLAD_MIN_INLIERS = 4, 328.6
GUIDED_MIN_PAIRS, GUIDED_MIN_MATCHES = 4, 820.6


def _words_agree(x, centers, got, want):
    """(share of equal ids, largest float64 distance gap of a flip over
    |x|^2 + |c|^2)."""
    equal = got == want
    rows, cols = np.nonzero(~equal)
    gap = 0.0
    if len(rows):
        x64 = np.asarray(x, np.float64)[rows]
        c64 = np.asarray(centers, np.float64)
        dg = ((x64 - c64[got[rows, cols]]) ** 2).sum(1)
        dw = ((x64 - c64[want[rows, cols]]) ** 2).sum(1)
        scale = (x64 ** 2).sum(1) + (c64[want[rows, cols]] ** 2).sum(1)
        gap = float((np.abs(dg - dw) / scale).max())
    return float(equal.mean()), gap


def _sorted_pairs(pairs):
    return sorted("|".join(sorted(p)) for p in pairs)


def _selection_on_cpu(path):
    """The pairs that `match_candidates_from_metadata` selects on the CPU
    for the dataset at `path`."""
    from opensfm_tpu_torch import pairs_selection, vlad
    from opensfm_tpu_torch.dataset import DataSet

    vlad.instance.clear_cache()
    data = DataSet(path)
    images = data.images()
    exifs = {im: data.load_exif(im) for im in images}
    pairs, _ = pairs_selection.match_candidates_from_metadata(
        images, images, exifs, data, {}, device="cpu")
    vlad.instance.clear_cache()
    return _sorted_pairs(pairs)


def _vocab_match(label, path, min_pairs, min_inliers, dev):
    """`match_features` on the card through the command runner, with row
    6's launches read around it; the selected pairs held equal to the CPU's
    selection and the written matches graded."""
    from opensfm_tpu_torch import vlad
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    top2 = _wrappers()["top2_sqdist"]
    vlad.instance.clear_cache()
    reset_launches()
    t0 = time.perf_counter()
    pairs = command_runner(opensfm_commands,
                           argv=["match_features", path, "--device", dev])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vlad.instance.clear_cache()
    data = DataSet(path)
    report = json.loads(data.load_report("matches.json"))
    inliers = [len(m) for m in pairs.values()]
    out = dict(wall_s=wall, pairs=len(pairs),
               num_pairs_bow=report["num_pairs_bow"],
               num_pairs_vlad=report["num_pairs_vlad"],
               pairs_matched=int(np.count_nonzero(inliers)),
               inliers_mean=float(np.mean(inliers)) if inliers else 0.0,
               launches=top2.launches, launches_masked=top2.launches_masked)
    t0 = time.perf_counter()
    out["cpu_selection_equal"] = _selection_on_cpu(path) == \
        _sorted_pairs(pairs)
    out["cpu_selection_s"] = time.perf_counter() - t0
    log(f"  {label}: {json.dumps(out)}")
    check(0 < len(pairs) <= VOCAB_MAX_PAIRS,
          f"{label}: {len(pairs)} pairs, at most {VOCAB_MAX_PAIRS}")
    check(out["launches_masked"] > 0
          and out["launches_masked"] == out["launches"],
          f"{label}: row 6 launched, every search on its masked route")
    check(out["cpu_selection_equal"],
          f"{label}: the card's pairs are the CPU's selection")
    check(out["pairs_matched"] >= min_pairs
          and out["inliers_mean"] >= min_inliers,
          f"{label}: >= {min_pairs} pairs matched, >= {min_inliers} inliers "
          f"a pair on average")
    return out


def _epipolar_angles(b1, b2, pose):
    """[N1, N2] symmetric epipolar angles, float64 on the CPU."""
    from opensfm_tpu_torch.geometry.triangulation import (
        epipolar_angle_two_bearings_many,
    )

    return epipolar_angle_two_bearings_many(*(
        torch.as_tensor(np.asarray(a, np.float64)) for a in
        (b1, b2, pose.get_rotation_matrix(), pose.translation))).numpy()


def _guided_angles(data, matches, pose, cam1, cam2, im1, im2):
    """The symmetric epipolar angle of each match, float64 on the CPU."""
    from opensfm_tpu_torch import feature_loader

    m = np.asarray(matches).reshape(-1, 2)
    p1 = feature_loader.instance.load_all_data(data, im1, True).points
    p2 = feature_loader.instance.load_all_data(data, im2, True).points
    return np.diagonal(_epipolar_angles(cam1.bearings_many(p1[m[:, 0], :2]),
                                        cam2.bearings_many(p2[m[:, 1], :2]),
                                        pose))


def run_guided(chain_path, dev="cuda"):
    """Phase 20's guided matching: GUIDED_PAIRS consecutive shots of phase
    15's reconstruction through `match_images_with_pairs(poses=...)` on the
    card, each pair's relative pose from the reconstructed shots; every
    match within `guided_matching_threshold` of its epipolar geometry, row
    6's masked launches, the matches graded, and one pair on the card
    against the CPU (epipolar mask, descriptor matches, and `match` with
    the same RANSAC draws, which come from one CPU generator)."""
    from opensfm_tpu_torch import feature_loader, matching
    from opensfm_tpu_torch.dataset import DataSet

    top2 = _wrappers()["top2_sqdist"]
    data = DataSet(chain_path)
    rec = data.load_reconstruction()[0]
    shots = sorted(rec.shots)
    pairs = list(zip(shots, shots[1:]))[:GUIDED_PAIRS]
    poses = {(a, b): rec.shots[b].pose.compose(rec.shots[a].pose.inverse())
             for a, b in pairs}
    exifs = {im: data.load_exif(im) for im in data.images()}
    cams = data.load_camera_models()
    thr = data.config["guided_matching_threshold"]
    reset_launches()
    t0 = time.perf_counter()
    guided = matching.match_images_with_pairs(data, {}, exifs, pairs,
                                              poses=poses, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [len(m) for m in guided.values()]
    worst = max((float(_guided_angles(data, m, poses[p],
                                      cams[exifs[p[0]]["camera"]],
                                      cams[exifs[p[1]]["camera"]], *p).max())
                 for p, m in guided.items() if len(m)), default=0.0)
    out = dict(wall_s=wall, pairs=len(pairs),
               pairs_matched=int(np.count_nonzero(counts)),
               matches_mean=float(np.mean(counts)), max_angle=worst,
               launches=top2.launches, launches_masked=top2.launches_masked)

    im1, im2 = pairs[0]
    cam1, cam2 = cams[exifs[im1]["camera"]], cams[exifs[im2]["camera"]]
    b1 = feature_loader.instance.load_bearings(data, im1, True, cam1)
    b2 = feature_loader.instance.load_bearings(data, im2, True, cam2)
    masks = {d: matching.compute_inliers_bearing_epipolar(
        b1, b2, poses[im1, im2], thr, device=d).cpu().numpy()
        for d in (dev, "cpu")}
    near = np.abs(_epipolar_angles(b1, b2, poses[im1, im2]) - thr) \
        <= EPIPOLAR_NEAR
    differ = masks[dev] != masks["cpu"]
    desc = {d: matching._match_descriptors_guided_impl(
        im1, im2, cam1, cam2, poses[im1, im2], data, data.config,
        device=d)[2] for d in (dev, "cpu")}
    robust = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        robust[d] = matching.match(im1, im2, cam1, cam2, data, data.config,
                                   poses[im1, im2], device=d)
        robust[d + "_s"] = time.perf_counter() - t0
    rows = {d: {tuple(r) for r in robust[d]} for d in (dev, "cpu")}
    out["vs_cpu"] = dict(
        pair=[im1, im2], mask_cells=int(differ.size),
        mask_differ=int(differ.sum()),
        mask_differ_decided=int((differ & ~near).sum()),
        descriptor_matches=len(desc["cpu"]),
        descriptor_matches_equal=bool(np.array_equal(desc[dev],
                                                     desc["cpu"])),
        robust_card=len(robust[dev]), robust_cpu=len(robust["cpu"]),
        robust_jaccard=len(rows[dev] & rows["cpu"])
        / max(len(rows[dev] | rows["cpu"]), 1),
        match_card_s=robust[dev + "_s"], match_cpu_s=robust["cpu_s"])
    feature_loader.instance.clear_cache()
    log(f"  guided: {json.dumps(out)}")
    check(out["launches_masked"] == 2 * len(pairs)
          and out["launches"] == out["launches_masked"],
          "guided: two masked row-6 searches a pair")
    check(worst < thr, f"guided: every match within {thr} rad of its "
          f"epipolar geometry (largest {worst:.6g})")
    check(out["pairs_matched"] >= GUIDED_MIN_PAIRS
          and out["matches_mean"] >= GUIDED_MIN_MATCHES,
          f"guided: >= {GUIDED_MIN_PAIRS} pairs matched, >= "
          f"{GUIDED_MIN_MATCHES} matches a pair on average")
    v = out["vs_cpu"]
    check(v["mask_differ_decided"] == 0,
          "guided: card and CPU epipolar masks equal away from the threshold")
    check(v["mask_differ"] > 0 or v["descriptor_matches_equal"],
          "guided: card and CPU descriptor matches identical")
    check(v["robust_jaccard"] >= 0.99,
          f"guided: card and CPU robust matches, Jaccard "
          f"{v['robust_jaccard']:.4f}")
    return out


def run_training(akaze_path, dev="cuda"):
    """Phase 20's vocabulary training: BoW pair selection on phase 19's
    AKAZE (M-SURF) views, whose float domain trains a 1,024-word k-means;
    on the card twice (equal bits) and on the CPU (the tests' tolerance,
    the same pairs), with the training's seconds."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch import pairs_selection
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.ops import kmeans

    images = DataSet(akaze_path).images()
    out, centres, pairs = {}, {}, {}
    for run, d in (("card", dev), ("card_again", dev), ("cpu", "cpu")):
        path = os.path.join(WORK, f"vocab_train_{run}")
        sb.subset_dataset(akaze_path, path, images, VOCAB_TRAIN)
        data = DataSet(path)
        exifs = {im: data.load_exif(im) for im in images}
        acc = {}
        original = _timed(kmeans, "train_kmeans", acc)
        try:
            t0 = time.perf_counter()
            selected, report = pairs_selection.match_candidates_from_metadata(
                images, images, exifs, data, {}, device=d)
            if d != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            kmeans.train_kmeans = original
        cache = np.load(os.path.join(path, "bow_vocabulary.npz"))
        centres[run], pairs[run] = cache["words"], _sorted_pairs(selected)
        out[run] = dict(selection_s=wall, train_s=acc["train_kmeans"],
                        num_pairs_bow=report["num_pairs_bow"])
    sample = np.concatenate([DataSet(akaze_path).load_features(im)
                             .descriptors for im in images])
    tol = CENTRE_TOL_REL * float(np.abs(sample).max())
    diff = np.abs(centres["card"] - centres["cpu"]).max(axis=1)
    out.update(words=int(len(centres["card"])), descriptors=len(sample),
               centres_max_abs=float(diff.max()), centres_tol=tol,
               bits_equal=bool(np.array_equal(centres["card"],
                                              centres["card_again"])),
               pairs_equal=pairs["card"] == pairs["cpu"]
               == pairs["card_again"])
    log(f"  training: {json.dumps(out)}")
    check(out["words"] == 1024, "training: a 1,024-word vocabulary")
    check(out["bits_equal"], "training: two card runs give equal bits")
    check(out["centres_max_abs"] <= tol,
          f"training: card centres within {tol:.3g} of the CPU's")
    check(out["pairs_equal"], "training: the same pairs on card and CPU")
    return out


def run_exports(chain_path, dev="cuda"):
    """Phase 20's exports: the seven commands through the command runner on
    phase 15's dataset, each output parsed."""
    from opensfm_tpu_torch import io, io_openmvs
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet

    data = DataSet(chain_path)
    recs = data.load_reconstruction()
    rec = recs[0]
    seconds = {}
    for cmd in ("export_ply", "export_colmap", "export_bundler",
                "export_visualsfm", "export_geocoords", "export_pmvs",
                "export_openmvs"):
        t0 = time.perf_counter()
        command_runner(opensfm_commands, argv=[cmd, chain_path, "--device",
                                               dev])
        seconds[cmd] = time.perf_counter() - t0

    def lines(*parts):
        with open(os.path.join(chain_path, *parts)) as f:
            return f.read().splitlines()

    ply = lines("reconstruction.ply")
    n_ply = int(next(x for x in ply if x.startswith("element vertex"))
                .split()[2])
    colmap_points = len(lines("colmap_export", "points3D.txt")) - 1
    colmap_images = len(lines("colmap_export", "images.txt")) - 1
    bundler_head = lines("bundler", "bundle.rd.out")[1].split()
    nvm = lines("reconstruction.nvm")
    geo_rows = [r.split(",") for r in lines("image_geocoords.csv")[1:]]
    jpgs = sorted(os.listdir(os.path.join(chain_path, "pmvs", "visualize")))
    jpg = io.imread(os.path.join(chain_path, "pmvs", "visualize", jpgs[0]))
    udata = data.undistorted_dataset()
    scene = io_openmvs.read_mvs(os.path.join(udata.data_path, "openmvs",
                                             "scene.mvs"))
    urec = udata.load_undistorted_reconstruction()[0]
    out = dict(seconds=seconds, ply_vertices=n_ply,
               colmap_points=colmap_points, colmap_image_lines=colmap_images,
               bundler=[int(v) for v in bundler_head], nvm_shots=int(nvm[2]),
               geocoords_rows=len(geo_rows), pmvs_jpegs=len(jpgs),
               pmvs_jpeg_shape=list(jpg.shape),
               openmvs_images=len(scene["images"]),
               openmvs_vertices=len(scene["vertices"]),
               shots=len(rec.shots), points=len(rec.points))
    log(f"  exports: {json.dumps(out)}")
    check(n_ply > len(rec.points), "export_ply: points and cameras")
    check(colmap_points == len(rec.points)
          and colmap_images == 2 * len(rec.shots),
          "export_colmap: the reconstruction's points and images")
    check(out["bundler"] == [len(rec.shots), len(rec.points)],
          "export_bundler: the reconstruction's shots and points")
    check(nvm[0] == "NVM_V3" and out["nvm_shots"] == len(rec.shots),
          "export_visualsfm: NVM_V3 with every shot")
    check(len(geo_rows) == sum(len(r.shots) for r in recs)
          and np.isfinite([[float(v) for v in r[1:]]
                           for r in geo_rows]).all(),
          "export_geocoords: one finite row a shot")
    check(len(jpgs) == len(rec.shots)
          and jpg.shape == (IMAGE_H, IMAGE_W, 3),
          "export_pmvs: one JPEG a shot, decodable")
    check(out["openmvs_images"] == len(urec.shots)
          and 0 < out["openmvs_vertices"] <= len(urec.points)
          and all(os.path.isfile(im["name"]) for im in scene["images"]),
          "export_openmvs: the undistorted shots and their images")
    return out


def run_vocab_chain(chain_path, akaze_path, dev="cuda"):
    """Phase 20: word assignment, BoW and VLAD pair selection with the
    WORDS matcher on VOCAB_VIEWS of phase 15's views, vocabulary training
    on phase 19's AKAZE views, guided matching on phase 15's
    reconstruction, and the seven export commands on its dataset."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch import bow, vlad
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.ops import kmeans

    images = DataSet(chain_path).images()[:VOCAB_VIEWS]
    bow_path = os.path.join(WORK, "vocab_bow")
    sb.subset_dataset(chain_path, bow_path, images, VOCAB_BOW)
    out = {}
    reset_launches()
    t0 = time.perf_counter()
    report = command_runner(opensfm_commands,
                            argv=["detect_features", bow_path, "--device",
                                  dev])
    torch.cuda.synchronize()
    words_wall = time.perf_counter() - t0
    data = DataSet(bow_path)
    bag = bow.load_vocabulary(data, device="cpu")
    x = data.load_features(images[0]).descriptors
    n_closest = data.config["bow_words_to_match"]
    share, gap = _words_agree(x, bag.words,
                              data.load_words(images[0]).astype(np.int64),
                              bag.map_to_words(x, n_closest, device="cpu"))
    xd = torch.as_tensor(x, device=dev)
    cd = torch.as_tensor(bag.words, device=dev)
    kmeans.assign_words_topk(xd, cd, n_closest)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        kmeans.assign_words_topk(xd, cd, n_closest)
    torch.cuda.synchronize()
    out["words"] = dict(
        command_s=words_wall, images=len(report["words"]),
        ms_an_image=1e3 * float(np.mean(list(report["words"].values()))),
        search_ms=(time.perf_counter() - t0) / 5 * 1e3,
        descriptors=len(x), vocabulary=len(bag.words), k=n_closest,
        cpu_equal_share=share, cpu_flip_gap_rel=gap)
    log(f"  word assignment: {json.dumps(out['words'])}")
    check(out["words"]["images"] == VOCAB_VIEWS,
          f"words assigned for {VOCAB_VIEWS} images")
    check(share >= WORDS_MIN_SHARE and gap <= WORDS_NEAR_TIE_REL,
          f"words: card = CPU on {share:.5f} of the ids, every flip a "
          f"near-tie ({gap:.3g})")

    out["bow"] = _vocab_match("BoW + WORDS", bow_path, VOCAB_BOW_MIN_PAIRS,
                              VOCAB_BOW_MIN_INLIERS, dev)
    vlad_path = os.path.join(WORK, "vocab_vlad")
    sb.subset_dataset(bow_path, vlad_path, images, VOCAB_VLAD)
    out["vlad"] = _vocab_match("VLAD + WORDS", vlad_path,
                               VOCAB_VLAD_MIN_PAIRS, VOCAB_VLAD_MIN_INLIERS,
                               dev)
    v = [vlad.unnormalized_vlad(x, vlad.instance.load_words(DataSet(
        vlad_path), device=dev), device=dev) for _ in range(2)]
    vlad.instance.clear_cache()
    out["vlad"]["bits_equal"] = bool(np.array_equal(v[0], v[1]))
    check(out["vlad"]["bits_equal"],
          "unnormalized_vlad: two card runs give equal bits")
    out["train"] = run_training(akaze_path, dev)
    out["guided"] = run_guided(chain_path, dev)
    out["exports"] = run_exports(chain_path, dev)
    out["launches_words"] = out["bow"]["launches_masked"] + \
        out["vlad"]["launches_masked"]
    out["launches_guided"] = out["guided"]["launches_masked"]
    return out


# --------------------------------------------------------------------------
# The submodel path and the pose-graph bundle (phase 21)
# --------------------------------------------------------------------------

SUB_SIZE = 8  # submodel_size: ceil(16 / 8) = 2 GPS clusters
SUB_MIN_VIEWS, SUB_MAX_VIEWS, SUB_MIN_SHARED = 9, 11, 4
# Bounds on phase 21's submodel path: 3.5 times the larger CPU reading of
# the two packages, half the smaller count (phase 15's dense bounds'
# rule), from submodel_study.py.  Set before the first card run
# from phase 15's 16 views at 640 x 480 (image_chain_study.py --jpeg
# --until match_features, the AUTO config, PYTHONHASHSEED=1): both
# packages split them into submodels of 10 and 11 views sharing 5 and
# reconstructed each whole; reconstructed centres (GPS-anchored, before
# the alignment) against the render's truth in the topocentric frame, no
# similarity fit: RMS 0.35231 m (port) and 0.35230 m (JAX package);
# aligned centres: RMS 3.898 / 3.849 m, largest 6.421 / 6.340 m (the
# alignment's common-point rows, 0.1 m a point against the EXIF's 5 m
# GPS, shrink both packages' submodels: ROADMAP C4); shared shots'
# aligned centres 3.906e-3 / 3.979e-3 m apart; 21 / 21 aligned shots.
# The card's readings of the shared shots moved with the hash seed of its
# matching (3.9e-3 to 1.972e-2 m over ten card runs; the first broke the
# 0.01393 m bound those readings set), where the 640 x 480 readings
# stayed at 1.2e-3 to 3.9e-3 m (hash seeds 1-3), so the rule was applied
# again on the card's own 2,048 x 1,536 features and matches: of its
# hash seeds 1-5 the worst (4: 1.943e-2 m on the card) through both
# packages on the CPU read 0.35248 m, 3.888 m, 6.389 m and 1.9433e-2 m
# (equal to 1e-10), another run's data 0.35240, 3.808, 6.272 and
# 6.274e-3.  Each bound is 3.5 times the larger of all these readings.
SUB_MAX_RECON_RMS = 1.234  # m
SUB_MAX_ALIGNED_RMS = 13.64  # m
SUB_MAX_ALIGNED_ERR = 22.47  # m
SUB_MAX_SHARED = 0.06801  # m
SUB_MIN_ALIGNED_SHOTS = 10
SUB_ALIGN_REL = 1e-9  # the alignment's parameters, card vs CPU
# Steps of the card-vs-CPU alignment, phase 5's 3 (the main path's takes
# 50).  As lam falls the solve creeps along the submodels' shrinking scale
# (ROADMAP C4), where J^T J is ill-conditioned and the two devices'
# products round apart by more than the arithmetic is checked to: on one
# run's data 9.3e-14, 1.3e-12, 3.2e-9 and 4.6e-9 after 1, 3, 10 and 50
# steps, on another's 1.065e-9 after 10 (H100 80GB HBM3, 700 W).
SUB_ALIGN_STEPS = 3
# Phase 21's pose-graph bundle: phase 3's map through the BundleAdjuster
# facade, every family (module docstring), FACADE_ITERATIONS LM steps.
FACADE_SHOTS, FACADE_POINTS, FACADE_TRACK = 256, 32768, 8
FACADE_NEXT = 4  # relative motions from each instance to its next 4
FACADE_HEATMAPS, FACADE_HEATMAP_CELLS = 16, 64  # instances, grid side
FACADE_ITERATIONS = 10
FACADE_CPU_SHOTS, FACADE_CPU_POINTS = 32, 4096  # phase 5's dense size


def _align_params(ra):
    return np.concatenate([e.parameters for e in list(ra._recs.values())
                           + list(ra._shots.values())])


def run_submodels(dev="cuda"):
    """Phase 21 (a): the submodel path on a copy of phase 15's dataset
    (views, EXIF, features, matches): `create_submodels` into GPS clusters
    of SUB_SIZE grown by their two nearest outside views, `create_tracks`
    and `reconstruct` in each submodel and `align_submodels`, all through
    the command runner on the card; graded against the render's truth in
    the topocentric frame with no similarity fit
    (`synthetic_images.grade_aligned`); then the alignment solve of the same
    constraints on the card against the CPU."""
    import copy

    import synthetic_images as si
    from opensfm_tpu_torch.ba import alignment
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.dataset import DataSet
    from opensfm_tpu_torch.large import tools
    from opensfm_tpu_torch.large.metadataset import MetaDataSet

    def run(command, p):
        out = command_runner(opensfm_commands,
                             argv=[command, p, "--device", dev])
        torch.cuda.synchronize()
        return out

    src = os.path.join(WORK, "image_chain")
    path = os.path.join(WORK, "submodels")
    si.copy_submodel_inputs(src, path, {"submodel_size": SUB_SIZE})
    overlap = si.submodel_overlap(path, SUB_SIZE)
    si.copy_submodel_inputs(src, path, {"submodel_size": SUB_SIZE,
                                        "submodel_overlap": overlap})
    out = {"overlap_m": overlap}
    reset_launches()
    t0 = time.perf_counter()
    run("create_submodels", path)
    out["create_submodels_s"] = time.perf_counter() - t0
    subs = MetaDataSet(path).get_submodel_paths()
    views = [DataSet(s).images() for s in subs]
    shared = set(views[0]).intersection(*views[1:]) if views else set()
    out["views"] = [len(v) for v in views]
    out["shared_views"] = len(shared)
    log(f"  create_submodels {out['create_submodels_s']:.2f} s: overlap "
        f"{overlap:.3f} m, views {out['views']}, shared {len(shared)}")
    check(len(subs) == 2 and all(SUB_MIN_VIEWS <= len(v) <= SUB_MAX_VIEWS
                                 for v in views)
          and len(shared) >= SUB_MIN_SHARED,
          f"2 submodels of {SUB_MIN_VIEWS}-{SUB_MAX_VIEWS} views sharing >= "
          f"{SUB_MIN_SHARED}")
    out["reconstruct_s"] = {}
    for sp in subs:
        name = os.path.basename(sp)
        t0 = time.perf_counter()
        run("create_tracks", sp)
        run("reconstruct", sp)
        out["reconstruct_s"][name] = time.perf_counter() - t0
        recs = DataSet(sp).load_reconstruction()
        log(f"  {name}: create_tracks + reconstruct "
            f"{out['reconstruct_s'][name]:.2f} s, partials "
            f"{[len(r.shots) for r in recs]} of {len(DataSet(sp).images())}")
        check(len(recs) == 1
              and len(recs[0].shots) == len(DataSet(sp).images()),
              f"{name} reconstructed whole")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    report = run("align_submodels", path)
    out["align_submodels_s"] = time.perf_counter() - t0
    out["alignment"] = dict(report, peak_device_bytes=int(
        torch.cuda.max_memory_allocated() - base))
    out["launches"] = launches()
    log(f"  align_submodels {out['align_submodels_s']:.2f} s: "
        f"{json.dumps(out['alignment'])}")
    log(f"  kernel launches over the submodel path: {out['launches']}")
    for name in ("fused_residual_jacobian", "fused_cost"):
        check(out["launches"][name] > 0, f"{name} launched on the submodels")
    grade = si.grade_aligned(path, si.true_centres(path, IMAGE_VIEWS,
                                                   IMAGE_STEP_DEG))
    out["grade"] = {k: v for k, v in grade.items() if k != "submodels"}
    log(f"  graded against the render's truth (no fit): "
        f"{json.dumps(out['grade'])}")
    check(grade["aligned_shots"] >= SUB_MIN_ALIGNED_SHOTS,
          f">= {SUB_MIN_ALIGNED_SHOTS} aligned shots")
    check(grade["reconstructed_centre_rms_m"] <= SUB_MAX_RECON_RMS,
          f"reconstructed centre RMS <= {SUB_MAX_RECON_RMS} m")
    check(grade["centre_rms_m"] <= SUB_MAX_ALIGNED_RMS
          and grade["centre_max_m"] <= SUB_MAX_ALIGNED_ERR,
          f"aligned centres: RMS <= {SUB_MAX_ALIGNED_RMS} m, largest <= "
          f"{SUB_MAX_ALIGNED_ERR} m")
    check(grade["shared_shots"] >= SUB_MIN_SHARED
          and grade["shared_max_m"] <= SUB_MAX_SHARED,
          f"shared shots agree within {SUB_MAX_SHARED} m after the alignment")

    # The alignment solve of the same constraints on the card and the CPU.
    shots = tools.load_reconstruction_shots(MetaDataSet(path))
    ra = alignment.ReconstructionAlignment(device=dev)
    tools.add_camera_constraints_soft(ra, shots,
                                      tools.partial_reconstruction_name)
    tools.add_point_constraints(ra, shots, tools.partial_reconstruction_name,
                                device=dev)
    ra_cpu = copy.deepcopy(ra)
    ra_cpu._device = "cpu"
    vs = {}
    for label, r in (("card", ra), ("cpu", ra_cpu)):
        t0 = time.perf_counter()
        r.run(max_iterations=SUB_ALIGN_STEPS)
        vs[f"{label}_s"] = time.perf_counter() - t0
    g, c = _align_params(ra), _align_params(ra_cpu)
    vs.update(iterations=ra.iterations, cpu_iterations=ra_cpu.iterations,
              jacobian_shape=list(ra.jacobian_shape),
              max_param_rel=float(np.abs(g - c).max()
                                  / max(np.abs(c).max(), 1.0)))
    out["alignment_vs_cpu"] = vs
    log(f"  alignment card vs CPU: {json.dumps(vs)}")
    check(ra.iterations == ra_cpu.iterations
          and vs["max_param_rel"] <= SUB_ALIGN_REL,
          f"alignment: card = CPU within {SUB_ALIGN_REL} relative")
    return out


def facade_adjuster(problem, device, seed: int = 7):
    """`problem` (a mono perspective map of `synthetic_bundle`) through the
    BundleAdjuster facade with every constraint family: relative motions
    from each instance to its next FACADE_NEXT and relative rotations to
    the next one (observed from the initial poses, 1 mrad and 1 cm of
    noise), common positions and linear motions on consecutive pairs and
    triples, up vectors on every instance, a FACADE_HEATMAP_CELLS^2 bowl
    heatmap on FACADE_HEATMAPS instances, two reconstructions' scale
    variables (the first half shared, the second one an instance) and a
    gauge fix between instances 0 and NI / 2."""
    from opensfm_tpu_torch.ba import adjuster
    from opensfm_tpu_torch.geometry.cameras import Camera
    from opensfm_tpu_torch.geometry.pose import Pose, _matrix_to_rotvec_np

    rng = np.random.default_rng(seed)
    ni = len(problem.inst)
    sa = adjuster.BundleAdjuster(device=device)
    camera = Camera("perspective", problem.cam[0, :3])
    sa.add_camera("cam", camera, camera, False)
    sa.add_rig_camera("rc", Pose(), Pose(), True)
    ids = [f"s{i}" for i in range(ni)]
    poses = [Pose(x[:3], x[3:]) for x in problem.inst]
    for i, sid in enumerate(ids):
        sa.add_rig_instance(sid, poses[i], {sid: "cam"}, {sid: "rc"}, False)
        sa.add_rig_instance_position_prior(
            sid, problem.gps_pos[i], np.full(3, 1.0 / problem.gps_inv_sd[i]),
            "")
    for p, x in enumerate(problem.points):
        sa.add_point(str(p), x, False)
    for o in np.flatnonzero(problem.obs_inv_sd > 0):
        sa.add_point_projection_observation(
            ids[problem.obs_inst[o]], str(problem.obs_point[o]),
            problem.obs_uv[o], 1.0 / problem.obs_inv_sd[o])
    half = ni // 2
    for rec, members, shared in (("A", ids[:half], True),
                                 ("B", ids[half:], False)):
        sa.add_reconstruction(rec, False)
        for sid in members:
            sa.add_reconstruction_instance(rec, 1.0, sid)
        sa.set_scale_sharing(rec, shared)
    R = [p.get_rotation_matrix() for p in poses]
    o = [p.get_origin() for p in poses]
    for a in range(ni):
        for b in range(a + 1, min(a + 1 + FACADE_NEXT, ni)):
            rvec = _matrix_to_rotvec_np(R[b] @ R[a].T) \
                + rng.normal(size=3) * 1e-3
            sa.add_relative_motion(adjuster.RelativeMotion(
                ids[a], ids[b], rvec, R[b] @ (o[a] - o[b])
                + rng.normal(size=3) * 1e-2, 1.0, 1.0, False))
            if b == a + 1:
                sa.add_relative_rotation(adjuster.RelativeRotation(
                    ids[a], ids[b], rvec))
                sa.add_common_position(ids[a], ids[b], 100.0, 1.0)
                if b + 1 < ni:
                    sa.add_linear_motion(ids[a], ids[b], ids[b + 1], 0.5,
                                         1.0, 1.0)
        sa.add_absolute_up_vector(ids[a], R[a] @ [0.0, 0.0, 1.0], 1.0)
    n, res = FACADE_HEATMAP_CELLS, 0.25
    xy = (np.arange(n) - n / 2) * res
    bowl = 1.0 - np.exp(-(xy[None, :] ** 2 + xy[:, None] ** 2) / 32.0)
    sa.add_heatmap("bowl", bowl.reshape(-1).tolist(), n, res)
    for a in range(0, ni, max(ni // FACADE_HEATMAPS, 1))[:FACADE_HEATMAPS]:
        sa.add_absolute_position_heatmap(ids[a], "bowl", o[a][0], o[a][1],
                                         1.0)
    sa.set_gauge_fix_shots(ids[0], ids[half])
    sa.set_max_num_iterations(FACADE_ITERATIONS)
    return sa


def run_facade(big, dev="cuda"):
    """Phase 21 (b): phase 3's map through the BundleAdjuster facade with
    every constraint family (`facade_adjuster`), solved once with
    `compute_covariances=True` on the card: the cost falls, the kernel
    route's rows launch, the covariances are symmetric, finite and
    positive on the diagonal; the same at phase 5's 32 x 4,096 on the card
    against the CPU (phase 5's tolerance); and one LM step of
    `synthetic_bundle.add_pose_graph` on the 64 x 8,192 dense problem on
    the fused dense assembly against the canonical route's."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch.ba import lm

    out = {}
    t0 = time.perf_counter()
    sa = facade_adjuster(big, dev)
    problem = sa.build_problem()
    out["build_s"] = time.perf_counter() - t0
    counts = {f[0].split(":")[0]: int(np.asarray(getattr(problem, f[0].split(
        ":")[0])).shape[0]) for f in lm._GRAPH_FIELDS}
    out["families"] = dict(counts, scales=len(problem.scales),
                           up_vectors=len(problem.up_vec),
                           observations=len(problem.obs_uv))
    cov_s = []
    covariances = lm._instance_covariances

    def timed_covariances(*a, **k):
        t = time.perf_counter()
        r = covariances(*a, **k)
        torch.cuda.synchronize()
        cov_s.append(time.perf_counter() - t)
        return r

    lm._instance_covariances = timed_covariances
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = lm.bundle_adjust(problem, max_iterations=FACADE_ITERATIONS,
                               compute_covariances=True, device=dev)
        torch.cuda.synchronize()
        out["solve_s"] = time.perf_counter() - t0 - cov_s[0]
        out["covariances_s"] = cov_s[0]
        out["launches"] = launches()
    finally:
        lm._instance_covariances = covariances
    cov = res.covariances
    diag = np.einsum("aii->ai", cov)
    out.update(route=res.route, iterations=res.iterations,
               initial_cost=res.initial_cost, final_cost=res.final_cost,
               covariance_valid=res.covariance_valid,
               covariance_asymmetry=float(
                   np.abs(cov - cov.transpose(0, 2, 1)).max()
                   / np.abs(cov).max()),
               covariance_min_diagonal=float(diag.min()))
    log(f"  facade {FACADE_SHOTS} x {FACADE_POINTS} x K={FACADE_TRACK}: "
        f"{json.dumps({k: v for k, v in out.items() if k != 'launches'})}")
    log(f"  launches: {out['launches']}")
    check(res.final_cost < res.initial_cost, "facade: the cost falls")
    check(all(out["launches"][k] > 0 for k in ("fused_residual_jacobian",
                                                "fused_cost"))
          or all(out["launches"][k] > 0 for k in DENSE_KERNELS),
          "facade: rows 1-2 (or 3-5) launched")
    check(res.covariance_valid and np.all(np.isfinite(cov))
          and out["covariance_asymmetry"] <= 1e-9 and diag.min() > 0,
          "facade: covariances symmetric, finite, positive diagonal")

    # Card vs CPU at phase 5's size (its tolerance), covariances included.
    small = facade_adjuster(sb.make_problem(FACADE_CPU_SHOTS,
                                            FACADE_CPU_POINTS), dev)
    sp = small.build_problem()
    got = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        got[d] = lm.bundle_adjust(sp, max_iterations=3,
                                  compute_covariances=True, device=d)
        got[f"{d}_s"] = time.perf_counter() - t0
    g, c = got[dev], got["cpu"]
    vs = dict(card_s=got[f"{dev}_s"], cpu_s=got["cpu_s"],
              iterations=g.iterations, cpu_iterations=c.iterations,
              cost_rel=abs(g.final_cost - c.final_cost) / abs(c.final_cost),
              covariance_rel=float(np.abs(g.covariances - c.covariances).max()
                                   / np.abs(c.covariances).max()))
    out["vs_cpu"] = vs
    log(f"  facade {FACADE_CPU_SHOTS} x {FACADE_CPU_POINTS} card vs CPU: "
        f"{json.dumps(vs)}")
    check(g.iterations == c.iterations and vs["cost_rel"] <= 1e-8
          and vs["covariance_rel"] <= 1e-8,
          "facade: card = CPU (same iterations, cost and covariances within "
          "1e-8)")

    # One step on the fused dense assembly and on the canonical route.
    gp = sb.add_pose_graph(sb.make_problem(64, 8192))
    kw = dict(loss=gp.loss, loss_threshold=gp.loss_threshold, pmax=3, ni=64,
              nr=1, nc=1)
    _, dense, st, data = lm.device_problem(gp, torch.float64,
                                           torch.device(dev))
    check(dense and lm._fused_dense(st[3], 64, 3, dense),
          "64 x 8192 + pose graph takes the fused dense route")
    fused = lm._lm_step(st, data, 1e-3, dense=True, **kw)
    canonicalize = lm.canonicalize_problem_dense
    lm.canonicalize_problem_dense = lambda q: (lm.canonicalize_problem(q),
                                               False)
    try:
        _, dense_c, st_c, data_c = lm.device_problem(gp, torch.float64,
                                                     torch.device(dev))
    finally:
        lm.canonicalize_problem_dense = canonicalize
    check(not dense_c, "the canonical layout")
    canon = lm._lm_step(st_c, data_c, 1e-3, dense=False, **kw)
    out["fused_vs_canonical_step_rel"] = max(
        float((a - b).abs().max() / max(float(b.abs().max()), 1.0))
        for a, b in zip(fused, canon))
    log(f"  one step, fused dense vs canonical with the pose graph: "
        f"{out['fused_vs_canonical_step_rel']:.3e}")
    check(out["fused_vs_canonical_step_rel"] <= 1e-10,
          "fused dense and canonical steps agree within 1e-10")
    return out


def run_pose_graph(big, dev="cuda"):
    """Phase 21: the submodel path (a) and the pose-graph bundle (b)."""
    t0 = time.perf_counter()
    out = {"submodels": run_submodels(dev)}
    out["submodels"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["facade"] = run_facade(big, dev)
    out["facade"]["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# The dense-assembly ablation profiler (row 7)
# --------------------------------------------------------------------------

VARIANT_SHOTS, VARIANT_POINTS = 64, 8192  # the TPU script's problem


# A ragged ablation grid beside the profiler's: 6 NI = 222 (two ragged
# 128-wide product tiles, rows of 224 floats with a half-filled last
# 16-byte piece), K = 3,000 (not a multiple of the 16-row stage).
VARIANT_RAGGED = (37, 1000)


# Phase 22: statistics, the report and the synthetic circle scene.  The
# scene is tests/test_reconstruction_incremental.py:33-47's (seed 42, GPS
# noise 5 m, GCP noise (0.01, 0.1) m, 10 GCPs shifted by (10, 0, 100) m, its
# three config keys), graded by upstream's bounds (:57-83), fixed before
# the first card run: (low, high), both exclusive, ratio_cameras exactly 1.
CIRCLE_SEED = 42
CIRCLE_CONFIG = {"bundle_compensate_gps_bias": True, "bundle_use_gcp": True,
                 "bundle_max_iterations": 20}
CIRCLE_BOUNDS = {
    "ratio_points": (0.7, 1.0),
    "aligned_position_rmse": (0.0, 0.03),
    "aligned_rotation_rmse": (0.0, 0.003),
    "aligned_points_rmse": (0.0, 0.1),
    "absolute_gps_rmse": (3.0, 7.0),
    "absolute_gcp_rmse_horizontal": (0.01, 0.05),
    "absolute_gcp_rmse_vertical": (0.08, 0.18),
}
CIRCLE_BIAS = {0: (9.8, 10.4), 2: (99.8, 100.4)}  # GPS bias, x and z (m)
# stats.json card vs CPU: floats relative to the larger value, absolute
# below 1 (tests/test_torch_stats.py's rule; the numbers are host NumPy on
# both, the GCPs triangulated in f64 on each device).
STATS_REL = 1e-12
STATS_MIN_PAGES = 4
# What compute_statistics reads of phase 15's dataset, beyond what
# synthetic_bundle.subset_dataset copies (config, camera models, image
# list, exif/, features/).
STATS_FILES = ("tracks.csv", "reconstruction.json", "reference_lla.json")
SECTION_TITLES = ("Dataset Summary", "Processing Summary", "Features Details",
                  "Reconstruction Details", "Tracks Details",
                  "Camera Models Details", "Processing Time Details",
                  "GPS/GCP Errors Details")


def read_pdf(path):
    """(pages, text runs in order, images in order as (width, height,
    pixels)) of a PDF written by `opensfm_tpu_torch.pdf`, checking its
    structure on the way: every xref offset at its `n 0 obj`, every stream
    of its /Length, the page count, A4 pages, RGB 8-bit images."""
    import re
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    check(data.startswith(b"%PDF-1.4\n"), f"{path}: a PDF 1.4 header")
    start = int(re.search(rb"startxref\n(\d+)\n%%EOF\n$", data).group(1))
    check(data[start:start + 5] == b"xref\n", f"{path}: startxref -> xref")
    head = data[start + 5:].split(b"\n", 1)
    first, count = (int(v) for v in head[0].split())
    table, trailer = head[1][:20 * count], head[1][20 * count:]
    check(re.match(rb"trailer\n<< /Size %d /Root 1 0 R >>" % count, trailer)
          is not None, f"{path}: the trailer")
    objects = {}
    for k in range(count):
        entry = table[20 * k:20 * k + 20]
        if entry[17:18] == b"f":
            continue
        num, pos = first + k, int(entry[:10])
        prefix = b"%d 0 obj\n" % num
        check(data[pos:pos + len(prefix)] == prefix,
              f"{path}: xref offset of object {num}")
        body = data[pos + len(prefix):]
        m = re.match(rb"(<<.*?>>)\nstream\n", body, re.S)
        if m:
            length = int(re.search(rb"/Length (\d+)", m.group(1)).group(1))
            raw = body[m.end():m.end() + length]
            check(body[m.end() + length:].startswith(b"\nendstream\nendobj"),
                  f"{path}: /Length of object {num}")
            objects[num] = (m.group(1), zlib.decompress(raw)
                            if b"/FlateDecode" in m.group(1) else raw)
        else:
            objects[num] = (body[:body.index(b"\nendobj")], None)

    def ref(obj, key):
        return int(re.search(rb"/" + key + rb" (\d+) 0 R", obj).group(1))

    pages_obj = objects[ref(objects[1][0], b"Pages")][0]
    kids = [int(k) for k in re.findall(rb"(\d+) 0 R",
                                       pages_obj.split(b"/Kids")[1])]
    check(int(re.search(rb"/Count (\d+)", pages_obj).group(1)) == len(kids),
          f"{path}: /Count")
    texts, images = [], []
    for kid in kids:
        page = objects[kid][0]
        check(b"/MediaBox [0 0 595.28 841.89]" in page, f"{path}: A4 pages")
        content = objects[ref(page, b"Contents")][1]
        xobjects = dict(re.findall(rb"/(Im\d+) (\d+) 0 R", page))
        for m in re.finditer(rb"\(((?:\\.|[^\\)])*)\) Tj|/(Im\d+) Do",
                             content):
            if m.group(1) is not None:
                texts.append(re.sub(rb"\\(.)", rb"\1", m.group(1))
                             .decode("cp1252"))
                continue
            head_, pixels = objects[int(xobjects[m.group(2)])]
            check(b"/DeviceRGB" in head_ and b"/BitsPerComponent 8" in head_,
                  f"{path}: RGB 8-bit images")
            w = int(re.search(rb"/Width (\d+)", head_).group(1))
            h = int(re.search(rb"/Height (\d+)", head_).group(1))
            images.append((w, h, np.frombuffer(pixels, np.uint8)))
    return len(kids), texts, images


def _stats_gap(got, want, path=""):
    """Largest gap between two statistics trees (floats relative to the
    larger, absolute below 1); raises on any other difference."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and list(got) == list(want),
              f"stats keys at {path}")
        return max([_stats_gap(got[k], want[k], f"{path}.{k}")
                    for k in want] or [0.0])
    if isinstance(want, (list, tuple)):
        check(isinstance(got, (list, tuple)) and len(got) == len(want),
              f"stats length at {path}")
        return max([_stats_gap(g, w, f"{path}[{k}]")
                    for k, (g, w) in enumerate(zip(got, want))] or [0.0])
    if isinstance(want, float) and isinstance(got, float):
        return abs(got - want) / max(abs(got), abs(want), 1.0)
    check(type(got) is type(want) and got == want,
          f"stats {path}: {got!r} == {want!r}")
    return 0.0


def check_report(stats_path):
    """report.pdf under `stats_path`: well formed, >= STATS_MIN_PAGES pages,
    the section titles in order, each figure an image of its PNG's pixels.
    Returns the page count."""
    from opensfm_tpu_torch import io

    pages, texts, images = read_pdf(os.path.join(stats_path, "report.pdf"))
    check(pages >= STATS_MIN_PAGES, f"report.pdf has {pages} pages >= "
          f"{STATS_MIN_PAGES}")
    check(texts[:2] == ["OpenSfM Quality Report",
                        "Processed with OpenSfM-TPU"], "the report's title")
    it = iter(texts)
    check(all(any(t == title for t in it) for title in SECTION_TITLES),
          "the report's sections in order")
    names = sorted(os.listdir(stats_path))
    pngs = (["topview.png"] + [n for n in names if n.startswith("heatmap_")
                               and n.endswith(".png")][:4]
            + ["matchgraph.png"] + [n for n in names
                                    if n.startswith("residuals_")
                                    and n.endswith(".png")])
    pngs = [n for n in pngs if os.path.isfile(os.path.join(stats_path, n))]
    check(len(images) == len(pngs) >= 4, f"report images {len(images)} for "
          f"{pngs}")
    for (w, h, pixels), name in zip(images, pngs):
        png = io.imread(os.path.join(stats_path, name))
        check(png.shape[:2] == (h, w) and np.array_equal(pixels,
                                                         png.reshape(-1)),
              f"report image {name} equals its PNG")
    return pages


def _stats_copy(src, out):
    """A copy of phase 15's dataset with what compute_statistics reads;
    copy2 keeps reconstruction.json's mtime, and so the `date`."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch.dataset import DataSet

    sb.subset_dataset(src, out, DataSet(src).images())
    for name in STATS_FILES:
        if os.path.isfile(os.path.join(src, name)):
            shutil.copy2(os.path.join(src, name), out)
    shutil.copytree(os.path.join(src, "reports"), os.path.join(out, "reports"))


def _figure_specs(tm, rec):
    from opensfm_tpu_torch import stats

    return {"matchgraph": (stats.draw_matchgraph,
                           stats.matchgraph_figure(tm, [rec])),
            "topview": (stats.draw_topview, stats.topview_figure([rec])),
            "heatmap": (stats.draw_heatmap, stats.heatmap_figures([rec])[0]),
            "residual_grid": (stats.draw_residual_grid,
                              stats.residual_grid_figures(tm, [rec])[0])}


def run_statistics(dev="cuda"):
    """Phase 22.  (a) The circle scene from the port's synthetic_data
    (CIRCLE_SEED, `rng=RandomState`) through `incremental_reconstruction`
    on the card, graded by `synthetic_scene.compare` within CIRCLE_BOUNDS,
    the GPS bias recovered, rows 1 and 2 launched; its statistics and
    figures on the card against the CPU.  (b) `compute_statistics` and
    `export_report` through the command runner on a copy of phase 15's
    dataset on the card, `compute_statistics --device cpu` on a second
    copy: stats.json equal within STATS_REL, every figure bit-equal,
    report.pdf well formed (`check_report`)."""
    import copy

    from opensfm_tpu_torch import geo, reconstruction, stats
    from opensfm_tpu_torch.commands import command_runner, opensfm_commands
    from opensfm_tpu_torch.synthetic_data import (synthetic_dataset,
                                                  synthetic_examples,
                                                  synthetic_scene)

    out = {}
    t0 = time.perf_counter()
    rng = np.random.RandomState(CIRCLE_SEED)
    reference = geo.TopocentricConverter(47.0, 6.0, 0)
    scene = synthetic_examples.synthetic_circle_scene(reference, rng=rng)
    inp = synthetic_scene.SyntheticInputData(
        scene.get_reconstruction(), reference, 40, 1.0, 5.0, 0.1,
        (0.01, 0.1), False, 10, [10.0, 0.0, 100.0], rng=rng)
    data = synthetic_dataset.SyntheticDataSet(
        inp.reconstruction, inp.exifs, inp.features, inp.tracks_manager,
        inp.gcps)
    data.config.update(CIRCLE_CONFIG)
    out["circle_build_s"] = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    _, recs = reconstruction.incremental_reconstruction(
        data, inp.tracks_manager, device=dev)
    torch.cuda.synchronize()
    out["circle_reconstruct_s"] = time.perf_counter() - t0
    out["launches"] = launches()
    errors = synthetic_scene.compare(inp.reconstruction, inp.gcps, recs[0],
                                     device=dev)
    bias = recs[0].biases["1"].translation
    out["circle"] = {k: errors[k] for k in ("ratio_cameras",
                                            *CIRCLE_BOUNDS)}
    out["circle"]["bias"] = [float(v) for v in bias]
    out["circle"]["shots"] = [len(r.shots) for r in recs]
    n_obs = sum(len(inp.tracks_manager.get_shot_observations(s))
                for s in inp.tracks_manager.get_shot_ids())
    log(f"  circle scene ({len(inp.reconstruction.shots)} shots, "
        f"{len(inp.reconstruction.points)} points, "
        f"{n_obs} observations): built in "
        f"{out['circle_build_s']:.2f} s, reconstructed in "
        f"{out['circle_reconstruct_s']:.2f} s; {json.dumps(out['circle'])}")
    log(f"  kernel launches over the reconstruction: {out['launches']}")
    check(errors["ratio_cameras"] == 1.0, "circle: every shot reconstructed")
    for key, (lo, hi) in CIRCLE_BOUNDS.items():
        check(lo < errors[key] < hi, f"circle: {lo} < {key} "
              f"{errors[key]:.6g} < {hi}")
    for axis, (lo, hi) in CIRCLE_BIAS.items():
        check(lo < bias[axis] < hi, f"circle: GPS bias[{axis}] "
              f"{bias[axis]:.4f} in ({lo}, {hi})")
    for name in ("fused_residual_jacobian", "fused_cost"):
        check(out["launches"][name] > 0, f"{name} launched on the circle")

    # Its statistics and figures on the card against the CPU.
    rec = recs[0]
    card, cpu = copy.deepcopy(rec), copy.deepcopy(rec)
    t0 = time.perf_counter()
    got = stats.compute_all_statistics(data, inp.tracks_manager, [card],
                                       device=dev)
    out["circle_stats_s"] = time.perf_counter() - t0
    want = stats.compute_all_statistics(data, inp.tracks_manager, [cpu],
                                        device="cpu")
    out["circle_stats_gap"] = _stats_gap(got, want)
    check(out["circle_stats_gap"] <= STATS_REL,
          f"circle statistics card vs CPU {out['circle_stats_gap']:.3g}")
    out["circle_figure_ms"] = {}
    for name, (draw, spec) in _figure_specs(inp.tracks_manager,
                                            card).items():
        draw(spec, dev)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = draw(spec, dev)
        out["circle_figure_ms"][name] = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(image, draw(spec, "cpu")),
              f"circle {name}: card = CPU, bit for bit")
    log(f"  circle statistics {out['circle_stats_s']:.2f} s (card vs CPU "
        f"gap {out['circle_stats_gap']:.3g}); figures drawn on the card, "
        f"ms: {json.dumps(out['circle_figure_ms'])}")

    # (b) The commands on phase 15's dataset, card and CPU.
    src = os.path.join(WORK, "image_chain")
    paths = {d: os.path.join(WORK, f"statistics_{d}") for d in ("card", "cpu")}
    for path in paths.values():
        _stats_copy(src, path)
    for label, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        result = command_runner(opensfm_commands, argv=[
            "compute_statistics", paths[label], "--device", device])
        torch.cuda.synchronize()
        out[f"compute_statistics_{label}_s"] = time.perf_counter() - t0
        out[f"figures_{label}_s"] = result["figures_s"]
    t0 = time.perf_counter()
    command_runner(opensfm_commands, argv=["export_report", paths["card"],
                                           "--device", dev])
    out["export_report_s"] = time.perf_counter() - t0
    stats_dirs = {k: os.path.join(p, "stats") for k, p in paths.items()}
    with open(os.path.join(stats_dirs["card"], "stats.json")) as f:
        got = json.load(f)
    with open(os.path.join(stats_dirs["cpu"], "stats.json")) as f:
        want = json.load(f)
    out["stats_gap"] = _stats_gap(got, want)
    check(out["stats_gap"] <= STATS_REL,
          f"stats.json card vs CPU {out['stats_gap']:.3g}")
    figures = sorted(n for n in os.listdir(stats_dirs["card"])
                     if n.endswith(".png"))
    check(figures == sorted(n for n in os.listdir(stats_dirs["cpu"])
                            if n.endswith(".png")) and len(figures) >= 4,
          f"the same figures on the card and the CPU: {figures}")
    for name in figures:
        with open(os.path.join(stats_dirs["card"], name), "rb") as a, \
                open(os.path.join(stats_dirs["cpu"], name), "rb") as b:
            check(a.read() == b.read(), f"{name}: card = CPU, bit for bit")
    out["figures"] = figures
    out["report_pages"] = check_report(stats_dirs["card"])
    rs = got["reconstruction_statistics"]
    out["phase15_stats"] = {k: rs[k] for k in (
        "reconstructed_shots_count", "reconstructed_points_count",
        "observations_count", "reprojection_error_pixels")}
    log(f"  compute_statistics on phase 15's dataset: card "
        f"{out['compute_statistics_card_s']:.2f} s (figures s: "
        f"{json.dumps(out['figures_card_s'])}), CPU "
        f"{out['compute_statistics_cpu_s']:.2f} s; export_report "
        f"{out['export_report_s']:.2f} s, {out['report_pages']} pages; "
        f"stats.json card vs CPU gap {out['stats_gap']:.3g}; "
        f"{len(figures)} figures bit-equal; {json.dumps(out['phase15_stats'])}")
    # Phase 24's input: the circle as reconstructed on the card.
    out["circle_map"] = (rec, inp.tracks_manager, list(inp.gcps.values()))
    return out


# Phase 23: the sharded bundle (`opensfm_tpu_torch.parallel`).  Gates
# written before the first card run: the JAX tests' sharded-vs-single-device
# bounds (tests/test_distributed_pipeline.py:449-471 and :760-784,
# tests/test_distributed_ba.py:244-252, tests/test_multihost_ba.py).
SHARDS = 4  # virtual shards on cuda:0
SHARD_REL_COST = 1e-9  # relative final cost, f64 sharded vs one device
SHARD_PARAM = 1e-8  # inst, cam, rig cameras and points, f64
SHARD_GRAPH_REL_COST = 1e-7  # the pose-graph families
SHARD_GRAPH_INST = 1e-6
SHARD_GRAPH_SCALES = 1e-8
# The f32 dense-grid solve's final cost against the f64 solve's: 10 x the
# larger CPU reading of the same comparison (4 shards: 1.04e-6 at 32 x
# 4,096 x K=8, 4.81e-9 at 64 x 8,192 x K=8).
SHARD_F32_REL_COST = 1e-5
SHARD_CG_TOL = {"inst": (1e-5, 1e-6), "cam": (1e-5, 1e-6),
                "points": (1e-4, 1e-6)}  # (rtol, atol), fixed-lambda step
SHARD_SMALL = (32, 4096, 8)  # shots, points, track window: (b) and (c)
SHARD_RANKS = 2  # (d): gloo ranks on cuda:0, 2 shards each
SHARD_RANK_SIZE = (16, 1024, 8)  # (d)'s problem
SHARD_RANK_STEPS = 3


def _sharded_problem(kind):
    """Phase 23's (b) problems at SHARD_SMALL: an optimized rig camera with
    up-vector rows, or one pose-graph family (relative motions with two
    scale variables)."""
    import synthetic_bundle as sb

    p = sb.make_problem(*SHARD_SMALL[:2], track_window=SHARD_SMALL[2])
    ni = len(p.inst)
    if kind == "rig_opt_up":
        p.rigcam = np.array([[0.0, 0.02, 0.0, 0.1, 0.0, 0.05]])
        p.opt_rigcam = np.ones(1, bool)
        p.rigcam_prior = p.rigcam.copy()
        p.rigcam_prior_inv_sd = np.full((1, 6), 10.0)
        p.up_inst = np.arange(ni, dtype=np.int64)
        p.up_rigcam = np.zeros(ni, dtype=np.int64)
        p.up_vec = np.tile([0.0, 0.0, 1.0], (ni, 1))
        p.up_inv_sd = np.full(ni, 10.0)
        return p
    from opensfm_tpu_torch.geometry import rotation as rot

    i = np.arange(ni - 1, dtype=np.int32)
    j = i + 1
    Ri = rot.rotvec_to_matrix(torch.as_tensor(p.inst[i, :3])).numpy()
    Rj = rot.rotvec_to_matrix(torch.as_tensor(p.inst[j, :3])).numpy()
    rel = np.einsum("kij,klj->kil", Rj, Ri).transpose(0, 2, 1)
    K = len(i)
    p.scales = np.ones(2)
    p.opt_scales = np.array([False, True])
    p.rm_i, p.rm_j = i, j
    p.rm_si = np.zeros(K, np.int32)
    p.rm_sj = np.ones(K, np.int32)
    p.rm_rvec = rot.matrix_to_rotvec(torch.as_tensor(rel)).numpy()
    p.rm_tvec = np.zeros((K, 3))
    p.rm_scale = np.ones(K)
    p.rm_inv_sd = np.full((K, 7), 5.0)
    p.rm_obs_scale = np.zeros(K, bool)
    p.rm_loss_c = np.ones(K)
    return p


def _sharded_run(label, fn, out, counts):
    """Run `fn` with the launch counts from 0 and the peak memory reset;
    adds the launches to `counts` and records seconds and peak memory."""
    from opensfm_tpu_torch import context

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    context.reset_dispatch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launches()
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    out[label] = dict(s=secs, peak_bytes=torch.cuda.max_memory_allocated(),
                      trials=context.DISPATCH_COUNTS.get("sharded_trial", 0))
    return res, got


def _same_solve(label, got, want, rel_cost, param, iterations=True):
    rel = abs(got.final_cost - want.final_cost) / abs(want.final_cost)
    gaps = {k: float(np.abs(np.asarray(getattr(got, k))
                            - np.asarray(getattr(want, k))).max())
            for k in ("inst", "cam", "rigcam", "points")}
    log(f"  {label}: cost {got.initial_cost:.12g} -> {got.final_cost:.12g} "
        f"in {got.iterations} iterations (one device: {want.final_cost:.12g} "
        f"in {want.iterations}); rel {rel:.3g}; max gaps {gaps}")
    check(rel <= rel_cost, f"{label}: relative final cost {rel:.3g}")
    check(all(v <= param for v in gaps.values()),
          f"{label}: parameters within {param}")
    if iterations:
        check(got.iterations == want.iterations, f"{label}: iterations")
    return rel, gaps


def sharded_rank(port: int, rank: int, dev: str = "cuda") -> None:
    """Phase 23 (d), one rank of a gloo group on `dev` (run by
    `run_sharded` in a subprocess): SHARD_RANK_STEPS fixed-lambda CG steps
    on a mesh of SHARD_RANKS x 2 shards; prints the replicated outputs'
    checksums as JSON."""
    import torch.distributed as dist

    from opensfm_tpu_torch.parallel.mesh import Mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=SHARD_RANKS)
    try:
        inst, cam = _rank_steps(Mesh([dev] * 2, group=dist.group.WORLD),
                                dev)
        print(json.dumps({"rank": rank, "inst": inst, "cam": cam}),
              flush=True)
    finally:
        dist.destroy_process_group()


def _rank_steps(mesh, dev):
    """The (d) steps over `mesh`: checksums (sums of |x|) of inst and cam."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch.parallel import distributed_ba as dba

    problem = dba.shard_problem(sb.make_problem(
        *SHARD_RANK_SIZE[:2], track_window=SHARD_RANK_SIZE[2]),
        mesh.n_shards)
    a = {k: v.to(dev) for k, v in dba._cg_args(
        problem, mesh.n_shards, np.float64).items()}
    a["lam"] = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    win = problem.cg_window
    step = dba.make_sharded_cg_lm_step(
        mesh, "points", "perspective", 3, len(problem.inst),
        len(problem.cam), cg_iters=200, win=win)
    for _ in range(SHARD_RANK_STEPS):
        a["inst"], a["cam"], a["points"] = step(*(a[k] for k in step.names))
    return (float(a["inst"].abs().sum()), float(a["cam"].abs().sum()))


def run_sharded(big, card, dev="cuda"):
    """Phase 23: the sharded bundle on the card (see the module
    docstring).  Returns the phase's figures and the launches of its
    sharded runs."""
    import socket

    from opensfm_tpu_torch.parallel import mesh as mesh_lib

    vmesh = mesh_lib.virtual_mesh(dev, SHARDS)
    out, counts, runs = {"card": card, "shards": SHARDS}, {}, {}
    # (d)'s ranks start first: their processes' start-up (~10 s) overlaps
    # (a)-(c), whose seconds are read with them running beside.
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    t_ranks = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         f"chip_smoke.sharded_rank({port}, {rank}, {dev!r})"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(SHARD_RANKS)]
    try:
        return _run_sharded(big, dev, vmesh, out, counts, runs, procs,
                            t_ranks)
    finally:
        for p_ in procs:  # only after a failure are they still running
            if p_.poll() is None:
                p_.kill()
                p_.wait()


def _run_sharded(big, dev, vmesh, out, counts, runs, procs, t_ranks):
    """Phase 23's (a)-(e), with (d)'s ranks already started."""
    import synthetic_bundle as sb
    from opensfm_tpu_torch.ba import lm
    from opensfm_tpu_torch.parallel import distributed_ba as dba
    from opensfm_tpu_torch.parallel import mesh as mesh_lib

    # (a) The dense-grid route at phase 3's size, f64 and f32.
    t0 = time.perf_counter()
    want = lm.bundle_adjust(big, dtype=torch.float64, device=dev)
    out["single_device_s"] = time.perf_counter() - t0
    dense = {}
    for dt in (np.float64, np.float32):
        res, got = _sharded_run(
            f"dense_{dt.__name__}",
            lambda: dba.bundle_adjust_sharded(big, dtype=dt, mesh=vmesh),
            runs, counts)
        check(res.route == "sharded_dense", "phase 3's map takes the grid")
        dense[dt] = res
        trials = runs[f"dense_{dt.__name__}"]["trials"]
        runs[f"dense_{dt.__name__}"].update(iterations=res.iterations,
                                            launches=got)
        check(got["fused_schur_assembly"] == got["fused_back_substitute"]
              == SHARDS * trials and trials >= res.iterations > 0,
              f"rows 4 and 5: shards x trials ({trials}; {got})")
        check(got["fused_cost_dense"] == SHARDS * (trials + 1),
              f"row 3: shards x (trials + the initial cost) ({got})")
    rel, gaps = _same_solve("(a) dense f64", dense[np.float64], want,
                            SHARD_REL_COST, SHARD_PARAM)
    rel32 = abs(dense[np.float32].final_cost - dense[np.float64].final_cost) \
        / dense[np.float64].final_cost
    log(f"  (a) dense f32: cost {dense[np.float32].final_cost:.9g} in "
        f"{dense[np.float32].iterations} iterations; rel to f64 {rel32:.3g}")
    check(rel32 <= SHARD_F32_REL_COST, f"(a) f32 relative cost {rel32:.3g}")
    out["dense"] = dict(rel_cost=rel, gaps=gaps, rel_cost_f32=rel32)

    # (b) The assembled-Schur route: a rig with up-vector rows, one
    # pose-graph family; f64 against one device.
    for kind in ("rig_opt_up", "relative_motion"):
        p = _sharded_problem(kind)
        want = lm.bundle_adjust(p, max_iterations=12, device=dev)
        res, got = _sharded_run(
            f"schur_{kind}",
            lambda: dba.bundle_adjust_sharded(
                p, max_iterations=12, dtype=np.float64, mesh=vmesh,
                solver="schur"), runs, counts)
        check(res.route == "sharded_schur", f"(b) {kind}: the Schur route")
        runs[f"schur_{kind}"].update(iterations=res.iterations,
                                     launches=got)
        if kind == "rig_opt_up":
            out[kind] = _same_solve(f"(b) {kind}", res, want,
                                    SHARD_REL_COST, SHARD_PARAM)
        else:
            rel = abs(res.final_cost - want.final_cost) / want.final_cost
            dinst = float(np.abs(res.inst - want.inst).max())
            dscale = float(np.abs(res.scales - want.scales).max())
            log(f"  (b) {kind}: rel {rel:.3g}, inst {dinst:.3g}, scales "
                f"{dscale:.3g}; {res.iterations} iterations")
            check(rel <= SHARD_GRAPH_REL_COST and dinst <= SHARD_GRAPH_INST
                  and dscale <= SHARD_GRAPH_SCALES, f"(b) {kind} gates")
            check(got["fused_cost"] > 0, "(b) row 1 on the Schur cost")
            out[kind] = dict(rel_cost=rel, inst=dinst, scales=dscale)

    # (c) One fixed-lambda CG step against the replicated-dense step.
    p = dba.shard_problem(sb.make_problem(
        *SHARD_SMALL[:2], track_window=SHARD_SMALL[2]), SHARDS)
    a = {k: v.to(dev) for k, v in dba._cg_args(p, SHARDS,
                                                np.float64).items()}
    a["lam"] = torch.tensor(1e-4, dtype=torch.float64, device=dev)
    ni, nr, nc = len(p.inst), len(p.rigcam), len(p.cam)
    zero_priors = dict(a, cam_prior_inv_sd=torch.zeros_like(
        a["cam_prior_inv_sd"]), point_prior_inv_sd=torch.zeros_like(
        a["point_prior_inv_sd"]))
    ref_step = dba.make_sharded_lm_step(vmesh, "points", "perspective", 3,
                                        ni, nr, nc)
    want = ref_step(*(a[k] for k in ref_step.names[:10]),
                    torch.as_tensor(p.point_obs, dtype=torch.int32,
                                    device=dev),
                    *(a[k] for k in ref_step.names[11:]))
    cg = dba.make_sharded_cg_lm_step(vmesh, "points", "perspective", 3, ni,
                                     nc, cg_iters=400, cg_tol=1e-12,
                                     win=p.cg_window)
    t0 = time.perf_counter()
    got_cg = cg(*(zero_priors[k] for k in cg.names))
    torch.cuda.synchronize()
    gaps = {}
    for (name, (rtol, atol)), g, w in zip(SHARD_CG_TOL.items(), got_cg, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        gaps[name] = float(np.max(np.abs(g - w) / (atol + rtol * np.abs(w))))
    log(f"  (c) CG step against the dense step: {time.perf_counter() - t0:.2f}"
        f" s; gap / tolerance {gaps}")
    check(all(v <= 1.0 for v in gaps.values()), "(c) CG step within bounds")
    res, got = _sharded_run(
        "cg_solve", lambda: dba.bundle_adjust_sharded(
            sb.make_problem(*SHARD_SMALL[:2], track_window=SHARD_SMALL[2]),
            max_iterations=5, dtype=np.float64, mesh=vmesh, solver="cg"),
        runs, counts)
    check(res.route == "sharded_cg" and res.final_cost < res.initial_cost
          and got["fused_cost"] > 0, f"(c) CG solve, row 1 ({got})")
    runs["cg_solve"].update(iterations=res.iterations, launches=got)
    out["cg_step"] = gaps

    # (d), collected below: two ranks of a gloo group on the card, 2 shards
    # each, against one process's 4-shard mesh.
    ranks = []
    for p_ in procs:
        try:
            so, se = p_.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        check(p_.returncode == 0, f"(d) rank failed: {se[-2000:]}")
        ranks.append(json.loads(so.strip().splitlines()[-1]))
    single = _rank_steps(vmesh, dev)
    r0, r1 = ((r["inst"], r["cam"]) for r in ranks)
    log(f"  (d) {SHARD_RANKS} gloo ranks: {time.perf_counter() - t_ranks:.1f}"
        f" s from their start; "
        f"checksums {r0} / {r1}; one process {single}")
    check(np.allclose(r0, r1, rtol=1e-12, atol=0), "(d) ranks agree")
    check(np.allclose(r0, single, rtol=1e-8, atol=0),
          "(d) ranks equal the one-process mesh")
    out["ranks"] = dict(checksums=[r0, r1], one_process=single)

    # (e) More than one card: the same map on default_mesh() and through
    # the bundle command.
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        mesh = mesh_lib.default_mesh()
        res, got = _sharded_run(
            "default_mesh", lambda: dba.bundle_adjust_sharded(
                big, dtype=np.float64, mesh=mesh), runs, counts)
        _same_solve("(e) default_mesh", res, dense[np.float64], 1e-9, 1e-8)
        path = os.path.join(WORK, "bundle_sharded")
        shutil.rmtree(path, ignore_errors=True)
        sb.write_dataset(path, big, {"bundle_distributed": "yes"})
        from opensfm_tpu_torch.commands import command_runner, \
            opensfm_commands

        rep = command_runner(opensfm_commands, argv=["bundle", path])[0]
        check(rep["route"].startswith("sharded_")
              and rep["final_cost"] < rep["initial_cost"],
              f"(e) the bundle command sharded over {n_dev} cards")
        out["multi_card"] = dict(devices=n_dev, route=rep["route"])
    else:
        log(f"  (e) multi-card run did not happen: {n_dev} CUDA device "
            f"visible (it needs a machine with more than one card)")
        out["multi_card"] = None
    out["runs"] = runs
    return out, counts


# Phase 24: the GCP annotation tool (`opensfm_tpu_torch.annotation`) on
# phase 22's circle as reconstructed on the card.  Its shots, sorted by id,
# go to two sequences in turn (two passes over one street, as the tool
# aligns them: disjoint shots, common GCPs), each with the points that two
# of its shots observe; the second sequence is moved by ANNOT_SIMILARITY.
# Bounds written before the first card run: 3.5 times the larger CPU
# reading of the two packages (the rule of phases 15 and 21), from the same
# steps on the circle reconstructed by the port on the CPU (CIRCLE_CONFIG;
# 20 shots, 4,896 points; sequences of 3,468 and 3,201 points, 7 common
# GCPs).  The readings, port = JAX package to 1e-11: GCP RMS rigid
# 8.1759e-4, flex and full 7.0620e-4; scale error 9.659e-4, rotation
# 0.0849 deg, shift 0.1001 m.  ANNOT_REL is the CPU tests' parity
# tolerance.
ANNOT_SIMILARITY = (1.3, 20.0, (5.0, 0.0, 0.0))  # scale, yaw (deg), shift (m)
ANNOT_MODES = ("rigid", "flex", "full")
ANNOT_REL = 1e-8  # full, card vs CPU: poses, points, covariances, median std
ANNOT_MAX_RMS = {"rigid": 2.862e-3, "flex": 2.472e-3,
                 "full": 2.472e-3}  # GCP reprojection RMS by mode
ANNOT_MAX_SCALE_ERR = 3.381e-3  # |s / s_true - 1| of the recovered similarity
ANNOT_MAX_ROT_DEG = 0.2972  # its rotation's angle from the true inverse's
ANNOT_MAX_SHIFT = 0.3504  # its translation's distance from the true one (m)
ANNOT_MIN_COMMON = 3  # GCPs both sequences triangulate
# multiview.triangulate_gcp's thresholds: a GCP is triangulated or not with
# at least GCP_MARGIN of room on each, so no device's rounding flips it.
GCP_MIN_RAY_DEG, GCP_MAX_REPROJ, GCP_MARGIN = 1.0, 0.02, 0.1
ROUTE_ROWS = {"canonical": ("fused_residual_jacobian", "fused_cost"),
              "dense": ("fused_residual_jacobian", "fused_cost_dense"),
              "fused_dense": DENSE_KERNELS}


def annotation_similarity():
    """(s, A, b) of ANNOT_SIMILARITY: y = s A x + b, A a yaw."""
    s, yaw, shift = ANNOT_SIMILARITY
    c, si = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    A = np.array([[c, -si, 0.0], [si, c, 0.0], [0.0, 0.0, 1.0]])
    return s, A, np.asarray(shift, dtype=np.float64)


def write_annotation_dataset(root, rec, tracks_manager, gcps, config=None,
                             point_stride=1):
    """Write `rec` as the annotation tool's two sequences under `root`:
    shots sorted by id go to sequence a and b in turn; each holds every
    `point_stride`-th of the points (by id) that two of its shots observe
    in `tracks_manager`; b is moved by ANNOT_SIMILARITY.  With them: the
    tracks, `gcps`, the camera models, the reference, `config` and an empty
    file a shot under images/.  Returns the two lists of shot ids."""
    from opensfm_tpu_torch import io, types
    from opensfm_tpu_torch.align import apply_similarity
    from opensfm_tpu_torch.dataset import DataSet

    ids = sorted(rec.shots)
    halves = []
    for shot_ids in (ids[0::2], ids[1::2]):
        half = types.Reconstruction()
        half.reference = rec.reference
        seen = {}
        for sid in shot_ids:
            half.add_shot(rec.shots[sid])
            for tid in tracks_manager.get_shot_observations(sid):
                seen[tid] = seen.get(tid, 0) + 1
        keep = [p for p in sorted(rec.points) if seen.get(p, 0) >= 2]
        for pid in keep[::point_stride]:
            point = half.create_point(pid, rec.points[pid].coordinates.copy())
            point.color = rec.points[pid].color
        halves.append(half)
    apply_similarity(halves[1], *annotation_similarity())
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "images"))
    for sid in ids:
        open(os.path.join(root, "images", sid), "wb").close()
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in (config or {}).items())
                or "{}\n")
    data = DataSet(root)
    data.save_camera_models(rec.cameras)
    data.save_tracks_manager(tracks_manager)
    lla = rec.reference
    data.save_reference_lla({"latitude": lla.lat, "longitude": lla.lon,
                             "altitude": lla.alt})
    data.save_reconstruction(halves)
    with open(os.path.join(root, "ground_control_points.json"), "w") as f:
        io.write_ground_control_points(list(gcps), f)
    return ids[0::2], ids[1::2]


def gcp_margins(gcps, shots):
    """{gcp id: None below two rays, else (largest angle between two rays
    in degrees, largest angle from a ray to the midpoint in radians)}: the
    two quantities `multiview.triangulate_gcp` holds against its
    thresholds, in NumPy f64 on the host."""
    out = {}
    for gcp in gcps:
        origins, rays = [], []
        for obs in gcp.observations:
            shot = shots.get(obs.shot_id)
            if shot is None:
                continue
            rays.append(shot.pose.get_rotation_matrix().T
                        @ shot.camera.bearing(obs.projection))
            origins.append(shot.pose.get_origin())
        if len(rays) < 2:
            out[gcp.id] = None
            continue
        o = np.asarray(origins)
        b = np.asarray(rays) / np.linalg.norm(rays, axis=1, keepdims=True)
        proj = np.eye(3)[None] - b[:, :, None] * b[:, None, :]
        x = np.linalg.solve(proj.sum(0), np.einsum("kij,kj->i", proj, o))
        cos = np.clip(b @ b.T, -1.0, 1.0)
        to_x = (x - o) / np.linalg.norm(x - o, axis=1, keepdims=True)
        err = np.arccos(np.clip(np.sum(to_x * b, axis=1), -1.0, 1.0))
        out[gcp.id] = (float(np.degrees(np.arccos(cos.min()))),
                       float(err.max()))
    return out


def gcp_margin(margins) -> float:
    """The smallest relative room of any GCP of `margins` (gcp_margins) from
    either threshold; inf where no GCP has two rays."""
    room = [min(abs(m[0] / GCP_MIN_RAY_DEG - 1.0),
                abs(m[1] / GCP_MAX_REPROJ - 1.0))
            for m in margins.values() if m is not None]
    return min(room, default=float("inf"))


def _annotation_state(rec):
    """Poses, points and shot covariances of a merged map, by id."""
    ids = sorted(rec.shots)
    cov = [rec.shots[s].covariance for s in ids]
    return dict(
        poses=np.array([np.r_[rec.shots[s].pose.rotation,
                              rec.shots[s].pose.translation] for s in ids]),
        points=np.array([rec.points[p].coordinates
                         for p in sorted(rec.points)]),
        covariances=(np.array(cov) if all(c is not None for c in cov)
                     else None))


def _relgap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _post(port, route, body):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def run_annotation(circle, dev="cuda"):
    """Phase 24.  Phase 22's circle as two sequences
    (`write_annotation_dataset`): every GCP at least GCP_MARGIN from the
    triangulation's thresholds in each sequence; the similarity recovered
    from the GCPs within the ANNOT_ bounds of the true inverse; the port's
    `run_ba.align` in rigid, flex and full on `dev` (seconds, launches, the
    bundle's route, whose rows must launch; GCP RMS within ANNOT_MAX_RMS;
    full's covariances valid); full again on the CPU (poses, points,
    covariances and median_shot_std within ANNOT_REL); and one POST
    /analyze full through the tool's server on `dev`."""
    import threading

    from opensfm_tpu_torch.annotation import main as tool
    from opensfm_tpu_torch.annotation import run_ba
    from opensfm_tpu_torch.dataset import DataSet

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    rec, tracks_manager, gcps = circle
    out = {}
    paths = {d: os.path.join(WORK, f"annotation_{d}") for d in ("card", "cpu")}
    t0 = time.perf_counter()
    ids = write_annotation_dataset(paths["card"], rec, tracks_manager, gcps)
    shutil.rmtree(paths["cpu"], ignore_errors=True)
    shutil.copytree(paths["card"], paths["cpu"])
    data = DataSet(paths["card"])
    halves = data.load_reconstruction()
    gcp_list = data.load_ground_control_points()
    out["write_s"] = time.perf_counter() - t0
    out["sequences"] = [[len(h.shots), len(h.points)] for h in halves]
    margins = [gcp_margins(gcp_list, h.shots) for h in halves]
    out["gcp_margin"] = min(gcp_margin(m) for m in margins)
    check(out["gcp_margin"] >= GCP_MARGIN, f"every GCP {out['gcp_margin']:.3g}"
          f" >= {GCP_MARGIN} from the triangulation's thresholds")

    # The similarity that brings b back onto a.
    coords = [run_ba.triangulate_gcps(gcp_list, h, device=dev)
              for h in halves]
    out["common_gcps"] = sum(a is not None and b is not None
                             for a, b in zip(*coords))
    s, A, b = run_ba.find_alignment(*coords, device=dev)
    s0, A0, b0 = annotation_similarity()
    cos = (np.trace(A @ A0) - 1.0) / 2.0  # A against the inverse, A0^T
    out["similarity"] = dict(
        scale_err=abs(s * s0 - 1.0),
        rot_err_deg=float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))),
        shift_err=float(np.linalg.norm(b - (-A0.T @ b0 / s0))))
    check(out["common_gcps"] >= ANNOT_MIN_COMMON,
          f"{out['common_gcps']} common GCPs >= {ANNOT_MIN_COMMON}")
    for key, bound in (("scale_err", ANNOT_MAX_SCALE_ERR),
                       ("rot_err_deg", ANNOT_MAX_ROT_DEG),
                       ("shift_err", ANNOT_MAX_SHIFT)):
        check(out["similarity"][key] <= bound, f"recovered similarity "
              f"{key} {out['similarity'][key]:.3g} <= {bound}")

    # The three modes on `dev`, then full on the CPU.
    solves, bundled = [], []
    bundle_adjust, with_fixed = run_ba.bundle_adjust, run_ba.bundle_with_fixed_images

    def solve(*args, **kw):
        result = bundle_adjust(*args, **kw)
        solves.append(dict(route=result.route, iterations=result.iterations,
                           cost=[result.initial_cost, result.final_cost]))
        return result

    def fixed(reconstruction, *args, **kw):
        valid = with_fixed(reconstruction, *args, **kw)
        bundled.append(_annotation_state(reconstruction))
        return valid

    run_ba.bundle_adjust, run_ba.bundle_with_fixed_images = solve, fixed
    try:
        out["modes"], counts = {}, {name: 0 for name in BA_KERNELS}
        for mode in ANNOT_MODES:
            reset_launches()
            t0 = time.perf_counter()
            report = run_ba.align(paths["card"], mode=mode, device=dev)
            sync()
            seconds = time.perf_counter() - t0
            n = launches()
            for name in BA_KERNELS:
                counts[name] += n[name]
            out["modes"][mode] = dict(
                s=seconds, gcp_rms=report["gcp_reprojection_rms"],
                launches={k: n[k] for k in BA_KERNELS},
                **({} if mode == "rigid" else dict(
                    solve=solves[-1],
                    covariance_valid=report["covariance_valid"],
                    median_shot_std=report["median_shot_std"],
                    accepted=report["accepted"])))
            log(f"  {mode} on {dev}: {seconds:.2f} s; "
                f"{json.dumps(out['modes'][mode])}")
            check(report["gcp_reprojection_rms"] <= ANNOT_MAX_RMS[mode],
                  f"{mode}: GCP RMS {report['gcp_reprojection_rms']:.4g} <= "
                  f"{ANNOT_MAX_RMS[mode]}")
        full = report
        check(full["covariance_valid"], "full: covariances valid")
        t0 = time.perf_counter()
        cpu = run_ba.align(paths["cpu"], mode="full", device="cpu")
        out["full_cpu_s"] = time.perf_counter() - t0
    finally:
        run_ba.bundle_adjust = bundle_adjust
        run_ba.bundle_with_fixed_images = with_fixed
    out["routes"] = sorted({x["route"] for x in solves})
    out["launches"] = counts
    for route in out["routes"]:
        for name in ROUTE_ROWS.get(route, ()):
            check(counts[name] > 0, f"{name} launched on the {route} route")
    check(solves[-1]["iterations"] == solves[-2]["iterations"],
          "full on the card and the CPU: same iterations")
    card, host = bundled[-2], bundled[-1]
    out["card_vs_cpu"] = {k: _relgap(card[k], host[k])
                          for k in ("poses", "points", "covariances")}
    out["card_vs_cpu"]["median_shot_std"] = _relgap(
        full["median_shot_std"], cpu["median_shot_std"])
    log(f"  full on the CPU: {out['full_cpu_s']:.2f} s; card vs CPU "
        f"{json.dumps(out['card_vs_cpu'])}")
    for key, gap in out["card_vs_cpu"].items():
        check(gap <= ANNOT_REL, f"full card vs CPU: {key} {gap:.3g} <= "
              f"{ANNOT_REL}")
    check(full["accepted"] == cpu["accepted"], "full: the same verdict")

    # One analysis through the tool's server.
    server = tool.make_server(paths["card"], 0, dev, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        served = _post(server.server_address[1], "/analyze", {"mode": "full"})
        out["server_full_s"] = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    out["server_gap"] = _relgap(served["median_shot_std"],
                                full["median_shot_std"])
    check(served["accepted"] == full["accepted"]
          and out["server_gap"] <= ANNOT_REL,
          f"POST /analyze full = align full ({out['server_gap']:.3g})")
    log(f"  {len(ids[0])} + {len(ids[1])} shots, {out['common_gcps']} common "
        f"GCPs, margin {out['gcp_margin']:.3g}; similarity "
        f"{json.dumps(out['similarity'])}; routes {out['routes']}, launches "
        f"{counts}; POST /analyze full {out['server_full_s']:.2f} s")
    return out


def check_assembly_variants():
    """Phase 13: each mode's kernel against its plain version on the card,
    at the profiler's 64 x 8,192 problem and on VARIANT_RAGGED, f32: every
    written out_obs row and s_ii within TOL_DENSE[f32]["out"] of its largest
    entry, the same bits twice.  Returns (the profiler problem's inputs, the
    worst absolute difference)."""
    from opensfm_tpu_torch.ops.kernels import assembly_variants as V
    from opensfm_tpu_torch.tools import profile_kernel_variants as tool

    tol = TOL_DENSE[torch.float32]["out"]
    worst = 0.0
    for shots, points in ((VARIANT_SHOTS, VARIANT_POINTS), VARIANT_RAGGED):
        args = tool.variant_inputs(tool.dense_problem(shots, points),
                                   torch.device("cuda"))
        if shots == VARIANT_SHOTS:
            lane = args
        for mode in V.MODES:
            got = V.assembly_variant(mode, *args)
            want = V.assembly_variant_plain(mode, *args)
            again = V.assembly_variant(mode, *args)
            torch.cuda.synchronize()
            rows = V.rows_written(mode)
            pairs = [(f"out_obs[{r}]", got[0][r], want[0][r])
                     for r in range(rows)]
            pairs.append(("s_ii", got[1], want[1]))
            rel = 0.0
            for name, a, b in pairs:
                check(bool(torch.isfinite(a).all()), f"{mode} {name} finite")
                rel = max(rel, _rel(a, b))
                worst = max(worst, float((a - b).abs().max()))
            check(rel <= tol, f"assembly_variant {mode} {shots} x {points}: "
                  f"rel {rel:.3g}")
            check(torch.equal(got[0][:rows], again[0][:rows])
                  and torch.equal(got[1], again[1]),
                  f"assembly_variant {mode} is deterministic")
            check(bool((got[1].abs().max() > 0) == V.has_product(mode)),
                  f"assembly_variant {mode}: s_ii zero exactly without "
                  f"product")
            log(f"  {mode} {shots} x {points}: {rows} out_obs rows and s_ii "
                f"within {tol:g} (largest rel {rel:.3g}), bit-equal twice")
    return lane, worst


def time_product_step(args):
    """Phase 13: the `full` mode's product step alone (`assembly_product`:
    split product and fixed-order sum) beside torch.mm(op_a.T, op_g), FP32
    with TF32 off, on the same operands (the plain slot pass's, [3 NP,
    6 NI]); both timed by `_time_ms`.  The port never calls torch.mm here:
    it is the yardstick of what FP32 SIMT reaches on this card.  Returns
    (kernel ms, torch.mm ms)."""
    from opensfm_tpu_torch.ops.kernels import assembly_variants as V

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    op_a, op_g = (t.contiguous() for t in V.operands_plain("full", *args))
    got = V.assembly_product(op_a, op_g)
    want = torch.mm(op_a.T, op_g)
    rel = _rel(got, want)
    check(rel <= TOL_DENSE[torch.float32]["out"],
          f"the product step against torch.mm: rel {rel:.3g}")
    check(torch.equal(got, V.assembly_product(op_a, op_g)),
          "the product step is deterministic")
    ms = _time_ms(lambda: V.assembly_product(op_a, op_g))
    mm_ms = _time_ms(lambda: torch.mm(op_a.T, op_g))
    K, n = op_a.shape
    log(f"  product step, operands [{K}, {n}] f32: assembly_product "
        f"{ms:.4f} ms ({2 * n * n * K / ms / 1e9:.1f} TFLOP/s), "
        f"torch.mm(op_a.T, op_g) {mm_ms:.4f} ms "
        f"({2 * n * n * K / mm_ms / 1e9:.1f} TFLOP/s); within {rel:.3g}")
    return ms, mm_ms


def time_assembly_variants(args, rows):
    """Phase 13: the profiler's entry point for all five modes, with the
    launch counts read around it; each mode's time beside its bound and its
    plain version."""
    from opensfm_tpu_torch.ops.kernels import assembly_variants as V
    from opensfm_tpu_torch.tools import profile_kernel_variants as tool

    reset_launches()
    times = tool.profile(V.MODES, "cuda", VARIANT_SHOTS, VARIANT_POINTS)
    torch.cuda.synchronize()
    n_launch = launches()["assembly_variant"]
    check(n_launch > 0, "assembly_variant launched by the profiler")
    n_p, ni = args[0].shape
    slots = n_p * ni
    inputs = sum(t.numel() * t.element_size() for t in args)
    n6 = 6 * ni
    for mode in V.MODES:
        nbytes = inputs + (V.rows_written(mode) * slots + n6 * n6) * 4
        per_slot = FLOPS_RESJAC_OBS if mode in ("full", "nomatmul", "noout") \
            else FLOPS_COST_OBS
        flops = slots * per_slot + (2 * n6 * n6 * 3 * n_p
                                    if V.has_product(mode) else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3  # FP32, no TF32
        ms_plain = _time_ms(lambda m=mode: V.assembly_variant_plain(m, *args))
        rows.setdefault("assembly_variant", {})[mode] = dict(
            ms=times[mode], plain_ms=ms_plain, library_ms=None,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, flops=flops)
        log(f"  {mode:9s} {times[mode]:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), plain {ms_plain:.4f} ms")
    return n_launch


def ptxas_report(ptxas: str):
    """{kernel: dict(regs, stack, spill_st, spill_ld)} (bytes but regs) from
    nvcc -Xptxas -v.  A kernel's properties are the first stack-frame line
    after its entry; later ones before the next entry belong to the
    functions it calls (the math library's slow paths)."""
    import re

    out, name = {}, None
    for line in ptxas.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
            out[name] = dict(regs=None, stack=None, spill_st=None,
                             spill_ld=None)
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if hit and out[name]["stack"] is None:
            out[name].update(stack=int(hit.group(1)),
                             spill_st=int(hit.group(2)),
                             spill_ld=int(hit.group(3)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name]["regs"] = int(hit.group(1))
    return out


def ptxas_spills(ptxas: str):
    """{kernel: (spill store bytes, spill load bytes)} from nvcc -Xptxas -v."""
    return {k: (v["spill_st"], v["spill_ld"])
            for k, v in ptxas_report(ptxas).items()}


# Wrapper -> the kernel entry that ptxas reports and the trace counts for it.
ROW_KERNEL = {"fused_cost": "cost_kernel",
              "fused_cost_dense": "cost_dense_kernel",
              "fused_back_substitute": "backsub_kernel",
              "assembly_variant": "product_kernel"}


def redesigned_ptxas(libs_log):
    """Phase 1: registers, stack frame and spills of the redesigned kernels
    (rows 1, 3 and 5: 2 types x 5 losses each; row 4's f64 tensor-core
    product; row 7's product), summarised per kernel and type; fails on a
    spill."""
    from opensfm_tpu_torch.ops.kernels import assembly_variants as V
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K

    summary = {}
    for source, key, count, types in (
            (K.SOURCE, "cost_kernel", 10, ("f64", "f32")),
            (A.SOURCE, "cost_dense_kernel", 10, ("f64", "f32")),
            (A.SOURCE, "backsub_kernel", 10, ("f64", "f32")),
            (A.SOURCE, "syrk_dmma_kernel", 1, ("f64",)),
            (V.SOURCE, "product_kernel", 1, ("f32",))):
        found = {k: v for k, v in ptxas_report(libs_log[source][1]).items()
                 if f"{len(key)}{key}" in k}
        check(len(found) == count,
              f"{count} {key} instantiations in ptxas's report, "
              f"{len(found)} found")
        for dt in types:
            tag = {"f64": "Id", "f32": "If"}[dt]
            rows = [v for k, v in found.items()
                    if len(types) == 1 or f"{key}{tag}" in k]
            summary[f"{key} {dt}"] = dict(
                regs=sorted({r["regs"] for r in rows}),
                stack=sorted({r["stack"] for r in rows}),
                spill=sorted({(r["spill_st"], r["spill_ld"]) for r in rows}))
        check(all(v["spill_st"] == 0 and v["spill_ld"] == 0
                  for v in found.values()), f"{key} does not spill")
    return summary


# f64 mma.sync shapes: (A, B, C/D) registers per thread.  m8n8k4 is sm_80's;
# the m16n8 ones are sm_90's (fused_schur_assembly's product uses m16n8k8).
DMMA_SHAPES = {"m8n8k4": (1, 1, 2), "m16n8k4": (2, 1, 4),
               "m16n8k8": (4, 2, 4), "m16n8k16": (8, 4, 4)}


def start_dmma_probe():
    """Starts one nvcc per f64 mma.sync shape on a one-instruction kernel;
    returns {shape: process}: which shapes the installed ptxas takes."""
    from opensfm_tpu_torch.ops.kernels import _build

    probes = {}
    for shape, (na, nb, nc) in DMMA_SHAPES.items():
        ops, k = [], 0
        for n in (nc, na, nb):
            ops.append("{" + ", ".join(f"%{k + i}" for i in range(n)) + "}")
            k += n
        outs = ", ".join('"+d"(c[%d])' % i for i in range(nc))
        ins = ", ".join(['"d"(a[%d])' % i for i in range(na)]
                        + ['"d"(b[%d])' % i for i in range(nb)])
        src = os.path.join(WORK, f"dmma_{shape}.cu")
        with open(src, "w") as f:
            f.write(
                "__global__ void probe(double* p) {\n"
                f"  double a[{na}], b[{nb}], c[{nc}];\n"
                f"  for (int i = 0; i < {na}; ++i) a[i] = p[i];\n"
                f"  for (int i = 0; i < {nb}; ++i) b[i] = p[8 + i];\n"
                f"  for (int i = 0; i < {nc}; ++i) c[i] = p[16 + i];\n"
                f'  asm volatile("mma.sync.aligned.{shape}.row.col.f64.f64.'
                f'f64.f64 {ops[0]}, {ops[1]}, {ops[2]}, {ops[0]};"\n'
                f"      : {outs}\n      : {ins});\n"
                f"  for (int i = 0; i < {nc}; ++i) p[16 + i] = c[i];\n"
                "}\n")
        probes[shape] = subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-cubin", "-o", src[:-3] + ".cubin", src],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return probes


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
    from opensfm_tpu_torch.ops.kernels import assembly_variants as V
    from opensfm_tpu_torch.ops.kernels import ba_assemble as A
    from opensfm_tpu_torch.ops.kernels import ba_resjac as K
    from opensfm_tpu_torch.ops.kernels import top2 as T

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    os.makedirs(WORK, exist_ok=True)

    log("phase 1: build (one nvcc per source, all at once)")
    t0 = time.perf_counter()
    probes = start_dmma_probe()
    libs = _build.build_all([K.SOURCE, A.SOURCE, T.SOURCE, V.SOURCE])
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    takes = {shape: p.wait() == 0 for shape, p in probes.items()}
    log(f"  ptxas takes these f64 mma.sync shapes (sm_90a): {takes}")
    check(takes["m16n8k8"], "ptxas takes mma.sync m16n8k8 .f64")
    for source, lib in libs.items():
        secs, ptxas = _build.BUILD_LOG[source]
        log(f"  {source} -> {os.path.relpath(lib, REPO)} (nvcc {secs:.1f} s)")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")
    u8 = {k: v for k, v in ptxas_spills(_build.BUILD_LOG[T.SOURCE][1])
          .items() if "top2_u8_kernel" in k}
    log(f"  tensor-core top-2 kernels' spills (stores, loads): "
        f"{list(u8.values())}")
    check(len(u8) == 2 and all(v == (0, 0) for v in u8.values()),
          "the tensor-core top-2 kernels (unmasked, masked) do not spill")
    # The f64 tensor-core product of row 4 and row 2's 10 variants.
    redesigned = {k: v for src in (A.SOURCE, K.SOURCE) for k, v in
                  ptxas_spills(_build.BUILD_LOG[src][1]).items()
                  if "syrk_dmma_kernel" in k or "resjac_kernel" in k}
    log(f"  DMMA product and resjac kernels' spills (stores, loads): "
        f"{sorted(set(redesigned.values()))} over {len(redesigned)} kernels")
    check(len(redesigned) == 11
          and all(v == (0, 0) for v in redesigned.values()),
          "the DMMA product and the resjac kernels do not spill")
    ptxas_rows = redesigned_ptxas(_build.BUILD_LOG)
    for key, v in ptxas_rows.items():
        log(f"  {key}: registers {v['regs']}, stack frame {v['stack']} B, "
            f"spill (stores, loads) {v['spill']}")

    log("phase 2: kernels vs plain on the card")
    t0 = time.perf_counter()
    big = sb.make_problem(256, 32768, track_window=8)
    dense64 = sb.make_problem(64, 8192)
    worst = check_kernels(big, sb.make_problem(3000, 65536, track_window=8))
    worst.update(check_dense_kernels(
        [dense64] + [sb.make_problem(ni, n_p) for ni, n_p in DENSE_RAGGED]))
    check_cost_dense_wide(sb.make_problem, worst)
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
    schur_split, product_mm_ms = trace_schur_assembly(dense64)

    log("phase 8: top-2 search kernel vs plain on the card")
    t0 = time.perf_counter()
    worst["top2_sqdist"], top2_per_call = check_top2()
    log(f"  done in {time.perf_counter() - t0:.1f} s; worst abs err "
        f"{worst['top2_sqdist']}")
    per_call_1_3_5 = check_launches_1_3_5(big, dense64)

    log(f"phase 9: match_features command, {MATCH_SHOTS} images x "
        f"{MATCH_FEATURES} features")
    match_path = os.path.join(WORK, "match_32x8192")
    tracks = write_matching_dataset(match_path, words=True)
    match_launches, scores, match_wall, stages = run_match_command(
        match_path, tracks, "match_features", MATCH_SHOTS)

    log(f"phase 10: WORDS matcher, {WORDS_IMAGES}-image subset")
    words_path = os.path.join(WORK, "match_words")
    sb.subset_dataset(match_path, words_path,
                      [sb.shot_id(i) for i in range(WORDS_IMAGES)],
                      {"matcher_type": "WORDS"})
    words_launches, _, words_wall, words_stages = run_match_command(
        words_path, tracks, "WORDS", WORDS_IMAGES, trace=True)

    log("phase 11: card vs CPU on 4 pairs, the same draws injected")
    t0 = time.perf_counter()
    run_match_vs_cpu(match_path)
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 12: top-2 timings and one pair's profile ({card})")
    time_top2(rows, top2_per_call)
    pair_profile = profile_match_pair(match_path)

    log(f"phase 13: assembly ablation profiler, {VARIANT_SHOTS} x "
        f"{VARIANT_POINTS}, f32 ({card})")
    t0 = time.perf_counter()
    variant_args, worst["assembly_variant"] = check_assembly_variants()
    variant_launches = time_assembly_variants(variant_args, rows)
    variant_product_ms, variant_mm_ms = time_product_step(variant_args)
    log(f"  done in {time.perf_counter() - t0:.1f} s; launches "
        f"{variant_launches}")

    log(f"phase 14: create_tracks + reconstruct, {MATCH_SHOTS} images x "
        f"{MATCH_FEATURES} features ({card})")
    t0 = time.perf_counter()
    recon = run_reconstruct(match_path, tracks)
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 15: from images, {IMAGE_VIEWS} views of {IMAGE_W} x "
        f"{IMAGE_H} as JPEGs, the AUTO outlier filter ({card})")
    t0 = time.perf_counter()
    chain = run_image_chain()
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 16: merge, triangulation and reconstruct_from_prior on "
        f"phase 14's {MATCH_SHOTS} images ({card})")
    t0 = time.perf_counter()
    algos = run_merge_and_algorithms(match_path, tracks, MATCH_SHOTS,
                                     MATCH_POINTS, 5)
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 17: camera models, mixed maps, rigs and depth priors at "
        f"256 x 32768 x K=8, f64; card vs CPU; {MIXED_SHOTS} brown / "
        f"fisheye_opencv images x {MATCH_FEATURES} features ({card})")
    t0 = time.perf_counter()
    models = run_models()
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 18: a rig from images, {RIG_VIEWS} instances of 2 cameras "
        f"(brown, fisheye_opencv) at {RIG_W} x {RIG_H} ({card})")
    t0 = time.perf_counter()
    rig_chain = run_rig_chain()
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 19: AKAZE, {AKAZE_VIEWS} of phase 15's JPEG views of "
        f"{IMAGE_W} x {IMAGE_H} (M-SURF), 2 with M-LDB ({card})")
    t0 = time.perf_counter()
    akaze = run_akaze_chain(os.path.join(WORK, "image_chain", "images"))
    log(f"  done in {time.perf_counter() - t0:.1f} s")

    log(f"phase 20: vocabularies and guided matching on {VOCAB_VIEWS} of "
        f"phase 15's views, phase 19's AKAZE views and phase 15's "
        f"reconstruction; the seven exports ({card})")
    t0 = time.perf_counter()
    vocab = run_vocab_chain(os.path.join(WORK, "image_chain"),
                            os.path.join(WORK, "akaze_msurf"))
    vocab["phase_s"] = time.perf_counter() - t0
    log(f"  done in {vocab['phase_s']:.1f} s")

    log(f"phase 21: the submodel path on phase 15's {IMAGE_VIEWS} views "
        f"(submodels of {SUB_SIZE}); the pose-graph bundle through the "
        f"BundleAdjuster facade at {FACADE_SHOTS} x {FACADE_POINTS} x "
        f"K={FACADE_TRACK}, f64, with covariances ({card})")
    t0 = time.perf_counter()
    pose_graph = run_pose_graph(big)
    pose_graph["phase_s"] = time.perf_counter() - t0
    log(f"  done in {pose_graph['phase_s']:.1f} s")

    log(f"phase 22: the circle scene (synthetic_data, seed {CIRCLE_SEED}) "
        f"reconstructed; compute_statistics and export_report on phase 15's "
        f"dataset, card and CPU ({card})")
    t0 = time.perf_counter()
    statistics = run_statistics()
    statistics["phase_s"] = time.perf_counter() - t0
    log(f"  done in {statistics['phase_s']:.1f} s")

    log(f"phase 23: the sharded bundle on {SHARDS} shards of the card: "
        f"the dense grid at 256 x 32768 x K=8 (f64, f32), the Schur and CG "
        f"routes at {SHARD_SMALL[0]} x {SHARD_SMALL[1]}, {SHARD_RANKS} gloo "
        f"ranks ({card})")
    t0 = time.perf_counter()
    sharded, sharded_counts = run_sharded(big, card)
    sharded["phase_s"] = time.perf_counter() - t0
    log(f"  done in {sharded['phase_s']:.1f} s; launches {sharded_counts}")
    for name in ("fused_cost",) + DENSE_KERNELS:
        check(sharded_counts[name] > 0, f"{name} launched by the sharded "
              f"bundle")

    log(f"phase 24: the GCP annotation tool on phase 22's circle as two "
        f"sequences of 10 shots: run_ba.align rigid, flex and full on the "
        f"card, full on the CPU, POST /analyze ({card})")
    t0 = time.perf_counter()
    annotation = run_annotation(statistics.pop("circle_map"))
    annotation["phase_s"] = time.perf_counter() - t0
    log(f"  done in {annotation['phase_s']:.1f} s; routes "
        f"{annotation['routes']}, launches {annotation['launches']}")

    paths = {name: ("bundle command 256x32768xK=8, f64", counts)
             for name in ("fused_residual_jacobian", "fused_cost")}
    paths.update({name: ("bundle_adjust dense 64x8192, f64", dense_counts)
                  for name in DENSE_KERNELS})
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name == "assembly_variant":
            by_mode = rows[name]
            full = by_mode["full"]
            kernels.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=variant_launches,
                path=f"profile_kernel_variants {VARIANT_SHOTS}x"
                     f"{VARIANT_POINTS}, f32",
                max_abs_err=worst[name], ms=full["ms"],
                plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
                bound_by=full["bound_by"], library_ms=None, dtype="float32",
                ms_by_mode={k: v["ms"] for k, v in by_mode.items()},
                plain_ms_by_mode={k: v["plain_ms"] for k, v in by_mode.items()},
                bound_ms_by_mode={k: v["bound_ms"] for k, v in by_mode.items()},
                product_step_ms=variant_product_ms,
                product_step_torch_mm_ms=variant_mm_ms,
                ptxas=ptxas_rows["product_kernel f32"],
            ))
            continue
        if name == "top2_sqdist":
            un, ma = rows[name]["unmasked"], rows[name]["masked"]
            kernels.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=match_launches,
                path=f"match_features {MATCH_SHOTS}x{MATCH_FEATURES}, uint8",
                max_abs_err=worst[name]["uint8"], ms=un["ms"],
                plain_ms=un["plain_ms"], bound_ms=un["bound_ms"],
                bound_by=un["bound_by"], library_ms=un["library_ms"],
                dtype="uint8", max_abs_err_f32=worst[name]["float32"],
                ms_masked=ma["ms"], plain_ms_masked=ma["plain_ms"],
                bound_ms_masked=ma["bound_ms"],
                library_ms_masked=ma["library_ms"],
                library_int8_ms=un["library_int8_ms"],
                library_int8_ms_masked=ma["library_int8_ms"],
                call_ms=un["call_ms"], call_ms_masked=ma["call_ms"],
                launches_per_call=un["launches_per_call"],
                launches_words=words_launches, words_command_s=words_wall,
                words_command_stage_s=words_stages, command_s=match_wall,
                command_stage_s=stages, precision=scores[0],
                recall=scores[1], launches_image_chain=chain["launches"][name],
                launches_models=models["launches"][name],
                launches_rig_chain=rig_chain["launches"][name],
                launches_akaze_chain=akaze["launches"][name],
                launches_by_input_akaze_chain=akaze["top2_by_input"],
                launches_vocab_words=vocab["launches_words"],
                launches_vocab_guided=vocab["launches_guided"],
                **pair_profile,
            ))
            continue
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
        kernels[-1]["launches_reconstruct"] = recon["launches"][name]
        kernels[-1]["launches_image_chain"] = chain["launches"][name]
        kernels[-1].update({f"launches_{k}": v["launches"][name]
                            for k, v in algos.items()})
        kernels[-1]["launches_models"] = models["launches"][name]
        kernels[-1]["launches_rig_chain"] = rig_chain["launches"][name]
        kernels[-1]["launches_akaze_chain"] = akaze["launches"][name]
        kernels[-1]["launches_submodels"] = \
            pose_graph["submodels"]["launches"][name]
        kernels[-1]["launches_facade"] = pose_graph["facade"]["launches"][name]
        kernels[-1]["launches_synthetic"] = statistics["launches"][name]
        kernels[-1]["launches_annotation"] = annotation["launches"][name]
        if name == "fused_schur_assembly":
            kernels[-1].update(sub_kernel_ms=schur_split,
                               product_step_torch_mm_ms=product_mm_ms)
        if name in per_call_1_3_5:
            ptx = {k.split()[1]: v for k, v in ptxas_rows.items()
                   if k.split()[0] == ROW_KERNEL[name]}
            kernels[-1].update(launches_per_call=per_call_1_3_5[name],
                               ptxas=ptx)
    for row in kernels:
        row["launches_sharded"] = sharded_counts[row["name"]]
    print(json.dumps({"reconstruct": {k: v for k, v in recon.items()
                                      if k != "launches"}}), flush=True)
    print(json.dumps({"image_chain": {k: v for k, v in chain.items()
                                      if k != "launches"}}), flush=True)
    print(json.dumps({"merge_and_algorithms": algos}), flush=True)
    print(json.dumps({"models": {k: v for k, v in models.items()
                                 if k != "launches"}}), flush=True)
    print(json.dumps({"rig_chain": {k: v for k, v in rig_chain.items()
                                    if k != "launches"}}), flush=True)
    print(json.dumps({"akaze_chain": {k: v for k, v in akaze.items()
                                      if k != "launches"}}), flush=True)
    print(json.dumps({"vocab_chain": vocab}), flush=True)
    print(json.dumps({"pose_graph": {
        part: {k: v for k, v in d.items() if k != "launches"}
        if isinstance(d, dict) else d
        for part, d in pose_graph.items()}}), flush=True)
    print(json.dumps({"statistics": {k: v for k, v in statistics.items()
                                     if k != "launches"}}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"annotation": {k: v for k, v in annotation.items()
                                     if k != "launches"}}), flush=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
