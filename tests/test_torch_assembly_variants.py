"""The port's assembly ablation variants (`ops/kernels/assembly_variants`,
the counterpart of the root script `profile_kernel_variants.py`) against the
script's own arithmetic in JAX, on the CPU.

The script builds its 64 x 8,192 problem when imported and its Pallas kernel
uses TPU memory spaces with no interpret mode, so the reference here is the
kernel body's arithmetic (`profile_kernel_variants.py:50-104`) written in
jnp over the JAX package's `_chain` and `jax.linearize`, on 8 shots x 256
points.  Both sides take the same numpy inputs, float32.  Tolerance: out_obs
and s_ii within 1e-4 of each output's largest entry (the port's Jacobian is
in closed form, the reference's comes from tangent pushes, and the product
sums in another order).  The CUDA kernel is held against the plain twin on
the card by `chip_smoke.py`."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_problem
from opensfm_tpu.ba import lm as ref_lm
from opensfm_tpu.ops.pallas_kernels.ba_resjac import _chain
from opensfm_tpu_torch.ops.kernels import assembly_variants as V
from opensfm_tpu_torch.tools import profile_kernel_variants as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    """The script's inputs as numpy float32 arrays: the JAX package lays
    the problem out on the dense grid."""
    problem, dense = ref_lm.canonicalize_problem_dense(
        _make_problem(n_shots=8, n_points=256, seed=0))
    assert dense
    return tuple(t.numpy() for t in tool.variant_inputs(problem, "cpu"))


def _reference(mode, u, v, isd, points, inst_t, cam_row):
    """profile_kernel_variants.py's kernel body over the whole grid."""
    n_p, ni = u.shape
    u, v, isd = jnp.asarray(u), jnp.asarray(v), jnp.asarray(isd)
    one_row = jnp.ones((1, ni), jnp.float32)
    vals = tuple(jnp.asarray(inst_t[k:k + 1]) for k in range(6)) + tuple(
        cam_row[0, k] * one_row for k in range(3)) + tuple(
        jnp.broadcast_to(jnp.asarray(points[:, j:j + 1]), (n_p, ni))
        for j in range(3))
    zero = jnp.zeros((n_p, ni), jnp.float32)
    s_ii = jnp.zeros((6 * ni, 6 * ni), jnp.float32)
    if mode == "fwdonly":
        p0, p1 = _chain(vals)
        rows = [(p0 - u) * isd, (p1 - v) * isd] + [zero] * 30
        return np.asarray(jnp.stack(rows)), np.asarray(s_ii)
    (p0, p1), lin = jax.linearize(_chain, vals)
    rows = [(p0 - u) * isd, (p1 - v) * isd]
    if mode == "nopush":
        J0 = [p0 * (0.1 + j) for j in range(12)]
        J1 = [p1 * (0.1 + j) for j in range(12)]
    else:
        J0, J1 = [], []
        for jdir in range(12):
            tang = tuple(jnp.ones_like(vals[i]) if i == jdir
                         else jnp.zeros_like(vals[i]) for i in range(12))
            d0, d1 = lin(tang)
            J0.append(d0 + zero)
            J1.append(d1 + zero)
    rows += [zero] * 30 if mode == "noout" else J0 + J1 + [zero] * 6
    if mode != "nomatmul":
        for k in range(3):
            cat_a = jnp.concatenate([J0[x] * J0[9 + k] for x in range(6)], 1)
            cat_g = jnp.concatenate([J1[x] * J1[9 + k] for x in range(6)], 1)
            s_ii = s_ii + jax.lax.dot_general(
                cat_a, cat_g, (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
    return np.asarray(jnp.stack(rows)), np.asarray(s_ii)


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return np.abs(got - want).max() / scale if scale else np.abs(got).max()


@pytest.mark.parametrize("mode", V.MODES)
def test_plain_matches_the_script(inputs, mode):
    out, s_ii = V.assembly_variant(mode, *map(torch.from_numpy, inputs))
    want_out, want_s = _reference(mode, *inputs)
    rows = V.rows_written(mode)
    assert out.dtype == torch.float32 and out.shape == (32, 256, 8)
    assert np.isfinite(out.numpy()).all() and np.isfinite(s_ii.numpy()).all()
    # Each written row against its reference row, within TOL of its scale.
    for r in range(rows):
        assert _max_rel(out[r], want_out[r]) <= TOL, f"row {r}"
    assert _max_rel(s_ii, want_s) <= TOL
    assert (np.abs(want_s).max() > 0) == V.has_product(mode)


PRODUCT_SHAPES = [(64, 8192), (8, 256), (1, 1), (256, 16384), (33, 1000),
                  (37, 1000)]


def test_product_plan_covers_k():
    """The K splits partition 3 NP in order, each a whole number of stages;
    at the profiler's 64 x 8,192 the nine 128 x 128 tiles times 29 splits
    fill the 132 SMs about twice (261 blocks, one wave of two a SM)."""
    for ni, n_p in PRODUCT_SHAPES:
        n_split, k_split = V.product_plan(ni, n_p)
        k = 3 * n_p
        assert k_split % V.PRODUCT_TILE_K == 0
        assert (n_split - 1) * k_split < k <= n_split * k_split
        assert V.product_plan(ni, n_p) == (n_split, k_split)
    assert V.product_plan(64, 8192) == (29, 848)
    blocks = len(V.product_tiles(6 * 64)) * 29
    assert V.SMS < blocks <= V.PRODUCT_BLOCKS_PER_SM * V.SMS


@pytest.mark.parametrize("ni,n_p", PRODUCT_SHAPES)
def test_product_tiles_and_pieces_cover_the_output(ni, n_p):
    """The product's blocks (blockIdx.x row-major over the 128 x 128 tiles,
    as csrc/assembly_variants.cu decodes it) cover every entry of the
    6 NI x 6 NI output once; the operand rows (ld floats, a multiple of 4)
    start on 16 bytes; a stage's 16-byte pieces, each reading
    clamp(4 (n - c), 0, 16) bytes from column c, read exactly the columns
    below n; the split sum's quads (four columns of an ld-wide partial
    row) write every output entry once."""
    n, ld = 6 * ni, V.operand_ld(ni)
    assert ld % 4 == 0 and n <= ld < n + 4
    t, tile = -(-n // V.PRODUCT_TILE), V.PRODUCT_TILE
    cover = np.zeros((t * tile, t * tile), dtype=int)
    for b, (r, c) in enumerate(V.product_tiles(n)):
        assert (r, c) == (b // t, b % t)
        cover[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] += 1
    assert (cover[:n, :n] == 1).all()
    for j0 in range(0, t * tile, tile):
        read = np.zeros(t * tile, dtype=int)
        for c in range(0, tile, 4):
            nbytes = min(max(4 * (n - (j0 + c)), 0), 16)
            read[j0 + c:j0 + c + nbytes // 4] += 1
        assert (read[j0:j0 + tile] == (np.arange(j0, j0 + tile) < n)).all()
    i, j = np.divmod(np.arange(n * (ld // 4)), ld // 4)
    col = 4 * j[:, None] + np.arange(4)
    keep = col < n
    written = np.bincount((i[:, None] * n + col)[keep], minlength=n * n)
    assert (written == 1).all() and written.size == n * n


def test_operands_give_the_plain_product(inputs):
    """The slot pass's operands as `operands_plain` lays them out ([3 NP,
    6 NI], row 3 p + k) give the plain version's s_ii as one product
    A^T G (float32, within TOL of its largest entry), for the three modes
    with the product; the others have none."""
    cpu = tuple(map(torch.from_numpy, inputs))
    for mode in V.MODES:
        if not V.has_product(mode):
            with pytest.raises(ValueError, match="no product"):
                V.operands_plain(mode, *cpu)
            continue
        a, g = V.operands_plain(mode, *cpu)
        assert a.shape == g.shape == (3 * 256, 6 * 8)
        assert _max_rel(a.T @ g, V.assembly_variant_plain(mode, *cpu)[1]) \
            <= TOL


def test_wrapper_raises_off_the_cpu_and_on_bad_input(inputs):
    """A tensor on a device other than the CPU goes to the kernel or
    raises (a meta tensor stands for one the wrapper cannot serve); an
    unknown mode raises on any device."""
    meta = tuple(torch.empty(x.shape, device="meta") for x in inputs)
    with pytest.raises(ValueError, match="unsupported device"):
        V.assembly_variant("full", *meta)
    cpu = tuple(map(torch.from_numpy, inputs))
    with pytest.raises(ValueError, match="unknown mode"):
        V.assembly_variant("fast", *cpu)
    with pytest.raises(ValueError, match="bad shapes"):
        V.assembly_variant("full", cpu[0][:, :4], *cpu[1:])
    with pytest.raises(ValueError, match="bad shapes"):
        V.assembly_variant("full", *meta[:3], meta[3][:, :2], *meta[4:])
    before = V.assembly_variant.launches
    V.assembly_variant("fwdonly", *cpu)
    assert V.assembly_variant.launches == before
    with pytest.raises(ValueError, match="runs on CUDA"):
        V.assembly_product(cpu[0], cpu[1])


def test_tool_prints_five_timings_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "opensfm_tpu_torch.tools.profile_kernel_variants",
         *V.MODES, "--device", "cpu", "--shots", "4", "--points", "64",
         "--reps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert "on cpu" in lines[0]
    timed = [ln.split() for ln in lines[1:]]
    assert [t[0] for t in timed] == list(V.MODES)
    assert all(float(t[1]) > 0 and t[2] == "ms/call" for t in timed)
