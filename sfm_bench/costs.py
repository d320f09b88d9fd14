"""The yardstick's peaks and the operation and byte counts of the port's
hand-written BA kernels (rows 1 and 2 of the kernel table), copied from
`chip_smoke.py` so that no later change to the program moves them.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
rates).  Operations per observation slot are counted from the kernels'
sources (sin, cos, sqrt and divide one each, a fused multiply-add two).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # no tensor cores
PEAK_MMA_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_INT8_OPS = 1979e12
FLOPS_COST_OBS = 75
FLOPS_COST_DENSE_SLOT = 62
FLOPS_ROTATION = 13
FLOPS_RESJAC_OBS = 330
FLOPS_ASSEMBLE_SLOT = 830
FLOPS_BACKSUB_SLOT = 136

INDEX_BYTES = 4  # int32 indices


def _tables(n_inst: int, n_cam: int, n_points: int, fb: int) -> int:
    """Bytes of the instance, camera and point tables (6, 3, 3 values)."""
    return (6 * n_inst + 3 * n_cam + 3 * n_points) * fb


def _read(n_obs, n_inst, n_cam, n_points, fb) -> int:
    """An observation's uv and inverse sd, its three indices, the tables."""
    return (n_obs * (3 * fb + 3 * INDEX_BYTES)
            + _tables(n_inst, n_cam, n_points, fb))


def resjac_bound_s(n_obs: int, n_inst: int, n_cam: int, n_points: int,
                   dtype: str = "float64") -> float:
    """Least seconds of one `fused_residual_jacobian` launch: its inputs
    read once, r, Jc, Jp and the cost (27 values an observation) written
    once, or its operations at the peak, whichever is longer."""
    fb = 8 if dtype == "float64" else 4
    nbytes = _read(n_obs, n_inst, n_cam, n_points, fb) + n_obs * 27 * fb
    return max(nbytes / HBM_BYTES_PER_S,
               n_obs * FLOPS_RESJAC_OBS / PEAK_FLOPS[dtype])


def cost_bound_s(n_obs: int, n_inst: int, n_cam: int, n_points: int,
                 dtype: str = "float64") -> float:
    """Least seconds of one `fused_cost` launch: its inputs read once and
    one value written, or its operations at the peak."""
    fb = 8 if dtype == "float64" else 4
    nbytes = _read(n_obs, n_inst, n_cam, n_points, fb) + fb
    return max(nbytes / HBM_BYTES_PER_S,
               n_obs * FLOPS_COST_OBS / PEAK_FLOPS[dtype])
