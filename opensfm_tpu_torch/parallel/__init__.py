"""Sharded bundle adjustment over a mesh of shards.

The map is partitioned by points across the shards (`parallel.mesh.Mesh`:
CUDA devices, several shards on one device, or ranks of a
`torch.distributed` group); each shard reduces its share of the Schur
system and the reduced camera system is summed over the mesh.
"""

from opensfm_tpu_torch.parallel.distributed_ba import (  # noqa: F401
    bundle_adjust_sharded,
    check_cg_compatible,
    make_sharded_cg_lm_step,
    make_sharded_cost,
    make_sharded_lm_step,
    make_sharded_lm_step_dense,
    make_sharded_schur_lm_step,
    shard_problem,
    shard_problem_dense,
)
