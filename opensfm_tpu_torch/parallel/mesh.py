"""A mesh of shards for the sharded bundle: the port's counterpart of a
`jax.sharding.Mesh` with `shard_map` over one axis.

`Mesh(devices, group=None)` holds one torch device per local shard.  A
device may repeat: shards on one device form a *virtual* mesh (one card, or
the CPU, running several shards one after another on its stream), as the
JAX package's tests run on virtual CPU devices.  `group`, an optional
`torch.distributed` process group, joins the local shards of every rank
into one mesh of `world_size * len(devices)` shards, rank-major: rank r's
local shard j is global shard `r * len(devices) + j`.

`psum` sums the local shards' partial results in a fixed order (shard 0
first) on the first local device and then, with a group, across the ranks
by `dist.all_reduce`.  Over gloo (a host library) the sum crosses the group
on the host; over NCCL (one card per rank) on the device.  The group's
backend decides; neither is a fallback for the other.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from opensfm_tpu_torch import resolve_device


class Mesh:
    """Shards over `devices` (one per local shard), optionally joined with
    the other ranks of `group`."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        rank, world = 0, 1
        if group is not None:
            rank = dist.get_rank(group)
            world = dist.get_world_size(group)
        self.n_local = len(self.devices)
        self.n_shards = self.n_local * world
        self.shard_ids = [rank * self.n_local + j for j in range(self.n_local)]
        self.device = self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"n_shards={self.n_shards})")

    def _host_collectives(self) -> bool:
        return (self.group is not None
                and dist.get_backend(self.group) == dist.Backend.GLOO)

    def replicate(self, tensors) -> List[tuple]:
        """One copy of `tensors` (a tuple) per local shard, each on its
        shard's device; shards that share a device share the copy."""
        copies = {}
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = tuple(t.to(dev) for t in tensors)
            out.append(copies[dev])
        return out

    def psum(self, parts: Sequence[Sequence[torch.Tensor]]) -> List[tuple]:
        """Sum over every shard of the mesh: `parts` holds one tuple of
        tensors per local shard; returns the summed tuple once per local
        shard, on that shard's device."""
        if len(parts) != self.n_local:
            raise ValueError(f"{len(parts)} parts for {self.n_local} shards")
        total = [t.to(self.device) for t in parts[0]]
        for part in parts[1:]:
            total = [a + b.to(self.device) for a, b in zip(total, part)]
        if self.group is not None:
            total = self._all_reduce(total)
        return self.replicate(tuple(total))

    def _all_reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        # One collective for the whole tuple: a flat buffer per dtype.
        out = list(tensors)
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            if self._host_collectives():
                flat = flat.cpu()
            dist.all_reduce(flat, group=self.group)
            flat = flat.to(self.device)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].reshape(tensors[i].shape)
                off += n
        return out

    def allgather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global array of a sharded output: the local shards' blocks
        (equal sizes) concatenated in shard order on the first local
        device, then across the ranks of the group."""
        local = torch.cat([p.to(self.device) for p in parts])
        if self.group is None:
            return local
        send = local.cpu() if self._host_collectives() else local
        world = self.n_shards // self.n_local
        recv = [torch.empty_like(send) for _ in range(world)]
        dist.all_gather(recv, send, group=self.group)
        return torch.cat(recv).to(self.device)


def default_mesh(device=None) -> Mesh:
    """The mesh a pipeline bundle shards over: every visible CUDA device,
    one shard each (the JAX package's `Mesh(np.array(jax.devices()))`).
    Raises where CUDA is absent, as `resolve_device`; with `device` a CPU
    device, that device alone (one shard: the CPU is one device)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return Mesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    return Mesh([dev])


def virtual_mesh(device, n_shards: int) -> Mesh:
    """`n_shards` shards on one device (a virtual mesh)."""
    return Mesh([torch.device(device)] * int(n_shards))
