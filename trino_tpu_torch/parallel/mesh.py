"""The shard mesh: one process driving an ordered list of shard devices.

Counterpart of the reference's `shard_map` over a one-axis
`jax.sharding.Mesh` (trino_tpu/parallel/mesh_plan.py). The reference's
mesh plane is ONE SPMD program over one host's devices; here the same
plan runs as a Python loop over shard indices, each shard holding its
own fixed-capacity RelBatch on `devices[s]`. The shard index is passed
explicitly where the reference reads `lax.axis_index`.

A device may appear more than once (8 CPU shards in the tests, 4 shards
on one card in chip_smoke.py). The three collectives are the only
points where shards meet; each is a plain function over the list of
per-shard tensors, in shard order:

- `all_to_all` (tiled): shard d receives the concatenation, in source
  order, of every source's block d (`lax.all_to_all(x, AXIS, 0, 0,
  tiled=True)`);
- `all_gather` (tiled): every shard receives the concatenation of all
  shards' tensors (`lax.all_gather(x, AXIS, tiled=True)`);
- `psum`: the sum over shards, given to every shard.

A block moves between devices by `tensor.to(dst)` (a peer copy between
cards); on one device `.to` is a no-op and the collective is a
reindexing. No process group is involved: a width-n mesh on one card
needs no NCCL communicator, and traffic across processes is the HTTP
page plane (runtime/http.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class ShardMesh:
    """An ordered list of shard devices (repeats allowed)."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard mesh needs at least one device")

    @property
    def n(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]})"

    @staticmethod
    def resolve(devices: Optional[Sequence], device) -> "ShardMesh":
        """`devices` as given; None means every visible card when the
        runner's `device` is CUDA (torch.cuda.device_count()), and one
        shard on the runner's device otherwise."""
        if devices is not None:
            return ShardMesh(devices)
        dev = torch.device(device)
        if dev.type == "cuda":
            return ShardMesh([torch.device("cuda", i)
                              for i in range(torch.cuda.device_count())])
        return ShardMesh([dev])


def _blocks(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """x's leading dimension cut into n equal blocks (views)."""
    m = x.shape[0] // n
    return [x.narrow(0, i * m, m) for i in range(n)]


def all_to_all(mesh: ShardMesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled all_to_all over dim 0: xs[s] is shard s's tensor whose
    leading dimension splits into n equal blocks; shard d's output is
    the concatenation of block d of every source, in source order."""
    n = mesh.n
    parts = [_blocks(x, n) for x in xs]
    return [
        torch.cat([parts[s][d].to(dev) for s in range(n)])
        for d, dev in enumerate(mesh.devices)
    ]


def all_gather(mesh: ShardMesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled all_gather over dim 0: every shard receives the
    concatenation of all shards' tensors, in shard order."""
    return [torch.cat([x.to(dev) for x in xs]) for dev in mesh.devices]


def psum(mesh: ShardMesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over shards, given to every shard on its own device."""
    home = mesh.devices[0]
    total = xs[0].to(home)
    for x in xs[1:]:
        total = total + x.to(home)
    return [total.to(dev) for dev in mesh.devices]
