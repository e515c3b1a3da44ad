"""The device mesh of a `ShardedIndex` and the process group behind it.

Counterpart of `usearch_tpu/parallel/mesh.py`. A `Mesh` is 1-D: this
process's shard devices, in shard order, and, across processes, a
`torch.distributed` group. A device may hold several shards (the JAX tests'
virtual CPU devices, or several shards on one card). Global shard ids are
rank-major: rank ``r`` holds shards ``r * L`` to ``r * L + L - 1`` of
``L = len(devices)`` each.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..exact import resolve_device

SHARD_AXIS = "shard"


class Mesh:
    """This process's shard devices and the group they are merged over
    (None within one process)."""

    def __init__(self, devices: List[torch.device], axis_name: str = SHARD_AXIS, group=None):
        if not devices:
            raise ValueError("a mesh needs at least one shard device")
        self.devices = list(devices)
        self.axis_name = axis_name
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world_size = dist.get_world_size(group) if group is not None else 1

    @property
    def shape(self) -> dict:
        """``{axis_name: global shard count}``, as a JAX mesh's shape."""
        return {self.axis_name: len(self.devices) * self.world_size}

    @property
    def shard_ids(self) -> range:
        """The global ids of this process's shards."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    def __repr__(self) -> str:
        return (f"usearch_torch.Mesh({self.shape[self.axis_name]} shards, rank {self.rank} of "
                f"{self.world_size}, devices {[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SHARD_AXIS, device="cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` shards on ``device``. On "cuda" the
    shards take the visible cards in turn (``make_mesh(4)`` on one card puts
    4 shards on it), by default one shard a card; once
    `distributed_initialize` has run, they all take this process's current
    card, and the mesh merges over the default group. A device with an
    index ("cuda:1") takes every shard. On "cpu", ``n_devices`` shards (1 by
    default) on the CPU. The mesh merges over the default group only where
    its backend serves the device (NCCL the cards, gloo the CPU); otherwise
    it stays within this process. A card that is absent raises."""
    dev = resolve_device(device)
    group = None
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == ("nccl" if dev.type == "cuda" else "gloo"):
            group = dist.group.WORLD
    if dev.type == "cpu" or dev.index is not None:
        devices = [dev] * (n_devices or 1)
    elif group is not None:
        devices = [torch.device("cuda", torch.cuda.current_device())] * (n_devices or 1)
    else:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [cards[i % len(cards)] for i in range(n_devices or len(cards))]
    return Mesh(devices, axis_name, group)


def distributed_initialize(coordinator_address: str, num_processes: int, process_id: int, device="cuda",
                           **kwargs) -> None:
    """Join a group of ``num_processes`` processes as ``process_id``, the
    first of them listening at ``coordinator_address`` ("host:port" or a
    URL): NCCL between cards, gloo on the CPU. Takes the JAX call's argument
    names; `make_mesh` then merges over this group. On the card the process
    takes card ``process_id`` modulo the cards it sees. ``kwargs`` go to
    `torch.distributed.init_process_group` (``timeout``, say)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=url,
                            world_size=int(num_processes), rank=int(process_id), **kwargs)
