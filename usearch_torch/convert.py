"""Carry an index's state across from the JAX package.

The JAX package's index state is a handful of arrays; ``np.asarray`` of its
attributes gives them as numpy. `index_from_arrays` builds a port `Index`
holding the same rows, stats, deletions and keys, and `install_ivf` gives it
the same built IVF, so both packages answer the same queries;
`sharded_from_arrays` does the same for a `ShardedIndex`.
"""

from __future__ import annotations

import numpy as np

import torch

from .enums import normalize_dtype, normalize_metric
from .index import Index
from .ivf import IVFPartitions
from .ops.casts import as_tensor
from .parallel.mesh import SHARD_AXIS, make_mesh
from .parallel.sharded import ShardedIndex, _local_ivf

#: the keys `index_from_arrays` reads
STATE_KEYS = ("table", "stats", "valid", "slot_keys", "count", "next_slot", "free_slots",
              "ndim", "metric", "dtype", "multi")


def index_from_arrays(state: dict, device="cuda") -> Index:
    """A port `Index` from numpy state: ``table [capacity, width]`` (i8,
    bf16, f16 or f32, f32 for an f64 index; packed uint8 bytes for b1;
    int32 sets padded with -1 for jaccard), ``stats [capacity, 2]`` f32
    (popcount and 0 for b1), ``valid [capacity]`` bool, ``slot_keys
    [capacity]`` u64, ``count``, ``next_slot``, ``free_slots``, and the
    configuration ``ndim``, ``metric``, ``dtype`` (names such as "ip" and
    "i8"; ``metric`` may be a `CompiledMetric`) and ``multi``; an f64 index
    takes its exact rows from ``host_f64 [capacity, ndim]`` where given."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"state lacks {missing}")
    index = Index(ndim=int(state["ndim"]), metric=state["metric"], dtype=state["dtype"],
                  multi=bool(state["multi"]), device=device)
    table = np.asarray(state["table"])
    host_f64 = state.get("host_f64")
    index._install(
        torch.from_numpy(table.copy()) if table.dtype == np.int32 else as_tensor(table),
        as_tensor(np.asarray(state["stats"], dtype=np.float32)),
        as_tensor(np.asarray(state["valid"], dtype=bool)),
        state["slot_keys"],
        state["count"],
        state["next_slot"],
        np.asarray(state["free_slots"], dtype=np.int64).tolist(),
        host_f64=None if host_f64 is None else np.asarray(host_f64, dtype=np.float64),
    )
    return index


#: the keys `install_ivf` reads; the dense layout's are None in the copied
#: one, and ``part_slots`` is None in the dense one
IVF_KEYS = ("centroids", "avg_rows", "built_count", "spilled", "fresh", "starts", "lens", "p_win",
            "shadow_pos", "shadow_src", "part_slots")


def install_ivf(index: Index, state: dict) -> None:
    """Give ``index`` a built IVF from numpy state: ``centroids [C, D]``
    f32 in the quantizer's space (the unpacked bits, 8 per stored byte, for
    b1), ``avg_rows``, ``built_count``, ``spilled``, the ``fresh`` slots,
    and for the dense layout ``starts``/``lens [C]``, ``p_win`` and the
    spill shadows ``shadow_pos``/``shadow_src``, or for the copied layout
    ``part_slots [C, P]``, whose rows and stats are read from the index's
    table. ``index`` must hold the table the IVF was built over (as
    `index_from_arrays` gives it)."""
    missing = [k for k in IVF_KEYS if k not in state]
    if missing:
        raise KeyError(f"state lacks {missing}")
    dev = index.device
    centroids = torch.as_tensor(np.array(state["centroids"], dtype=np.float32), device=dev)
    avg_rows, built = float(state["avg_rows"]), int(state["built_count"])
    if state["starts"] is not None:
        lens = torch.as_tensor(np.array(state["lens"], dtype=np.int32), device=dev)
        ivf = IVFPartitions(
            centroids, None, None, None, avg_rows, built, inplace_shape=(int(lens.shape[0]), int(state["p_win"])),
            starts=torch.as_tensor(np.array(state["starts"], dtype=np.int32), device=dev), lens=lens,
            p_win=int(state["p_win"]),
        )
        pos = np.array(state["shadow_pos"], dtype=np.int32)
        if pos.size:
            ivf.set_shadows(pos, np.array(state["shadow_src"], dtype=np.int32))
    else:
        slots = torch.as_tensor(np.array(state["part_slots"], dtype=np.int32), device=dev)
        safe = slots.clamp_min(0).long()
        ivf = IVFPartitions(centroids, index._table[safe], index._stats[safe], slots, avg_rows, built)
    ivf.spilled = bool(state["spilled"])
    ivf.fresh_np = np.array(state["fresh"], dtype=np.int64)
    index._ivf = ivf
    index._ivf_dirty = False


#: the keys `sharded_from_arrays` reads
SHARDED_KEYS = ("table", "stats", "valid", "keys", "metric", "kind", "ndim")
#: the keys of its optional ``ivf``
SHARDED_IVF_KEYS = ("cents", "starts", "lens", "p_win", "block", "c_max", "avg_rows")


def sharded_from_arrays(state: dict, mesh=None) -> ShardedIndex:
    """A port `ShardedIndex` from a JAX one's numpy state, every slot where
    it is: ``table [S per_shard, W]``, ``stats [S per_shard, 2]`` f32,
    ``valid [S per_shard]`` bool and ``keys [S per_shard]`` u64 over ``S``
    = the mesh's shards, ``metric``, ``kind`` and ``ndim``; and optionally
    ``ivf``, a dict of ``cents [S c_max, W]`` f32, ``starts``/``lens [S
    c_max]`` i32 and the statics ``p_win``, ``block``, ``c_max`` and
    ``avg_rows``. ``mesh`` defaults to `make_mesh()`."""
    missing = [k for k in SHARDED_KEYS if k not in state]
    if missing:
        raise KeyError(f"state lacks {missing}")
    mesh = mesh or make_mesh()
    table = as_tensor(np.asarray(state["table"]))
    stats = as_tensor(np.asarray(state["stats"], dtype=np.float32))
    per = table.shape[0] // mesh.shape[SHARD_AXIS]
    parts = [(table[s * per : (s + 1) * per].to(dev), stats[s * per : (s + 1) * per].to(dev))
             for s, dev in zip(mesh.shard_ids, mesh.devices)]
    out = ShardedIndex._assemble(
        mesh, normalize_metric(state["metric"]), normalize_dtype(state["kind"]), int(state["ndim"]),
        [t for t, _ in parts], np.array(state["keys"], dtype=np.uint64), np.array(state["valid"], dtype=bool),
        stats=[st for _, st in parts])
    iv = state.get("ivf")
    if iv is not None:
        missing = [k for k in SHARDED_IVF_KEYS if k not in iv]
        if missing:
            raise KeyError(f"ivf state lacks {missing}")
        out._ivf = _local_ivf(mesh, np.asarray(iv["cents"]), np.asarray(iv["starts"]), np.asarray(iv["lens"]),
                              iv["p_win"], iv["block"], iv["c_max"], iv["avg_rows"])
    return out
