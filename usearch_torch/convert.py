"""Carry an index's state across from the JAX package.

The JAX package's index state is a handful of arrays; ``np.asarray`` of its
attributes gives them as numpy. `index_from_arrays` builds a port `Index`
holding the same rows, stats, deletions and keys, so both packages answer
the same queries.
"""

from __future__ import annotations

import numpy as np

from .index import Index
from .ops.casts import as_tensor

#: the keys `index_from_arrays` reads
STATE_KEYS = ("table", "stats", "valid", "slot_keys", "count", "next_slot", "free_slots",
              "ndim", "metric", "dtype", "multi")


def index_from_arrays(state: dict, device="cuda") -> Index:
    """A port `Index` from numpy state: ``table [capacity, width]`` (i8,
    bf16, f16 or f32), ``stats [capacity, 2]`` f32, ``valid [capacity]``
    bool, ``slot_keys [capacity]`` u64, ``count``, ``next_slot``,
    ``free_slots``, and the configuration ``ndim``, ``metric``, ``dtype``
    (names such as "ip" and "i8") and ``multi``."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"state lacks {missing}")
    index = Index(ndim=int(state["ndim"]), metric=state["metric"], dtype=state["dtype"],
                  multi=bool(state["multi"]), device=device)
    index._install(
        as_tensor(state["table"]),
        as_tensor(np.asarray(state["stats"], dtype=np.float32)),
        as_tensor(np.asarray(state["valid"], dtype=bool)),
        state["slot_keys"],
        state["count"],
        state["next_slot"],
        np.asarray(state["free_slots"], dtype=np.int64).tolist(),
    )
    return index
