"""Kernel B12 on the card: the cost of each selection operation of the
probe kernels, alone.

    python -m usearch_torch.microbench.select_microbench

The counterpart of scripts/tpu_select_microbench.py: each variant of
`ops.microbench.select_loop` runs IT passes over a ``[W, G]`` i32 buffer
held in shared memory; each line reads ``variant: us/iter``, the time of
one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.microbench import SELECT_VARIANTS, select_loop
from . import resolve_device, time_once

W, G, IT = 1408, 128, 200
SEED = 0


def buffer(w: int, g: int, seed: int, device) -> torch.Tensor:
    """The script's buffer: i32 in [-2e6, 2e6) from numpy's generator."""
    x = np.random.default_rng(seed).integers(-2_000_000, 2_000_000, (w, g), dtype=np.int32)
    return torch.from_numpy(x).to(device)


def main(device="cuda") -> list:
    """Print and return the lines; the timed call runs on ``x + 1`` after a
    warm call on ``x``, as the script's does."""
    dev = resolve_device(device)
    x = buffer(W, G, SEED, dev)
    x1 = x + 1
    out = []
    for v in SELECT_VARIANTS:
        seconds = time_once(lambda: select_loop(x1, v, IT), dev, warm=lambda: select_loop(x, v, IT))
        out.append(f"{v:16s}: {seconds / IT * 1e6:8.2f} us/iter")
        print(out[-1], flush=True)
    return out


if __name__ == "__main__":
    main()
