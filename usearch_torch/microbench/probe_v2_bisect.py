"""Kernel B13 on the card: the grouped probe's window stream under each
select.

    python -m usearch_torch.microbench.probe_v2_bisect [variant ...]

The counterpart of scripts/tpu_probe_v2_bisect.py, at its shape: an i8
table of N = 10M rows of D = 128 in C = 8,192 partitions of ``N // C``
rows, Q = 1,024 queries probing NPROBE = 16 partitions each, cut into cells
of G = 128 (query, partition) pairs sorted by partition. Each variant of
`ops.microbench.bisect_probe` is timed on the second of two layouts
(`build(1)`, `build(2)`); each line reads ``variant: ms (us/window,
windows=)``. The table is made on the device from the seed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.microbench import BISECT_VARIANTS, bisect_probe
from . import resolve_device, time_once

N, D, C, Q, G = 10_000_000, 128, 8192, 1024, 128
NPROBE = 16
SEED = 0


class Layout:
    """The script's table layout: ``c`` partitions of ``n // c`` rows, each
    read through a window of ``w_pad`` rows from its 128-aligned start."""

    def __init__(self, n: int, c: int, d: int, q: int, nprobe: int):
        self.n, self.c, self.d, self.q, self.nprobe = n, c, d, q, nprobe
        self.clen = n // c
        self.cap2 = c * self.clen
        self.w_pad = ((self.clen + 127) // 128 + 1) * 128
        self.out_pad = ((self.w_pad // 8 + 127) // 128) * 128
        self.starts = np.arange(c, dtype=np.int32) * self.clen

    def table(self, seed: int, device) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(-127, 128, (self.cap2, self.d), generator=gen, device=device, dtype=torch.int8)

    def build(self, seed: int, rng: np.random.Generator):
        """The script's `build(seed)`: the probes from ``seed``, the queries
        from ``rng`` (the script's module-level generator). Returns the
        pairs' query rows, their aux (column 2: the pair's window in its
        cell), the cells' meta (row 0: window starts, row 3: window count)
        and the number of windows."""
        r = np.random.default_rng(seed)
        c, q, nprobe = self.c, self.q, self.nprobe
        probes = np.stack([r.choice(c, nprobe, replace=False) for _ in range(q)])
        p0 = q * nprobe
        part = probes.reshape(-1)
        qid = np.arange(p0, dtype=np.int32) // nprobe
        order = np.argsort(part, kind="stable")
        part_s, qid_s = part[order], qid[order]
        st_c = np.minimum((self.starts[part_s] // 128) * 128, self.cap2 - self.w_pad)
        cells = p0 // G
        ps2 = part_s.reshape(cells, G)
        prev = np.concatenate([np.full((cells, 1), -1, ps2.dtype), ps2[:, :-1]], axis=1)
        flag = ps2 != prev
        widx = np.cumsum(flag, axis=1) - 1
        meta = np.zeros((cells, 8, G), np.int32)
        ri = np.broadcast_to(np.arange(cells)[:, None], (cells, G))
        meta[ri, 0, widx] = st_c.reshape(cells, G)
        meta[:, 3, :] = flag.sum(axis=1).astype(np.int32)[:, None]
        qv = rng.integers(-127, 128, (q, self.d), dtype=np.int8)
        q_g = qv[qid_s]
        qa = np.zeros((p0, 8), np.float32)
        qa[:, 2] = widx.reshape(-1)
        return q_g, qa, meta, int(flag.sum())


def script_layout() -> Layout:
    """The layout at the script's shape."""
    return Layout(N, C, D, Q, NPROBE)


def main(variants=tuple(BISECT_VARIANTS), device="cuda") -> list:
    """Print and return one line per variant."""
    dev = resolve_device(device)
    lay = script_layout()
    table = lay.table(SEED, dev)
    rng = np.random.default_rng(SEED)
    (q_a, qa_a, meta_a, _), (q_b, qa_b, meta_b, windows) = (
        [torch.from_numpy(x).to(dev) for x in made[:3]] + [made[3]] for made in (lay.build(1, rng), lay.build(2, rng)))
    out = []
    for v in variants:
        seconds = time_once(lambda: bisect_probe(meta_b, q_b, qa_b, table, v, lay.w_pad, lay.out_pad), dev,
                            warm=lambda: bisect_probe(meta_a, q_a, qa_a, table, v, lay.w_pad, lay.out_pad))
        out.append(f"{v:9s}: {seconds * 1e3:8.1f} ms  ({seconds / windows * 1e6:6.2f} us/window, windows={windows})")
        print(out[-1], flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:] or tuple(BISECT_VARIANTS))
