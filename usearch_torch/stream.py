"""Larger-than-memory serving: exact search over a host-resident (mapped)
table streamed through the device in double-buffered tiles.

Counterpart of `usearch_tpu/stream.py`. A streamed view (``view(path,
stream=True)``) keeps its rows in the file's memory map; a search copies
them tile by tile into one of two pinned host buffers, uploads the buffer
to one of two device tiles on a side CUDA stream, and runs the port's exact
route on the tile (`exact.search_kernel`: kernel B2 and the exact rescore
where `kernel_tiles` admits the tile, which every 131,072-row tile of a
supported pair is), folding each tile's top-k into a running ``[Q, k]``
with `ops.topk.merge_topk`. So a streamed search returns what a resident
``search(exact=True)`` returns over the same rows.

A worker thread reads tile i+1 from the map while tile i's search is
enqueued and runs, and tile i+1's upload is enqueued right after that
search. Events order the two buffers both ways: a host buffer is refilled
only after its last upload finished, and a device tile is overwritten only
after the search that read it finished; the compute stream waits on each
upload. Device memory holds the two tiles, their masks and the carry.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from .enums import ScalarKind, to_torch_dtype
from .exact import pick_tile_rows, search_kernel
from .ops.distances import MASKED, row_stats
from .ops.topk import finish, merge_topk

#: rows per streamed tile (32 MiB of i8 rows at 256 dimensions); read at
#: each search
DEFAULT_TILE_ROWS = 1 << 17


class TileStager:
    """The two staging slots of a streamed search: tile i goes through slot
    ``i % 2``. `fill` copies its rows (and mask) from the map into the
    slot's host buffer, `upload` copies that buffer to the slot's device
    tile, `take` hands the tile to the compute stream and `release` marks
    its search done. On the CPU the same steps run in order, without
    streams or events."""

    def __init__(self, host_rows: np.ndarray, host_valid: Optional[np.ndarray], tile_rows: int, width: int,
                 file_dtype: torch.dtype, device: torch.device, pad_value: int = 0):
        self.rows, self.valid, self.tile_rows = host_rows, host_valid, tile_rows
        self.cuda = device.type == "cuda"
        cols = host_rows.shape[1]
        self._host = [torch.empty((tile_rows, width), dtype=file_dtype, pin_memory=self.cuda) for _ in range(2)]
        self._host_valid = [torch.empty(tile_rows, dtype=torch.bool, pin_memory=self.cuda) for _ in range(2)]
        self.pad_value = pad_value
        for buf in self._host:
            buf[:, cols:] = pad_value  # the stored width's padding (-1 for sets); fills write only the file's columns
        self._host_np = [buf.numpy() for buf in self._host]
        self._tiles = [torch.empty((tile_rows, width), dtype=file_dtype, device=device) for _ in range(2)]
        self._tile_valid = [torch.empty(tile_rows, dtype=torch.bool, device=device) for _ in range(2)]
        if self.cuda:
            self._copy_stream = torch.cuda.Stream(device)
            self._uploaded = [torch.cuda.Event() for _ in range(2)]
            self._consumed = [torch.cuda.Event() for _ in range(2)]

    def span(self, i: int) -> Tuple[int, int]:
        lo = i * self.tile_rows
        return lo, min(lo + self.tile_rows, self.rows.shape[0])

    def fill(self, i: int) -> None:
        s = i % 2
        if self.cuda:
            self._uploaded[s].synchronize()  # the slot's last upload has read the buffer
        lo, hi = self.span(i)
        n = hi - lo
        buf = self._host_np[s]
        np.copyto(buf[:n, : self.rows.shape[1]], self.rows[lo:hi], casting="no")
        buf[n:] = self.pad_value
        valid = self._host_valid[s].numpy()
        valid[n:] = False
        valid[:n] = True if self.valid is None else self.valid[lo:hi]

    def upload(self, i: int) -> None:
        s = i % 2
        if not self.cuda:
            self._tiles[s].copy_(self._host[s])
            self._tile_valid[s].copy_(self._host_valid[s])
            return
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._consumed[s])  # the search of tile i - 2 is done with the tile
            self._tiles[s].copy_(self._host[s], non_blocking=True)
            self._tile_valid[s].copy_(self._host_valid[s], non_blocking=True)
            self._uploaded[s].record(self._copy_stream)

    def take(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        s = i % 2
        if self.cuda:
            torch.cuda.current_stream(self._tiles[s].device).wait_event(self._uploaded[s])
        return self._tiles[s], self._tile_valid[s]

    def release(self, i: int) -> None:
        if self.cuda:
            s = i % 2
            self._consumed[s].record(torch.cuda.current_stream(self._tiles[s].device))


def streamed_search(metric, kind: ScalarKind, q: torch.Tensor, host_rows: np.ndarray, ndim: int, k: int,
                    host_valid: Optional[np.ndarray] = None, metric_fn=None,
                    pad_value: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of prepared queries ``q [Q, W]`` (on the search's device)
    against ``host_rows [N, columns]``, the stored rows of a file (bf16 as
    its int16 bits; int32 sets padded with ``pad_value`` -1), ``host_valid
    [N]`` the rows a filter admits, under ``metric`` or the user-defined
    ``metric_fn``: ``[Q, k]`` f32 distances and i32 rows, -1 where none.
    The host fills every tile
    and a fill waits for the upload two tiles back, so this returns with
    at most the last two tiles' uploads and searches still in flight: a
    streamed `search_async` blocks for about the whole search."""
    tile_rows = DEFAULT_TILE_ROWS
    n, width = host_rows.shape[0], q.shape[1]
    file_dtype = torch.from_numpy(np.empty(0, host_rows.dtype)).dtype
    stager = TileStager(host_rows, host_valid, tile_rows, width, file_dtype, q.device, pad_value)
    storage = to_torch_dtype(kind) if kind == ScalarKind.BF16 else file_dtype
    plain_rows = pick_tile_rows(tile_rows, width * storage.itemsize, metric, ndim, q.shape[0], metric_fn)
    while tile_rows % plain_rows:
        plain_rows //= 2
    k_tile = min(k, tile_rows)
    best_d = torch.full((q.shape[0], k), MASKED, dtype=torch.float32, device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    n_tiles = -(-n // tile_rows)
    if n_tiles == 0:
        return finish(best_d, best_i)
    # a worker thread fills the next host buffer (numpy's copy leaves the
    # interpreter lock) while this one enqueues the current tile's search
    with ThreadPoolExecutor(max_workers=1) as filler:
        stager.fill(0)
        stager.upload(0)
        filled = filler.submit(stager.fill, 1) if n_tiles > 1 else None
        for i in range(n_tiles):
            tile, valid = stager.take(i)
            tile = tile.view(storage)
            d, rows = search_kernel(metric, kind, q, tile, row_stats(tile, kind), valid, ndim, k_tile, plain_rows,
                                    metric_fn=metric_fn)
            stager.release(i)
            rows = rows.long()
            best_d, best_i = merge_topk(best_d, best_i, d, torch.where(rows >= 0, rows + stager.span(i)[0], -1), k)
            if i + 1 < n_tiles:
                filled.result()
                stager.upload(i + 1)
                if i + 2 < n_tiles:
                    filled = filler.submit(stager.fill, i + 2)
    return finish(best_d, best_i)
