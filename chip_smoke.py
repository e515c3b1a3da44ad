#!/usr/bin/env python3
"""Drive usearch_torch's main path on one CUDA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. setup: the card's name and power limit, TF32 off, the kernels built from
   usearch_torch/csrc (one nvcc per source, all started together; beside
   them, on a thread, the C library of usearch_torch/cabi built by g++ and
   its test.c and test.cpp run as programs on the card, step (j) reading
   their results), and the SASS of the scan and fused libraries
   (cuobjdump -sass, one process a library, all at once, on a thread while
   phase 2 runs; checked after phase 2): every wgmma
   instantiation of B1/B2 and of B8/B9/B10 must hold its tensor-core
   product, IGMMA for i8, HGMMA for bf16 and compact f32, an HGMMA of TF32
   for B8/B9/B10 over f32 (the three-pass TF32 product), and B1/B2's SIMT
   f32 kernel FFMA and no tensor-core product (no TF32 on the exact path);
   and the probe library's: every i8, bf16, f32 and b1 instantiation of the
   tensor-core probe kernel (B3, B5, B6's lists; B7 over i8) holds IGMMA,
   HGMMA, an HGMMA of TF32 or BGMMA (the b1 and-popc product); no SIMT
   kernel of f32 rows (`grouped_probe_kernel`, `fused_kernel`,
   `lanes_kernel`) is left; and the bit-scan library's: every
   `bit_scan_wgmma` instantiation (hamming, tanimoto, sorensen; lists in
   shared memory and in the output rows) holds BGMMA;
2. every kernel against its plain version on the card: B1 (binned scan)
   and B2 (bin minima) at N=65,536 rows, Q=512 and Q=40 queries, width 256,
   ~10% deleted rows, on {i8, bf16, f32} x {ip, cos, l2sq}, and B1 compact on
   f32; the same at SCAN_EDGES (ragged query tiles, two fully deleted bins,
   a half 256-row tile, W=128, rows too wide to stay in shared memory);
   the exact rescore's dots (csrc/rescore.cu) at RESCORE_CHECK: i8 rows at
   W=256 and W=1,152 bit for bit, bf16 and f32 unit rows within
   FLOAT_RTOL/FLOAT_ATOL, the table's last bin in every query's list and one
   list of a repeated bin, Q=512, 40 and 1; B3 (grouped probe) on 256 windows of 200-400 rows, the pairs of 512
   and 40 queries at nprobe 8, on the same dtypes and metrics, with and
   without the penalty row (ip), with 4 and k candidates per bin, and B5 on
   the same windows and metrics at 4 and 8 per bin; B3 over packed
   1024-bit rows with hamming (4 and k per bin) and B5 (4, 8 and 16 per
   bin) on windows of the same lengths, bit for bit; B3/B5 over i8, bf16
   and b1 at PROBE_EDGES (every lane its own window, one 128-lane segment, a
   segment across lanes 60-70, windows mid-bin, empty and ending at the
   table's last row, W=128, 384 and 1,024 bytes, k 1-128 with bin_m 1-16,
   B5 over b1 at 1-16 per bin, ties across a bin edge and between lanes 63
   and 64; f32 too, W elements; i8 and b1 bit for bit); the exact bit
   scan (csrc/bitscan.cu) at BITSCAN_CHECK bit for bit against
   `bit_scan_plain`: tables of few byte values with equal rows across
   every 128-row tile's edge, ~10% deleted rows and tables of 5 live rows,
   Q 1, 40 and 4,096, k 1, 10 and 128, widths of 128 and 1,024 bytes,
   hamming, tanimoto and sorensen, with and without the bf16 rounding; B6 (per-query
   probe: B3's kernel over
   its pairs, then its fold) on such windows for {i8, bf16, f32} x {ip,
   cos, l2sq} and b1 hamming, with and without the penalty row, k 10 and
   128 at 4 and k per bin, and on a narrow surface (windows shared by many
   queries and probed by one, one probed twice, one past the table) at
   k/bin_m (10, 16), (64, 32) and (128, 128); B7 (packed-key binned probe)
   over i8 rows, `pack` and `fminarg` at (bw, keep) (32, 4) and (8, 1), and
   at every admitted (bw, keep, sel) over rows of 128, 384 and 2,048 bytes
   with planted equal dots (dots above 2**24 at 2,048), bit for bit; the
   flat-scan flavours at B1's
   shape with a fully deleted 4,096-row stretch besides: B8 (fused running
   top-k) and B9 (its streamed form) at k 10 and 128 and B10 (lane-layout
   surface); the three again on rows too wide to stay in shared memory
   (f32 W=512, i8 W=2,048) in 509 bins (a partial last merge group for B9);
   B8/B9 on an i8 table of 3 live bins at k=10; over f32 B8/B9 bit for bit
   against the top-k of B10's minima; B8/B9 at FUSED_EDGES: i8, bf16 and
   f32 tables with equal bin minima planted across a 256-row tile
   edge, an 8-bin merge-group edge and in a half last tile, 40 and 300
   queries, k 1, 10 and 128, ties held to the earlier bin, and a table
   with fewer live bins than k; and B10 at LANES_EDGES: the same planted
   tables in i8, bf16 and f32 (24, 19 and 1,023 bins, 40 and 300 queries)
   and wide planted rows, i8 bit for bit, i8 and bf16 bit for bit against
   B1's surface (the same product and epilogue), f32 within `tf32_atol` of
   it (B1's f32 is exact), and each within the float tolerance of the plain
   version (bf16's scaled by the squared norms, f32's by `tf32_atol`). The
   f32 flavours of B3/B5/B6 and B8-B10 (the three-pass TF32 product) hold
   their plain versions within FLOAT_RTOL and `tf32_atol`: FLOAT_ATOL and
   the dot bound tests/test_torch_tf32_split.py proves at the row width
   plus TERMS_ATOL, times the largest q_sq + t_sq (2 for cos);
3. the main paths through the public entry points, at the shape of
   bench.py: `Index(ndim=256, metric="ip", dtype="i8")`, 1M unit rows added
   on the card, 16,384 member queries at k=10 (recall@1 >= 0.99), 1,024
   exact queries against a plain ground truth, 1% of the keys removed; an
   f32 cos index of 262,144 rows through the compact + rescore path; and
   the IVF path: a new i8 ip index of 1M rows, `optimize(n_partitions=1024,
   reorder=True, spill=0.05)`, `expansion_search = 1024`, 16,384 member
   queries (recall@1 >= 0.99, recall@10 against the exact answer printed),
   the same search through the plain probe, equal to the kernel's; then the
   same in each probe flavour `ivf.PROBE_MODE` = "pair" (B6), "bin" (B7)
   and "nofold" (B5 over i8), each through its kernel's plain version too,
   and the grouped search once more, unchanged; 4,096 rows added after the
   build and found, 1% of the keys removed and never returned, in every
   flavour. The launch counters are zeroed just before each path and
   flavour and read just after: B1, B2 and the rescore's dots must have
   launched on the flat paths, on the IVF path B3 and no other kernel, and in each flavour its
   own kernel and no other. The flat-scan flavours on the i8 index after its
   removal: `search_fused` (B8), `search_fused_stream` (B9) and
   `search_binned_lanes` (B10) on the 16,384 member queries at k=10, each
   with recall@1 >= 0.99 over the members still live, distances equal bit
   for bit to `search_binned`'s (B1) and ids equal apart from ties, each
   launching its own kernel once and no other (and no earlier path any of
   them); the same on the f32 cos table with 1% of its rows masked as
   removed, distances within `tf32_atol` of B1's exact search and equal bit
   for bit among the three. The f32 IVF path: `Index(ndim=256, metric="cos",
   dtype="f32")` over the IVF path's 1M unit rows, the same build and
   16,384 member queries (recall@1 >= 0.99, recall@10 printed), the plain
   probe's search within `tf32_atol` (keys equal apart from near ties),
   then `pair` (B6) and `nofold` (B5) each against its plain version; B3
   and no flat kernel must launch.
   The binary paths, at the shape of scripts/tpu_binary_ivf_bench.py: 1M
   packed 1024-bit rows of a clustered corpus (400 template rows, 8% of
   the bits flipped), 4,096 member queries, k=10; per metric (hamming, then
   tanimoto) a new b1 index: `add`, the flat approximate search of the
   member queries (recall@1 >= 0.99) and `search(exact=True)` as the ground
   truth, both through the bit scan and equal bit for bit to
   `bit_scan_plain` over the same arguments (`bit_scan` and no other
   kernel must launch on them), the exact search timed beside the plain
   scan it replaced (ms, QPS, peak device memory; results equal),
   `optimize(n_partitions=976, reorder=True)`, `expansion_search =
   1024`, the probed search (recall@1 >= 0.99, tie-aware recall@10
   printed), the same search through the kernels' plain versions (keys and
   distances equal), 4,096 rows added after the build and found, 1% of the
   keys removed and never returned. From `optimize` on, B3 (B4, its b1
   instantiation) must launch on hamming, B5 on tanimoto, and neither B1,
   B2 nor the bit scan on either.
   The index lifecycle (LIFECYCLE, bench.py's width): (a) 2**20 host f32
   rows added to a new `Index(ndim=256, metric="ip", dtype="i8")`, the host
   cast, the key map's calls and the rest (upload, scatter, stats) timed,
   failing unless the native key map and the native i8 cast ran; (b)
   `optimize(n_partitions=8192, reorder=True)`, past the flat fit's 4,096
   partitions, its stages timed (level 1, the coarse assignment, level 2's
   sub-fits, the flat pass, the layout), 16,384 member queries at k=10
   (recall@1 >= 0.99, recall@10 against the exact answer printed) through
   B3 alone, equal to B3's plain version; (c) saved to a temporary file
   (its size equal to `serialized_length`) and to a buffer, and restored
   three ways (`Index.restore(path)`, with `view=True`, from the buffer),
   each with its IVF and no k-means fit, searching bit for bit as the saved
   index through B3; then 1% of the keys removed and 4,096 rows added on a
   restored index, saved and restored again: no removed key returned, every
   fresh row found, at least 99% of the queries' results equal bit for bit
   (the compaction moves rows across B3's 128-row bins); (d) the IVF path's
   spilled index (after its removals and fresh adds) saved and restored
   without its shadow rows: recall@1 >= 0.99 over its live member queries,
   no removed key returned, every fresh row found; the files deleted.
   Serving, each step fatal and timed: (e) a streamed view at a real size
   (STREAMED): 2**22 unit rows in an i8 ip index (1 GiB), saved and
   `Index.restore(path, view=True, stream=True)`, 1,024 member queries at
   k=10 equal to the resident `search(exact=True)` apart from ties, through
   B2 and the rescore once a tile (32 each) and no other kernel, a filter (even keys) against the
   resident filtered search, `get` from the map, `add`/`remove` refused,
   the search's time beside the host copy of the rows out of the map into
   pinned memory and a pinned upload of the same bytes, a streamed
   `search_async`'s dispatch time beside its result's and its host syncs,
   and bench.py's streamed shape (2**18 rows) with its QPS; (f)
   `search_async` on the IVF path's i8 index: 8 batches of 1,024 member
   queries in flight, each equal bit for bit to the synchronous search, an
   add on another thread within 10 s, the host syncs inside one dispatch
   (`torch.cuda.set_sync_debug_mode`), a filtered one's too; (g) a `BinaryIndexServer` on that
   index and a `BinaryIndexClient` pipelining 4,096 single-query requests,
   each response equal to the one-batch search, QPS and the mean coalesced
   batch printed; then `IndexServer`/`IndexClient` over HTTP (info, add,
   search, get, remove, contains); every socket with a 10 s timeout;
   (h) the metric tail and host modules (TAIL): haversine over 2**20
   points and divergence over 2**20 x 64 probability rows (exact search,
   `optimize(1024)`, probed search at nprobe 16, recall@10 against the
   exact answer >= 0.9), jaccard over 2**18 sets of ~45 ids (`optimize(512)`,
   recall@10 >= 0.85), a user-defined weighted L1 (`CompiledMetric`) over
   2**18 x 128 f32 rows probed, its distances within 2e-3 relative of the
   metric; an f64 index of 2**18 x 256 whose `get` gives its rows back bit
   for bit, whose exact search (the plain scan) equals an f32 index's (B2)
   within FLOAT_RTOL and f32 summation's bound and whose approximate search has recall@1
   >= 0.99; `cluster()` over the
   IVF path's index within [512, 1024] clusters; `join` of 16,384 perturbed
   member rows against it, `exact=True` (B2 and the rescore must launch) and probed (B3
   must launch), at least 90% of the proposers matched; each piece timed;
   (i) the sharded index (SHARDED): 2**20 unit rows x 256 in an i8 ip
   `ShardedIndex` on `make_mesh(4)` (4 shards of 262,144 rows on the one
   card), 1,024 member queries searched exactly (B2 and the rescore once a
   shard and no other kernel; keys equal to a single-device `Index.search(exact=True)`
   over the same rows apart from ties), `optimize(256)` per shard, 16,384
   member queries probed at `expansion_search` 1,024 (B3 once a shard and
   no other kernel, recall@1 >= 0.99, recall@10 against the exact answer
   printed beside the plain core's, ``PROBE_MODE = "xla"``), the same
   search through B3's plain version equal, the host syncs of one search;
   4,096 rows added and found through B2 and the rescore, 1% of the keys removed and never
   returned, `optimize` again, saved and loaded, the loaded pool searching
   bit for bit as the saved one; then a process group of one over NCCL
   (`distributed_initialize`), the exact search through the all-gather
   equal to the search without a group; each piece timed;
   (j) the C ABI (CABI): libusearch_torch.so loaded into this process
   through ctypes, on the card (no USEARCH_TORCH_DEVICE); the IVF path's
   index saved, `usearch_metadata` (ip, i8, 256), `usearch_init`,
   `usearch_load`, `usearch_change_expansion_search(1024)`; 1,024 one-query
   `usearch_search` calls of live member queries, each equal bit for bit to
   `Index.search` of the query on the file restored in Python, recall@1 >=
   0.99, B3 once a call and no other kernel, the median and p99 us a call
   beside the Python one-query search's and `usearch_size`'s; 64
   `usearch_filtered_search` calls against 10% of the keys equal to
   `Index.search(filter=...)`; `usearch_view` of the file searching as the
   loaded handle; `usearch_get` in i8 and f32 equal to `Index.get`; 1% of
   the keys removed one call each, none returned; `usearch_exact_search`
   over bench.py's 1M x 256 unit i8 rows in host memory with 16,384 member
   queries, distances bit for bit and keys apart from ties against
   `exact_search`, B2 and the rescore launched, its upload share; 4,096 one-row
   `usearch_add` calls into a fresh i8 ip index (adds/s), every row found
   by an exact search; test.c and test.cpp exited 0 on the card;
   (k) whole-search capture (CAPTURE): each captured path's replay (B1,
   B2 with the rescore's dots, B3 and its `pair` (B6) and `bin` (B7) flavours, B4, B5, both b1
   indexes' exact flat searches (the bit scan), the sharded
   searches) equal to its eager body bit for bit, both timed, one replay
   profiled (a graph launch a graph, no kernel launch outside it); the
   updates' replays and recaptures; (l) the k-means fits captured (FITS):
   phase 3's two builds split again with their fits eager, beside the
   replayed splits; a two-level fit's sub-fits in at least two size buckets and a flat fit
   with its early exits, each equal bit for bit (assignments, centroids,
   the exit iteration) to its eager steps at the same seed, timed both
   ways, and one sub-fit's launches profiled eager and replayed;
4. each kernel at each path's shapes: held against its plain version with
   phase 2's tolerances, then timed beside its bound, the plain version's
   time (the hold's own call, synchronised) and one library call's time as
   a yardstick (none for the probe
   kernels B3-B7 and the rescore over i8; `torch.bmm` of the gathered rows
   for its bf16 and f32); the rescore's dots at both exact searches' bins;
   the bit scan at both b1 exact searches' arguments (its yardstick a bf16
   `torch.matmul` of the unpacked bits, the product alone, and a profile of
   each exact b1 search); B3 also over the IVF pairs with queries and table in
   bf16, and at the pairs of a batch of 1,024 queries (that search through
   B3's plain version held equal to the kernel's); B3, B5 (`nofold`) and B6
   (`pair`) over f32 at the f32 IVF path's arguments and B8/B9/B10 over f32
   on the f32 cos table, bound at the three-pass TF32 rate (PEAK_OPS
   "tf32x3", the SIMT f32 bound printed beside it), the f32 flat rows beside
   f32 `torch.matmul` (TF32 off); and a profile of one warm search of each
   path and flavour, the f32 IVF path, the flat-scan flavours over i8 and
   f32, both exact paths and the lifecycle's 8,192-partition IVF included
   (B3 also at that IVF's pairs); B2 and B3 at one shard of the sharded
   index (262,144 rows, Q=1,024 and the probed search's pairs), and its
   exact and probed searches profiled, timed beside the single-device
   index's over the same rows, and split into the shards' work, the merge
   and the host;
5. the TPU micro-benchmarks of scripts/, each a path of its own: the
   modules `python -m usearch_torch.microbench.i8_matmul_probe`,
   `select_microbench` and `probe_v2_bisect` at their scripts' shapes, the
   counters zeroed just before each and read just after (its own kernel
   and no other must launch); then B11 (loop-carried `wgmma` products, a
   flag a step in place of a grid barrier) in its four modes at small
   shapes, one past 2**24, at LOOP_EDGES (rows padded inside a 64-row tile,
   K = N, K over two and sixteen lead blocks, 64-column warpgroups) and at
   the script's (256 x 256 x 8192, 512 steps), bit for bit, with its chain
   alone (the product taken out) timed beside it; B12 (selection loop) in
   its eight variants at three shapes, the last the script's, bit for bit
   (the two f32 sums of group minima within 1e-6 relative), its time per
   pass (a 1-pass launch's time taken out) at 200 and 400 passes within 10%,
   beside the grid's blocks and the bound a pass;
   B13 (probe-select bisection on `wgmma`) in its five variants, and from 0
   as well as from MASKED, on a 64-partition table, at BISECT_EDGES (a half
   last tile, rows of 384 and 640 bytes, planted equal dots, windows outside
   the table, own windows at or past n_win) and at the script's shape (10M
   x 128 i8 rows, 1,024 queries x 16 probes), bit for bit, each select's
   time also beside dot_only's; each timed beside its bound, its plain
   version and, for B11, one library product times the steps.

The line before the last is a JSON object with a row per kernel (B1/B2's
and B8-B10's rows also say whether the tensor cores, in TF32 passes or not,
or SIMT FMAs ran the product); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import datetime
import faulthandler
import importlib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from usearch_torch import Index, build, cabi, exact_search, graphs, ivf, keymap, persist
from usearch_torch.client import IndexClient
from usearch_torch.rpc import BinaryIndexClient, BinaryIndexServer
from usearch_torch.server import IndexServer
from usearch_torch.enums import CompiledMetric, MetricKind, ScalarKind, normalize_metric
from usearch_torch.exact import pad_queries, pick_tile_rows
from usearch_torch.matches import BatchMatches
from usearch_torch.microbench import bitscan_breakdown, i8_matmul_probe, probe_v2_bisect, select_microbench, time_once
from usearch_torch.native import casts_native, keymap_native
from usearch_torch.ops import bitscan, casts, microbench, probe, scan, tf32
from usearch_torch.ops.casts import cast_rows
from usearch_torch.ops.distances import MASKED, dot, row_stats, scan_epilogue, tile_dists
from usearch_torch.ops.packbits import pack_bits, unpack_bits
from usearch_torch.ops.topk import masked_topk
from usearch_torch.parallel import sharded
from usearch_torch.parallel.mesh import distributed_initialize, make_mesh

#: modules whose functions phase 3 times (the package's name `kmeans` is
#: the clustering function, not its module)
kmeans = importlib.import_module("usearch_torch.kmeans")
index_module = importlib.import_module("usearch_torch.index")

SEED = 0
#: phase 2 shape
CHECK = dict(n=65536, q=512, ragged_q=40, w=256, deleted=0.1)
#: phase 2 shape of the exact rescore's dots: table rows by width (i8 also
#: past I8_F32_EXACT_WIDTH, where the plain version sums in f64), query
#: counts, bins a query (k=10 + EXACT_BIN_SLACK)
RESCORE_CHECK = dict(rows={256: 65536, 1152: 16384}, widths={"i8": (256, 1152), "bf16": (256,), "f32": (256,)},
                     qs=(512, 40, 1), b=14)
#: phase 3/4 shapes: bench.py's headline, and the f32 compact path
MAIN = dict(n=1_000_000, w=256, q=16384, k=10, exact_q=1024, removed=0.01)
COMPACT = dict(n=262144, w=256, q=16384, k=10, exact_q=1024)
#: phase 2's ragged and wide B1/B2 cases: rows, width by dtype, query
#: counts; bins 1 and 2 of each table fully deleted. Two 256-row tiles at
#: W=128; an odd bin count at the widest rows a block keeps whole (i8 512
#: bytes, bf16 and f32 compact 512 bytes as bf16); rows streamed through the
#: ring beside the queries
SCAN_EDGES = ((512, {"i8": 128, "bf16": 128, "f32": 128}, (100, 1)),
              (384, {"i8": 512, "bf16": 256, "f32": 256}, (100, 40)),
              (4096, {"i8": 2048, "bf16": 512, "f32": 512}, (100, 40)))
#: the product instruction of the wgmma instantiations of csrc/scan.cu, by
#: the storage type's mangled name (f32: compact mode only)
SCAN_SASS = {"a": "IGMMA", "13__nv_bfloat16": "HGMMA", "f": "HGMMA"}
#: the wgmma instantiations of B8/B9/B10 in csrc/fused.cu: storage type's
#: mangled name -> the `kSmall` flags it has (i8 rows of at most 256 bytes);
#: the flavour (`Flavour`) by its code; f32 ("f") takes the three-pass TF32
#: product (an HGMMA of TF32 operands, `TF32_SASS`)
FUSED_SASS = {"a": ("0", "1"), "13__nv_bfloat16": ("0",), "f": ("0",)}
#: the product instruction of the f32 instantiations of fused.cu and
#: probe.cu: an HGMMA whose operands are TF32
TF32_SASS = ("HGMMA", "TF32")
FUSED_FLAVOURS = {"0": "B8", "1": "B9", "2": "B10"}
#: B1/B2's SIMT f32 kernel (modes kBinned, kMinima): the FMA it must hold
#: and the tensor-core products it must not
SIMT_SASS = ("FFMA", ("HMMA", "HGMMA", "IGMMA", "IMMA"))
#: phase 2 shape of B3: windows, their lengths, queries, probes per query
PROBE_CHECK = dict(windows=256, min_len=200, max_len=400, q=512, ragged_q=40, nprobe=8, w=256, deleted=0.1)
#: phase 2's edges of B3/B5's tensor-core design (PROBE_EDGES): a table of
#: n rows, padded windows of w_pad rows, the widths (one 128-byte K-block;
#: a K-tail past a 256-byte tile; i8, bf16 and b1 query tiles too wide to
#: stay in shared memory), B3's k and bin_m (B5's bin_m over i8/bf16, and
#: over b1), ~10% deleted rows
PROBE_EDGES = dict(n=4096, w_pad=768, widths=(128, 384, 1024), ks=(1, 3, 10, 128), bin_ms=(1, 4, 16),
                   nofold_bin_ms=(1, 4, 8), b1_nofold_bin_ms=(1, 4, 8, 16), deleted=0.1)
#: phase 1: the SASS of the probe library; the tensor-core kernel
#: (`grouped_wgmma`) by storage type (mangled: i8, bf16, packed b1 as uint8)
#: and product, its metric codes (b1: hamming as l2sq's rank form), kSmall
#: values and (kernel, list length) pairs of B3, B5 and B6's lists, the one
#: instantiation of B7 (i8, no metric, integer keys), the flavours by their
#: code (csrc/probe.cu `Flavour`); f32 ("f") takes the three-pass TF32
#: product
PROBE_SASS = {"a": "IGMMA", "13__nv_bfloat16": "HGMMA", "h": "BGMMA", "f": TF32_SASS}
PROBE_METRICS = {"a": (0, 1, 2), "13__nv_bfloat16": (0, 1, 2), "h": (2,), "f": (0, 1, 2)}
PROBE_SMALL = {"a": ("0", "1"), "13__nv_bfloat16": ("0",), "h": ("1",), "f": ("0",)}
PROBE_LISTS = {"a": (("B3", 4), ("B3", 16), ("B5", 4), ("B5", 8), ("B6", 4)),
               "13__nv_bfloat16": (("B3", 4), ("B3", 16), ("B5", 4), ("B5", 8), ("B6", 4)),
               "h": (("B3", 4), ("B3", 16), ("B5", 8), ("B5", 16), ("B6", 4)),
               "f": (("B3", 4), ("B3", 16), ("B5", 4), ("B5", 8), ("B6", 4))}
PROBE_B7 = "a/metric 0/B7 lists 4/small 0"
PROBE_FLAVOURS = {"0": "B5", "1": "B3", "2": "B6", "3": "B7"}
#: the SIMT kernels that once took f32 rows, which must be gone
SIMT_GONE = ("grouped_probe_kernel", "fused_kernel", "lanes_kernel")
#: phase 4: the small batch of B3's row at the IVF path's index
SMALL_Q = 1024
#: phase 3/4: the IVF path of bench.py
IVF = dict(n=1_000_000, w=256, q=16384, k=10, partitions=1024, spill=0.05, expansion=1024, gt_q=2048,
           fresh=4096, removed=0.01)
#: phase 3/4: the f32 IVF path: IVF's build over the same rows in f32 with
#: cos, and the probe flavours it also runs ("bin" is i8-only)
F32_IVF = dict(metric="cos", modes=("pair", "nofold"))
#: phase 3/4: the share of the f32 cos table's rows masked as removed for
#: the f32 flat-scan flavours
F32_REMOVED = 0.01
#: phase 3/4: the index lifecycle at bench.py's width: 2**20 host f32 rows
#: added to an i8 ip index, an IVF of 8,192 partitions (the two-level fit),
#: saved and restored, then 1% of the keys removed and 4,096 rows added
LIFECYCLE = dict(n=1 << 20, w=256, q=16384, k=10, partitions=8192, expansion=1024, gt_q=2048, removed=0.01,
                 fresh=4096)
#: phase 3 (e): a streamed view of 2**22 unit rows x 256 i8 (1 GiB of rows,
#: 32 tiles of stream.DEFAULT_TILE_ROWS; 2**23 until step (k) came, whose
#: time it pays for), 1,024 member queries at k=10; and bench.py's streamed
#: shape (bench.py:225-253: 2**18 rows, 1,024 queries)
STREAMED = dict(n=1 << 22, w=256, q=1024, k=10, tiles=32, bench_n=1 << 18)
#: phase 3 (f): batches of member queries in flight at once on the IVF path's
#: index; phase 3 (g): single-query requests over the binary RPC; every
#: socket's and wait's timeout, s
ASYNC = dict(batches=8, q=1024, rounds=3)
SERVING = dict(requests=4096, timeout=10.0)
#: phase 3 (h): the metric tail at real sizes: 2**20 (lat, lon) points,
#: 2**20 x 64 probability rows (a mixture of `div_anchors` Dirichlet
#: draws), 2**18 integer sets of ~45 ids (templates of 48 from a universe
#: of 2**20, each id kept with probability 0.85, 4 ids added), a weighted
#: L1 metric over 2**18 x 128 f32 rows (`udf_anchors` clusters), an f64
#: index of 2**18 x 256; probed at nprobe 16 (`expansion` each); `cluster`
#: over the IVF path's index within `cluster` bounds; `join` of
#: `join_n` perturbed member rows against it at `proposals`
TAIL = dict(hav_n=1 << 20, div_n=1 << 20, div_w=64, div_anchors=4096, set_n=1 << 18, set_templates=4096,
            set_ids=48, set_keep=0.85, set_extra=4, set_universe=1 << 20, udf_n=1 << 18, udf_w=128,
            udf_anchors=1024, f64_n=1 << 18, f64_w=256, q=1024, gt_q=256, k=10,
            partitions={"haversine": 1024, "divergence": 1024, "jaccard": 512, "udf": 512},
            expansion={"haversine": 1024, "divergence": 1024, "jaccard": 512, "udf": 512},
            bars={"haversine": 0.9, "divergence": 0.9, "jaccard": 0.85}, udf_rtol=2e-3,
            cluster=(512, 1024), join_n=16384, proposals=16, join_noise=0.02)
#: phase 3 (i): the sharded index at bench.py's width: 2**20 unit rows x
#: 256 in an i8 ip `ShardedIndex` of 4 shards on the one card (262,144 rows
#: each), `exact_q` member queries searched exactly, `optimize(partitions)`
#: per shard, `q` member queries probed at `expansion`, `fresh` rows added
#: and `removed` of the keys removed
SHARDED = dict(n=1 << 20, w=256, shards=4, exact_q=1024, q=16384, k=10, partitions=256, expansion=1024,
               fresh=4096, removed=0.01)
#: phase 3 (j): the C ABI (usearch_torch.cabi) in this process, on the IVF
#: path's index saved to a file: `q` one-query searches at `expansion`,
#: `filtered` filtered ones against `allowed` of the keys, `view_q` on a
#: view, `get_keys` gets, `removed` of the keys removed (`removed_q` of
#: them searched for after); usearch_exact_search over bench.py's 1M x 256
#: unit i8 rows in host memory with `exact_q` member queries; `adds`
#: one-row adds into a fresh index (16,384 until step (k) came, whose time
#: the cut pays for, with step (e)'s); the port's test.c and test.cpp as
#: programs, each within `timeout` s
CABI = dict(q=1024, k=10, expansion=1024, filtered=64, allowed=0.1, view_q=64, get_keys=64, removed=0.01,
            removed_q=256, exact_q=16384, adds=4096, timeout=180)
#: phase 3 (k): whole-search capture (graphs.py): each path's eager body and
#: its replay timed `reps` times each, in turns; the updates' IVF of `n`
#: unit rows x 256 i8 (`partitions`, spill, `q` member queries), `removed`
#: of its keys removed, `fresh` rows added, then `grow` rows (past its
#: capacity: the IVF gives way to the flat search)
CAPTURE = dict(reps=10, n=1 << 18, partitions=256, spill=0.05, expansion=1024, q=1024, k=10, removed=0.01,
               fresh=1024, grow=80000)
#: phase 3 (l): the k-means fits captured (kmeans.py, graphs.py
#: `GraphCache.repeat`): a two-level fit of `n` rows x 256 in i8 (unit rows
#: around `blobs` centers, the i-th drawn i + 1 times as often, so the coarse
#: clusters differ in size) into `k` centroids (46 coarse, 45 a sub-fit of
#: ~5,700 rows on average, in more than one size bucket), `iters` fused steps
#: each; a flat fit of the first `flat_n` rows into `flat_k` centroids with
#: its early exits; one sub-fit at `optimize(8192)`'s level-2 shape
#: (`sub_rows` rows into `sub_k`) profiled eager and replayed; the seeding
#: steps of `optimize(1024)`'s fit (`seed_k` over `seed_rows`: a quarter of
#: its 1,023 steps, each the same work) profiled
FITS = dict(n=1 << 18, blobs=64, k=2048, iters=25, flat_n=1 << 17, flat_k=256, seed=0, sub_rows=11500, sub_k=91,
            seed_rows=1 << 20, seed_k=256)
#: phase 3/4: the binary IVF paths of scripts/tpu_binary_ivf_bench.py
BINARY = dict(n=1_000_000, bits=1024, templates=400, flip=0.08, q=4096, k=10, partitions=976, expansion=1024,
              fresh=4096, removed=0.01, metrics=("hamming", "tanimoto"))
#: phase 2 shape of the exact bit scan (csrc/bitscan.cu): table rows (a
#: ragged last tile), widths in bytes (1,024: the queries stream their
#: K-blocks beside the table's), query counts, k, the share of rows
#: deleted, and the live rows of the tables with fewer than k
BITSCAN_CHECK = dict(n=16384 + 77, widths=(128, 1024), qs=(1, 40, 4096), ks=(1, 10, 128), dead=0.1, live=5)
#: phase 3/4: the binary metrics the bit scan takes
BIT_METRICS = ("hamming", "tanimoto", "sorensen")
#: phase 4: rows of the unpacked table a chunk of the bit scan's library
#: yardstick (bf16, 2 GiB at 1,024 bits)
BIT_LIBRARY_ROWS = 1 << 17
#: H100 SXM peaks (NVIDIA data sheet, dense): ops/s by operand type, bytes/s;
#: f32 products to f32 accuracy on the tensor cores ("tf32x3") at a third of
#: the TF32 rate (three products each), beside SIMT f32 FMAs ("f32");
#: b1 (two operations per bit pair) at eight times the int8 rate: the b1
#: `wgmma` with and-popc (m64n128k256) issues at the s8 form's (m64n128k32)
#: rate per instruction, 256 bit pairs where s8 takes 32 byte pairs
#: (`python -m usearch_torch.microbench.probe_breakdown`: B4's product alone
#: beside the s8 product over the same bytes at the same steps)
PEAK_OPS = {"i8": 1979e12, "bf16": 989e12, "f32": 67e12, "b1": 8 * 1979e12, "tf32x3": 494.7e12 / 3}
PEAK_BYTES = 3.35e12
#: float bin minima: f32 sums of W products in another order
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-4
#: B10 bf16 at LANES_EDGES against its plain version: those sums round by
#: about 2^-24 sqrt(W) times the squared norms, not the distance (l2sq on
#: the planted copies of the queries cancels to near 0), so an atol of this
#: times the largest q_sq + t_sq besides, as tests/test_torch_fused_edges.py
TERMS_ATOL = 1e-6
METRICS = ("ip", "cos", "l2sq")
DTYPES = {"i8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
#: the kernel wrappers of the flat paths (B1, B2 and the exact rescore's
#: dots) and of the IVF path, each with its launch counter
FLAT_KERNELS = (scan.binned_scan, scan.binned_minima, scan.block_dots)
PROBE_KERNELS = (probe.grouped_probe, probe.grouped_probe_nofold, probe.pair_probe, probe.binned_probe)
#: the flat-scan flavours (phase 3): each search with the wrapper of the one
#: kernel it must launch, and the TPU kernel that one replaces
FLAVOURS = {
    "fused": (scan.search_fused, scan.fused_topk, "B8", "usearch_tpu/ops/pallas_scan.py:113"),
    "fused_stream": (scan.search_fused_stream, scan.fused_topk_stream, "B9", "usearch_tpu/ops/pallas_scan.py:228"),
    "binned_lanes": (scan.search_binned_lanes, scan.binned_scan_lanes, "B10", "usearch_tpu/ops/pallas_scan.py:397"),
}
FLAVOUR_KERNELS = tuple(f[1] for f in FLAVOURS.values())
#: phase 5: the TPU micro-benchmarks of scripts/, each module's `main` with
#: the wrapper of the one kernel it must launch, its source and the TPU kernel
#: it replaces
MICRO = {
    "i8_matmul_probe": (i8_matmul_probe.main, microbench.loop_matmul, "usearch_torch/csrc/matmul_probe.cu",
                        "scripts/tpu_i8_matmul_probe.py:50"),
    "select_microbench": (select_microbench.main, microbench.select_loop, "usearch_torch/csrc/select.cu",
                          "scripts/tpu_select_microbench.py:19"),
    "probe_v2_bisect": (probe_v2_bisect.main, microbench.bisect_probe, "usearch_torch/csrc/bisect.cu",
                        "scripts/tpu_probe_v2_bisect.py:60"),
}
MICRO_KERNELS = tuple(m[1] for m in MICRO.values())
#: the exact scan over packed b1 rows (csrc/bitscan.cu)
BIT_KERNELS = (bitscan.bit_scan,)
ALL_KERNELS = FLAT_KERNELS + PROBE_KERNELS + FLAVOUR_KERNELS + MICRO_KERNELS + BIT_KERNELS
#: phase 5 checks at small shapes: B11's (M, K, N, REPS), the first past
#: 2**24; B12's (W, G, IT); B13 on a 64-partition table of 78,080 rows
LOOP_CHECK = ((32, 64, 128, 512), (64, 128, 256, 40), (256, 256, 1024, 24))
SELECT_CHECK = ((256, 64, 5), (1536, 32, 3), (1408, 128, 200))
BISECT_CHECK = dict(n=64 * 1220, c=64, d=128, q=256, nprobe=16)
#: B11's edges of its tensor-core design: rows padded inside a 64-row tile
#: (48, 80), K = N, K spanning two lead blocks (512) and sixteen (1,024: A
#: through a ring of K-blocks, bf16's a0 left in device memory), 64-column
#: warpgroups (N = 192)
LOOP_EDGES = ((48, 512, 512, 64), (80, 64, 192, 100), (16, 1024, 1024, 8), (80, 128, 128, 30))
#: B13's edges on BISECT_CHECK's table: w_pad ending in a half 128-row tile
#: (1,344), rows of 384 bytes (three K-blocks) and 640 (query K-blocks
#: streamed beside the table's), rows copying a window's row 0 inside a
#: thread's rows and across the quad (offsets), windows outside the table
#: (cell 0: past the end, negative) and lanes whose own window is at or past
#: n_win or skipped
BISECT_EDGES = dict(w_pads=(1408, 1344), widths=(128, 384, 640), offsets=(1, 2, 8, 34), own=(200, 2, 5))
#: B12: f32 sums of group minima may follow another order (none does here)
SELECT_RTOL = 1e-6
SELECT_F32_SUMS = ("f32_min32", "f32_minarg32")
#: B12: (rows a pass needs, 32-bit operations an element) by variant, for
#: the bound: add i; convert; min or compare-and-select; negate, shift, or;
#: counted at PEAK_OPS["f32"], two a lane and clock of the FMA pipe. On
#: compute capability 9.0 these issue slower (CUDA C++ Programming Guide,
#: results a clock and SM): 64 for 32-bit integer add, shift, bitwise,
#: compare, min and max, a quarter of that rate; 16 for int-to-f32, a
#: sixteenth (csrc/select.cu's note)
SELECT_OPS = {"astype_only": (lambda w: 8, 3), "i32_min128": (lambda w: w, 2), "i32_min32": (lambda w: w, 2),
              "f32_min32": (lambda w: w, 3), "pack_only": (lambda w: w // 32, 4), "pack_min32": (lambda w: w, 5),
              "f32_minarg128": (lambda w: w, 4), "f32_minarg32": (lambda w: w, 4)}
#: B12's time per pass at IT and at 2 IT agree within this share; a pass's
#: time is (t(IT) - t(1)) / (IT - 1), the launch and the staging of one
#: launch taken out
PASS_STEADY = 0.10
#: phase 2 of the flavours: k, a deleted stretch of rows, the live bins of a
#: table with fewer live bins than k=10, and the rows, by dtype the widths,
#: of tables whose rows B10 stages slab by slab
FUSED_CHECK = dict(ks=(10, 128), stretch=(4096, 8192), live_bins=(5, 300, 511), wide_n=509 * 128,
                   wide_w={"f32": 512, "i8": 2048})
#: phase 2's edges of B8/B9's tensor-core design: bin counts (three 8-bin
#: merge groups; an odd count, so a half last 256-row tile; a larger odd
#: one), the width, query counts (no full 128-query block; three blocks,
#: the last partial), k, the bins that copy bin 1
#: (across a tile edge and a merge-group edge; the last bin too), the noise
#: of bf16 bin 1 about its queries, and the live bins of a table with fewer
#: than k
FUSED_EDGES = dict(bins=(24, 19, 1023), w=256, qs=(40, 300), ks=(1, 10, 128), copies=(2, 7, 8), noise=0.5,
                   live_bins=(1, 2, 18))
#: phase 2's edges of B10 on B8's tensor-core kernel: FUSED_EDGES' planted
#: tables (bins, query counts) in every dtype, and planted rows too wide to
#: stay in shared memory (i8 and bf16: streamed query K-blocks) in 19 bins
LANES_EDGES = dict(wide_w={"i8": 2048, "bf16": 1024, "f32": 512}, wide_bins=19)
#: phase 3/4: the IVF path's probe flavours besides the default, each with
#: the wrapper of the kernel it must launch
MODES = {"pair": "pair_probe", "bin": "binned_probe", "nofold": "grouped_probe_nofold"}
#: phase 2, B6 on a narrow surface: (k, bin_m), bin_m past the 16 a B3 list
#: holds
PAIR_NARROW = ((10, 16), (64, 32), (128, 128))
#: phase 2, B7: every admitted (sel, bw, keep) (ops/probe.py `_check_binned`)
#: and the row widths in bytes
BINNED_SELECTIONS = tuple((sel, bw, keep) for sel in probe.BIN_SELECTIONS
                          for bw in (2, 4, 8, 16, 32, 64, 128) if sel == "fminarg" or bw <= 32
                          for keep in range(1, min(probe.MAX_KEEP, bw // 2) + 1))
BINNED_WIDTHS = (128, 384, 2048)


def log(*args) -> None:
    print(*args, flush=True)


#: perf_counter at the start of `main`
T_START = time.perf_counter()


def stamp(label: str) -> None:
    """The seconds since the start, after ``label``: where the run's time goes."""
    log(f"-- {label} done at {time.perf_counter() - T_START:.1f} s")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def tf32_atol(metric, q: torch.Tensor, table: torch.Tensor) -> float:
    """The atol of an f32 flavour's distances (the three-pass TF32 product
    of B3/B5/B6 and B8-B10) against its plain version's (f32 FMAs), beside
    FLOAT_RTOL: FLOAT_ATOL, and the bound tests/test_torch_tf32_split.py
    proves for the product's dots of W columns (ops/tf32.dot_rtol(W): the
    split's error a product and one f32 rounding a k-step and pass) plus
    TERMS_ATOL for the plain version's sums in another order, as bf16's,
    times the largest q_sq + t_sq: a dot's terms sum |q_i t_i| <= (q_sq +
    t_sq) / 2, and l2sq takes -2 dot; cos divides its dots by both norms, so
    2 in place of q_sq + t_sq."""
    if metric == MetricKind.Cos:
        scale = 2.0
    else:
        scale = float((q.float() ** 2).sum(1).max() + (table.float() ** 2).sum(1).max())
    return FLOAT_ATOL + (tf32.dot_rtol(q.shape[1]) + TERMS_ATOL) * scale


def make_rows(n: int, w: int, dtype, gen, dev) -> torch.Tensor:
    """Random rows in storage dtype; i8 through the port's quantizer."""
    x = torch.randn(n, w, generator=gen, device=dev)
    if dtype == torch.int8:
        return cast_rows(x, ScalarKind.F32, ScalarKind.I8)
    return x.to(dtype)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 units in the last place."""

    def ordered(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))

    return (ordered(a) - ordered(b)).abs()


def bin_gaps(metric, q, table, q_sq, t_sq, penalty, shifted, round_bf16):
    """Gap between the two best rows of every bin, from the full scores, in
    query chunks of at most 2**28 scores."""
    if round_bf16:
        q, table = q.to(torch.bfloat16), table.to(torch.bfloat16)
    step = max(1, (1 << 28) // table.shape[0])
    gaps = []
    for lo in range(0, q.shape[0], step):
        d = scan_epilogue(metric, dot(q[lo : lo + step], table), q_sq[lo : lo + step], t_sq, penalty, shifted)
        two = torch.topk(d.view(d.shape[0], -1, 128), 2, dim=-1, largest=False).values
        gaps.append(two[..., 1] - two[..., 0])
    return torch.cat(gaps)


def check_kernels(dev) -> None:
    """Phase 2."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, nq, w = CHECK["n"], CHECK["q"], CHECK["w"]
    valid = torch.rand(n, generator=gen, device=dev) >= CHECK["deleted"]
    for name, dtype in DTYPES.items():
        table = make_rows(n, w, dtype, gen, dev)
        q = make_rows(nq, w, dtype, gen, dev)
        table[:3] = 0  # zero rows and a zero query exercise cos's zero-norm rules
        q[0] = 0
        stats = torch.stack([(table.float() ** 2).sum(1), table.float().sum(1)], 1)
        for metric_name in METRICS:
            metric = normalize_metric(metric_name)
            # the full query batch, and a ragged one that fills no block
            for qc in (q, q[: CHECK["ragged_q"]]):
                modes = [False, True] if dtype == torch.float32 else [False]
                for compact in modes:
                    check_one(f"{name}/{metric_name}{' compact' if compact else ''} Q={qc.shape[0]}",
                              (metric, qc, table, *scan.scan_aux(metric, qc, stats, valid)), compact)


def check_scan_edges(dev) -> None:
    """Phase 2, B1/B2 at SCAN_EDGES: ragged query tiles, fully deleted bins,
    a half 256-row tile, W=128, and rows too wide for a block to keep."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for n, widths, counts in SCAN_EDGES:
        for name, dtype in DTYPES.items():
            w = widths[name]
            valid = torch.rand(n, generator=gen, device=dev) >= CHECK["deleted"]
            valid[128:384] = False
            table = make_rows(n, w, dtype, gen, dev)
            q = make_rows(max(counts), w, dtype, gen, dev)
            table[:3] = 0
            q[0] = 0
            stats = torch.stack([(table.float() ** 2).sum(1), table.float().sum(1)], 1)
            for metric_name in METRICS:
                metric = normalize_metric(metric_name)
                for nq in counts:
                    qc = q[:nq]
                    for compact in ([False, True] if dtype == torch.float32 else [False]):
                        check_one(f"{name}/{metric_name}{' compact' if compact else ''} N={n} W={w} Q={nq}",
                                  (metric, qc, table, *scan.scan_aux(metric, qc, stats, valid)), compact)


def sass_functions(names=("scan", "fused", "probe", "bitscan")) -> dict:
    """The SASS of the built libraries of csrc/<name>.cu (cuobjdump -sass,
    one process a library, all started together), by library and
    function."""
    exe = Path(build.nvcc()).with_name("cuobjdump")
    libs = build.build_all(names)
    procs = {n: subprocess.Popen([str(exe), "-sass", str(libs[n])], stdout=subprocess.PIPE, text=True)
             for n in names}
    out = {}
    for n, proc in procs.items():
        sass, _ = proc.communicate(timeout=300)
        if proc.returncode:
            fail(f"cuobjdump -sass of {libs[n].name} exited {proc.returncode}")
        out[n] = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    return out


def products(body: str, op) -> int:
    """Product instructions of one function's SASS: lines of the opcode
    ``op``, or of every word of a tuple (TF32_SASS: an HGMMA of TF32)."""
    words = (op,) if isinstance(op, str) else op
    return sum(all(w in line for w in words) for line in body.splitlines())


def check_scan_sass(sass: dict) -> dict:
    """Phase 1: the SASS of the built scan library holds a wgmma
    instantiation of B1/B2 for every storage type and mode, and the fused
    library one of B8/B9/B10 for every storage type, metric and flavour;
    each instantiation holds its tensor-core product: IGMMA for i8, HGMMA
    for bf16 and f32 compact, HGMMA of TF32 for B8/B9/B10 over f32. B1/B2's
    SIMT f32 kernel, in both its modes, holds FFMA and no tensor-core
    product; fused.cu's SIMT kernels are gone. Returns the count of product
    instructions by wgmma instantiation."""
    found = {}
    for name, body in sass["scan"].items():
        m = re.search(r"wgmma_scanI(a|13__nv_bfloat16|f)Li(\d)ELi(\d)ELb(\d)E", name)
        if m:
            kind, mode, metric, small = m.groups()
            found[f"{kind}/mode {mode}/metric {metric}/small {small}"] = body.count(SCAN_SASS[kind])
    have = {key.rsplit("/", 2)[0] for key in found}
    want = {f"{t}/mode {mode}" for t in SCAN_SASS for mode in ((1,) if t == "f" else (0, 1, 2))}
    log(f"scan.cu SASS, tensor-core products by wgmma instantiation: {found}")
    if have != want or any(n == 0 for n in found.values()):
        fail(f"scan.cu's wgmma instantiations lack their tensor-core product: {found}")
    simt = {}
    for name, body in sass["scan"].items():
        m = re.search(r"simt_scanILi(\d)E", name)
        if m:
            simt[f"simt mode {m.group(1)}"] = {op: len(re.findall(rf"\b{op}\b", body))
                                                for op in (SIMT_SASS[0], *SIMT_SASS[1])}
    log(f"scan.cu SASS, the SIMT f32 kernel's FMAs and tensor-core products: {simt}")
    if set(simt) != {"simt mode 0", "simt mode 2"} or any(
            c[SIMT_SASS[0]] == 0 or any(c[op] for op in SIMT_SASS[1]) for c in simt.values()):
        fail(f"scan.cu's SIMT f32 kernel lacks FFMA or holds a tensor-core product: {simt}")
    fused, gone = {}, []
    for name, body in sass["fused"].items():
        m = re.search(r"fused_wgmmaI(a|13__nv_bfloat16|f)Li(\d)ELb(\d)ELi(\d)E", name)
        if m:
            kind, metric, small, flavour = m.groups()
            op = TF32_SASS if kind == "f" else SCAN_SASS[kind]
            fused[f"{kind}/metric {metric}/small {small}/{FUSED_FLAVOURS[flavour]}"] = products(body, op)
        gone += [k for k in SIMT_GONE if k in name]
    want = {f"{t}/metric {m}/small {small}/{b}" for t in FUSED_SASS for m in (0, 1, 2) for small in FUSED_SASS[t]
            for b in FUSED_FLAVOURS.values()}
    log(f"fused.cu SASS, tensor-core products by B8/B9/B10 wgmma instantiation: {fused}")
    if set(fused) != want or any(n == 0 for n in fused.values()) or gone:
        fail(f"fused.cu's B8/B9/B10 wgmma instantiations lack their tensor-core product: {fused}; SIMT {gone}")
    return {**found, **fused}


def check_probe_sass(sass: dict) -> dict:
    """Phase 1: the SASS of the built probe library holds the tensor-core
    kernel (`grouped_wgmma`) of B3, B5 and B6's lists for i8 (rows up to 256
    bytes and wider), bf16, f32 and packed b1 (hamming; B5 with lists of 8
    and 16), every metric and list length, and of B7 over i8, each with its
    product (IGMMA, HGMMA, HGMMA of TF32, BGMMA: the b1 and-popc product);
    no SIMT `grouped_probe_kernel` is left. Returns the count of product
    instructions by instantiation."""
    found, simt = {}, []
    for name, body in sass["probe"].items():
        m = re.search(r"grouped_wgmmaI(a|13__nv_bfloat16|h|f)Li(\d)ELi(\d+)ELi(\d)ELb(\d)E", name)
        if m:
            kind, metric, lists, flavour, small = m.groups()
            key = f"{kind}/metric {metric}/{PROBE_FLAVOURS[flavour]} lists {lists}/small {small}"
            found[key] = products(body, PROBE_SASS[kind])
        simt += [k for k in SIMT_GONE if k in name]
    want = {f"{t}/metric {m}/{kind} lists {n}/small {small}" for t in PROBE_SASS for m in PROBE_METRICS[t]
            for kind, n in PROBE_LISTS[t] for small in PROBE_SMALL[t]} | {PROBE_B7}
    log(f"probe.cu SASS, tensor-core products by B3/B5/B6/B7 wgmma instantiation: {found}; SIMT kernels {simt}")
    if set(found) != want or any(n == 0 for n in found.values()) or simt:
        fail(f"probe.cu's B3/B5/B6/B7 instantiations are not the expected ones: {found}, SIMT {simt}")
    return found


def check_bitscan_sass(sass: dict) -> dict:
    """Phase 1: the SASS of the built bit-scan library holds
    `bit_scan_wgmma` for every metric (hamming, tanimoto, sorensen: codes
    3-5) with lists in shared memory and in the output rows, each with
    BGMMA (the b1 and-popc product). Returns the count of product
    instructions by instantiation."""
    found = {}
    for name, body in sass["bitscan"].items():
        m = re.search(r"bit_scan_wgmmaILi(\d)ELb(\d)E", name)
        if m:
            found[f"metric {m.group(1)}/small lists {m.group(2)}"] = products(body, PROBE_SASS["h"])
    want = {f"metric {m}/small lists {small}" for m in (3, 4, 5) for small in (0, 1)}
    log(f"bitscan.cu SASS, BGMMA by bit_scan_wgmma instantiation: {found}")
    if set(found) != want or any(n == 0 for n in found.values()):
        fail(f"bitscan.cu's bit_scan_wgmma instantiations lack BGMMA: {found}")
    return found


def check_one(tag: str, args, compact: bool) -> None:
    """B1 (and B2 when not compact) against the plain versions."""
    hold_b1(tag, args, compact, scan.binned_scan(*args, compact=compact),
            scan.binned_scan_plain(*args, compact=compact))
    if not compact:
        hold_b2(tag, args, scan.binned_minima(*args), scan.binned_minima_plain(*args))


def hold_b1(tag: str, args, compact: bool, kern, plain, name: str = "B1", atol: float = FLOAT_ATOL) -> float:
    """B1's [Q, N/128] surface (or B10's, transposed) against its plain
    version's: i8 bit for bit; compact bf16 minima within 1 ulp; float
    minima within FLOAT_RTOL and ``atol``; argmins equal wherever a bin's two
    best rows are further apart than that. Fails on a mismatch; returns the
    max abs error of the minima."""
    (kv, ki), (pv, pi) = kern, plain
    torch.cuda.synchronize()
    if args[1].dtype == torch.int8:
        ok, detail = torch.equal(kv, pv) and torch.equal(ki, pi), "bit for bit"
    elif compact:
        ulps = int(bf16_ulps(kv, pv).max())
        sure = bin_gaps(*args, shifted=True, round_bf16=True) > FLOAT_ATOL
        ok = ulps <= 1 and torch.equal(ki[sure], pi[sure])
        detail = f"bf16 minima within {ulps} ulp, argmins equal on {int(sure.sum())} clear bins"
    else:
        sure = bin_gaps(*args, shifted=False, round_bf16=False) > atol + FLOAT_RTOL * pv.abs()
        ok = torch.allclose(kv, pv, rtol=FLOAT_RTOL, atol=atol) and torch.equal(ki[sure], pi[sure])
        detail = f"minima within rtol {FLOAT_RTOL} atol {atol:.3g}, argmins equal on {int(sure.sum())} clear bins"
    err = float((kv.float() - pv.float()).abs().max())
    log(f"  {tag}: {name}{' compact' if compact else ''} vs plain {'ok' if ok else 'MISMATCH'}, "
        f"{detail} (max abs err {err:.3g})")
    if not ok:
        fail(f"{name} disagrees with its plain version at {tag}")
    return err


def hold_b2(tag: str, args, kern, plain) -> float:
    """B2's minima against its plain version's: i8 bit for bit, floats
    within FLOAT_RTOL/FLOAT_ATOL. Fails on a mismatch; returns the max abs
    error."""
    torch.cuda.synchronize()
    if args[1].dtype == torch.int8:
        ok = torch.equal(kern, plain)
    else:
        ok = torch.allclose(kern, plain, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    err = float((kern - plain).abs().max())
    log(f"  {tag}: B2 vs plain {'ok' if ok else 'MISMATCH'} (max abs err {err:.3g})")
    if not ok:
        fail(f"B2 disagrees with its plain version at {tag}")
    return err


def check_rescore(dev) -> None:
    """Phase 2, the exact rescore's dots (csrc/rescore.cu) at RESCORE_CHECK:
    random bins of the table with its last bin in every list and one list
    of a single bin repeated, at Q=512, 40 and 1; i8 rows from the
    quantizer (dots past 2**24 at W=1,152), bf16 and f32 unit rows, as the
    main paths store them."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    spec = RESCORE_CHECK
    for name, widths in spec["widths"].items():
        for w in widths:
            n, nq, b = spec["rows"][w], max(spec["qs"]), spec["b"]
            if name == "i8":
                table, q = make_rows(n, w, DTYPES[name], gen, dev), make_rows(nq, w, DTYPES[name], gen, dev)
            else:
                table, q = unit_rows(n, w, gen, dev).to(DTYPES[name]), unit_rows(nq, w, gen, dev).to(DTYPES[name])
            bins = torch.randint(0, n // 128, (nq, b), generator=gen, device=dev)
            bins[:, -1] = n // 128 - 1
            bins[0] = bins[0, 0]
            for m in spec["qs"]:
                args = (q[:m], table, bins[:m])
                hold_rescore(f"{name} N={n} W={w} Q={m} b={b}", args[0], scan.block_dots(*args),
                             scan.block_dots_plain(*args))


def hold_rescore(tag: str, q, kern, plain) -> float:
    """The rescore kernel's dots against its plain version's: i8 int32
    dots equal to the plain version's exact f32/f64 integers, bf16 and f32
    within FLOAT_RTOL/FLOAT_ATOL (f32 sums in another order). Fails on a
    mismatch; returns the max abs error."""
    torch.cuda.synchronize()
    if q.dtype == torch.int8:
        ok = kern.dtype == torch.int32 and torch.equal(kern.double(), plain.double())
        detail = "bit for bit"
    else:
        ok = kern.dtype == torch.float32 and torch.allclose(kern, plain.float(), rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        detail = f"within rtol {FLOAT_RTOL} atol {FLOAT_ATOL}"
    err = float((kern.double() - plain.double()).abs().max())
    log(f"  {tag}: the rescore's dots vs plain {'ok' if ok else 'MISMATCH'}, {detail} (max abs err {err:.3g})")
    if not ok:
        fail(f"the rescore kernel disagrees with its plain version at {tag}")
    return err


def probe_windows(gen, dev):
    """PROBE_CHECK's dense layout: window lengths and starts, the rows they
    cover, the padded window, the table rows (a 256 multiple past the
    body), and the deleted-row penalty (~10% deleted, the tail too)."""
    spec = PROBE_CHECK
    lens = torch.randint(spec["min_len"], spec["max_len"] + 1, (spec["windows"],), generator=gen, device=dev).int()
    starts = (torch.cumsum(lens, 0) - lens).int()
    body = int(lens.sum())
    w_pad = max(-(-int(lens.max()) // 128) * 128 + 128, 256)
    cap2 = -(-body // 256) * 256 + 256
    valid = torch.rand(cap2, generator=gen, device=dev) >= spec["deleted"]
    valid[body:] = False
    return lens, starts, body, w_pad, cap2, torch.where(valid, 0.0, MASKED)


def check_probe(dev) -> None:
    """Phase 2, kernel B3: a dense cluster-major table of windows of
    200-400 rows with planted ties (rows 5, 6 and 133 equal, row 7 zero),
    the pairs of random probes, every dtype and metric, with and without the
    penalty row (ip), 4 and k candidates per bin."""
    spec = PROBE_CHECK
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n_win, w, nprobe = spec["windows"], spec["w"], spec["nprobe"]
    lens, starts, body, w_pad, cap2, penalty = probe_windows(gen, dev)
    for name, dtype in DTYPES.items():
        table = make_rows(cap2, w, dtype, gen, dev)
        table[body:] = 0
        table[5] = table[6]
        table[133] = table[6]
        table[7] = 0
        q = make_rows(spec["q"], w, dtype, gen, dev)
        q[0] = table[6]
        t_sq = row_stats(table, ScalarKind(name))[:, 0].contiguous()
        for nq in (spec["q"], spec["ragged_q"]):
            probes = torch.argsort(torch.rand(nq, n_win, generator=gen, device=dev), dim=1)[:, :nprobe]
            q_g, qid_s, st_c, off, ln, _, _, _ = ivf._binned_pairs(q[:nq], probes, starts, lens, cap2, w_pad, nprobe)
            q_sq = (q[:nq].float() ** 2).sum(1)[qid_s].contiguous()
            shapes = [(10, 4), (10, 10)] + ([(128, 16)] if name == "i8" and nq == spec["q"] else [])
            for metric_name in METRICS:
                metric = normalize_metric(metric_name)
                t_m = None if metric == MetricKind.IP else t_sq
                for aux in ((True, False) if metric == MetricKind.IP else (True,)):
                    for k, bin_m in shapes:
                        args = (metric, q_g, q_sq, table, t_m, penalty if aux else None, (st_c + off).contiguous(),
                                ln, k, bin_m)
                        hold_probe(f"{name}/{metric_name}{'' if aux else ' no aux'} Q={nq} k={k} bin_m={bin_m}",
                                args, probe.grouped_probe(*args), probe.grouped_probe_plain(*args))
                if nq == spec["q"]:
                    for bin_m in (4, 8):
                        args = (metric, q_g, q_sq, table, t_m, penalty, st_c.contiguous(), (st_c + off).contiguous(),
                                ln, w_pad, bin_m)
                        hold_probe(f"{name}/{metric_name} Q={nq} w_pad={w_pad} bin_m={bin_m}", args,
                                probe.grouped_probe_nofold(*args), probe.grouped_probe_nofold_plain(*args), "B5")


def hold_probe(tag: str, args, kern, plain, name: str = "B3") -> float:
    """A probe kernel's results against its plain version's (B3's [P, k],
    B5's [P, out_pad], B6's [Q, k]; B8/B9's [Q, k] too): i8 and b1 bit for
    bit; bf16 distances within FLOAT_RTOL/FLOAT_ATOL, f32 within FLOAT_RTOL
    and `tf32_atol`, ids equal except where the distances at that place
    agree within it (near ties). ``args``: the kernel's, the queries second
    and the table next (flat scans) or after their norms (probes). Fails on
    a mismatch; returns the max abs error of the distances."""
    (kd, ki), (pd, pi) = kern, plain
    torch.cuda.synchronize()
    differ = ki != pi
    if args[1].dtype in (torch.int8, torch.uint8):
        ok, detail = torch.equal(kd, pd) and not bool(differ.any()), "bit for bit"
    else:
        atol = FLOAT_ATOL
        if args[1].dtype == torch.float32:
            atol = tf32_atol(args[0], args[1], args[2] if args[2].dim() == 2 else args[3])
        ok = torch.allclose(kd, pd, rtol=FLOAT_RTOL, atol=atol) and torch.allclose(
            kd[differ], pd[differ], rtol=FLOAT_RTOL, atol=atol)
        detail = f"distances within rtol {FLOAT_RTOL} atol {atol:.3g}, {int(differ.sum())} ids differ on near ties"
    err = float((kd - pd).abs().max())
    log(f"  {tag}: {name} vs plain {'ok' if ok else 'MISMATCH'}, {detail} ({int((ki >= 0).sum())} found, "
        f"max abs err {err:.3g})")
    if not ok:
        fail(f"{name} disagrees with its plain version at {tag}")
    return err


def edge_windows(n: int):
    """PROBE_EDGES' four cells of 128 pairs, (start, length) by pair: every
    lane its own window (starts mid-bin, lengths 1-300, the last ending at
    the table's last row); one window for the whole cell; lanes 0-59, 60-70
    (a segment across the two warpgroups) and 71-127; lanes 0-29 on a
    window across the 127/128 bin edge, 30-40 empty, 41-127 on a window
    ending at the table's last row."""
    own = [(29 * i + (i % 7) * 3, 1 + (i * 53) % 300) for i in range(127)] + [(n - 200, 200)]
    cells = [own, [(1000, 600)] * 128, [(5, 250)] * 60 + [(300, 700)] * 11 + [(2000, 129)] * 57,
             [(127, 130)] * 30 + [(0, 0)] * 11 + [(n - 300, 300)] * 87]
    return tuple(zip(*(w for cell in cells for w in cell)))


def check_probe_edges(dev) -> None:
    """Phase 2, B3/B5 at PROBE_EDGES: `edge_windows`' segment layouts over
    a table with rows 127/128 and 255/256 equal (a tie across each bin
    edge) and equal queries in lanes 63 and 64 of every cell (a tie across
    the warpgroups); i8 rows and queries in -5..5 (many exact ties, queries
    a third random, the rest table rows), bf16 and f32 rows and queries
    random normal (f32: W elements, so its rows stream their queries);
    every width, metric and dtype at k=10, 4 per bin (ip with and without
    the penalty row), B5 at 8 per bin, and at W=128 every k and bin_m of
    PROBE_EDGES on l2sq; packed b1 rows of bytes drawn from a few values
    (`few_bytes`, many equal hamming distances; queries drawn as the i8
    ones) with hamming at every width, k and bin_m, B5 at every b1 bin_m; i8
    and b1 bit for bit, bf16 and f32 within the float tolerances."""
    spec = PROBE_EDGES
    n, w_pad = spec["n"], spec["w_pad"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    st, ln = edge_windows(n)
    win_start = torch.tensor(st, dtype=torch.int32, device=dev)
    win_len = torch.tensor(ln, dtype=torch.int32, device=dev)
    win_base = torch.clamp(win_start // 128 * 128, max=n - w_pad).int()
    n_pairs = win_start.shape[0]
    valid = torch.rand(n, generator=gen, device=dev) >= spec["deleted"]
    penalty = torch.where(valid, 0.0, MASKED)
    count = 0
    for name in ("i8", "bf16", "b1", "f32"):
        for w in spec["widths"]:
            if name == "i8":
                table = torch.randint(-5, 6, (n, w), generator=gen, device=dev, dtype=torch.int8)
                q_g = table[torch.randint(0, n, (n_pairs,), generator=gen, device=dev)]
                q_g[::3] = torch.randint(-5, 6, (q_g[::3].shape[0], w), generator=gen, device=dev, dtype=torch.int8)
            elif name == "b1":
                table = few_bytes((n, w), gen, dev)
                q_g = table[torch.randint(0, n, (n_pairs,), generator=gen, device=dev)]
                q_g[::3] = few_bytes((q_g[::3].shape[0], w), gen, dev)
            else:
                table = torch.randn(n, w, generator=gen, device=dev).to(DTYPES[name])
                q_g = torch.randn(n_pairs, w, generator=gen, device=dev).to(DTYPES[name])
            table[128], table[256] = table[127], table[255]
            q_g[64::128] = q_g[63::128]
            q_g = q_g.contiguous()
            if name == "b1":
                t_sq = row_stats(table, ScalarKind.B1)[:, 0].contiguous()
                q_sq = row_stats(q_g, ScalarKind.B1)[:, 0].contiguous()
            else:
                t_sq = (table.float() ** 2).sum(1).contiguous()
                q_sq = (q_g.float() ** 2).sum(1).contiguous()
            for metric_name in (("hamming",) if name == "b1" else METRICS):
                metric = normalize_metric(metric_name)
                t_m = None if metric == MetricKind.IP else t_sq
                shapes = [(10, 4)]
                if name == "b1" or (w == spec["widths"][0] and metric_name == "l2sq"):
                    shapes = [(k, b) for k in spec["ks"] for b in spec["bin_ms"]]
                for aux in ((True, False) if metric == MetricKind.IP else (True,)):
                    for k, bin_m in shapes:
                        args = (metric, q_g, q_sq, table, t_m, penalty if aux else None, win_start, win_len, k, bin_m)
                        hold_probe(f"edges {name}/{metric_name}{'' if aux else ' no aux'} W={w} k={k} bin_m={bin_m}",
                                   args, probe.grouped_probe(*args), probe.grouped_probe_plain(*args))
                        count += 1
                nofold = spec["b1_nofold_bin_ms"] if name == "b1" else spec["nofold_bin_ms"]
                for bin_m in (nofold if name == "b1" or w == spec["widths"][0] else nofold[-1:]):
                    args = (metric, q_g, q_sq, table, t_m, penalty, win_base, win_start, win_len, w_pad, bin_m)
                    hold_probe(f"edges {name}/{metric_name} W={w} w_pad={w_pad} bin_m={bin_m}", args,
                               probe.grouped_probe_nofold(*args), probe.grouped_probe_nofold_plain(*args), "B5")
                    count += 1
    log(f"  PROBE_EDGES: {count} B3/B5 cases held")


def pair_windows(starts, lens, probes, cap2: int, w_pad: int):
    """B6's [Q, nprobe] int32 windows: 128-aligned DMA starts clamped so
    w_pad rows fit, the windows' offsets inside them, their lengths."""
    st, ln = starts[probes].int(), lens[probes].int()
    st_c = torch.clamp_max(st // 128 * 128, cap2 - w_pad)
    return st_c.contiguous(), (st - st_c).contiguous(), ln.contiguous()


def narrow_windows(starts, lens, cap2: int, w_pad: int, nq: int):
    """B6's windows on a narrow surface (two probes a query): windows 0 and
    1 probed by all but the last 12 queries, each of those 12 its own two
    windows; query 1 probes window 5 twice and query 2's second window lies
    past the table (it finds nothing)."""
    probes = torch.zeros((nq, 2), dtype=torch.long, device=starts.device)
    probes[:, 1] = 1
    probes[nq - 12 :] = torch.arange(2, 26, device=starts.device).view(12, 2)
    probes[1] = 5
    st_c, off, ln = pair_windows(starts, lens, probes, cap2, w_pad)
    st_c[2, 1] = cap2
    return st_c, off, ln


def check_pair(dev) -> None:
    """Phase 2, kernel B6: the windows of `check_probe` (planted ties, ~10%
    deleted rows), 512 and 40 queries of 8 random probes each, every dtype
    and metric and b1 hamming, with and without the penalty row, k 10 and
    128 at 4 and k candidates per bin; and on a narrow surface
    (`narrow_windows`: windows shared by many queries and windows probed by
    one, a window probed twice, one past the table) at k/bin_m (10, 16),
    (64, 32) and (128, 128), every dtype and metric with the penalty row
    (float queries there without the planted copy of row 6)."""
    spec = PROBE_CHECK
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n_win, w, nprobe = spec["windows"], spec["w"], spec["nprobe"]
    lens, starts, body, w_pad, cap2, penalty = probe_windows(gen, dev)
    sets = []
    for name, dtype in DTYPES.items():
        table = make_rows(cap2, w, dtype, gen, dev)
        table[body:] = 0
        table[5] = table[6]
        table[133] = table[6]
        q = make_rows(spec["q"], w, dtype, gen, dev)
        q[0] = table[6]
        sets.append((name, table, q, row_stats(table, ScalarKind(name))[:, 0].contiguous(),
                     (q.float() ** 2).sum(1).contiguous(), METRICS))
    table, q = bit_rows(cap2, body, spec["q"], gen, dev)
    sets.append(("b1", table, q, row_stats(table, ScalarKind.B1)[:, 0].contiguous(),
                 row_stats(q, ScalarKind.B1)[:, 0].contiguous(), ("hamming",)))
    count = 0
    for name, table, q, t_sq, q_sq, metrics in sets:
        for nq in (spec["q"], spec["ragged_q"]):
            probes = torch.argsort(torch.rand(nq, n_win, generator=gen, device=dev), dim=1)[:, :nprobe]
            windows = pair_windows(starts, lens, probes, cap2, w_pad)
            for metric_name in metrics:
                metric = normalize_metric(metric_name)
                for aux in (True, False):
                    for k, bin_m in ((10, 4), (10, 10), (128, 4), (128, 128)):
                        args = (metric, q[:nq].contiguous(), q_sq[:nq].contiguous(), table,
                                None if metric == MetricKind.IP else t_sq, penalty if aux else None, *windows, k,
                                w_pad, bin_m)
                        hold_probe(f"{name}/{metric_name}{'' if aux else ' no penalty'} Q={nq} k={k} bin_m={bin_m}",
                                   args, probe.pair_probe(*args), probe.pair_probe_plain(*args), "B6")
                        count += 1
        windows = narrow_windows(starts, lens, cap2, w_pad, spec["q"])
        if name in ("bf16", "f32"):
            # no planted copy among the float queries of windows 0 and 1: its
            # l2sq distance, ~0 from terms of ~2 W, cancels digits in any sum
            # order (PROBE_EDGES likewise)
            q = q.clone()
            q[0] = make_rows(1, w, q.dtype, gen, dev)[0]
            q_sq = (q.float() ** 2).sum(1).contiguous()
        for metric_name in metrics:
            metric = normalize_metric(metric_name)
            for k, bin_m in PAIR_NARROW:
                args = (metric, q, q_sq, table, None if metric == MetricKind.IP else t_sq, penalty, *windows, k,
                        w_pad, bin_m)
                hold_probe(f"{name}/{metric_name} narrow Q={spec['q']} k={k} bin_m={bin_m}", args,
                           probe.pair_probe(*args), probe.pair_probe_plain(*args), "B6")
                count += 1
    log(f"  B6: {count} cases held")


def planted_keys(n_rows: int, w: int, gen, dev):
    """i8 rows for B7 with planted equal dots: values in -2..2 (many ties
    inside a thread's rows and across the quad), rows 1, 3 and 64 copies of
    row 0; at w = 2,048 every row 127 but the last column and queries 127
    but a last 1, so the dots (above 2**24) differ by the last column alone
    and f32 rounds neighbours together (``fminarg`` ties what ``pack``
    orders)."""
    if w < 2048:
        table = torch.randint(-2, 3, (n_rows, w), generator=gen, device=dev, dtype=torch.int8)
        table[1], table[3], table[64] = table[0], table[0], table[0]
        return table, None
    table = torch.full((n_rows, w), 127, dtype=torch.int8, device=dev)
    table[:, -1] = torch.randint(-127, 128, (n_rows,), generator=gen, device=dev).to(torch.int8)
    q = torch.full((1, w), 127, dtype=torch.int8, device=dev)
    q[0, -1] = 1
    return table, q


def check_binned(dev) -> None:
    """Phase 2, kernel B7: the windows of `check_probe` over i8 rows (a
    duplicate of row 6 at rows 5 and 133), the pairs of 512 and 40 queries
    at nprobe 8, ``pack`` and ``fminarg`` at (bw, keep) (32, 4) and (8, 1);
    then every admitted (bw, keep, sel) (`BINNED_SELECTIONS`) at the pairs
    of 40 queries over rows of 128, 384 and 2,048 bytes with planted equal
    dots (`planted_keys`; at 2,048 bytes dots above 2**24); bit for bit."""
    spec = PROBE_CHECK
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    n_win, nprobe = spec["windows"], spec["nprobe"]
    lens, starts, body, w_pad, cap2, _ = probe_windows(gen, dev)
    table = make_rows(cap2, spec["w"], torch.int8, gen, dev)
    table[5] = table[6]
    table[133] = table[6]
    q = make_rows(spec["q"], spec["w"], torch.int8, gen, dev)
    q[0] = table[6]
    for nq in (spec["q"], spec["ragged_q"]):
        probes = torch.argsort(torch.rand(nq, n_win, generator=gen, device=dev), dim=1)[:, :nprobe]
        q_g, _, st_c, _, _, _, _, _ = ivf._binned_pairs(q[:nq], probes, starts, lens, cap2, w_pad, nprobe)
        for sel in ("pack", "fminarg"):
            for bw, keep in ((32, 4), (8, 1)):
                args = (q_g.contiguous(), table, st_c.contiguous(), w_pad, bw, keep, sel)
                hold_exact(f"i8 Q={nq} {sel} bw={bw} keep={keep}", "B7", probe.binned_probe(*args),
                           probe.binned_probe_plain(*args))
    nq = spec["ragged_q"]
    probes = torch.argsort(torch.rand(nq, n_win, generator=gen, device=dev), dim=1)[:, :nprobe]
    count = 0
    for w in BINNED_WIDTHS:
        table, q_top = planted_keys(cap2, w, gen, dev)
        q = table[torch.randint(0, cap2, (nq,), generator=gen, device=dev)] if q_top is None else q_top.expand(nq, w)
        q_g, _, st_c, _, _, _, _, _ = ivf._binned_pairs(q, probes, starts, lens, cap2, w_pad, nprobe)
        for sel, bw, keep in BINNED_SELECTIONS:
            args = (q_g.contiguous(), table, st_c.contiguous(), w_pad, bw, keep, sel)
            hold_exact(f"i8 W={w} Q={nq} {sel} bw={bw} keep={keep}", "B7", probe.binned_probe(*args),
                       probe.binned_probe_plain(*args))
            count += 1
    log(f"  B7: {count} planted cases held")


def check_flavours(dev) -> None:
    """Phase 2, kernels B8, B9 and B10 at CHECK's shape: ~10% deleted rows
    and a fully deleted 4,096-row stretch, zero rows and a zero query, every
    dtype and metric, 512 and 40 queries; the same on FUSED_CHECK's wide
    rows; then an i8 table with fewer live bins than k, whose tail must be
    (MASKED, -1)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    nq = CHECK["q"]
    lo, hi = FUSED_CHECK["stretch"]
    shapes = [(name, dtype, CHECK["n"], CHECK["w"]) for name, dtype in DTYPES.items()]
    shapes += [(name, DTYPES[name], FUSED_CHECK["wide_n"], w) for name, w in FUSED_CHECK["wide_w"].items()]
    for name, dtype, n, w in shapes:
        valid = torch.rand(n, generator=gen, device=dev) >= CHECK["deleted"]
        valid[lo:hi] = False
        table = make_rows(n, w, dtype, gen, dev)
        q = make_rows(nq, w, dtype, gen, dev)
        table[:3] = 0
        q[0] = 0
        stats = torch.stack([(table.float() ** 2).sum(1), table.float().sum(1)], 1)
        for metric_name in METRICS:
            metric = normalize_metric(metric_name)
            for qc in (q, q[: CHECK["ragged_q"]]):
                check_flavour_kernels(f"{name}/{metric_name} N={n} W={w} Q={qc.shape[0]}",
                                      (metric, qc, table, *scan.scan_aux(metric, qc, stats, valid)))
    n, w = CHECK["n"], CHECK["w"]
    table = make_rows(n, w, torch.int8, gen, dev)
    q = make_rows(nq, w, torch.int8, gen, dev)
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    for b in FUSED_CHECK["live_bins"]:
        live[b * 128 : (b + 1) * 128] = True
    stats = row_stats(table, ScalarKind.I8)
    args = (MetricKind.L2sq, q, table, *scan.scan_aux(MetricKind.L2sq, q, stats, live))
    n_live = len(FUSED_CHECK["live_bins"])
    plain = scan.fused_topk_plain(*args, 10)
    for tag, out in (("B8", scan.fused_topk(*args, 10)), ("B9", scan.fused_topk_stream(*args, 10))):
        d, i = out
        hold_probe(f"i8/l2sq Q={nq} {n_live} live bins k=10", args, out, plain, tag)
        if not (bool((i[:, :n_live] >= 0).all()) and bool((i[:, n_live:] == -1).all())
                and bool((d[:, n_live:] == MASKED).all())):
            fail(f"{tag} with {n_live} live bins: the slots past them are not (MASKED, -1)")
    check_fused_edges(dev)
    check_lanes_edges(dev)


def planted_table(name: str, n_bins: int, nq: int, gen, dev, w: int = FUSED_EDGES["w"]):
    """FUSED_EDGES' table of ``n_bins`` bins of width ``w`` and ``nq``
    queries: bin 1 holds the first 128 queries (bf16 and f32: with noise),
    and the bins of `copies` and the last bin copy it, rows and deleted rows
    alike (~10% deleted)."""
    spec, dtype = FUSED_EDGES, DTYPES[name]
    n = n_bins * 128
    t = make_rows(n, w, dtype, gen, dev)
    q = make_rows(nq, w, dtype, gen, dev)
    m = min(nq, 128)
    noise = 0.0 if name == "i8" else spec["noise"]
    t[128 : 128 + m] = (q[:m].float() + noise * torch.randn(m, w, generator=gen, device=dev)).to(dtype)
    valid = torch.rand(n, generator=gen, device=dev) >= CHECK["deleted"]
    for b in spec["copies"] + (n_bins - 1,):
        t[b * 128 : (b + 1) * 128] = t[128:256]
        valid[b * 128 : (b + 1) * 128] = valid[128:256]
    return t, q, valid


def hold_tie_order(tag: str, name: str, out) -> int:
    """Within every run of equal distances of B8's or B9's lists the ids
    increase: the earlier bin first. Fails otherwise; returns the count of
    equal neighbours."""
    d, i = out
    both = (d[:, 1:] == d[:, :-1]) & (i[:, 1:] >= 0) & (i[:, :-1] >= 0)
    if bool((both & (i[:, 1:] <= i[:, :-1])).any()):
        fail(f"{name} puts a later bin before an earlier one of equal distance at {tag}")
    return int(both.sum())


def check_fused_edges(dev) -> None:
    """Phase 2, B8/B9 at FUSED_EDGES: i8 and bf16 tables of `planted_table`
    (equal bin minima across a 256-row tile edge, an 8-bin merge-group edge
    and in a half last tile), ragged Q, k 1, 10 and 128, every metric; then
    an l2sq table with fewer live bins than k=10, whose tail must be
    (MASKED, -1) after the live bins in bin order. Held against the plain
    version (i8 bit for bit, bf16 within FLOAT_RTOL/FLOAT_ATOL, f32 within
    FLOAT_RTOL and `tf32_atol`), and ties to the earlier bin."""
    spec = FUSED_EDGES
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    ties = checks = 0
    for name in ("i8", "bf16", "f32"):
        for n_bins in spec["bins"]:
            for nq in spec["qs"]:
                t, q, valid = planted_table(name, n_bins, nq, gen, dev)
                stats = torch.stack([(t.float() ** 2).sum(1), t.float().sum(1)], 1)
                for metric_name in METRICS:
                    metric = normalize_metric(metric_name)
                    args = (metric, q, t, *scan.scan_aux(metric, q, stats, valid))
                    for k in spec["ks"]:
                        plain = scan.fused_topk_plain(*args, k)
                        for tag, fn in (("B8", scan.fused_topk), ("B9", scan.fused_topk_stream)):
                            label = f"edges {name}/{metric_name} bins={n_bins} Q={nq} k={k}"
                            out = fn(*args, k)
                            hold_probe(label, args, out, plain, tag)
                            ties += hold_tie_order(label, tag, out)
                            checks += 1
        t, q, _ = planted_table(name, 19, spec["qs"][0], gen, dev)
        live = torch.zeros(t.shape[0], dtype=torch.bool, device=dev)
        for b in spec["live_bins"]:
            live[b * 128 : (b + 1) * 128] = True
        stats = torch.stack([(t.float() ** 2).sum(1), t.float().sum(1)], 1)
        args = (MetricKind.L2sq, q, t, *scan.scan_aux(MetricKind.L2sq, q, stats, live))
        plain = scan.fused_topk_plain(*args, 10)
        n_live = len(spec["live_bins"])
        for tag, fn in (("B8", scan.fused_topk), ("B9", scan.fused_topk_stream)):
            d, i = out = fn(*args, 10)
            hold_probe(f"edges {name}/l2sq {n_live} live bins k=10", args, out, plain, tag)
            bins = torch.tensor(spec["live_bins"], device=dev).expand(q.shape[0], -1)
            if not (torch.equal(i[:, :n_live] // 128, bins) and bool((i[:, n_live:] == -1).all())
                    and bool((d[:, n_live:] == MASKED).all())):
                fail(f"{tag} with {n_live} live bins: not the live bins in order, then (MASKED, -1)")
            checks += 1
    log(f"  FUSED_EDGES: {checks} B8/B9 checks held, {ties} equal neighbours in bin order")
    if ties == 0:
        fail("FUSED_EDGES planted no equal bin minima")


def check_lanes_edges(dev) -> None:
    """Phase 2, B10 at LANES_EDGES: `planted_table`'s tables (equal bin
    minima across a 256-row tile edge, at merge-group edges and in a half
    last tile) in every dtype at FUSED_EDGES' bin and query counts, and
    planted rows too wide to stay in shared memory, every metric. i8 bit for
    bit against the plain version; bf16 within FLOAT_RTOL and FLOAT_ATOL
    plus TERMS_ATOL times the largest q_sq + t_sq (f32 sums in another
    order), f32 within FLOAT_RTOL and `tf32_atol` (the three-pass TF32
    product); i8 and bf16 bit for bit, rows included, against B1's surface
    transposed, which has the same product and epilogue (wgmma), f32 within
    `tf32_atol` of it (B1's f32 is the exact SIMT product). At an odd bin
    count, outputs one bin longer keep their sentinel past the last bin. The
    planted equal minima must be there."""
    spec = FUSED_EDGES
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    shapes = [(name, n_bins, nq, spec["w"]) for name in DTYPES for n_bins in spec["bins"] for nq in spec["qs"]]
    shapes += [(name, LANES_EDGES["wide_bins"], nq, w) for name, w in LANES_EDGES["wide_w"].items()
               for nq in spec["qs"]]
    checks = ties = 0
    for name, n_bins, nq, w in shapes:
        t, q, valid = planted_table(name, n_bins, nq, gen, dev, w)
        stats = torch.stack([(t.float() ** 2).sum(1), t.float().sum(1)], 1)
        for metric_name in METRICS:
            metric = normalize_metric(metric_name)
            args = (metric, q, t, *scan.scan_aux(metric, q, stats, valid))
            tag = f"lanes edges {name}/{metric_name} bins={n_bins} W={w} Q={nq}"
            kv, ki = scan.binned_scan_lanes(*args)
            pv, pi = scan.binned_scan_lanes_plain(*args)
            atol = FLOAT_ATOL
            if name == "bf16":
                atol += TERMS_ATOL * float((q.float() ** 2).sum(1).max() + stats[:, 0].max())
            elif name == "f32":
                atol = tf32_atol(metric, q, t)
            hold_b1(tag, args, False, (kv.T, ki.T), (pv.T, pi.T), "B10", atol)
            bv, bi = scan.binned_scan(*args)
            if name == "f32":
                hold_b1(tag, args, False, (kv.T, ki.T), (bv, bi), "B10 against B1's surface", atol)
            elif not (torch.equal(kv, bv.T) and torch.equal(ki, bi.T)):
                fail(f"B10 differs from B1's surface at {tag}")
            if n_bins % 2 and not lanes_guard_kept(args):
                fail(f"B10 stored past the last bin at {tag}")
            ties += int((kv[1] == kv[2]).sum())  # bins 1 | 2: a 256-row tile edge
            checks += 1
    log(f"  LANES_EDGES: {checks} B10 checks held, {ties} equal minima across a tile edge")
    if ties == 0:
        fail("LANES_EDGES planted no equal bin minima")


def lanes_guard_kept(args) -> bool:
    """B10 through its C entry point into outputs one bin longer, filled
    with a sentinel: the row past the last bin keeps it."""
    metric, q, table, q_sq, t_sq, penalty = args
    n_q, (n, w) = q.shape[0], table.shape
    out_v = torch.full((n // 128 + 1, n_q), 7.0, device=q.device)
    out_i = torch.full((n // 128 + 1, n_q), 7, dtype=torch.int32, device=q.device)
    ptr = scan._ptr
    scan._launch(build.load("fused").usearch_binned_scan_lanes, ptr(q), ptr(table), ptr(q_sq), ptr(t_sq),
                 ptr(penalty), ptr(out_v), ptr(out_i), n_q, n, w, scan._DTYPE_CODES[q.dtype],
                 scan._METRIC_CODES[metric], ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    return bool((out_v[-1] == 7.0).all()) and bool((out_i[-1] == 7).all())


def check_flavour_kernels(tag: str, args) -> None:
    """B8 and B9 at each k of FUSED_CHECK, and B10, against their plain
    versions; over f32 B8 and B9 also bit for bit against the top-k of
    B10's minima (one product and epilogue)."""
    (kv, ki), (pv, pi) = scan.binned_scan_lanes(*args), scan.binned_scan_lanes_plain(*args)
    f32 = args[1].dtype == torch.float32
    hold_b1(tag, args, False, (kv.T, ki.T), (pv.T, pi.T), "B10", tf32_atol(*args[:3]) if f32 else FLOAT_ATOL)
    for k in FUSED_CHECK["ks"]:
        plain = scan.fused_topk_plain(*args, k)
        for name, out in (("B8", scan.fused_topk(*args, k)), ("B9", scan.fused_topk_stream(*args, k))):
            hold_probe(f"{tag} k={k}", args, out, plain, name)
            if f32 and not all(torch.equal(a, b) for a, b in zip(out, scan.topk_of_minima(kv.T, ki.T, k))):
                fail(f"{name} over f32 differs from the top-k of B10's minima at {tag} k={k}")


def few_bytes(shape, gen, dev) -> torch.Tensor:
    """Packed b1 rows of random bytes each masked by one of a few values
    (many equal hamming distances)."""
    masks = torch.tensor([0x11, 0x81, 0xFF], dtype=torch.uint8, device=dev)
    rows = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
    return rows & masks[torch.randint(0, 3, shape, generator=gen, device=dev)]


def bit_rows(cap2: int, body: int, nq: int, gen, dev):
    """Packed 1024-bit rows of bytes drawn from a few values (many equal
    hamming distances), zero past ``body``, rows 5 and 133 equal to row 6;
    and ``nq`` queries drawn from the rows."""
    table = few_bytes((cap2, 128), gen, dev)
    table[body:] = 0
    table[5] = table[6]
    table[133] = table[6]
    return table, table[torch.randint(0, body, (nq,), generator=gen, device=dev)].clone()


def check_binary_probe(dev) -> None:
    """Phase 2, B3 over packed bits (B4) and B5: windows as in
    `check_probe`, 1024-bit rows of bytes drawn from a few values (many
    equal hamming distances), planted ties (rows 5, 6 and 133 equal), ~10%
    deleted rows; bit for bit against the plain versions."""
    spec = PROBE_CHECK
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n_win, nprobe = spec["windows"], spec["nprobe"]
    lens, starts, body, w_pad, cap2, penalty = probe_windows(gen, dev)
    table, q = bit_rows(cap2, body, spec["q"], gen, dev)
    pop_t = row_stats(table, ScalarKind.B1)[:, 0].contiguous()
    for nq in (spec["q"], spec["ragged_q"]):
        probes = torch.argsort(torch.rand(nq, n_win, generator=gen, device=dev), dim=1)[:, :nprobe]
        q_g, qid_s, st_c, off, ln, _, _, _ = ivf._binned_pairs(q[:nq], probes, starts, lens, cap2, w_pad, nprobe)
        q_sq = row_stats(q_g, ScalarKind.B1)[:, 0].contiguous()
        start = (st_c + off).contiguous()
        for k, bin_m in ((10, 4), (10, 10)):
            args = (MetricKind.Hamming, q_g, q_sq, table, pop_t, penalty, start, ln, k, bin_m)
            hold_exact(f"b1/hamming Q={nq} k={k} bin_m={bin_m}", "B3", probe.grouped_probe(*args),
                       probe.grouped_probe_plain(*args))
        for bin_m in (4, 8, 16):
            args = (MetricKind.Hamming, q_g, q_sq, table, pop_t, penalty, st_c.contiguous(), start, ln, w_pad, bin_m)
            hold_exact(f"b1/hamming Q={nq} w_pad={w_pad} bin_m={bin_m}", "B5", probe.grouped_probe_nofold(*args),
                       probe.grouped_probe_nofold_plain(*args))


def hold_bits(tag: str, name: str, kern, plain) -> bool:
    """Distances (as their f32 bits) and ids equal; fails on a mismatch
    with the first row that differs."""
    (kd, ki), (pd, pi) = kern, plain
    torch.cuda.synchronize()
    same = (kd.view(torch.int32) == pd.view(torch.int32)) & (ki == pi)
    if not bool(same.all()):
        r = int(torch.nonzero(~same.all(dim=1))[0, 0])
        fail(f"{name} disagrees with its plain version at {tag}, query {r}: {kd[r, :8].tolist()} "
             f"{ki[r, :8].tolist()} against {pd[r, :8].tolist()} {pi[r, :8].tolist()}")
    return True


def check_bitscan(dev) -> None:
    """Phase 2, the exact bit scan (csrc/bitscan.cu) against
    `bit_scan_plain` bit for bit at BITSCAN_CHECK: `few_bytes` tables
    (many equal distances) with equal rows planted across every 128-row
    tile's edge (a ring slot's), queries drawn from the rows before an edge
    (two rows at distance 0, a tie at the first place) and fresh ones, ~10%
    of the rows deleted and a table of 5 live rows (fewer than k), a ragged
    last tile, widths of 128 and 1,024 bytes, Q 1, 40 and 4,096 (one and
    several row splits), k 1, 10 and 128, each metric, with and without
    the bf16 rounding."""
    spec = BITSCAN_CHECK
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    n, nq_max = spec["n"], max(spec["qs"])
    for w in spec["widths"]:
        t0 = time.perf_counter()
        table = few_bytes((n, w), gen, dev)
        edges = torch.arange(128, n, 128, device=dev)
        table[edges] = table[edges - 1]
        valid = torch.rand(n, generator=gen, device=dev) >= spec["dead"]
        valid[edges] = valid[edges - 1] = True
        few = torch.zeros(n, dtype=torch.bool, device=dev)
        few[torch.randperm(n, generator=gen, device=dev)[: spec["live"]]] = True
        picks = edges[torch.randint(0, edges.numel(), (nq_max,), generator=gen, device=dev)] - 1
        queries = table[picks]
        queries[1::2] = few_bytes((nq_max // 2, w), gen, dev)
        t_pop = row_stats(table, ScalarKind.B1)[:, 0]
        cases = 0
        for nq in spec["qs"]:
            q = queries[:nq].contiguous()
            q_pop = row_stats(q, ScalarKind.B1)[:, 0]
            for k in spec["ks"]:
                for metric in BIT_METRICS:
                    for rnd in (False, True):
                        masks = ((valid, "10% deleted"),) + (((few, f"{spec['live']} live"),) if k > spec["live"]
                                                             else ())
                        for v, label in masks:
                            args = (MetricKind(metric), q, table, q_pop, t_pop, v, k, rnd)
                            tag = f"{metric} W={w} Q={nq} k={k} round={rnd} {label}"
                            hold_bits(tag, "bit_scan", bitscan.bit_scan(*args), bitscan.bit_scan_plain(*args))
                            cases += 1
            log(f"  bit_scan b1 W={w} Q={nq} ({bitscan.splits_for(dev, nq, n)[1]} row splits): every metric, k "
                f"{spec['ks']}, rounded and not, {spec['dead']:.0%} deleted and {spec['live']} live rows: "
                f"bit for bit with bit_scan_plain")
        log(f"  bit_scan W={w}: {cases} cases bit for bit in {time.perf_counter() - t0:.1f} s")


def hold_exact(tag: str, name: str, kern, plain) -> float:
    """Integer-valued results (hamming): distances and ids bit for bit.
    Fails on a mismatch; returns the max abs error (0)."""
    (kd, ki), (pd, pi) = kern, plain
    torch.cuda.synchronize()
    ok = torch.equal(kd, pd) and torch.equal(ki, pi)
    err = float((kd - pd).abs().max())
    log(f"  {tag}: {name} vs plain {'ok, bit for bit' if ok else 'MISMATCH'} "
        f"({int((ki >= 0).sum())} found, max abs err {err:.3g})")
    if not ok:
        fail(f"{name} disagrees with its plain version at {tag}")
    return err


def unit_rows(n: int, w: int, gen, dev) -> torch.Tensor:
    x = torch.randn(n, w, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def ground_truth(index, queries: torch.Tensor, k: int):
    """Plain exact top-k over the index's table: (distances, slots)."""
    q = index._cast_device(queries, ScalarKind.F32)
    q_stats = row_stats(q, index.dtype)
    best_d, best_i = [], []
    for lo in range(0, q.shape[0], 256):
        d = tile_dists(index.metric, index.dtype, q[lo : lo + 256], q_stats[lo : lo + 256],
                       index._table, index._stats, index.ndim)
        dd, ii = masked_topk(d, index._valid, k)
        best_d.append(dd)
        best_i.append(ii)
    return torch.cat(best_d).cpu().numpy(), torch.cat(best_i).cpu().numpy()


def same_apart_from_ties(index, matches, gt_d, gt_slots, tol: float) -> bool:
    """Keys equal to the ground truth's, except where distances tie."""
    gt_keys = index._slot_keys[np.clip(gt_slots, 0, None)]
    differs = matches.keys != gt_keys
    return bool(np.all(np.abs(matches.distances - gt_d)[differs] <= tol)) and bool(
        np.allclose(matches.distances, gt_d, rtol=1e-5, atol=tol)
    )


def drive(dev, spec, metric, dtype, gen, removed: float = 0.0) -> dict:
    """One index through add, approximate search, exact search, removal;
    the kernels' launch counters are zeroed just before and read just
    after, and both kernels must have launched."""
    n, w, nq, k, eq = spec["n"], spec["w"], spec["q"], spec["k"], spec["exact_q"]
    x = unit_rows(n, w, gen, dev)
    torch.cuda.synchronize()
    zero_counters()
    index = Index(ndim=w, metric=metric, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys = index.add(None, x)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    member = torch.randperm(n, generator=gen, device=dev)[:nq]
    index.search(x[member], k)  # warm
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m = index.search(x[member], k)
    search_s = time.perf_counter() - t0
    search_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    want = keys[member.cpu().numpy()]
    recall1 = float(np.mean(m.keys[:, 0] == want))
    log(f"  {dtype} {metric} {n} x {w}: capacity {index.capacity}, add {add_s:.3f} s, "
        f"search {nq} queries {search_s * 1e3:.1f} ms = {nq / search_s:.0f} QPS, recall@1 {recall1:.4f}, "
        f"search memory {search_gib:.2f} GiB above the index")
    if not np.all(np.isfinite(m.distances)) or m.keys.shape != (nq, k) or recall1 < 0.99:
        fail(f"approximate search at {dtype}/{metric}: recall@1 {recall1:.4f}")

    qx = x[member[:eq]]
    me = index.search(qx, k, exact=True)
    gt_d, gt_slots = ground_truth(index, qx, k)
    tol = 0.0 if dtype == "i8" else 1e-5
    if not same_apart_from_ties(index, me, gt_d, gt_slots, tol):
        fail(f"exact search at {dtype}/{metric} differs from the plain ground truth")
    log(f"  exact search of {eq} queries: keys equal to the plain ground truth apart from ties")

    gone = keys[:0]
    if removed:
        gone = keys[torch.randperm(n, generator=gen, device=dev)[: int(n * removed)].cpu().numpy()]
        index.remove(gone)
        probe = x[torch.as_tensor(gone[:eq].astype(np.int64), device=dev)]
        hits = np.isin(index.search(probe, k).keys, gone).sum()
        hits += np.isin(index.search(probe, k, exact=True).keys, gone).sum()
        if hits or len(index) != n - len(gone):
            fail(f"{hits} removed keys came back")
        log(f"  removed {len(gone)} keys: none comes back (approximate and exact)")
    launches = counters()
    log(f"  kernel launches on the {dtype} {metric} path: {launches}")
    if min(launches[k.__name__] for k in FLAT_KERNELS) == 0 or any(
            launches[name] for name in set(launches) - {k.__name__ for k in FLAT_KERNELS}):
        fail(f"the {dtype} {metric} path did not go through B1 and B2 alone: {launches}")
    return dict(index=index, queries=x[member], want=want, gone=gone, recall1=recall1, qps=nq / search_s,
                launches=launches)


def flavour_args(run, valid=None):
    """The flat-scan flavours' search arguments on ``run``'s index and
    member queries: (metric, queries, table, stats, valid), ``valid`` the
    index's unless given."""
    ix = run["index"]
    q = ix._cast_device(run["queries"], ScalarKind.F32)
    return ix.metric, q, ix._table, ix._stats, ix._valid if valid is None else valid


def f32_removal(run, gen):
    """The f32 cos table's valid rows with F32_REMOVED of them masked as
    removed (the index keeps them), and the keys of those rows."""
    ix = run["index"]
    n = len(ix)
    slots = torch.randperm(n, generator=gen, device=ix._valid.device)[: int(n * F32_REMOVED)]
    valid = ix._valid.clone()
    valid[slots] = False
    return valid, ix._slot_keys[slots.cpu().numpy()]


def drive_flavours(run, valid=None, gone=None) -> dict:
    """Phase 3, the flat-scan flavours on the index of ``run`` after its
    removal (the i8 index), or with ``valid`` masking the ``gone`` keys (the
    f32 cos table), on its member queries: recall@1 over the members still
    live, distances equal bit for bit to `search_binned`'s (B1) and ids
    equal apart from ties; over f32 (the three-pass TF32 product against
    B1's exact SIMT one) distances within FLOAT_RTOL and `tf32_atol` of
    B1's, ids equal apart from near ties, and bit for bit equal among the
    three flavours; the launch counters are zeroed just before each
    flavour's search (after a warm one) and read just after: its own kernel
    once, no other."""
    ix, k = run["index"], MAIN["k"]
    args = flavour_args(run, valid)
    q8 = args[1]
    f32 = ix._table.dtype == torch.float32
    atol = tf32_atol(ix.metric, q8, ix._table) if f32 else 0.0
    ref_d, ref_i = scan.search_binned(*args, k)
    live = ~np.isin(run["want"], run["gone"] if gone is None else gone)
    out, first_d = {}, None
    for name, (search, kern, _, _) in FLAVOURS.items():
        search(*args, k)  # warm
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        d, i = search(*args, k)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        launches = counters()
        top = ix._slot_keys[np.clip(i[:, 0].cpu().numpy(), 0, None)]
        recall1 = float(np.mean(top[live] == run["want"][live]))
        differ = i != ref_i
        if f32:
            same_d = torch.allclose(d, ref_d, rtol=FLOAT_RTOL, atol=atol) and torch.allclose(
                d[differ], ref_d[differ], rtol=FLOAT_RTOL, atol=atol)
            same_d = same_d and (first_d is None or torch.equal(d, first_d))
            first_d = d if first_d is None else first_d
            same = f"within rtol {FLOAT_RTOL} atol {atol:.3g} of B1's search and equal among the flavours"
        else:
            same_d, same = torch.equal(d, ref_d), "equal to B1's search"
        log(f"  {name}: {q8.shape[0]} queries {search_s * 1e3:.1f} ms = {q8.shape[0] / search_s:.0f} QPS, recall@1 "
            f"{recall1:.4f} over {int(live.sum())} live members; distances {same if same_d else 'NOT ' + same}, "
            f"{int(differ.sum())} ids differ on ties; launches {launches}")
        if not bool(torch.isfinite(d).all()) or d.shape != (q8.shape[0], k) or recall1 < 0.99 or not same_d:
            fail(f"the {name} search: recall@1 {recall1:.4f}, distances {same}: {same_d}")
        check_launches(f"{name} flat", launches, kern.__name__)
        if launches[kern.__name__] != 1:
            fail(f"the {name} search launched {kern.__name__} {launches[kern.__name__]} times")
        out[name] = dict(recall1=recall1, qps=q8.shape[0] / search_s, launches=launches[kern.__name__])
    return out


def zero_counters() -> None:
    for kern in ALL_KERNELS:
        kern.launches = 0


def counters() -> dict:
    return {kern.__name__: kern.launches for kern in ALL_KERNELS}


def search_timed(index, queries, k: int):
    """One search, synchronised: the matches and the seconds it took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = index.search(queries, k)
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def recall_at(m, want_keys, gt_keys, k: int):
    """recall@1 of member queries finding themselves, and recall@k of the
    first ``len(gt_keys)`` rows against the exact answer."""
    r1 = float(np.mean(m.keys[:, 0] == want_keys))
    rk = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(m.keys[: len(gt_keys)].tolist(), gt_keys.tolist())]))
    return r1, rk


def check_launches(label: str, launches: dict, kern: str) -> None:
    """``kern`` launched on the path, and no other kernel of ALL_KERNELS
    did: neither the flat kernels nor another probe kernel."""
    if launches[kern] == 0 or any(launches[name] for name in set(launches) - {kern}):
        fail(f"the {label} searches did not go through {kern} alone: {launches}")


def searches_agree(got, want, atol: float) -> bool:
    """Two searches' matches: distances within FLOAT_RTOL and ``atol``, and
    keys equal except where the distances at that place agree within it
    (near ties)."""
    close = np.abs(got.distances - want.distances) <= atol + FLOAT_RTOL * np.abs(want.distances)
    return bool(close.all()) and bool(np.all(close[got.keys != want.keys]))


def drive_mode(index, mode: str, spec, x, member, want, gt_keys, gen, dev, atol=None) -> dict:
    """Phase 3, one probe flavour on the built IVF: warm on another batch,
    the member queries (recall@1 >= 0.99, recall@10 printed, QPS), the same
    search through the flavour's plain kernel (keys and distances equal; an
    f32 index within ``atol``, `searches_agree`), the launch counters zeroed
    just before and read just after."""
    kern = MODES[mode]
    nq, k = spec["q"], spec["k"]
    zero_counters()
    ivf.PROBE_MODE = mode
    index.search(x[torch.randperm(x.shape[0], generator=gen, device=dev)[:nq]], k)  # warm, on another batch
    m, search_s = search_timed(index, x[member], k)
    recall1, recall10 = recall_at(m, want, gt_keys, k)
    log(f"  {mode}: IVF search of {nq} member queries {search_s * 1e3:.1f} ms = {nq / search_s:.0f} QPS, "
        f"recall@1 {recall1:.4f}, recall@10 {recall10:.4f}")
    if not np.all(np.isfinite(m.distances)) or m.keys.shape != (nq, k) or recall1 < 0.99:
        fail(f"IVF search in {mode} mode: recall@1 {recall1:.4f}")
    launches = counters()
    t0 = time.perf_counter()
    mp, args = plain_probe_search(index, x[member], k, kern)
    plain_s = time.perf_counter() - t0
    differ = mp.keys != m.keys
    if atol is None:
        ok, same = np.array_equal(mp.distances, m.distances) and not differ.any(), "keys and distances equal"
    else:
        ok, same = searches_agree(m, mp, atol), f"within atol {atol:.3g}, {int(differ.sum())} keys differ on near ties"
    if not ok:
        fail(f"the plain {kern}'s search differs from the kernel's in {mode} mode at {int(differ.sum())} places")
    log(f"  {mode}: the same search through {kern}'s plain version ({plain_s:.2f} s): {same}")
    check_launches(f"{mode}-mode IVF", launches, kern)
    log(f"  {mode}: kernel launches: {launches}")
    ivf.PROBE_MODE = "group"
    return dict(recall1=recall1, recall10=recall10, qps=nq / search_s, plain_s=plain_s, launches=launches,
                probe_args=args, kern=kern)


def mode_after_updates(index, mode: str, new, new_keys, probe_q, gone, k: int) -> dict:
    """Phase 3, one flavour after the fresh adds and the removal: every
    fresh row found among its own results, no removed key returned; the
    launch counters zeroed just before and read just after."""
    zero_counters()
    ivf.PROBE_MODE = mode
    mf = index.search(new, k)
    hits = int(np.isin(index.search(probe_q, k).keys, gone).sum())
    ivf.PROBE_MODE = "group"
    launches = counters()
    found = float(np.mean([key in row for key, row in zip(new_keys.tolist(), mf.keys.tolist())]))
    log(f"  {mode}: {found:.4f} of the fresh rows found as members, {hits} removed keys returned; "
        f"launches {launches}")
    if found < 1.0 or hits:
        fail(f"{mode} mode after the updates: fresh rows found {found:.4f}, {hits} removed keys came back")
    check_launches(f"{mode}-mode IVF", launches, MODES[mode])
    return launches


def drive_ivf(dev) -> dict:
    """Phase 3, the IVF path: build, search, recall, the plain probe, then
    the same in each probe flavour of MODES, fresh adds, removals (and each
    flavour once more after them); B3 must launch in the default flavour
    and the flat kernels never."""
    spec = IVF
    n, w, nq, k = spec["n"], spec["w"], spec["q"], spec["k"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = unit_rows(n, w, gen, dev)
    torch.cuda.synchronize()
    zero_counters()
    index = Index(ndim=w, metric="ip", dtype="i8", device=dev)
    keys = index.add(None, x)
    split = timed_flat_build(index, n_partitions=spec["partitions"], reorder=True, spill=spec["spill"])
    build_s = split["total"]
    index.expansion_search = spec["expansion"]
    iv = index._ivf
    nprobe = iv.nprobe_for(index.expansion_search, index.connectivity)
    log(f"  i8 ip IVF {n} x {w}: optimize({spec['partitions']} partitions, reorder, spill {spec['spill']}) "
        f"{build_s:.2f} s: {flat_split_text(split)}; {iv._shape()[0]} chunks, longest {iv.p_win} rows, "
        f"{iv.shadow_np_pos.size} shadow rows, capacity {index.capacity}")
    member = torch.randperm(n, generator=gen, device=dev)[:nq]
    index.search(x[torch.randperm(n, generator=gen, device=dev)[:nq]], k)  # warm, on another batch
    m, search_s = search_timed(index, x[member], k)
    want = keys[member.cpu().numpy()]
    gq = spec["gt_q"]
    _, gt_slots = ground_truth(index, x[member[:gq]], k)
    gt_keys = index._slot_keys[np.clip(gt_slots, 0, None)]
    recall1, recall10 = recall_at(m, want, gt_keys, k)
    log(f"  IVF search of {nq} member queries, k={k}, nprobe {nprobe}: {search_s * 1e3:.1f} ms = "
        f"{nq / search_s:.0f} QPS, recall@1 {recall1:.4f}, recall@10 against the exact answer ({gq} queries) "
        f"{recall10:.4f}")
    if not np.all(np.isfinite(m.distances)) or m.keys.shape != (nq, k) or recall1 < 0.99:
        fail(f"IVF search: recall@1 {recall1:.4f}")

    mp, args = plain_probe_search(index, x[member], k, "grouped_probe")
    differ = mp.keys != m.keys
    if not np.array_equal(mp.distances, m.distances) or differ.any():
        fail(f"the plain probe's search differs from the kernel's at {int(differ.sum())} places")
    log(f"  the same search through B3's plain version: keys and distances equal "
        f"({args[1].shape[0]} padded pairs, k {args[8]}, {args[9]} per bin)")
    launches = counters()

    modes = {mode: drive_mode(index, mode, spec, x, member, want, gt_keys, gen, dev) for mode in MODES}
    again = index.search(x[member], k)
    if not (np.array_equal(again.keys, m.keys) and np.array_equal(again.distances, m.distances)):
        fail("the grouped search changed after the other flavours ran")
    log("  back in the group flavour: the same keys and distances as before")

    zero_counters()
    new = unit_rows(spec["fresh"], w, gen, dev)
    new_keys = index.add(None, new)
    if index._ivf_dirty or iv.fresh_np.size != spec["fresh"]:
        fail("rows added after optimize did not join the fresh list")
    mf = index.search(new, k)
    found = float(np.mean([key in row for key, row in zip(new_keys.tolist(), mf.keys.tolist())]))
    log(f"  {spec['fresh']} rows added after the build: {found:.4f} found as members, "
        f"recall@1 {np.mean(mf.keys[:, 0] == new_keys):.4f}")
    if found < 1.0:
        fail(f"fresh rows not found: {found:.4f}")

    gone = keys[torch.randperm(n, generator=gen, device=dev)[: int(n * spec["removed"])].cpu().numpy()]
    index.remove(gone)
    probe_q = x[torch.as_tensor(gone[:nq].astype(np.int64), device=dev)]
    hits = int(np.isin(index.search(probe_q, k).keys, gone).sum())
    if hits or len(index) != n + spec["fresh"] - len(gone):
        fail(f"{hits} removed keys came back from the IVF")
    log(f"  removed {len(gone)} keys: none comes back")
    launches = {name: count + launches[name] for name, count in counters().items()}
    log(f"  kernel launches on the IVF path (group flavour): {launches}")
    check_launches("IVF", launches, "grouped_probe")
    for mode in MODES:
        after = mode_after_updates(index, mode, new, new_keys, probe_q, gone, k)
        modes[mode]["launches"] = {name: count + modes[mode]["launches"][name] for name, count in after.items()}
    return dict(index=index, queries=x[member], recall1=recall1, recall10=recall10, qps=nq / search_s,
                nprobe=nprobe, build_s=build_s, build_split=split, launches=launches, probe_args=args, modes=modes,
                want=want, gone=gone, new=new, new_keys=new_keys, probe_q=probe_q)


def drive_f32_ivf(dev) -> dict:
    """Phase 3, the f32 IVF path: an f32 cos index of the IVF path's 1M
    unit rows (the same seed), `optimize(n_partitions=1024, reorder=True,
    spill=0.05)`, `expansion_search = 1024`, 16,384 member queries at k=10
    (recall@1 >= 0.99, recall@10 against the exact answer printed), the same
    search through the plain probe (keys equal apart from near ties,
    distances within `tf32_atol`), then the flavours of F32_IVF each against
    its plain version; B3 (its f32 instantiations) must launch in the
    default flavour and no flat kernel."""
    spec = IVF
    n, w, nq, k = spec["n"], spec["w"], spec["q"], spec["k"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = unit_rows(n, w, gen, dev)
    torch.cuda.synchronize()
    zero_counters()
    index = Index(ndim=w, metric=F32_IVF["metric"], dtype="f32", device=dev)
    keys = index.add(None, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.optimize(n_partitions=spec["partitions"], reorder=True, spill=spec["spill"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index.expansion_search = spec["expansion"]
    iv = index._ivf
    nprobe = iv.nprobe_for(index.expansion_search, index.connectivity)
    log(f"  f32 cos IVF {n} x {w}: optimize({spec['partitions']} partitions, reorder, spill {spec['spill']}) "
        f"{build_s:.2f} s: {iv._shape()[0]} chunks, longest {iv.p_win} rows, capacity {index.capacity}")
    member = torch.randperm(n, generator=gen, device=dev)[:nq]
    index.search(x[torch.randperm(n, generator=gen, device=dev)[:nq]], k)  # warm, on another batch
    m, search_s = search_timed(index, x[member], k)
    want = keys[member.cpu().numpy()]
    gq = spec["gt_q"]
    _, gt_slots = ground_truth(index, x[member[:gq]], k)
    gt_keys = index._slot_keys[np.clip(gt_slots, 0, None)]
    recall1, recall10 = recall_at(m, want, gt_keys, k)
    log(f"  f32 IVF search of {nq} member queries, k={k}, nprobe {nprobe}: {search_s * 1e3:.1f} ms = "
        f"{nq / search_s:.0f} QPS, recall@1 {recall1:.4f}, recall@10 against the exact answer ({gq} queries) "
        f"{recall10:.4f}")
    if not np.all(np.isfinite(m.distances)) or m.keys.shape != (nq, k) or recall1 < 0.99:
        fail(f"f32 IVF search: recall@1 {recall1:.4f}")
    mp, args = plain_probe_search(index, x[member], k, "grouped_probe")
    atol = tf32_atol(index.metric, args[1], args[3])
    if not searches_agree(m, mp, atol):
        fail("the plain probe's f32 search differs from the kernel's beyond the tolerance")
    log(f"  the same search through B3's plain version: within atol {atol:.3g}, {int((mp.keys != m.keys).sum())} "
        f"keys differ on near ties ({args[1].shape[0]} padded pairs, k {args[8]}, {args[9]} per bin)")
    launches = counters()
    log(f"  kernel launches on the f32 IVF path (group flavour): {launches}")
    check_launches("f32 IVF", launches, "grouped_probe")
    modes = {mode: drive_mode(index, mode, spec, x, member, want, gt_keys, gen, dev, atol)
             for mode in F32_IVF["modes"]}
    return dict(index=index, queries=x[member], recall1=recall1, recall10=recall10, qps=nq / search_s,
                nprobe=nprobe, build_s=build_s, launches=launches, probe_args=args, modes=modes)


class CallTimer:
    """Within a with-block, ``owner.name`` is wrapped to count its calls,
    time each (the device synchronised before and after it, unless not
    ``sync``: then the host's time alone) and keep its results; a
    staticmethod or a class's function is put back as it was."""

    def __init__(self, owner, name: str, sync: bool = True):
        self.owner, self.name, self.calls, self.seconds, self.results = owner, name, 0, [], []
        self.sync = sync
        self.saved = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
        self.fn = getattr(owner, name)

    def __enter__(self):
        def timed(*args, **kwargs):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                self.results.append(self.fn(*args, **kwargs))
                return self.results[-1]
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                self.calls += 1
                self.seconds.append(time.perf_counter() - t0)

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)

    @property
    def total(self) -> float:
        return sum(self.seconds)


def timed_host_add(index, rows: np.ndarray):
    """`add` of host rows with its parts timed: the host cast
    (`exact.prepare_rows`), the key map's inserts and lookups, and the rest
    (upload, scatter, stats, the duplicate check). Fails unless the native
    key map and the native i8 cast ran."""
    with CallTimer(index_module, "prepare_rows") as cast_t, \
            CallTimer(keymap_native.NativeKeyMap, "insert_many") as km_insert, \
            CallTimer(keymap_native.NativeKeyMap, "contains_many") as km_lookup, \
            CallTimer(casts_native, "cast_f32_to_i8") as native_cast:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keys = index.add(None, rows)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    if not (keymap.NATIVE and casts.NATIVE and isinstance(index._keymap, keymap_native.NativeKeyMap)
            and native_cast.calls and km_insert.calls):
        fail(f"the host add did not take the native routes: key map {type(index._keymap).__name__}, "
             f"{native_cast.calls} native casts, {km_insert.calls} native inserts")
    km_s = km_insert.total + km_lookup.total
    return keys, dict(total=total, cast=cast_t.total, native_cast=native_cast.total, keymap=km_s,
                      rest=total - cast_t.total - km_s, native_casts=native_cast.calls)


def timed_build(index, **kwargs) -> dict:
    """`optimize` with the two-level fit's stages timed: level 1 (the coarse
    fit, `kmeans._fit`), the coarse assignment, level 2 (the sub-fits,
    `_sub_fits`, its `_sub_fit` calls counted, not timed apart), the flat pass, the rest of the
    quantizer (the gather of live rows, the chunks) and the layout (the
    table's permutation after the quantizer)."""
    with CallTimer(kmeans, "_fit") as fits, CallTimer(kmeans, "_coarse_assign") as coarse, \
            CallTimer(kmeans, "_sub_fits") as level2, CallTimer(kmeans, "_sub_fit", sync=False) as sub_fits, \
            CallTimer(kmeans, "_flat_pass") as flat, CallTimer(ivf.IVFPartitions, "_quantize") as quantize:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.optimize(**kwargs)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    if fits.calls != 1 or coarse.calls != 1 or level2.calls != 1 or flat.calls != 1:
        fail(f"optimize({kwargs}) did not take the two-level fit: {fits.calls} coarse fits, {coarse.calls} coarse "
             f"assignments, {level2.calls} levels 2, {flat.calls} flat passes")
    level1 = fits.total
    return dict(total=total, level1=level1, coarse=coarse.total, level2=level2.total, sub_fits=sub_fits.calls,
                flat=flat.total, quantize_rest=quantize.total - level1 - coarse.total - level2.total - flat.total,
                layout=total - quantize.total)


def timed_flat_build(index, **kwargs) -> dict:
    """`optimize` with the flat fit's stages timed: the k-means++ seeding,
    the Lloyd iterations (`kmeans._lloyd_loop`, less its final assignment)
    and how many, the final assignment (`_final_step`), the fit's set-up,
    the spill sweep (`assign_flat`'s top-2), the quantizer's rest and the
    layout."""
    with CallTimer(ivf, "kmeans_fit") as fit, CallTimer(kmeans, "_kmeanspp_init") as seeding, \
            CallTimer(kmeans, "_lloyd_loop") as loop, CallTimer(kmeans, "_final_step") as final, \
            CallTimer(ivf, "assign_flat") as sweep, CallTimer(ivf.IVFPartitions, "_quantize") as quantize:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.optimize(**kwargs)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    if fit.calls != 1 or loop.calls != 1:
        fail(f"optimize({kwargs}) did not take the flat fit: {fit.calls} fits, {loop.calls} Lloyd loops")
    return dict(total=total, seeding=seeding.total, lloyd=loop.total - final.total, iterations=loop.results[0][-1],
                final=final.total, fit_rest=fit.total - seeding.total - loop.total, sweep=sweep.total,
                quantize_rest=quantize.total - fit.total - sweep.total, layout=total - quantize.total)


def flat_split_text(split: dict) -> str:
    return (f"seeding {split['seeding']:.3f} s, {split['iterations']} Lloyd iterations {split['lloyd']:.3f} s, "
            f"final assignment {split['final']:.3f} s, the fit's set-up {split['fit_rest']:.3f} s, spill sweep "
            f"{split['sweep']:.3f} s, the quantizer's rest {split['quantize_rest']:.3f} s, layout "
            f"{split['layout']:.3f} s")


def same_search(got, want) -> bool:
    return np.array_equal(got.keys, want.keys) and np.array_equal(got.distances, want.distances)


def eager_body(index, queries, k: int, exact: bool = False):
    """The body ``index.search(queries, k, exact=exact)`` captures on the
    card (graphs.py), called directly, each op launched from Python:
    ``[Q, k]`` distances and slots of the padded queries."""
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.ascontiguousarray(queries))
    q = index._cast_device(*index._device_rows(queries))
    approx, use_ivf = index._route(exact)
    _, body, _ = index._search_plan(pad_queries(q.shape[0]), min(k, len(index)), index._valid, approx, use_ivf)
    return body(index._padded_queries(q), index._valid)


def eager_search(index, queries, k: int, exact: bool = False):
    """`eager_body`'s result as ``index.search`` gives it."""
    n = queries.shape[0]
    d, slots = eager_body(index, queries, k, exact)
    return index._finish_search(d[:n].cpu().numpy(), slots[:n].cpu().numpy(), n, False, math.inf, 0, None)


def sharded_eager_prepared(pool, q, k: int, exact: bool = False, expansion: int = 64, merge: bool = True):
    """The shards' searches ``pool.search`` captures, run eagerly on the
    prepared queries ``q`` (`sharded.eager_candidates`), then the merge:
    ``[Q, k]`` distances and global rows (``merge=False``: each shard's
    candidates)."""
    k = min(k, max(len(pool), 1), pool._per)
    plans = pool._shard_plans(q.shape[0], k, exact, expansion)
    cands = sharded.eager_candidates(plans, sharded._replicate(q, pool.mesh.devices))
    return sharded.merge_candidates(cands, k, pool.mesh) if merge else cands


def sharded_eager_search(pool, queries, k: int, exact: bool = False, expansion: int = 64):
    """`sharded_eager_prepared`'s result as ``pool.search`` gives it."""
    q, n = pool._queries(queries)
    d, i = sharded_eager_prepared(pool, q, k, exact, expansion)
    d, i = d[:n].cpu().numpy(), i[:n].cpu().numpy()
    found = i >= 0
    return BatchMatches(keys=np.where(found, pool._keys[np.clip(i, 0, None)], 0).astype(np.uint64), distances=d,
                        counts=found.sum(axis=1).astype(np.uint64))


def searched_through_b3(label: str, index, queries, k: int):
    """One search with the launch counters zeroed just before and read just
    after: B3 and no other kernel must launch."""
    zero_counters()
    m = index.search(queries, k)
    check_launches(label, counters(), "grouped_probe")
    return m


def restored(label: str, load, want, queries, k: int, card: str):
    """Phase 3 (c): an index brought back by ``load``: its IVF restored
    (not dirty), no k-means fit run, and its search through B3 equal to
    ``want`` bit for bit."""
    with CallTimer(kmeans, "kmeans_fit") as fits, CallTimer(ivf, "kmeans_fit") as flat_fits, \
            CallTimer(ivf, "kmeans_hierarchical") as hier_fits:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = load()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        m = searched_through_b3(f"{label} IVF", index, queries, k)
    refits = fits.calls + flat_fits.calls + hier_fits.calls
    if index._ivf is None or index._ivf_dirty or refits:
        fail(f"{label}: the IVF did not come back with the index ({refits} k-means fits)")
    if not same_search(m, want):
        fail(f"{label}: the search differs from the saved index's at {int((m.keys != want.keys).sum())} places")
    log(f"  {label}: loaded in {load_s:.2f} s, its IVF restored with no k-means fit, the {queries.shape[0]} "
        f"queries' keys and distances through B3 equal bit for bit to the saved index's ({card})")
    return index, load_s


def compacted_as_saved(saved, loaded) -> str:
    """Phase 3 (c): ``loaded``, restored from a save of ``saved`` (which
    had removals and fresh rows), holds ``saved``'s live keys and rows in
    slot order, its centroids, and its chunk starts, lens and fresh slots
    moved to the live rows' ranks (counted here with a binary search over
    the live slots). Fails otherwise; returns what was held."""
    live = saved._live_slots()
    if not np.array_equal(loaded._live_keys(), saved._live_keys()):
        fail("the restored index's live keys differ from the saved index's")
    if not np.array_equal(persist._logical_rows_np(loaded), persist._logical_rows_np(saved)):
        fail("the restored index's live rows differ from the saved index's")
    si, li = saved._ivf, loaded._ivf
    starts, lens = si.starts.cpu().numpy().astype(np.int64), si.lens.cpu().numpy().astype(np.int64)
    want_starts = np.searchsorted(live, starts)
    want_lens = np.searchsorted(live, starts + lens) - want_starts
    fresh = np.asarray(si.fresh_np, dtype=np.int64)
    want_fresh = np.searchsorted(live, fresh)
    if not np.array_equal(live[want_fresh], fresh):
        fail("a fresh row of the saved index is not live")
    same = dict(centroids=torch.equal(li.centroids.cpu(), si.centroids.cpu()), p_win=li.p_win == si.p_win,
                starts=np.array_equal(li.starts.cpu().numpy(), want_starts),
                lens=np.array_equal(li.lens.cpu().numpy(), want_lens),
                fresh=np.array_equal(np.asarray(li.fresh_np), want_fresh))
    if not all(same.values()):
        fail(f"the restored IVF is not the saved one compacted: {same}")
    return (f"{len(live)} live keys and rows in slot order equal to the saved index's, centroids, p_win, "
            f"{starts.size} chunk starts and lens and {fresh.size} fresh slots equal to the saved ones moved to "
            f"the live rows' ranks ({len(starts) - int(np.sum(want_starts == starts))} starts moved)")


def drive_lifecycle(dev, ivf_run: dict, card: str) -> dict:
    """Phase 3, the index lifecycle at bench.py's width (LIFECYCLE): (a)
    host f32 rows added to an i8 ip index, the add's host cast, key map and
    the rest timed, through the native routes; (b) `optimize(8192,
    reorder=True)` past the flat fit's 4,096 partitions, its stages timed,
    searched (recall@1, recall@10, B3 alone, equal to B3's plain version);
    (c) saved, and restored three ways (file, view, buffer), each with its
    IVF and no fit, searching bit for bit as the saved index does; then 1%
    of the keys removed and 4,096 rows added on a restored index, saved and
    restored again; (d) the spilled IVF path's index through a save and
    restore (its shadows stay behind); the files deleted."""
    spec = LIFECYCLE
    n, w, nq, k = spec["n"], spec["w"], spec["q"], spec["k"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    x = unit_rows(n, w, gen, dev)
    host = x.cpu().numpy()
    index = Index(ndim=w, metric="ip", dtype="i8", device=dev)
    keys, add = timed_host_add(index, host)
    log(f"  (a) add of {n} host f32 rows x {w} to an i8 index: host cast {add['cast']:.3f} s, of it "
        f"{add['native_cast']:.3f} s in {add['native_casts']} native cast calls (the libraries built in phase 1), key map {add['keymap']:.3f} s, upload, scatter and the rest "
        f"{add['rest']:.3f} s; total {add['total']:.3f} s = {n / add['total']:.0f} rows/s ({card})")

    build_split = timed_build(index, n_partitions=spec["partitions"], reorder=True, spill=0.0)
    index.expansion_search = spec["expansion"]
    iv = index._ivf
    nprobe = iv.nprobe_for(index.expansion_search, index.connectivity)
    log(f"  (b) optimize({spec['partitions']} partitions, reorder) {build_split['total']:.2f} s: level 1 "
        f"{build_split['level1']:.2f} s, coarse assignment {build_split['coarse']:.2f} s, level 2 "
        f"{build_split['level2']:.2f} s ({build_split['sub_fits']} sub-fits), flat pass {build_split['flat']:.2f} s, "
        f"the quantizer's rest {build_split['quantize_rest']:.2f} s, layout {build_split['layout']:.2f} s; "
        f"{iv._shape()[0]} chunks of {int(ivf.centroid_groups(iv.centroids)[0].shape[0])} centroids, longest "
        f"{iv.p_win} rows, capacity {index.capacity} ({card})")
    member = torch.randperm(n, generator=gen, device=dev)[:nq]
    queries = x[member]
    index.search(x[torch.randperm(n, generator=gen, device=dev)[:nq]], k)  # warm, on another batch
    zero_counters()
    m, search_s = search_timed(index, queries, k)
    launches = counters()
    check_launches("8,192-partition IVF", launches, "grouped_probe")
    want = keys[member.cpu().numpy()]
    _, gt_slots = ground_truth(index, queries[: spec["gt_q"]], k)
    recall1, recall10 = recall_at(m, want, index._slot_keys[np.clip(gt_slots, 0, None)], k)
    log(f"  IVF search of {nq} member queries, k={k}, nprobe {nprobe}: {search_s * 1e3:.1f} ms = "
        f"{nq / search_s:.0f} QPS, recall@1 {recall1:.4f}, recall@10 against the exact answer ({spec['gt_q']} "
        f"queries) {recall10:.4f}; launches {launches}")
    if not np.all(np.isfinite(m.distances)) or m.keys.shape != (nq, k) or recall1 < 0.99:
        fail(f"the {spec['partitions']}-partition IVF search: recall@1 {recall1:.4f}")
    mp, args = plain_probe_search(index, queries, k, "grouped_probe")
    if not same_search(mp, m):
        fail(f"the plain probe's search differs from B3's at {int((mp.keys != m.keys).sum())} places")
    log(f"  the same search through B3's plain version: keys and distances equal ({args[1].shape[0]} padded "
        f"pairs, k {args[8]}, {args[9]} per bin)")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lifecycle_"))
    try:
        buf = index.save()  # no path yet: the bytes
        path = str(tmp / "ivf8192.usearch")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        if size != index.serialized_length or len(buf) != size:
            fail(f"the file holds {size} bytes, the buffer {len(buf)}, serialized_length says "
                 f"{index.serialized_length}")
        log(f"  (c) saved in {save_s:.2f} s: {size / 1e9:.3f} GB, equal to serialized_length ({card})")
        loads = {}
        loaded, loads["restore"] = restored("Index.restore(path)", lambda: Index.restore(path, device=dev), m,
                                            queries, k, card)
        _, loads["view"] = restored("Index.restore(path, view=True)",
                                    lambda: Index.restore(path, view=True, device=dev), m, queries, k, card)
        _, loads["buffer"] = restored("Index.restore(buffer)", lambda: Index.restore(buf, device=dev), m, queries,
                                      k, card)
        del buf

        gone = keys[torch.randperm(n, generator=gen, device=dev)[: int(n * spec["removed"])].cpu().numpy()]
        loaded.remove(gone)
        new = unit_rows(spec["fresh"], w, gen, dev)
        new_keys = loaded.add(None, new)
        before = searched_through_b3("updated IVF", loaded, queries, k)
        path2 = str(tmp / "ivf8192_updated.usearch")
        loaded.save(path2)
        again = Index.restore(path2, device=dev)
        held = compacted_as_saved(loaded, again)
        after = searched_through_b3("updated and restored IVF", again, queries, k)
        mp, _ = plain_probe_search(again, queries, k, "grouped_probe")
        if not same_search(mp, after):
            fail(f"the updated and restored index: B3's plain version differs from B3 at "
                 f"{int((mp.keys != after.keys).sum())} places")
        log(f"  the updated index restored: {held}; its search through B3's plain version equal to B3's bit for bit")
        same_rows = float(np.mean(np.all((after.keys == before.keys) & (after.distances == before.distances),
                                         axis=1)))
        probe_q = x[torch.as_tensor(gone[:nq].astype(np.int64), device=dev)]
        hits = int(np.isin(again.search(probe_q, k).keys, gone).sum())
        mf = again.search(new, k)
        found = float(np.mean([key in row for key, row in zip(new_keys.tolist(), mf.keys.tolist())]))
        log(f"  removed {len(gone)} keys and added {spec['fresh']} rows on the restored index, saved and restored "
            f"again: IVF restored {again._ivf is not None and not again._ivf_dirty} with "
            f"{again._ivf.fresh_np.size} fresh rows, {same_rows:.4f} of the queries' results equal bit for bit "
            f"to the updated index's before the save (the compaction moves rows across 128-row bins), "
            f"{hits} removed keys returned, {found:.4f} of the fresh rows found")
        if again._ivf is None or again._ivf_dirty or same_rows < 0.99 or hits or found < 1.0:
            fail("the updated index's round trip")

        spilled = ivf_run["index"]
        spath = str(tmp / "ivf1024_spilled.usearch")
        spilled.save(spath)
        back = Index.restore(spath, device=dev)
        ms = searched_through_b3("restored spilled IVF", back, ivf_run["queries"], k)
        live = ~np.isin(ivf_run["want"], ivf_run["gone"])
        s_recall1 = float(np.mean(ms.keys[live, 0] == ivf_run["want"][live]))
        s_hits = int(np.isin(back.search(ivf_run["probe_q"], k).keys, ivf_run["gone"]).sum())
        mf = back.search(ivf_run["new"], k)
        s_found = float(np.mean([key in row for key, row in zip(ivf_run["new_keys"].tolist(), mf.keys.tolist())]))
        log(f"  (d) the spilled IVF path's index ({spilled._ivf.shadow_np_pos.size} shadow rows) saved and "
            f"restored: {back._ivf.shadow_np_pos.size} shadow rows, recall@1 {s_recall1:.4f} over its "
            f"{int(live.sum())} live member queries, {s_hits} removed keys returned, {s_found:.4f} of its fresh "
            f"rows found")
        if back._ivf is None or back._ivf.shadow_np_pos.size or s_recall1 < 0.99 or s_hits or s_found < 1.0:
            fail("the spilled index's round trip")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  the files deleted: {not tmp.exists()}")
    return dict(index=index, queries=queries, recall1=recall1, recall10=recall10, qps=nq / search_s, nprobe=nprobe,
                add=add, build=build_split, launches=launches, probe_args=args, save_s=save_s, loads=loads,
                file_gb=size / 1e9)


def ties_aside(got, want) -> bool:
    """Distances and counts equal bit for bit (exact i8 dots); keys equal
    except where the distance there ties another in the row, or the k-th
    (which may tie a row left out)."""
    if not (np.array_equal(got.distances, want.distances) and np.array_equal(got.counts, want.counts)):
        return False
    d = want.distances
    return all(np.sum(d[r] == d[r, c]) > 1 or d[r, c] == d[r, -1] for r, c in zip(*np.nonzero(got.keys != want.keys)))


def drive_streamed(dev, card: str):
    """Phase 3 (e), the streamed view at a real size (STREAMED): 2**22 unit
    rows in an i8 ip index on the card, saved, and `Index.restore(path,
    view=True, stream=True)`; 1,024 member queries at k=10 equal to the
    resident `search(exact=True)` apart from ties, through B2 and the
    rescore once a tile and no other kernel (counters zeroed just before, read just after); a
    filter (even keys) against the resident filtered search; `get` from the
    map, `add` and `remove` refused; the search's time beside the host copy
    of the rows from the map into pinned memory and a pinned upload of the
    same bytes; a `search_async`'s dispatch time beside its result's, and
    the host syncs inside that dispatch; then bench.py's streamed shape. Returns B2's row at a
    streamed tile's shape."""
    from usearch_torch import stream

    spec = STREAMED
    n, w, nq, k = spec["n"], spec["w"], spec["q"], spec["k"]
    tile = stream.DEFAULT_TILE_ROWS
    if -(-n // tile) != spec["tiles"]:
        fail(f"{n} rows make {-(-n // tile)} tiles of {tile}, not {spec['tiles']}")
    t_step = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    index = Index(ndim=w, metric="ip", dtype="i8", device=dev)
    index.reserve(n)
    for lo in range(0, n, 1 << 20):
        index.add(None, unit_rows(min(1 << 20, n - lo), w, gen, dev))
    member = torch.randperm(n, generator=gen, device=dev)[:nq]
    queries = index._table[member]  # each query its own stored row
    even = lambda keys: keys % 2 == 0  # noqa: E731
    resident = index.search(queries, k, exact=True)
    resident_even = index.search(queries, k, exact=True, filter=even)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_streamed_"))
    try:
        path = str(tmp / "streamed.usearch")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        viewed = Index.restore(path, view=True, stream=True, device=dev)
        if not viewed._streamed or viewed._table is not None or len(viewed) != n:
            fail("view(stream=True) did not keep the rows in the file's map")
        viewed.search(queries[:8], k)  # warm: the pinned staging buffers
        zero_counters()
        t0 = time.perf_counter()
        m = viewed.search(queries, k)
        search_s = time.perf_counter() - t0
        launches = counters()
        only_launched("the streamed search", launches, exact_launches(spec["tiles"]))
        if not ties_aside(m, resident):
            fail(f"the streamed search differs from the resident exact search at "
                 f"{int((m.keys != resident.keys).sum())} places")
        if not ties_aside(viewed.search(queries, k, filter=even), resident_even):
            fail("the filtered streamed search differs from the resident filtered search")
        marks = []

        def dispatch():
            marks.append(time.perf_counter())
            pending = viewed.search_async(queries, k)
            marks.append(time.perf_counter())
            return pending

        stream_sites, pend = sync_sites(dispatch)
        if not same_search(pend.result(), m):
            fail("the streamed search_async result differs from the streamed search")
        marks.append(time.perf_counter())
        keys = index._slot_keys[member[:16].cpu().numpy()]
        if not np.array_equal(viewed.get(keys), index.get(keys)):
            fail("get on the streamed view differs from the resident index's")
        for label, change in (("add", lambda: viewed.add(None, queries[:1])), ("remove", lambda: viewed.remove(keys))):
            try:
                change()
            except RuntimeError:
                continue
            fail(f"{label} on a streamed view did not raise")
        nbytes = n * w
        pinned = torch.empty((tile, w), dtype=torch.int8, pin_memory=True)
        host = pinned.numpy()
        t0 = time.perf_counter()
        for lo in range(0, n, tile):
            np.copyto(host, viewed._stream_rows[lo : lo + tile])
        memcpy_s = time.perf_counter() - t0
        dst = torch.empty((tile, w), dtype=torch.int8, device=dev)
        upload_ms = time_ms(lambda: [dst.copy_(pinned, non_blocking=True) for _ in range(n // tile)], 2)
        log(f"  (e) streamed view of {n} x {w} i8 rows ({nbytes / 2**30:.2f} GiB, {spec['tiles']} tiles of {tile}, "
            f"saved in {save_s:.2f} s): {nq} member queries at k={k} {search_s * 1e3:.1f} ms = "
            f"{nbytes / search_s / 1e9:.2f} GB/s, {nq / search_s:.0f} QPS; keys and distances as the resident "
            f"exact search's apart from ties, the even-key filter too; launches {launches}; the host copy of the "
            f"rows from the map into pinned memory {memcpy_s * 1e3:.1f} ms = {nbytes / memcpy_s / 1e9:.2f} GB/s "
            f"(the file just written: a warm read), a pinned upload of the same bytes {upload_ms:.1f} ms = "
            f"{nbytes / upload_ms / 1e6:.2f} GB/s ({card})")
        log(f"  (e) a streamed search_async: its dispatch {(marks[1] - marks[0]) * 1e3:.1f} ms of "
            f"{(marks[2] - marks[0]) * 1e3:.1f} ms to its result; host syncs inside the dispatch "
            f"(`set_sync_debug_mode`, event waits not among them): {len(stream_sites)} {sorted(set(stream_sites))}")
        profile_search(viewed, queries, k, exact=False, label="streamed")
        row = kernel_row("binned_minima", "i8 ip streamed tile", "ip", queries.contiguous(), index._table[:tile],
                         index._stats[:tile], index._valid[:tile], False, launches["binned_minima"], "i8")
        del viewed, index, pinned, dst

        bn = spec["bench_n"]
        bx = unit_rows(bn, w, gen, dev)
        bix = Index(ndim=w, metric="ip", dtype="i8", device=dev)
        bix.add(None, bx)
        bpath = str(tmp / "bench_stream.usearch")
        bix.save(bpath)
        del bix
        bv = Index.restore(bpath, view=True, stream=True, device=dev)
        bv.search(bx[nq : 2 * nq], k)  # warm
        t0 = time.perf_counter()
        bm = bv.search(bx[:nq], k)
        bench_s = time.perf_counter() - t0
        recall1 = float(np.mean(bm.keys[:, 0] == np.arange(nq)))
        log(f"  (e) bench.py's streamed shape ({bn} rows, {nq} member queries, k={k}): {bench_s * 1e3:.2f} ms = "
            f"{nq / bench_s:.1f} QPS, recall@1 {recall1:.4f} ({card})")
        if not np.all(np.isfinite(bm.distances)) or bm.keys.shape != (nq, k) or recall1 < 0.99:
            fail(f"bench.py's streamed shape: recall@1 {recall1:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  (e) the files deleted: {not tmp.exists()}; step {time.perf_counter() - t_step:.1f} s")
    return row


def sync_sites(dispatch):
    """The host syncs ``dispatch()`` makes inside the port
    (`torch.cuda.set_sync_debug_mode`), each as "file:line" of the innermost
    line of the port on the stack when it warned (a warning with no line of
    the port on the stack comes from around the dispatch and is left out);
    returns them and ``dispatch()``'s result."""
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        ours = [f for f in traceback.extract_stack() if f"{os.sep}usearch_torch{os.sep}" in f.filename]
        if "synchroniz" in str(message) and ours:
            sites.append(f"{Path(ours[-1].filename).name}:{ours[-1].lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites, out


def finishes_within(fn, seconds: float) -> bool:
    """``fn`` on another thread returned within ``seconds``."""
    done = threading.Event()

    def run():
        fn()
        done.set()

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(seconds)
    return done.is_set()


def drive_async(dev, ivf_run: dict, card: str) -> None:
    """Phase 3 (f), `search_async` on the IVF path's i8 index: 8 batches of
    1,024 member queries in flight, then consumed, each equal bit for bit to
    the synchronous search; an add on another thread then finishes within
    SERVING's timeout (a leaked read lock fails the run); 8 synchronous
    searches' time beside 8 async ones (both warm, in turns, ASYNC["rounds"]
    times), one search's device time (its profile), and the host syncs
    inside one dispatch, of device and of host queries, and of a filter's
    first and second dispatch (each equal to the filtered search)."""
    t_step = time.perf_counter()
    index, k, nq = ivf_run["index"], IVF["k"], ASYNC["q"]
    batches = [ivf_run["queries"][i * nq : (i + 1) * nq] for i in range(ASYNC["batches"])]
    sync = [index.search(b, k) for b in batches]  # warm, and the results to hold
    [p.result() for p in [index.search_async(b, k) for b in batches]]  # warm: the pinned result buffers
    times = dict(sync=[], async_=[], dispatch=[])
    for _ in range(ASYNC["rounds"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [index.search(b, k) for b in batches]
        times["sync"].append(time.perf_counter() - t0)
        if not all(same_search(g, s) for g, s in zip(got, sync)):
            fail("a synchronous search changed between rounds")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pend = [index.search_async(b, k) for b in batches]
        times["dispatch"].append(time.perf_counter() - t0)
        got = [p.result() for p in pend]
        times["async_"].append(time.perf_counter() - t0)
        if not all(same_search(g, s) for g, s in zip(got, sync)):
            fail("a search_async result differs from the synchronous search")
    profile_search(index, batches[0], k, exact=False, label="IVF")
    sites, pend = sync_sites(lambda: index.search_async(batches[0], k))
    if not same_search(pend.result(), sync[0]):
        fail("the counted dispatch's result differs from the synchronous search")
    host_q = batches[0].cpu().numpy()
    host_sites, pend = sync_sites(lambda: index.search_async(host_q, k))
    pend.result()
    odd = lambda keys: keys % 2 == 1  # noqa: E731
    filter_sites = []
    for _ in range(2):  # the filter's first dispatch builds its mask, the second reuses it
        sites_f, pend = sync_sites(lambda: index.search_async(batches[0], k, filter=odd))
        if not same_search(pend.result(), index.search(batches[0], k, filter=odd)):
            fail("a filtered search_async result differs from the filtered search")
        filter_sites.append(sites_f)
    added = []
    rows = unit_rows(8, IVF["w"], torch.Generator(device=dev).manual_seed(SEED + 19), dev)
    if not finishes_within(lambda: added.extend(index.add(None, rows)), SERVING["timeout"]):
        fail(f"an add on another thread did not finish within {SERVING['timeout']} s: a read lock leaked")
    index.remove(np.asarray(added, dtype=np.uint64))
    log(f"  (f) search_async on the i8 ip IVF: {len(batches)} batches of {nq} member queries in flight, each "
        f"equal bit for bit to the synchronous search; in {ASYNC['rounds']} rounds, {len(batches)} synchronous searches "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times['sync'])} ms, {len(batches)} async "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times['async_'])} ms (their dispatch "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times['dispatch'])} ms); an add on another thread after them "
        f"finished; host syncs inside one dispatch of device queries: {len(sites)} {sorted(set(sites))}, of host "
        f"queries: {len(host_sites)} {sorted(set(host_sites))}, of a filter's first and second dispatch: "
        f"{len(filter_sites[0])} {sorted(set(filter_sites[0]))} and {len(filter_sites[1])} "
        f"{sorted(set(filter_sites[1]))}; step {time.perf_counter() - t_step:.1f} s ({card})")


def drive_serving(dev, ivf_run: dict, card: str) -> None:
    """Phase 3 (g), serving the IVF path's i8 index: a `BinaryIndexServer`
    (127.0.0.1, port 0) and a `BinaryIndexClient` sending 4,096
    single-query requests through `search_pipelined`, each response equal
    in keys and distances to `index.search` of the 4,096 as one batch (a
    result that depends on the batch a query was coalesced into fails);
    QPS and the mean coalesced batch; then `IndexServer` and `IndexClient`
    over HTTP: info, add, search, get, remove and contains once each.
    Every socket has SERVING's timeout; the servers stop in `finally`."""
    t_step = time.perf_counter()
    index, k, n, timeout = ivf_run["index"], IVF["k"], SERVING["requests"], SERVING["timeout"]
    q = ivf_run["queries"][:n].cpu().numpy()
    want = index.search(q, k)
    sizes = []
    real = index.search

    def counted(vectors, *args, **kwargs):
        sizes.append(len(vectors))
        return real(vectors, *args, **kwargs)

    srv = BinaryIndexServer(index, "127.0.0.1", 0).start()
    try:
        index.search = counted
        with BinaryIndexClient("127.0.0.1", srv.port, timeout=timeout) as cli:
            cli.search_pipelined([q[:1]] * 64, count=k)  # warm
            sizes.clear()
            t0 = time.perf_counter()
            res = cli.search_pipelined([q[i : i + 1] for i in range(n)], count=k)
            rpc_s = time.perf_counter() - t0
    finally:
        del index.search
        srv.stop()
    keys, dists = np.vstack([r.keys for r in res]), np.vstack([r.distances for r in res])
    differ = np.any((keys != want.keys) | (dists != want.distances), axis=1)
    log(f"  (g) binary RPC: {n} single-query requests pipelined at k={k}: {rpc_s * 1e3:.1f} ms = {n / rpc_s:.0f} QPS, "
        f"{len(sizes)} coalesced searches of {np.mean(sizes):.1f} queries on average (1-{max(sizes)}); "
        f"{int(differ.sum())} responses differ from the one-batch search ({card})")
    if differ.any():
        fail(f"{int(differ.sum())} RPC responses differ from the one-batch search: a result depends on the batch "
             f"its query was coalesced into")

    hsrv = IndexServer(index, "127.0.0.1", 0).start()
    try:
        cli = IndexClient("127.0.0.1", hsrv.port, timeout=timeout)
        info = cli.info
        key = int(index._keymap.max_key()) + 1
        row = unit_rows(1, IVF["w"], torch.Generator(device=dev).manual_seed(SEED + 20), dev).cpu().numpy()
        added = cli.add(np.array([key]), row)
        m = cli.search(q[:16], k)
        ws = index.search(q[:16], k)
        got = cli.get(np.array([key]))
        want_row = index.get(key)
        removed = cli.remove(np.array([key]))
        contains = cli.contains(np.array([key, int(want.keys[0, 0])]))
    finally:
        hsrv.stop()
    ok = dict(info=info["ndim"] == IVF["w"] and info["metric"] == "ip" and info["dtype"] == "i8",
              add=added.tolist() == [key], search=same_search(m, ws),
              get=np.array_equal(np.asarray(got)[0], want_row),
              remove=removed.tolist() == [1], contains=contains.tolist() == [False, True])
    log(f"  (g) HTTP: info, add, search, get, remove, contains: {ok}; step {time.perf_counter() - t_step:.1f} s")
    if not all(ok.values()):
        fail(f"the HTTP round trip: {ok}")


def bit_corpus(n: int, gen, dev, templates: torch.Tensor) -> torch.Tensor:
    """Packed rows of the clustered bit corpus: a template row each, with
    BINARY["flip"] of its bits flipped; made in chunks on the card."""
    out = torch.empty((n, templates.shape[1] // 8), dtype=torch.uint8, device=dev)
    for lo in range(0, n, 1 << 17):
        m = min(1 << 17, n - lo)
        pick = torch.randint(0, templates.shape[0], (m,), generator=gen, device=dev)
        flips = torch.rand((m, templates.shape[1]), generator=gen, device=dev) < BINARY["flip"]
        out[lo : lo + m] = pack_bits(templates[pick] ^ flips)
    return out


def tie_recall(got_d: np.ndarray, want_d: np.ndarray) -> float:
    """Share of the exact top-k distances the probe matched, as multisets
    per row (scripts/tpu_binary_ivf_bench.py's rule: hamming distances are
    small integers, and an equal distance is as near as the exact row)."""
    hits = 0
    for a, b in zip(np.sort(got_d, axis=1), np.sort(want_d, axis=1)):
        left = {}
        for x in a.tolist():
            left[x] = left.get(x, 0) + 1
        for x in b.tolist():
            if left.get(x, 0):
                left[x] -= 1
                hits += 1
    return hits / got_d.size


def plain_probe_search(index, queries, k: int, name: str):
    """`Index.search`'s eager body (`eager_search`) with probe kernel
    ``name``'s plain version (its wrapper in PROBE_KERNELS) bound in the
    kernel's place for this one call. Returns the matches and the arguments of the probe; fails if a
    probe kernel launched or the probe ran other than once."""
    calls = []
    kern = getattr(probe, name)
    plain_fn = getattr(probe, name + "_plain")

    def plain(*args):
        calls.append(args)
        return plain_fn(*args)

    before = [kern.launches for kern in PROBE_KERNELS]
    setattr(ivf, name, plain)
    try:
        m = eager_search(index, queries, k)  # a replay would launch the kernel its graph holds
    finally:
        setattr(ivf, name, kern)
    if [kern.launches for kern in PROBE_KERNELS] != before or len(calls) != 1:
        fail(f"the plain-probe search launched a probe kernel or probed {len(calls)} times")
    return m, calls[0]


def bit_args(index, queries, k: int, exact: bool) -> tuple:
    """The arguments the flat search of ``queries`` on a b1 ``index`` gives
    `bitscan.bit_scan`: its padded prepared queries, table, popcounts,
    mask, k and whether it ranks in bf16 (`Index._search_plan`'s tile)."""
    q = index._padded_queries(index._cast_device(*index._device_rows(queries)))
    approx, _ = index._route(exact)
    table, cap = index._table, index._capacity
    tile_rows = pick_tile_rows(cap, index._width * table.element_size(), index.metric, index.ndim, q.shape[0])
    while cap % tile_rows:
        tile_rows //= 2
    k = min(k, len(index))
    return (index.metric, q, table, row_stats(q, ScalarKind.B1)[:, 0], index._stats[:, 0], index._valid, k,
            bitscan.rounds(approx, cap, k, tile_rows))


def hold_flat_search(label: str, index, m, args) -> None:
    """``index``'s search result ``m`` equal to `bit_scan_plain` over
    ``args`` (`bit_args`) bit for bit: distances and keys."""
    d, slots = bitscan.bit_scan_plain(*args)
    nq = m.keys.shape[0]
    d, slots = d[:nq].cpu().numpy(), slots[:nq].cpu().numpy()
    keys = np.where(slots >= 0, index._slot_keys[np.clip(slots, 0, None)], 0).astype(np.uint64)
    if not (np.array_equal(m.distances.view(np.uint32), d.view(np.uint32)) and np.array_equal(m.keys, keys)):
        fail(f"the {label} differs from bit_scan_plain at {int((m.keys != keys).sum())} keys")
    log(f"  the {label}: distances and keys equal to bit_scan_plain's bit for bit"
        f"{' (ranked in bf16)' if args[-1] else ''}")


def plain_route_search(index, queries, k: int):
    """The exact search as it ran before the bit scan: `Index.search`'s
    eager body with the bit scan's gate closed, so the plain tiled scan
    (`ops/topk.scan_topk` over `packbits.bit_dot`) serves. Returns the
    matches, the seconds (synchronised) and the peak device bytes."""
    serves = bitscan.serves
    bitscan.serves = lambda *args, **kwargs: False
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = eager_search(index, queries, k, exact=True)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    finally:
        bitscan.serves = serves


def drive_binary(dev, metric: str, x: torch.Tensor, templates: torch.Tensor, gen) -> dict:
    """Phase 3, one binary path: a b1 index of the corpus ``x`` through
    add, the flat approximate search of the member queries and the exact
    search (the ground truth; both through the bit scan, held bit for bit
    against `bit_scan_plain`, the exact one timed beside the plain scan it
    replaced), optimize, probed search, the plain probe, fresh adds and
    removals; the launch counters are zeroed just before the flat searches
    and read just after (`bit_scan` and no other kernel), then zeroed again
    for the rest (B3 or B5, no flat kernel and no `bit_scan`)."""
    spec = BINARY
    n, nq, k = x.shape[0], spec["q"], spec["k"]
    kern_name = "grouped_probe" if metric == "hamming" else "grouped_probe_nofold"
    torch.cuda.synchronize()
    zero_counters()
    index = Index(ndim=spec["bits"], metric=metric, dtype="b1", device=dev)
    t0 = time.perf_counter()
    keys = index.add(None, x)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    member = torch.randperm(n, generator=gen, device=dev)[:nq]
    queries = x[member]
    want = keys[member.cpu().numpy()]
    other = x[torch.randperm(n, generator=gen, device=dev)[:nq]]
    index.search(other, k)  # warm: the capture
    flat, flat_s = search_timed(index, queries, k)
    flat_recall1 = float(np.mean(flat.keys[:, 0] == want))
    log(f"  b1 {metric} flat approximate search of {nq} member queries over {n} x {spec['bits']} bits (bit_scan): "
        f"{flat_s * 1e3:.1f} ms = {nq / flat_s:.0f} QPS, recall@1 {flat_recall1:.4f}")
    if not np.all(np.isfinite(flat.distances)) or flat.keys.shape != (nq, k) or flat_recall1 < 0.99:
        fail(f"b1 {metric} flat approximate search: recall@1 {flat_recall1:.4f}")
    index.search(other, k, exact=True)  # warm: the capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gt = index.search(queries, k, exact=True)
    torch.cuda.synchronize()
    exact_s, exact_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    flat_args = bit_args(index, queries, k, exact=False)
    exact_args = bit_args(index, queries, k, exact=True)
    hold_flat_search(f"b1 {metric} flat approximate search", index, flat, flat_args)
    hold_flat_search(f"b1 {metric} exact search", index, gt, exact_args)
    flat_launches = counters()
    if flat_launches["bit_scan"] == 0 or any(v for name, v in flat_launches.items() if name != "bit_scan"):
        fail(f"the b1 {metric} flat searches did not go through bit_scan alone: {flat_launches}")
    before, before_s, before_peak = plain_route_search(index, queries, k)
    if not same_search(before, gt):
        fail(f"the plain scan's b1 {metric} exact search differs from the bit scan's")
    log(f"  b1 {metric} exact search of {nq} queries, before (the plain scan, eager): {before_s * 1e3:.1f} ms = "
        f"{nq / before_s:.0f} QPS, peak device memory {before_peak / 2**30:.2f} GiB; after (bit_scan, replayed): "
        f"{exact_s * 1e3:.1f} ms = {nq / exact_s:.0f} QPS, peak {exact_peak / 2**30:.2f} GiB; equal bit for bit; "
        f"launches on the flat searches {flat_launches['bit_scan']} ({card_line()})")
    zero_counters()
    t0 = time.perf_counter()
    index.optimize(n_partitions=spec["partitions"], reorder=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index.expansion_search = spec["expansion"]
    iv = index._ivf
    nprobe = iv.nprobe_for(index.expansion_search, index.connectivity)
    index.search(x[torch.randperm(n, generator=gen, device=dev)[:nq]], k)  # warm, on another batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = index.search(queries, k)
    search_s = time.perf_counter() - t0
    recall1 = float(np.mean(m.keys[:, 0] == want))
    recall10 = tie_recall(m.distances, gt.distances)
    id_recall10 = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(m.keys.tolist(), gt.keys.tolist())]))
    log(f"  b1 {metric} IVF {n} x {spec['bits']} bits: add {add_s:.2f} s; exact search of {nq} queries "
        f"{exact_s * 1e3:.1f} ms = {nq / exact_s:.0f} QPS; optimize({spec['partitions']} partitions, reorder) "
        f"{build_s:.2f} s: {iv._shape()[0]} chunks, longest {iv.p_win} rows, capacity {index.capacity}")
    log(f"  probed search of {nq} member queries, k={k}, nprobe {nprobe}: {search_s * 1e3:.1f} ms = "
        f"{nq / search_s:.0f} QPS, recall@1 {recall1:.4f}, tie-aware recall@10 {recall10:.4f} "
        f"(on ids {id_recall10:.4f})")
    if not np.all(np.isfinite(m.distances)) or m.keys.shape != (nq, k) or recall1 < 0.99:
        fail(f"b1 {metric} IVF search: recall@1 {recall1:.4f}")

    mp, args = plain_probe_search(index, queries, k, kern_name)
    differ = mp.keys != m.keys
    if not np.array_equal(mp.distances, m.distances) or differ.any():
        fail(f"the plain probe's {metric} search differs from the kernel's at {int(differ.sum())} places")
    log(f"  the same search through {kern_name}'s plain version: keys and distances equal "
        f"({args[1].shape[0]} padded pairs)")

    new = bit_corpus(spec["fresh"], gen, dev, templates)
    new_keys = index.add(None, new)
    if index._ivf_dirty or iv.fresh_np.size != spec["fresh"]:
        fail("rows added after optimize did not join the fresh list")
    mf = index.search(new, k)
    found = float(np.mean([key in row for key, row in zip(new_keys.tolist(), mf.keys.tolist())]))
    log(f"  {spec['fresh']} rows added after the build: {found:.4f} found as members")
    if found < 1.0:
        fail(f"fresh rows not found: {found:.4f}")

    gone = keys[torch.randperm(n, generator=gen, device=dev)[: int(n * spec["removed"])].cpu().numpy()]
    index.remove(gone)
    hits = int(np.isin(index.search(x[torch.as_tensor(gone[:nq].astype(np.int64), device=dev)], k).keys,
                       gone).sum())
    if hits or len(index) != n + spec["fresh"] - len(gone):
        fail(f"{hits} removed keys came back from the b1 {metric} IVF")
    log(f"  removed {len(gone)} keys: none comes back")
    launches = counters()
    log(f"  kernel launches on the b1 {metric} IVF path: {launches}")
    if launches[kern_name] == 0 or any(launches[kern.__name__] for kern in FLAT_KERNELS + BIT_KERNELS):
        fail(f"the b1 {metric} searches did not go through {kern_name} alone among the kernels: {launches}")
    return dict(index=index, queries=queries, recall1=recall1, recall10=recall10, qps=nq / search_s,
                nprobe=nprobe, build_s=build_s, launches=launches, probe_args=args, kern=kern_name,
                exact_args=exact_args, flat_launches=flat_launches["bit_scan"], exact_ms=exact_s * 1e3,
                before_ms=before_s * 1e3)


def run_binary_paths(dev) -> dict:
    """Phase 3: the hamming path (B3 over packed rows), then tanimoto (B5),
    each on its own index of one corpus."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    templates = torch.randint(0, 2, (BINARY["templates"], BINARY["bits"]), generator=gen, device=dev,
                              dtype=torch.uint8)
    x = bit_corpus(BINARY["n"], gen, dev, templates)
    return {metric: drive_binary(dev, metric, x, templates, gen) for metric in BINARY["metrics"]}


def run_main_path(dev):
    """Phase 3: the i8 IP index, then the f32 cos (compact) index."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    head = drive(dev, MAIN, "ip", "i8", gen, removed=MAIN["removed"])
    comp = drive(dev, COMPACT, "cos", "f32", gen)
    return head, comp


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream, after one warm call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, peak_ops: float, nbytes: float):
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_ms(q: torch.Tensor, table: torch.Tensor) -> float:
    """One library product of the same operands: torch._int_mm for i8,
    torch.matmul otherwise; over row chunks when one output would not fit."""
    rows = max(128, min(table.shape[0], (8 << 30) // (4 * q.shape[0])))
    total = 0.0
    for lo in range(0, table.shape[0], rows):
        t = table[lo : lo + rows]
        if q.dtype == torch.int8:
            total += time_ms(lambda: torch._int_mm(q, t.t()), 2)
        else:
            total += time_ms(lambda: torch.matmul(q, t.t()), 2)
    return total


def kernel_row(name, path, metric, q, table, stats, valid, compact, launches, peak_key) -> dict:
    """Phase 4 row of one kernel at one main-path shape: held against its
    plain version as in phase 2, then timed beside its bound, the plain
    version and one library product."""
    metric = normalize_metric(metric)
    args = (metric, q, table, *scan.scan_aux(metric, q, stats, valid))
    tag = f"{name} {path} Q={q.shape[0]} N={table.shape[0]}"
    if name == "binned_scan":
        kern = lambda: scan.binned_scan(*args, compact=compact)
        plain = lambda: scan.binned_scan_plain(*args, compact=compact)
        out_bytes = (2 + 1) if compact else (4 + 4)
        want, plain_ms = plain_timed(plain)
        err = hold_b1(tag, args, compact, kern(), want)
    else:
        kern = lambda: scan.binned_minima(*args)
        plain = lambda: scan.binned_minima_plain(*args)
        out_bytes = 4
        want, plain_ms = plain_timed(plain)
        err = hold_b2(tag, args, kern(), want)
    ms = time_ms(kern, 5)
    nq, (n, w) = q.shape[0], table.shape
    ops = 2.0 * nq * n * w
    nbytes = (n + nq) * w * table.element_size() + 4 * (2 * n + nq) + nq * (n // 128) * out_bytes
    b_ms, b_by = bound_ms(ops, PEAK_OPS[peak_key], nbytes)
    lq, lt = (q, table) if not compact else (q.to(torch.bfloat16), table.to(torch.bfloat16))
    lib = library_ms(lq, lt)
    log(f"  {tag} W={w} ({scan_product(table, compact)}): {ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
        f"plain {plain_ms:.1f} ms, library {lib:.3f} ms, launches on its path {launches}, max abs err {err:.3g}")
    return dict(name=f"{name}[{path}]", route="cuda", source="usearch_torch/csrc/scan.cu",
                replaces="usearch_tpu/ops/pallas_scan.py:" + ("446" if name == "binned_scan" else "631"),
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, product=scan_product(table, compact))


def rescore_row(path: str, run, spec, peak_key: str) -> dict:
    """Phase 4 row of the exact rescore's dots at an exact search's shape:
    ``spec``'s first ``exact_q`` member queries on ``run``'s index, their
    bins from B2 and the bin top-k as `scan.exact_steps` takes them; held
    against the plain version, timed beside its bound (bytes: the rows of
    every distinct selected bin once, as this run's bins need them, the
    queries, the bins, the int32/f32 dots; the rate printed is that of the
    rows gathered, a bin once a query that selects it) and, for bf16 and
    f32, one `torch.bmm` over the rows gathered before the timing (torch
    has no batched int8 product on CUDA)."""
    ix = run["index"]
    q = ix._cast_device(run["queries"][: spec["exact_q"]], ScalarKind.F32).contiguous()
    table = ix._table
    q_sq, t_sq, penalty = scan.scan_aux(ix.metric, q, ix._stats, ix._valid)
    vals = scan.binned_minima(ix.metric, q, table, q_sq, t_sq, penalty)
    bins = scan.select_bins_exact(vals, min(spec["k"] + scan.EXACT_BIN_SLACK, vals.shape[1]))
    (nq, b), w, es = bins.shape, table.shape[1], table.element_size()
    tag = f"block_dots {path} Q={nq} b={b} N={table.shape[0]}"
    kern = lambda: scan.block_dots(q, table, bins)  # noqa: E731
    want, plain_ms = plain_timed(lambda: scan.block_dots_plain(q, table, bins))
    err = hold_rescore(tag, q, kern(), want)
    del want
    ms = time_ms(kern, 10)
    distinct = int(torch.unique(bins).numel())
    gathered = nq * b * 128 * w * es
    nbytes = distinct * 128 * w * es + nq * w * es + nq * b * 8 + nq * b * 128 * 4
    b_ms, b_by = bound_ms(2.0 * nq * b * 128 * w, PEAK_OPS[peak_key], nbytes)
    lib = None
    if q.dtype != torch.int8:
        rows = table.view(-1, 128, w)[bins].reshape(nq, b * 128, w)
        lib = time_ms(lambda: torch.bmm(rows, q[:, :, None]), 10)
        del rows
    launches = run["launches"]["block_dots"]
    lib_txt = "none (torch has no batched int8 product on CUDA)" if lib is None else f"{lib:.3f} ms (torch.bmm)"
    log(f"  {tag} W={w}: {ms:.4f} ms = {gathered / ms / 1e6:.1f} GB/s of rows gathered ({nq * b} bins, "
        f"{distinct} distinct), bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e9:.4f} GB), plain {plain_ms:.1f} ms, "
        f"library {lib_txt}, launches on its path {launches}, max abs err {err:.3g}")
    return dict(name=f"block_dots[{path}]", route="cuda", source="usearch_torch/csrc/rescore.cu",
                replaces="usearch_tpu/ops/pallas_scan.py:789", launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def scan_product(table: torch.Tensor, compact: bool) -> str:
    """How csrc/scan.cu multiplies this instantiation: on the tensor cores
    (wgmma) for i8, bf16 and compact f32, in SIMT f32 FMAs otherwise."""
    return "simt" if table.dtype == torch.float32 and not compact else "wgmma"


def touched_rows(n_rows: int, win_start, win_len) -> int:
    """Rows of every 128-row bin that some window touches."""
    live = win_len > 0
    first = win_start[live].long() // probe.LANES
    last = (win_start[live] + win_len[live] - 1).long() // probe.LANES
    n_bins = n_rows // probe.LANES
    edges = torch.bincount(first, minlength=n_bins + 1) - torch.bincount(last + 1, minlength=n_bins + 1)
    return int((torch.cumsum(edges, 0)[:n_bins] > 0).sum()) * probe.LANES


def b3_row(run, args=None, label: str = "i8 ip IVF", peak: str = "i8") -> dict:
    """Phase 4 row of B3 at the IVF path's pairs (or at ``args``, e.g. the
    same pairs over a bf16 table, or a small batch's): held against its
    plain version, timed beside its bound (operations at the ``peak`` rate)
    and the plain version's time; launches are the IVF path's. No one
    PyTorch call computes the grouped probe, so there is no library time."""
    args = run["probe_args"] if args is None else args
    _, q_g, q_sq, table, t_sq, penalty, win_start, win_len, k, bin_m = args
    n_pairs, (n_rows, w) = q_g.shape[0], table.shape
    tag = f"grouped_probe {label} P={n_pairs} k={k} bin_m={bin_m}"
    want, plain_ms = plain_timed(lambda: probe.grouped_probe_plain(*args))
    err = hold_probe(tag, args, probe.grouped_probe(*args), want)
    ms = time_ms(lambda: probe.grouped_probe(*args), 5)
    # bytes: every 128-row bin some window touches, read once with its aux
    # rows, plus the pairs' inputs and the [P, k] outputs; operations: each
    # window's own rows against its pair's query
    touched = touched_rows(n_rows, win_start, win_len)
    row_bytes = w * table.element_size() + 4 * sum(x is not None for x in (t_sq, penalty))
    in_bytes = q_g.numel() * q_g.element_size() + 4 * (q_sq.numel() + win_start.numel() + win_len.numel())
    nbytes = touched * row_bytes + in_bytes + n_pairs * k * 8
    ops = 2.0 * w * float(win_len.sum())
    b_ms, b_by = bound_ms(ops, PEAK_OPS[peak], nbytes)
    log(f"  {tag} W={w}: {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {touched} table rows touched, "
        f"{nbytes / 1e9:.4f} GB, {ops / 1e9:.2f} G operations){simt_bound(peak, ops, nbytes)}, plain "
        f"{plain_ms:.1f} ms, library none, launches on its path {run['launches']['grouped_probe']}, max abs err "
        f"{err:.3g}")
    return dict(name=f"grouped_probe[{label}]", route="cuda", source="usearch_torch/csrc/probe.cu",
                replaces="usearch_tpu/ops/pallas_probe.py:265", launches=run["launches"]["grouped_probe"],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def simt_bound(peak: str, ops: float, nbytes: float) -> str:
    """For an f32 row bound at the three-pass TF32 rate: the bound at the
    SIMT f32 FMA rate beside it."""
    if peak != "tf32x3":
        return ""
    b_ms, b_by = bound_ms(ops, PEAK_OPS["f32"], nbytes)
    return f"; at the SIMT f32 rate {b_ms:.4f} ms ({b_by})"


def bf16_probe_args(args):
    """B3's arguments at the IVF path's pairs with the queries and the table
    in bf16 (i8 values are exact there, so are their f32 dots)."""
    metric, q_g, q_sq, table, *rest = args
    return (metric, q_g.to(torch.bfloat16), q_sq, table.to(torch.bfloat16), *rest)


def small_probe_args(run):
    """B3's arguments for a batch of SMALL_Q member queries on the IVF
    path's index (pairs padded to cells of 128; nearly every partition in
    few pairs): the search through B3's plain version, held equal to the
    kernel's."""
    queries = run["queries"][:SMALL_Q]
    m = run["index"].search(queries, IVF["k"])
    mp, args = plain_probe_search(run["index"], queries, IVF["k"], "grouped_probe")
    if not (np.array_equal(mp.keys, m.keys) and np.array_equal(mp.distances, m.distances)):
        fail(f"the Q={SMALL_Q} IVF search through B3's plain version differs from the kernel's")
    windows = torch.unique(torch.stack([args[6], args[7]], 1), dim=0).shape[0]
    log(f"  IVF search of {SMALL_Q} member queries: the plain probe's equal to the kernel's "
        f"({args[1].shape[0]} padded pairs, {windows} distinct windows)")
    return args


def binary_row(run) -> dict:
    """Phase 4 row of B3 over packed rows (hamming path) or of B5 (tanimoto
    path) at the path's pairs: held bit for bit against the plain version,
    timed beside its bound and the plain version's time. Operations: two
    per bit pair of each window row and its pair's query, at the b1
    tensor-core rate (PEAK_OPS["b1"]: the and-popc product, eight times the
    int8 rate). No one PyTorch call computes a per-bin selection over
    gathered windows, so there is no library time."""
    args, name = run["probe_args"], run["kern"]
    kern, plain = getattr(probe, name), getattr(probe, name + "_plain")
    q_g, q_sq, table, win_start, win_len = args[1], args[2], args[3], args[-4], args[-3]
    n_pairs, (n_rows, w) = q_g.shape[0], table.shape
    tag = f"{name} b1 {run['index'].metric.value} IVF P={n_pairs}"
    want, plain_ms = plain_timed(lambda: plain(*args))
    err = hold_exact(tag, name, kern(*args), want)
    ms = time_ms(lambda: kern(*args), 5)
    out_cols = args[8] if name == "grouped_probe" else probe.nofold_width(args[-1], args[-2])
    in_bytes = q_g.numel() + 4 * q_sq.numel() + 4 * n_pairs * (2 if name == "grouped_probe" else 3)
    # bytes: each touched bin's rows with their popcount and penalty, the
    # pairs' inputs and the outputs
    nbytes = touched_rows(n_rows, win_start, win_len) * (w + 8) + in_bytes + n_pairs * out_cols * 8
    ops = 2.0 * 8 * w * float(win_len.sum())
    b_ms, b_by = bound_ms(ops, PEAK_OPS["b1"], nbytes)
    per_search = run["launches_per_search"]
    log(f"  {tag} W={w} bytes: {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.4f} GB, "
        f"{ops / 1e9:.2f} G bit operations), plain {plain_ms:.1f} ms, library none, launches on its path "
        f"{run['launches'][name]} ({per_search} per search), max abs err {err:.3g}")
    replaces = "usearch_tpu/ops/pallas_probe.py:" + ("115" if name == "grouped_probe" else "453")
    return dict(name=f"{name}[b1 {run['index'].metric.value} IVF]", route="cuda",
                source="usearch_torch/csrc/probe.cu", replaces=replaces, launches=run["launches"][name],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def bit_library_ms(q: torch.Tensor, table: torch.Tensor) -> float:
    """The bit scan's yardstick: the product alone, one bf16 `torch.matmul`
    of the 0/1-unpacked query bits by the unpacked table's, chunks of
    BIT_LIBRARY_ROWS rows unpacked before each chunk's timing (f32
    accumulation is exact for these counts; the port never calls it)."""
    qb = unpack_bits(q).to(torch.bfloat16)
    total = 0.0
    for lo in range(0, table.shape[0], BIT_LIBRARY_ROWS):
        tb = unpack_bits(table[lo : lo + BIT_LIBRARY_ROWS]).to(torch.bfloat16)
        total += time_ms(lambda: torch.matmul(qb, tb.T), 2)
        del tb
    return total


def bitscan_row(run) -> dict:
    """Phase 4 row of the bit scan at the exact b1 search's arguments (its
    member queries on the path's index): held bit for bit against
    `bit_scan_plain` (its time the hold's own call), timed beside its bound
    (operations: two per bit pair of every query and row at the b1
    tensor-core rate, PEAK_OPS["b1"]; bytes: the packed queries and rows,
    the rows' popcounts and mask, the [Q, k] outputs) and the library
    product (`bit_library_ms`)."""
    args = run["exact_args"]
    metric, q, table, k = args[0], args[1], args[2], args[6]
    (nq, w), n = q.shape, table.shape[0]
    tag = f"bit_scan b1 {metric.value} exact Q={nq} N={n} k={k}"
    want, plain_ms = plain_timed(lambda: bitscan.bit_scan_plain(*args))
    hold_bits(tag, "bit_scan", bitscan.bit_scan(*args), want)
    del want
    ms = time_ms(lambda: bitscan.bit_scan(*args), 5)
    ops = 2.0 * nq * n * 8 * w
    nbytes = (n + nq) * w + 4 * (n + nq) + n + nq * k * 8
    b_ms, b_by = bound_ms(ops, PEAK_OPS["b1"], nbytes)
    lib = bit_library_ms(q, table)
    launches = run["flat_launches"]
    usage = bitscan_breakdown.usage(build.build_log["bitscan"]["report"])
    regs = "; ".join(f"{name} {u.get('registers', 0)} registers, spills {u.get('spills', (0, 0))[0]}/"
                     f"{u.get('spills', (0, 0))[1]} B" for name, u in sorted(usage.items()) if "wgmma" in name)
    log(f"  {tag} W={w} bytes: {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {ops / 1e12:.2f} T bit operations, "
        f"{nbytes / 1e9:.4f} GB), plain {plain_ms:.1f} ms, library {lib:.3f} ms (bf16 torch.matmul of the unpacked "
        f"bits, the product alone), launches on its path {launches}, max abs err 0; the kernel's instantiations "
        f"(nvcc, stores/loads of spill): {regs}")
    return dict(name=f"bit_scan[b1 {metric.value} exact]", route="cuda", source="usearch_torch/csrc/bitscan.cu",
                replaces="usearch_tpu/ops/topk.py:86", launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def mode_row(run, mode: str, label: str = "i8 ip IVF", peak: str = "i8") -> dict:
    """Phase 4 row of the kernel of one probe flavour (B6 for ``pair``, B7
    ``pack`` for ``bin``, B5 over i8 for ``nofold``) at the IVF path's
    arguments, captured in phase 3: held against its plain version, timed
    beside its bound and the plain version's time. Bytes: the 128-row bins
    the kernel's windows touch, read once (with the aux rows it takes), its
    other inputs and its outputs; operations: 2 W per row it multiplies
    (B6, B5: the rows of each window; B7: every row of each pair's padded
    window), at the int8 tensor-core rate (f32: ``peak`` "tf32x3"). No one
    PyTorch call computes a per-window, per-bin selection, so there is no
    library time."""
    res = run["modes"][mode]
    args, name = res["probe_args"], res["kern"]
    kern, plain = getattr(probe, name), getattr(probe, name + "_plain")
    if name == "binned_probe":
        q, table, win_base, w_pad, bw, keep, sel = args
        n_rows, w = table.shape
        n_pairs = q.shape[0]
        tag = f"{name} i8 ip IVF P={n_pairs} w_pad={w_pad} bw={bw} keep={keep} {sel}"
        want, plain_ms = plain_timed(lambda: plain(*args))
        err = hold_exact(tag, "B7", kern(*args), want)
        touched = touched_rows(n_rows, win_base, torch.full_like(win_base, w_pad))
        nbytes = touched * w + q.numel() + 4 * n_pairs + n_pairs * probe.binned_width(keep, w_pad, bw) * 8
        ops = 2.0 * w * w_pad * n_pairs
        source, replaces = "usearch_torch/csrc/probe.cu", "usearch_tpu/ops/pallas_probe.py:636"
    else:
        q, q_sq, table, t_sq, penalty = args[1:6]
        n_rows, w = table.shape
        if name == "pair_probe":
            starts, offs, lens, k, w_pad, bin_m = args[6:]
            win_start, win_len = (starts + offs).flatten(), lens.flatten()
            in_bytes, out_cols = 4 * 3 * starts.numel(), k
            tag = f"{name} {label} Q={q.shape[0]} nprobe={starts.shape[1]} k={k} bin_m={bin_m}"
            source, replaces = "usearch_torch/csrc/pair.cu", "usearch_tpu/ops/pallas_probe.py:144"
        else:
            _, win_start, win_len, w_pad, bin_m = args[6:]
            in_bytes, out_cols = 4 * 3 * q.shape[0], probe.nofold_width(bin_m, w_pad)
            tag = f"{name} {label} P={q.shape[0]} w_pad={w_pad} bin_m={bin_m}"
            source, replaces = "usearch_torch/csrc/probe.cu", "usearch_tpu/ops/pallas_probe.py:453"
        want, plain_ms = plain_timed(lambda: plain(*args))
        err = hold_probe(tag, args, kern(*args), want, {"pair_probe": "B6"}.get(name, "B5"))
        row_bytes = w * table.element_size() + 4 * sum(x is not None for x in (t_sq, penalty))
        touched = touched_rows(n_rows, win_start, win_len)
        nbytes = (touched * row_bytes + q.numel() * q.element_size() + 4 * q_sq.numel() + in_bytes
                  + q.shape[0] * out_cols * 8)
        ops = 2.0 * w * float(win_len.sum())
    ms = time_ms(lambda: kern(*args), 3)
    b_ms, b_by = bound_ms(ops, PEAK_OPS[peak], nbytes)
    log(f"  {tag} W={w}: {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {touched} table rows touched, "
        f"{nbytes / 1e9:.4f} GB, {ops / 1e9:.2f} G operations){simt_bound(peak, ops, nbytes)}, plain "
        f"{plain_ms:.1f} ms, library none (no one PyTorch call selects per window and bin), launches on its path "
        f"{res['launches'][name]} ({res['launches_per_search']} per search), max abs err {err:.3g}")
    return dict(name=f"{name}[{label} {mode}]", route="cuda", source=source, replaces=replaces,
                launches=res["launches"][name], max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def flavour_row(name: str, run, launches: int, lib_ms: float, valid=None, label: str = "i8 ip",
                peak: str = "i8") -> dict:
    """Phase 4 row of one flat-scan flavour's kernel at the phase-3 shape
    (over f32: the cos table with ``valid`` masking the removed rows):
    held against its plain version as in phase 2, then timed beside its
    bound (f32: at the three-pass TF32 rate, the SIMT f32 one beside it) and
    the plain version's time. Its work is B1's product; the bytes are the
    table, queries and aux read once and its own output written once. No one
    PyTorch call computes bin minima and a top-k; ``lib_ms`` is B1's
    yardstick, one library product of the same operands (f32: f32
    `torch.matmul`, TF32 off). ``product``: the tensor cores (`fused_wgmma`:
    s8, or TF32 in three passes)."""
    _, kern, tag_name, replaces = FLAVOURS[name]
    metric, q8, table, stats, valid = flavour_args(run, valid)
    k = MAIN["k"]
    args = (metric, q8, table, *scan.scan_aux(metric, q8, stats, valid))
    nq, (n, w) = q8.shape[0], table.shape
    tag = f"{kern.__name__} {label} Q={nq} N={n}"
    if kern is scan.binned_scan_lanes:
        call, plain = (lambda: kern(*args)), (lambda: scan.binned_scan_lanes_plain(*args))
        (pv, pi), plain_ms = plain_timed(plain)
        kv, ki = call()
        atol = tf32_atol(*args[:3]) if table.dtype == torch.float32 else FLOAT_ATOL
        err = hold_b1(tag, args, False, (kv.T, ki.T), (pv.T, pi.T), tag_name, atol)
        out_bytes = nq * (n // 128) * 8
    else:
        call, plain = (lambda: kern(*args, k)), (lambda: scan.fused_topk_plain(*args, k))
        want, plain_ms = plain_timed(plain)
        err = hold_probe(tag, args, call(), want, tag_name)
        out_bytes = nq * k * 8
    product = "wgmma tf32x3" if table.dtype == torch.float32 else "wgmma"
    ms = time_ms(call, 3)
    nbytes = (n + nq) * w * table.element_size() + 4 * (2 * n + nq) + out_bytes
    ops = 2.0 * nq * n * w
    b_ms, b_by = bound_ms(ops, PEAK_OPS[peak], nbytes)
    log(f"  {tag} W={w}: {ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; bytes alone {nbytes / PEAK_BYTES * 1e3:.3f} ms, "
        f"of them the output's {out_bytes / 1e9:.4f} GB {out_bytes / PEAK_BYTES * 1e3:.3f} ms)"
        f"{simt_bound(peak, ops, nbytes)}, plain {plain_ms:.1f} ms, library {lib_ms:.3f} ms (B1's product), "
        f"launches on its path {launches} (1 per search), product {product}, max abs err {err:.3g}")
    return dict(name=f"{kern.__name__}[{label} flat]", route="cuda", source="usearch_torch/csrc/fused.cu",
                replaces=replaces, launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, product=product)


def drive_micro() -> dict:
    """Phase 5, the paths: the `main` of each `python -m
    usearch_torch.microbench.<name>` at its script's shape, with the launch
    counters zeroed just before and read just after; it must launch its own
    kernel and no other. Returns the launches by module."""
    launches = {}
    for name, (main_fn, kern, _, _) in MICRO.items():
        log(f"  python -m usearch_torch.microbench.{name}:")
        zero_counters()
        main_fn()
        torch.cuda.synchronize()
        got = counters()
        check_launches(f"{name} micro-benchmark", got, kern.__name__)
        launches[name] = got[kern.__name__]
        log(f"  launches: {{'{kern.__name__}': {launches[name]}}}")
    return launches


def hold_equal(tag: str, name: str, kern, plain) -> float:
    """A micro-benchmark kernel's output against its plain version's, bit
    for bit. Fails on a mismatch; returns the max abs error (0)."""
    torch.cuda.synchronize()
    ok = kern.dtype == plain.dtype and torch.equal(kern, plain)
    err = float((kern.double() - plain.double()).abs().max())
    log(f"  {tag}: {name} vs plain {'ok, bit for bit' if ok else 'MISMATCH'} (max abs err {err:.3g})")
    if not ok:
        fail(f"{name} disagrees with its plain version at {tag}")
    return err


def plain_timed(fn):
    """One synchronised call of a plain version: its output and its ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def loop_route(m: int, k: int, n: int, mode: str) -> str:
    """B11's tensor-core route at a shape: the wgmma form and the blocks."""
    knw, wgs, slots, resident = microbench.loop_layout(m, k, n, mode, torch.cuda.get_device_properties(0).multi_processor_count)
    form = f"m64n{knw}k32 s8" if mode in ("i8", "i8f32") else f"m64n{knw}k16 bf16"
    lead = -(-k // (knw * wgs))
    return (f"wgmma {form}, {-(-m // 64) * n // (knw * wgs)} blocks of 64 x {knw * wgs}, {lead} lead block(s) a "
            f"row tile, {slots} A K-block slot(s), a0 in {'shared' if resident else 'device'} memory, no grid barrier")


def loop_rows(dev, launches: int) -> list:
    """Phase 5, B11: every mode at LOOP_CHECK's and LOOP_EDGES' shapes,
    then at the script's, bit for bit against the plain version; timed beside
    its bound (the products at the tensor cores' i8 or bf16 rate), the chain
    alone (`microbench.loop_chain`: the same steps and handshake, the product
    taken out) and one library product of the same operands times REPS
    (torch._int_mm in i8, torch.matmul in bf16)."""
    for m, k, n, reps in LOOP_CHECK + LOOP_EDGES:
        a8, b8 = i8_matmul_probe.operands((m, k), (n, k), SEED + m, dev)
        for _, mode, dtype in i8_matmul_probe.LOOP_LINES:
            a, b = a8.to(dtype), b8.to(dtype)
            plain = microbench.loop_matmul_plain(a, b, mode, reps)
            hold_equal(f"{mode} M={m} K={k} N={n} REPS={reps} (|acc| up to {float(plain.abs().max()):.4g})", "B11",
                       microbench.loop_matmul(a, b, mode, reps), plain)
    m, k, n, reps = i8_matmul_probe.M, i8_matmul_probe.K, i8_matmul_probe.N, i8_matmul_probe.REPS
    a8, b8 = i8_matmul_probe.operands((m, k), (n, k), SEED, dev)
    ops = 2.0 * m * k * n * reps
    rows = []
    for _, mode, dtype in i8_matmul_probe.LOOP_LINES:
        a, b = a8.to(dtype), b8.to(dtype)
        tag = f"loop_matmul {mode} M={m} K={k} N={n} REPS={reps}"
        plain, plain_ms = plain_timed(lambda: microbench.loop_matmul_plain(a, b, mode, reps))
        err = hold_equal(tag, "B11", microbench.loop_matmul(a, b, mode, reps), plain)
        ms = time_once(lambda: microbench.loop_matmul(a, b, mode, reps), dev, reps=5) * 1e3
        chain = time_once(lambda: microbench.loop_chain(a, b, mode, reps), dev, reps=5) * 1e3
        peak = "bf16" if mode in ("bf16", "cast") else "i8"
        nbytes = (m + n) * k * a.element_size() + m * n * 4
        b_ms, b_by = bound_ms(ops, PEAK_OPS[peak], nbytes)
        if peak == "i8":
            lib_name, lib = "torch._int_mm", time_once(lambda: torch._int_mm(a8, b8.t()), dev, reps=20) * 1e3 * reps
        else:
            ab, bb = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
            lib_name, lib = "bf16 torch.matmul", time_once(lambda: torch.matmul(ab, bb.t()), dev, reps=20) * 1e3 * reps
        log(f"  loop_chain {mode} M={m} K={k} N={n} REPS={reps}: {chain:.4f} ms, the product taken out "
            f"({chain / reps * 1e3:.3f} us a step)")
        log(f"  {tag}: {ms:.4f} ms = {ops / ms / 1e9:.1f} T(FL)OPS on {loop_route(m, k, n, mode)}; bound "
            f"{b_ms:.4f} ms ({b_by}, {peak} peak), chain alone {chain:.4f} ms, library {lib:.4f} ms ({lib_name} of "
            f"one product x {reps} = {ops / lib / 1e9:.1f} T(FL)OPS), plain {plain_ms:.1f} ms, launches on its "
            f"path {launches}, max abs err {err:.3g}")
        rows.append(dict(name=f"loop_matmul[{mode}]", route="cuda", source=MICRO["i8_matmul_probe"][2],
                         replaces=MICRO["i8_matmul_probe"][3], launches=launches, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib, chain_ms=chain))
    return rows


def hold_select(tag: str, variant: str, kern, plain) -> float:
    """B12's output against its plain version's: bit for bit, the two f32
    sums of group minima within SELECT_RTOL relative. Fails on a mismatch;
    returns the max abs error."""
    torch.cuda.synchronize()
    if variant in SELECT_F32_SUMS:
        ok = torch.allclose(kern, plain, rtol=SELECT_RTOL, atol=0)
        detail = f"within {SELECT_RTOL} relative"
    else:
        ok, detail = torch.equal(kern, plain), "bit for bit"
    err = float((kern - plain).abs().max())
    log(f"  {tag}: B12 vs plain {'ok, ' + detail if ok else 'MISMATCH'} (max abs err {err:.3g})")
    if not ok:
        fail(f"B12 disagrees with its plain version at {tag}")
    return err


def select_rows(dev, launches: int) -> list:
    """Phase 5, B12: every variant at SELECT_CHECK's shapes (the last the
    script's), against the plain version; timed at IT and 2 IT passes,
    whose times per pass must agree within PASS_STEADY (no pass is dropped
    or merged), beside the bound of the IT-pass call, that bound a pass and
    the grid's blocks (G/32 column groups times the pass groups: enough to
    fill the card, 1 and 8 for astype_only and pack_only). A call's time
    holds the wrapper's zero fill of the output; the time a pass takes it
    out. No one PyTorch call computes a selection loop."""
    w, g, it = select_microbench.W, select_microbench.G, select_microbench.IT
    rows = []
    for variant in microbench.SELECT_VARIANTS:
        for cw, cg, cit in SELECT_CHECK:
            x = select_microbench.buffer(cw, cg, SEED + cw, dev)
            err = hold_select(f"{variant} W={cw} G={cg} IT={cit}", variant, microbench.select_loop(x, variant, cit),
                              microbench.select_loop_plain(x, variant, cit))
        x = select_microbench.buffer(w, g, SEED, dev)
        ms1, ms, ms2 = (time_once(lambda: microbench.select_loop(x, variant, n), dev, reps=20) * 1e3
                         for n in (1, it, 2 * it))
        per_pass, per_pass2 = (ms - ms1) / (it - 1), (ms2 - ms1) / (2 * it - 1)
        steady = abs(per_pass2 - per_pass) / per_pass
        _, plain_ms = plain_timed(lambda: microbench.select_loop_plain(x, variant, it))
        rows_of, per_element = SELECT_OPS[variant]
        ops = float(it) * rows_of(w) * g * per_element
        b_ms, b_by = bound_ms(ops, PEAK_OPS["f32"], (w + 8) * g * 4)
        blocks, bound_pass = microbench.select_blocks(g, variant, dev), b_ms / it
        log(f"  select_loop {variant} W={w} G={g}: {blocks} blocks, {ms:.4f} ms for {it} passes with the wrapper's "
            f"zero fill of the output ({ms / it * 1e3:.3f} us/pass as the script counts), one pass "
            f"{per_pass * 1e3:.4f} us at {it} and {per_pass2 * 1e3:.4f} us at {2 * it} ({steady:.1%} apart; a 1-pass "
            f"launch {ms1 * 1e3:.2f} us) against a bound of {bound_pass * 1e3:.5f} us a pass ({b_by}; "
            f"{per_pass / bound_pass:.2f}x), bound {b_ms:.5f} ms for the {it}-pass launch, plain {plain_ms:.1f} ms, "
            f"library none, launches on its path {launches}, max abs err {err:.3g}")
        if not per_pass > 0 or steady > PASS_STEADY:
            fail(f"B12 {variant}: the time per pass at {it} and {2 * it} passes is {steady:.1%} apart")
        rows.append(dict(name=f"select_loop[{variant}]", route="cuda", source=MICRO["select_microbench"][2],
                         replaces=MICRO["select_microbench"][3], launches=launches, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         us_per_pass=per_pass * 1e3, bound_us_per_pass=bound_pass * 1e3,
                         per_pass_over_bound=per_pass / bound_pass, blocks=blocks,
                         ms_holds="the wrapper's zero fill of the [8, G] output"))
    return rows


def bisect_cases(lay, dev):
    """A layout's table and its second build's arrays, on the card."""
    table = lay.table(SEED, dev)
    rng = np.random.default_rng(SEED)
    lay.build(1, rng)
    q_g, qa, meta, windows = lay.build(2, rng)
    return table, [torch.from_numpy(x).to(dev) for x in (meta, q_g, qa)], windows


def bisect_edges(small, table, meta, q_g, qa, dev) -> None:
    """B13 at BISECT_EDGES on BISECT_CHECK's arrays, every variant from
    MASKED and from 0, bit for bit against the plain version."""
    meta, qa = meta.clone(), qa.clone()
    n_rows = table.shape[0]
    meta[0, 0, 1] = n_rows - min(BISECT_EDGES["w_pads"]) + 1  # past the end at every w_pad
    meta[0, 0, 3] = -5
    qa[: len(BISECT_EDGES["own"]), 2] = torch.tensor(BISECT_EDGES["own"], dtype=qa.dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    starts = meta[:, 0][torch.arange(probe_v2_bisect.G, device=dev)[None, :] < meta[:, 3, :1]]
    starts = starts[(starts >= 0) & (starts < n_rows - 64)].long()
    for width in BISECT_EDGES["widths"]:
        if width == table.shape[1]:
            tw, qw = table.clone(), q_g
        else:
            tw = torch.randint(-127, 128, (n_rows, width), generator=gen, device=dev, dtype=torch.int8)
            qw = torch.randint(-127, 128, (q_g.shape[0], width), generator=gen, device=dev, dtype=torch.int8)
        for off in BISECT_EDGES["offsets"]:
            tw[starts + off] = tw[starts]
        for w_pad in BISECT_EDGES["w_pads"]:
            for v in microbench.BISECT_VARIANTS:
                for init in (MASKED, 0.0):
                    args = (meta, qw, qa, tw, v, w_pad, small.out_pad, init)
                    hold_equal(f"{v} init={init:g} width={width} w_pad={w_pad} planted", "B13",
                               microbench.bisect_probe(*args), microbench.bisect_probe_plain(*args))


def bisect_rows(dev, launches: int) -> list:
    """Phase 5, B13: every variant, and dot_only from init 0 (from MASKED
    every entry stays MASKED), on BISECT_CHECK's 64-partition table and at
    BISECT_EDGES, then at the script's shape, bit for bit against the plain
    version; timed beside its bound: the table rows the windows touch read
    once, the queries and aux, the output written once; operations for the
    dots the output needs (rows 0-7 of every window for every lane in
    dot_only, each lane's own window otherwise); and each select's time
    beside dot_only's, their difference the select's cost on the tensor-core
    kernel's register layout. No one PyTorch call computes it."""
    small = probe_v2_bisect.Layout(**BISECT_CHECK)
    table, (meta, q_g, qa), _ = bisect_cases(small, dev)
    cases = [(v, MASKED) for v in microbench.BISECT_VARIANTS] + [("dot_only", 0.0)]
    for v, init in cases:
        args = (meta, q_g, qa, table, v, small.w_pad, small.out_pad, init)
        hold_equal(f"{v} init={init:g} C={small.c} P={q_g.shape[0]} w_pad={small.w_pad}", "B13",
                   microbench.bisect_probe(*args), microbench.bisect_probe_plain(*args))
    bisect_edges(small, table, meta, q_g, qa, dev)
    lay = probe_v2_bisect.script_layout()
    table, (meta, q_g, qa), windows = bisect_cases(lay, dev)
    starts = meta[:, 0][torch.arange(probe_v2_bisect.G, device=dev)[None, :] < meta[:, 3, :1]]
    edges = torch.zeros(lay.cap2 + 1, dtype=torch.int32, device=dev)
    edges.index_add_(0, starts.long(), torch.ones_like(starts))
    edges.index_add_(0, starts.long() + lay.w_pad, -torch.ones_like(starts))
    touched = int((torch.cumsum(edges, 0)[:-1] > 0).sum())
    n_pairs, d = q_g.shape
    nbytes = touched * d + n_pairs * (d + 8 * 4 + lay.out_pad * 4) + meta.numel() * 4
    rows = []
    for v, init in cases:
        args = (meta, q_g, qa, table, v, lay.w_pad, lay.out_pad, init)
        tag = f"bisect_probe {v} init={init:g} N={lay.cap2} Q={lay.q} NPROBE={lay.nprobe} windows={windows}"
        plain, plain_ms = plain_timed(lambda: microbench.bisect_probe_plain(*args))
        err = hold_equal(tag, "B13", microbench.bisect_probe(*args), plain)
        if init != MASKED:
            continue  # a check only: the benchmark and the row start from MASKED
        ms = time_once(lambda: microbench.bisect_probe(*args), dev, reps=3) * 1e3
        ops = 2.0 * d * (windows * 8 * probe_v2_bisect.G if v == "dot_only" else n_pairs * lay.w_pad)
        b_ms, b_by = bound_ms(ops, PEAK_OPS["i8"], nbytes)
        dot_ms = rows[0]["ms"] if rows else ms
        log(f"  {tag}: {ms:.3f} ms = {ms / windows * 1e3:.3f} us/window on wgmma m64n128k32 s8 (one cell a block), "
            f"{ms - dot_ms:+.4f} ms beside dot_only, bound {b_ms:.4f} ms ({b_by}; {touched} table rows touched, "
            f"{nbytes / 1e9:.3f} GB), plain {plain_ms:.1f} ms, library none, launches on its path {launches}, max "
            f"abs err {err:.3g}")
        rows.append(dict(name=f"bisect_probe[{v}]", route="cuda", source=MICRO["probe_v2_bisect"][2],
                         replaces=MICRO["probe_v2_bisect"][3], launches=launches, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         us_per_window=ms / windows * 1e3, minus_dot_only_ms=ms - dot_ms))
    return rows


def tail_rows(name: str, gen, dev):
    """(index arguments, rows on the card, queries) of a metric of the
    tail at TAIL's sizes; the queries are member rows, for haversine moved
    by ~0.1 degree, for the user-defined metric by 0.05 noise."""
    spec, nq = TAIL, TAIL["q"]
    if name == "haversine":
        n = spec["hav_n"]
        x = torch.stack([torch.rand(n, generator=gen, device=dev) * 120 - 60,
                         torch.rand(n, generator=gen, device=dev) * 340 - 170], 1)
        q = x[:nq] + 0.1 * torch.randn(nq, 2, generator=gen, device=dev)
        return dict(metric="haversine", dtype="f32"), x, q
    if name == "divergence":
        n, w = spec["div_n"], spec["div_w"]
        anchors = torch.as_tensor(np.random.default_rng(SEED).dirichlet(np.full(w, 0.3), spec["div_anchors"]),
                                  dtype=torch.float32, device=dev)
        pick = torch.randint(0, spec["div_anchors"], (n,), generator=gen, device=dev)
        x = anchors[pick] * (0.7 + 0.6 * torch.rand(n, w, generator=gen, device=dev))
        x = x / x.sum(1, keepdim=True)
        return dict(ndim=w, metric="divergence", dtype="f32"), x, x[:nq]
    if name == "jaccard":
        n, ids, t = spec["set_n"], spec["set_ids"], spec["set_templates"]
        templates = torch.randint(0, spec["set_universe"], (t, ids), generator=gen, device=dev, dtype=torch.int32)
        rows = templates[torch.randint(0, t, (n,), generator=gen, device=dev)]
        rows = torch.where(torch.rand(n, ids, generator=gen, device=dev) < spec["set_keep"], rows, -1)
        extra = torch.randint(0, spec["set_universe"], (n, spec["set_extra"]), generator=gen, device=dev,
                              dtype=torch.int32)
        rows = torch.cat([rows, extra], 1)
        # sorted, repeats dropped, padding (-1) last
        big = torch.iinfo(torch.int32).max
        srt = torch.where(rows < 0, big, rows).sort(1).values
        srt[:, 1:][srt[:, 1:] == srt[:, :-1]] = big
        srt = srt.sort(1).values
        x = torch.where(srt == big, -1, srt)
        return dict(ndim=x.shape[1], metric="jaccard"), x, x[:nq]
    n, w = spec["udf_n"], spec["udf_w"]
    anchors = 3 * torch.randn(spec["udf_anchors"], w, generator=gen, device=dev)
    x = anchors[torch.randint(0, spec["udf_anchors"], (n,), generator=gen, device=dev)]
    x = x + torch.randn(n, w, generator=gen, device=dev)
    weights = torch.linspace(0.5, 2.0, w, device=dev)
    metric = CompiledMetric(lambda a, b: (weights * (a - b).abs()).sum())
    return dict(ndim=w, metric=metric, dtype="f32"), x, x[:nq] + 0.05 * torch.randn(nq, w, generator=gen, device=dev)


def timed(fn):
    """``fn()`` synchronised: (its result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_tail_metric(name: str, gen, dev, card: str) -> dict:
    """Phase 3 (h), one metric of the tail: add on the card, exact search
    (the ground truth of `gt_q` queries), `optimize`, the probed search of
    `q` queries (recall@10 against the exact answer at its bar; for the
    user-defined metric its distances against the metric itself), each
    piece timed, and a profile of the probed search."""
    spec, k = TAIL, TAIL["k"]
    kwargs, x, q = tail_rows(name, gen, dev)
    index = Index(device=dev, **kwargs)
    _, add_s = timed(lambda: index.add(None, x))
    gq = spec["gt_q"]
    exact, exact_s = timed(lambda: index.search(q[:gq], k, exact=True))
    _, build_s = timed(lambda: index.optimize(n_partitions=spec["partitions"][name]))
    index.expansion_search = spec["expansion"][name]
    nprobe = index._ivf.nprobe_for(index.expansion_search, index.connectivity)
    index.search(q[gq : 2 * gq], k)  # warm, on other queries
    m, probe_s = timed(lambda: index.search(q, k))
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(m.keys[:gq].tolist(), exact.keys.tolist())]))
    log(f"  {name} {x.shape[0]} x {index.ndim}: add {add_s:.2f} s, exact search of {gq} queries {exact_s:.2f} s, "
        f"optimize({spec['partitions'][name]}) {build_s:.2f} s, probed search of {q.shape[0]} queries at nprobe "
        f"{nprobe} {probe_s * 1e3:.1f} ms = {q.shape[0] / probe_s:.0f} QPS, scanned rows per query "
        f"{index._ivf.scanned_rows(index.expansion_search, index.connectivity)}, recall@10 {recall:.4f}; {card}")
    if m.keys.shape != (q.shape[0], k) or not np.all(np.isfinite(m.distances)):
        fail(f"{name}: probed search gave {m.keys.shape} or non-finite distances")
    if name in spec["bars"] and recall < spec["bars"][name]:
        fail(f"{name}: probed recall@10 {recall:.4f} below {spec['bars'][name]}")
    if name == "udf":
        got = torch.as_tensor(m.distances, device=dev)
        rows = x[torch.as_tensor(m.keys.astype(np.int64), device=dev)]
        weights = torch.linspace(0.5, 2.0, x.shape[1], device=dev)
        want = (weights * (q[:, None, :] - rows).abs()).sum(-1)
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-12)).max())
        log(f"  udf: probed distances within {rel:.2e} relative of the metric (bar {spec['udf_rtol']}), "
            f"recall@10 against its exact search {recall:.4f}")
        if rel > spec["udf_rtol"]:
            fail(f"udf: probed distances {rel:.2e} relative off the metric")
    profile_search(index, q, k, exact=False, label=f"{name} probed")
    return dict(recall=recall, add_s=add_s, exact_s=exact_s, build_s=build_s, probe_s=probe_s, nprobe=nprobe)


def drive_f64(gen, dev, card: str) -> None:
    """Phase 3 (h), f64 storage: `get` gives the rows back bit for bit; the
    f64 index searches as the JAX package's does, through the plain scan
    (the kernels take f32): its exact search equals the f32 index's of the
    same rows (B2 and its rescore) within FLOAT_RTOL and an atol of
    FLOAT_ATOL + 4 W 2**-24 max(q_sq + t_sq), the bound of two f32 sums of
    W products in different orders on l2sq's three terms, keys apart from
    near ties; its approximate search (bf16-rounded tile minima) finds the
    queries' own rows (recall@1 >= 0.99; recall@10 against the exact answer
    printed: bf16 ties the far neighbours)."""
    n, w, k = TAIL["f64_n"], TAIL["f64_w"], TAIL["k"]
    x = torch.randn(n, w, generator=gen, device=dev, dtype=torch.float64)
    f64 = Index(ndim=w, metric="l2sq", dtype="f64", device=dev)
    _, add_s = timed(lambda: f64.add(None, x))
    f32 = Index(ndim=w, metric="l2sq", dtype="f32", device=dev)
    f32.add(None, x.float())
    keys = torch.randperm(n, generator=gen, device=dev)[: TAIL["q"]]
    got, get_s = timed(lambda: f64.get(keys.cpu().numpy(), "f64"))
    if got.dtype != np.float64 or not np.array_equal(got, x[keys].cpu().numpy()):
        fail("f64: get() did not give the rows back bit for bit")
    q = (x[keys] + 0.01 * torch.randn(keys.shape[0], w, generator=gen, device=dev, dtype=torch.float64)).float()
    exact, exact_s = timed(lambda: f64.search(q, k, exact=True))
    want = f32.search(q, k, exact=True)
    sq = x.float().pow(2).sum(1)
    atol = FLOAT_ATOL + 4 * w * 2.0**-24 * float(sq.max() + sq[keys].max())
    diff = float(np.abs(exact.distances - want.distances).max())
    if not searches_agree(exact, want, atol):
        fail(f"f64: the exact search differs from the f32 index's by {diff:.3g} (atol {atol:.3g})")
    approx, approx_s = timed(lambda: f64.search(q, k))
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(approx.keys.tolist(), exact.keys.tolist())]))
    recall1 = float(np.mean(approx.keys[:, 0] == keys.cpu().numpy()))
    log(f"  f64 {n} x {w}: add {add_s:.2f} s, get of {keys.shape[0]} keys {get_s * 1e3:.1f} ms bit for bit; exact "
        f"search of {q.shape[0]} queries {exact_s * 1e3:.1f} ms, the f32 index's within {diff:.3g} (atol "
        f"{atol:.3g}), keys {float(np.mean(exact.keys == want.keys)):.4f} equal; approximate {approx_s * 1e3:.1f} ms, recall@1 {recall1:.4f}, recall@10 against exact "
        f"{recall:.4f}; {card}")
    if recall1 < 0.99:
        fail(f"f64: approximate recall@1 {recall1:.4f}")


def drive_metric_tail(dev, ivf_run: dict, card: str) -> None:
    """Phase 3 (h): the metric tail, f64, `cluster` and `join`."""
    t_step = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    for name in ("haversine", "divergence", "jaccard", "udf"):
        drive_tail_metric(name, gen, dev, card)
    drive_f64(gen, dev, card)

    women = ivf_run["index"]
    lo, hi = TAIL["cluster"]
    clustering, cluster_s = timed(lambda: women.cluster(min_count=lo, max_count=hi))
    _, sizes = clustering.centroids_popularity
    log(f"  cluster() of {len(women)} rows of the IVF path's index: {len(sizes)} clusters (bounds [{lo}, {hi}]), "
        f"largest {int(sizes.max())}, {cluster_s:.2f} s; {card}")
    if not lo <= len(sizes) <= hi or int(sizes.sum()) != len(women):
        fail(f"cluster(): {len(sizes)} clusters of {int(sizes.sum())} members")

    nj = TAIL["join_n"]
    src = ivf_run["queries"][:nj]
    rows = src + TAIL["join_noise"] * torch.randn(src.shape, generator=gen, device=dev)
    rows = rows / rows.norm(dim=1, keepdim=True)
    men = Index(ndim=women.ndim, metric="ip", dtype="i8", device=dev)
    men_keys = men.add(np.arange(nj, dtype=np.uint64) + 10**9, rows)
    source = dict(zip(men_keys.tolist(), ivf_run["want"][:nj].tolist()))
    for exact, kerns in ((True, ("binned_minima", "block_dots")), (False, ("grouped_probe",))):
        zero_counters()
        pairs, join_s = timed(lambda: men.join(women, max_proposals=TAIL["proposals"], exact=exact))
        launches = counters()
        matched = len(pairs) / nj
        own = sum(source[a] == b for a, b in pairs.items()) / nj
        log(f"  join of {nj} perturbed member rows against the IVF path's index, {'exact' if exact else 'probed'}, "
            f"max_proposals {TAIL['proposals']}: {join_s:.2f} s, men matched {matched:.4f}, to their own row "
            f"{own:.4f}; launches {launches}; {card}")
        if not all(launches[kern] for kern in kerns):
            fail(f"join (exact={exact}) did not launch {kerns}: {launches}")
        if len(set(pairs.values())) != len(pairs) or matched < 0.9:
            fail(f"join (exact={exact}): {matched:.4f} matched, one to one {len(set(pairs.values())) == len(pairs)}")
    log(f"  step (h) {time.perf_counter() - t_step:.1f} s; {card}")


def sharded_plain_probe(pool, queries, k: int, expansion: int):
    """``pool``'s probed search (its eager bodies, `sharded_eager_search`)
    with B3's plain version bound in the kernel's place: the matches and each shard's probe arguments; fails if
    a probe kernel launched or a shard did not probe once."""
    calls = []

    def plain(*args):
        calls.append(args)
        return probe.grouped_probe_plain(*args)

    before = [kern.launches for kern in PROBE_KERNELS]
    ivf.grouped_probe = plain
    try:
        m = sharded_eager_search(pool, queries, k, expansion=expansion)
    finally:
        ivf.grouped_probe = probe.grouped_probe
    if [kern.launches for kern in PROBE_KERNELS] != before or len(calls) != len(pool.mesh.devices):
        fail(f"the sharded plain-probe search launched a probe kernel or probed {len(calls)} times")
    return m, calls


def only_launched(label: str, launches: dict, want: dict) -> None:
    """Each kernel of ``want`` launched as often as it says, and no other
    kernel did."""
    if any(launches[name] != times for name, times in want.items()) or any(
            launches[name] for name in set(launches) - set(want)):
        fail(f"{label}: the launches {launches} are not {want} alone")


def exact_launches(times: int) -> dict:
    """An exact search's kernels, each launched ``times`` times (a shard or
    a tile each): B2 and the rescore's dots."""
    return {"binned_minima": times, "block_dots": times}


def group_search(x, qx, want, spec, card: str) -> None:
    """Phase 3 (i): a process group of one over NCCL
    (`distributed_initialize`, tcp://127.0.0.1 at a free port), the pool
    built again on a mesh merging over it, its exact search through the
    all-gather equal bit for bit to ``want`` (the search without a group)
    and the host syncs inside it; the group destroyed."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    distributed_initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0,
                           timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(spec["shards"])
        if mesh.group is None or dist.get_backend(mesh.group) != "nccl":
            fail(f"the mesh does not merge over the NCCL group: {mesh}")
        pool = sharded.ShardedIndex.build(x, metric="ip", dtype="i8", mesh=mesh)
        q, _ = pool._queries(qx)
        pool.search(qx, spec["k"], exact=True)  # warm: NCCL's first collective sets up its communicator
        zero_counters()
        got, search_s = timed(lambda: pool.search(qx, spec["k"], exact=True))
        only_launched("the group's exact search", counters(), exact_launches(spec["shards"]))
        sites, _ = sync_sites(lambda: pool._search_prepared(q, spec["k"], True, spec["expansion"]))
        if not same_search(got, want):
            fail(f"the search through the all-gather differs at {int((got.keys != want.keys).sum())} places")
        log(f"  a group of one over NCCL ({mesh}): the exact search of {qx.shape[0]} queries through the "
            f"all-gather {search_s * 1e3:.1f} ms, equal bit for bit to the search without a group; host syncs "
            f"inside it before the read-back: {len(sites)} {sorted(set(sites))}; {time.perf_counter() - t0:.1f} s "
            f"with the group's setup ({card})")
    finally:
        dist.destroy_process_group()


def drive_sharded(dev, card: str) -> dict:
    """Phase 3 (i), the sharded index (SHARDED), each piece timed: build on
    `make_mesh(4)`, the exact search of member queries (B2 and the rescore
    once a shard and no other kernel, keys equal to a single-device `Index.search(exact=True)`
    over the same rows apart from ties), `optimize` per shard, the probed
    search of member queries (B3 once a shard and no other kernel, recall@1
    >= 0.99, recall@10 against the exact answer beside the plain core's,
    ``PROBE_MODE = "xla"``; equal to the search through B3's plain
    version), the host syncs of one search; fresh rows found through B2 and
    the rescore,
    1% of the keys removed and never returned, `optimize` again, save and
    load, the loaded pool searching bit for bit as the saved one; then the
    search through a process group (`group_search`)."""
    t_step = time.perf_counter()
    spec = SHARDED
    n, w, k, shards, e = spec["n"], spec["w"], spec["k"], spec["shards"], spec["expansion"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    x = unit_rows(n, w, gen, dev)
    pool, build_s = timed(lambda: sharded.ShardedIndex.build(x, metric="ip", dtype="i8", mesh=make_mesh(shards)))
    if pool._per != n // shards or len(pool) != n:
        fail(f"the sharded build holds {len(pool)} rows in shards of {pool._per}")
    member = torch.randperm(n, generator=gen, device=dev)[: spec["q"]]
    want = member.cpu().numpy().astype(np.uint64)
    qx = x[member[: spec["exact_q"]]]
    pool.search(qx, k, exact=True)  # warm
    zero_counters()
    exact, exact_s = timed(lambda: pool.search(qx, k, exact=True))
    exact_counts = counters()
    only_launched("the sharded exact search", exact_counts, exact_launches(shards))
    single = Index(ndim=w, metric="ip", dtype="i8", device=dev)
    single.add(None, x)
    single.search(qx, k, exact=True)  # warm
    one, one_s = timed(lambda: single.search(qx, k, exact=True))
    if not ties_aside(exact, one):
        fail("the sharded exact search differs from the single-device exact search beyond ties")
    log(f"  sharded i8 ip {n} x {w} on {pool.mesh}: build {build_s:.2f} s; exact search of {qx.shape[0]} member "
        f"queries {exact_s * 1e3:.1f} ms (single-device {one_s * 1e3:.1f} ms), equal to the single-device "
        f"`search(exact=True)` apart from ties, recall@1 {np.mean(exact.keys[:, 0] == want[: qx.shape[0]]):.4f}; "
        f"launches {exact_counts}")

    _, opt_s = timed(lambda: pool.optimize(n_partitions=spec["partitions"]))
    iv = pool._ivf
    nprobe = pool.nprobe_for(e)
    queries = x[member]
    pool.search(x[torch.randperm(n, generator=gen, device=dev)[: spec["q"]]], k, expansion_search=e)  # warm
    zero_counters()
    m, probe_s = timed(lambda: pool.search(queries, k, expansion_search=e))
    probe_launches = counters()
    only_launched("the sharded probed search", probe_launches, {"grouped_probe": shards})
    gt = pool.search(qx, k, exact=True)
    recall1, recall10 = recall_at(m, want, gt.keys, k)
    ivf.PROBE_MODE = "xla"
    try:
        mx, xla_s = timed(lambda: pool.search(qx, k, expansion_search=e))
    finally:
        ivf.PROBE_MODE = "group"
    _, xla10 = recall_at(mx, want[: qx.shape[0]], gt.keys, k)
    log(f"  optimize({spec['partitions']} per shard) {opt_s:.2f} s: {iv['c_max']} chunks a shard at most, longest "
        f"{iv['p_win']} rows, {iv['avg_rows']:.1f} rows a chunk on average; probed search of {queries.shape[0]} "
        f"member queries at nprobe {nprobe} a shard {probe_s * 1e3:.1f} ms = {queries.shape[0] / probe_s:.0f} QPS, "
        f"recall@1 {recall1:.4f}, recall@10 against the exact answer ({qx.shape[0]} queries) {recall10:.4f}, the "
        f"plain core's (PROBE_MODE xla, {xla_s:.2f} s) {xla10:.4f}; launches {probe_launches}")
    if not np.all(np.isfinite(m.distances)) or m.keys.shape != (queries.shape[0], k) or recall1 < 0.99:
        fail(f"sharded probed search: recall@1 {recall1:.4f}")
    mp, calls = sharded_plain_probe(pool, queries, k, e)
    if not same_search(mp, m):
        fail(f"the sharded search through B3's plain version differs at {int((mp.keys != m.keys).sum())} places")
    log(f"  the same search through B3's plain version: keys and distances equal ({calls[0][1].shape[0]} padded "
        f"pairs a shard, k {calls[0][8]}, {calls[0][9]} per bin)")
    q8, _ = pool._queries(queries)
    probe_sites, _ = sync_sites(lambda: pool._search_prepared(q8, k, False, e))
    read_sites, _ = sync_sites(lambda: pool.search(queries, k, expansion_search=e))
    log(f"  host syncs inside one probed search: {len(probe_sites)} {sorted(set(probe_sites))} before the "
        f"read-back, {len(read_sites)} {sorted(set(read_sites))} with it")

    t0 = time.perf_counter()
    new = unit_rows(spec["fresh"], w, gen, dev)
    pool.add(None, new)
    new_keys = np.arange(n, n + spec["fresh"], dtype=np.uint64)
    zero_counters()
    mf = pool.search(new, k)
    fresh_launches = counters()
    only_launched("the search after the adds", fresh_launches, exact_launches(shards))
    found = float(np.mean([key in row for key, row in zip(new_keys.tolist(), mf.keys.tolist())]))
    if pool._ivf is not None or found < 1.0:
        fail(f"after the adds: IVF dropped {pool._ivf is None}, fresh rows found {found:.4f}")
    gone = torch.randperm(n, generator=gen, device=dev)[: int(n * spec["removed"])].cpu().numpy().astype(np.uint64)
    removed = pool.remove(gone)
    probe_q = x[torch.as_tensor(gone[: spec["exact_q"]].astype(np.int64), device=dev)]
    hits = int(np.isin(pool.search(probe_q, k).keys, gone).sum())
    _, reopt_s = timed(lambda: pool.optimize(n_partitions=spec["partitions"]))
    hits += int(np.isin(pool.search(probe_q, k, expansion_search=e).keys, gone).sum())
    mut_s = time.perf_counter() - t0
    if hits or removed != len(gone) or len(pool) != n + spec["fresh"] - len(gone):
        fail(f"after the removals: {hits} removed keys came back, {removed} removed, {len(pool)} live")
    log(f"  {spec['fresh']} rows added: found through B2 and the rescore ({found:.4f} as members, launches {fresh_launches}); "
        f"{removed} keys removed: none comes back, exactly or probed after `optimize` again ({reopt_s:.2f} s); "
        f"{mut_s:.2f} s")

    saved = pool.search(queries, k, expansion_search=e)
    with tempfile.TemporaryDirectory() as tmp:
        directory = os.path.join(tmp, "pool")
        _, save_s = timed(lambda: pool.save(directory))
        loaded, load_s = timed(lambda: sharded.ShardedIndex.load(directory, mesh=make_mesh(shards)))
    got = loaded.search(queries, k, expansion_search=e)
    if loaded._ivf is None or not same_search(got, saved):
        fail(f"the loaded pool searches other than the saved one at {int((got.keys != saved.keys).sum())} places")
    log(f"  saved in {save_s:.2f} s, loaded in {load_s:.2f} s with its IVF: the probed search equal bit for bit")

    group_search(x, qx, exact, spec, card)
    log(f"  step (i) {time.perf_counter() - t_step:.1f} s; {card}")
    return dict(single=single, qx=qx, queries=queries, exact_launches=exact_counts, probe_launches=probe_launches,
                pool=pool)


def c_call(lib, name: str, *args):
    """``name(*args, &error)`` of the C library; a set error fails the run."""
    err = ctypes.c_char_p(None)
    out = getattr(lib, name)(*args, ctypes.byref(err))
    if err.value is not None:
        fail(f"{name}: {err.value.decode()}")
    return out


def c_search(lib, handle, queries: np.ndarray, kind: int, k: int, allowed=None):
    """One C search per query row: keys, distances, each call's seconds."""
    n = queries.shape[0]
    keys, dists, secs = np.zeros((n, k), np.uint64), np.zeros((n, k), np.float32), np.zeros(n)
    kp, dp = ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_float)
    for i in range(n):
        t0 = time.perf_counter()
        if allowed is None:
            got = c_call(lib, "usearch_search", handle, queries[i].ctypes.data, kind, k, keys[i].ctypes.data_as(kp),
                         dists[i].ctypes.data_as(dp))
        else:
            got = c_call(lib, "usearch_filtered_search", handle, queries[i].ctypes.data, kind, k,
                         allowed.ctypes.data_as(kp), len(allowed), keys[i].ctypes.data_as(kp),
                         dists[i].ctypes.data_as(dp))
        secs[i] = time.perf_counter() - t0
        if got != k:
            fail(f"a C search returned {got} matches, not {k}")
    return keys, dists, secs


def us(secs) -> str:
    p50, p99 = np.percentile(np.asarray(secs) * 1e6, [50, 99])
    return f"median {p50:.1f} us, p99 {p99:.1f} us"


def run_c_programs() -> dict:
    """The port's test.c and test.cpp built over the library and run as
    programs on the card (no USEARCH_TORCH_DEVICE), both at once, each
    within CABI["timeout"]: exit codes, outputs, seconds. Phase 1 runs this
    on a thread while nvcc builds the kernels (the programs need none of
    them); step (j) reads the result."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cabi_programs_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        cabi.build()
        lib_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        progs = {name: cabi.build_program(cabi.SRC_DIR / name, tmp / name.replace(".", "_"))
                 for name in ("test.c", "test.cpp")}
        build_s = time.perf_counter() - t0
        env = dict(os.environ)
        env.pop("USEARCH_TORCH_DEVICE", None)
        root = str(Path(__file__).resolve().parent)
        site = [p for p in sys.path if p.endswith(("site-packages", "dist-packages"))]
        env["PYTHONPATH"] = os.pathsep.join([root, *site])
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen([str(exe), str(tmp / f"{name}.usearch")], env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True) for name, exe in progs.items()}
        out = {}
        try:
            for name, proc in procs.items():
                try:
                    text, _ = proc.communicate(timeout=CABI["timeout"])
                except subprocess.TimeoutExpired:
                    fail(f"{name} did not finish within {CABI['timeout']} s")
                out[name] = (proc.returncode, text.strip())
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return dict(out=out, lib_s=lib_s, build_s=build_s, run_s=time.perf_counter() - t0)


def drive_cabi(dev, ivf_run: dict, card: str, programs) -> None:
    """Phase 3 (j), the C ABI (`usearch_torch.cabi`, CABI): libusearch_torch.so
    built (g++) and loaded into this process through ctypes, its helper on
    the card (no USEARCH_TORCH_DEVICE). The IVF path's i8 index saved to a
    file: `usearch_metadata` (ip, i8, 256), `usearch_init`, `usearch_load`,
    `usearch_change_expansion_search`; one-query `usearch_search` calls of
    live member queries, each equal bit for bit to `Index.search` of the
    query on the same file restored in Python (recall@1 >= 0.99), B3 once a
    call and no other kernel (counters zeroed just before, read just after),
    their times beside the Python one-query search's and a call that
    searches nothing (`usearch_size`); filtered searches against 10% of the
    keys equal to `Index.search(filter=...)`; `usearch_view` of the file
    searching as the loaded handle; `usearch_get` in i8 and f32 equal to
    `Index.get`; 1% of the keys removed one call each, none coming back.
    `usearch_exact_search` over bench.py's 1M x 256 i8 rows in host memory
    with 16,384 member queries equal to `exact_search` (distances bit for
    bit, keys apart from ties), the kernels it launched and its upload
    share; 4,096 one-row `usearch_add` calls into a fresh i8 ip index, every
    row found by an exact search; and the port's test.c and test.cpp as
    programs on the card, each exiting 0 (``programs``: the future of
    `run_c_programs`, started in phase 1)."""
    t_step = time.perf_counter()
    t0 = time.perf_counter()
    lib = cabi.library()
    load_lib_s = time.perf_counter() - t0
    kinds, metrics = cabi.SCALARS, cabi.METRICS
    k, e, tmp = CABI["k"], CABI["expansion"], Path(tempfile.mkdtemp(prefix="chip_smoke_cabi_"))
    try:
        progs = programs.result()
        log(f"  libusearch_torch.so built (g++) in {progs['lib_s']:.2f} s in phase 1, loaded in {load_lib_s:.2f} s; "
            f"test.c and test.cpp built in {progs['build_s']:.2f} s and run at once on the card in "
            f"{progs['run_s']:.1f} s, during the kernels' build:")
        for name, (rc, text) in progs["out"].items():
            log(f"    {name}: exit {rc}: {text[-300:]}")
            if rc != 0:
                fail(f"the port's {name} exited {rc} on the card")
        if "NVIDIA" not in progs["out"]["test.c"][1]:
            fail("test.c did not run on the card")

        index, gen = ivf_run["index"], np.random.default_rng(SEED + 31)
        path = tmp / "ivf.usearch"
        index.save(str(path))
        opts = cabi.InitOptions()
        c_call(lib, "usearch_metadata", str(path).encode(), ctypes.byref(opts))
        if (opts.metric_kind, opts.quantization, opts.dimensions) != (metrics["ip"], kinds["i8"], IVF["w"]):
            fail(f"usearch_metadata: {(opts.metric_kind, opts.quantization, opts.dimensions)}")
        handle = c_call(lib, "usearch_init", ctypes.byref(opts))
        t0 = time.perf_counter()
        c_call(lib, "usearch_load", handle, str(path).encode())
        load_s = time.perf_counter() - t0
        c_call(lib, "usearch_change_expansion_search", handle, e)
        hw = c_call(lib, "usearch_hardware_acceleration", handle).decode()
        if hw != torch.cuda.get_device_name(0) or c_call(lib, "usearch_size", handle) != len(index):
            fail(f"the C index: hardware {hw!r}, size {c_call(lib, 'usearch_size', handle)} of {len(index)}")
        py = Index.restore(str(path), device=dev)
        py.expansion_search = e
        log(f"  the IVF path's index ({len(index)} rows, {path.stat().st_size / 2**20:.0f} MiB) saved; "
            f"usearch_metadata (ip, i8, {opts.dimensions}), usearch_init, usearch_load {load_s:.2f} s, "
            f"expansion_search {e}, on {hw}")

        live = np.nonzero(~np.isin(ivf_run["want"], ivf_run["gone"]))[0][: CABI["q"]]
        queries = np.ascontiguousarray(ivf_run["queries"][torch.as_tensor(live, device=dev)].cpu().numpy())
        want = ivf_run["want"][live]
        c_call(lib, "usearch_search", handle, queries[0].ctypes.data, kinds["f32"], k,  # warm
               np.zeros(k, np.uint64).ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
               np.zeros(k, np.float32).ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        py.search(queries[0], k)
        zero_counters()
        keys, dists, c_secs = c_search(lib, handle, queries, kinds["f32"], k)
        launches = counters()
        if launches["grouped_probe"] != len(queries) or sum(launches.values()) != len(queries):
            fail(f"{len(queries)} one-query C searches did not launch B3 once each and nothing else: {launches}")
        py_secs, differ = np.zeros(len(queries)), 0
        for i, q in enumerate(queries):
            t0 = time.perf_counter()
            m = py.search(q, k)
            py_secs[i] = time.perf_counter() - t0
            differ += int(not (np.array_equal(m.keys, keys[i]) and np.array_equal(m.distances, dists[i])))
        size_secs = np.zeros(len(queries))
        for i in range(len(queries)):
            t0 = time.perf_counter()
            c_call(lib, "usearch_size", handle)
            size_secs[i] = time.perf_counter() - t0
        recall1 = float(np.mean(keys[:, 0] == want))
        log(f"  {len(queries)} one-query usearch_search calls, k={k}: {us(c_secs)} a call "
            f"({len(queries) / c_secs.sum():.0f} calls/s); Python's Index.search of one query {us(py_secs)}; "
            f"usearch_size {us(size_secs)}; recall@1 {recall1:.4f}; {differ} differ from Index.search; "
            f"launches {launches}; {card}")
        if differ or recall1 < 0.99:
            fail(f"one-query C searches: {differ} differ from Index.search, recall@1 {recall1:.4f}")
        one = queries[:1]
        profile_call(lambda: c_search(lib, handle, one, kinds["f32"], k), "one one-query usearch_search call")

        keyspace = py._live_keys()
        allowed = np.sort(gen.choice(keyspace, int(len(keyspace) * CABI["allowed"]), replace=False)).astype(np.uint64)
        fq = queries[: CABI["filtered"]]
        fkeys, fdists, f_secs = c_search(lib, handle, fq, kinds["f32"], k, allowed)
        differ = sum(not (np.array_equal(m.keys, fkeys[i]) and np.array_equal(m.distances, fdists[i]))
                     for i, m in enumerate(py.search(q, k, filter=allowed) for q in fq))
        if differ or not np.isin(fkeys, allowed).all():
            fail(f"filtered C searches: {differ} differ from Index.search(filter=...)")
        viewed = c_call(lib, "usearch_init", ctypes.byref(opts))
        c_call(lib, "usearch_view", viewed, str(path).encode())
        c_call(lib, "usearch_change_expansion_search", viewed, e)
        vq = queries[: CABI["view_q"]]
        vkeys, vdists, _ = c_search(lib, viewed, vq, kinds["f32"], k)
        if not (np.array_equal(vkeys, keys[: len(vq)]) and np.array_equal(vdists, dists[: len(vq)])):
            fail("usearch_view's searches differ from usearch_load's")
        got_keys = gen.choice(keyspace, CABI["get_keys"], replace=False)
        for key in got_keys.tolist():
            for kind, dtype, want_row in (("i8", np.int8, py.get(key, "i8")), ("f32", np.float32, py.get(key))):
                row = np.zeros(IVF["w"], dtype)
                if c_call(lib, "usearch_get", handle, ctypes.c_uint64(key), 1, row.ctypes.data, kinds[kind]) != 1 \
                        or not np.array_equal(row, want_row):
                    fail(f"usearch_get({key}, {kind}) differs from Index.get")
        log(f"  {len(fq)} usearch_filtered_search calls against {len(allowed)} allowed keys ({us(f_secs)} a call) "
            f"equal to Index.search(filter=...); usearch_view's {len(vq)} searches equal to usearch_load's; "
            f"usearch_get of {len(got_keys)} keys in i8 and f32 equal to Index.get")

        gone = gen.choice(keyspace, int(len(keyspace) * CABI["removed"]), replace=False)
        gone_rows = np.zeros((CABI["removed_q"], IVF["w"]), np.int8)
        for i, key in enumerate(gone[: len(gone_rows)].tolist()):
            c_call(lib, "usearch_get", handle, ctypes.c_uint64(key), 1, gone_rows[i].ctypes.data, kinds["i8"])
        t0 = time.perf_counter()
        removed = sum(c_call(lib, "usearch_remove", handle, ctypes.c_uint64(key)) for key in gone.tolist())
        remove_s = time.perf_counter() - t0
        rkeys, _, _ = c_search(lib, handle, gone_rows, kinds["i8"], k)
        back = int(np.isin(rkeys, gone).sum())
        log(f"  {len(gone)} usearch_remove calls in {remove_s:.2f} s ({len(gone) / remove_s:.0f}/s), {removed} rows "
            f"removed; {len(gone_rows)} searches for them (i8 queries): {back} removed keys returned")
        if removed != len(gone) or back or c_call(lib, "usearch_size", handle) != len(index) - len(gone):
            fail(f"after usearch_remove: {removed} of {len(gone)} removed, {back} removed keys returned")
        for h in (handle, viewed):
            c_call(lib, "usearch_free", h)
        del py

        tgen = torch.Generator(device=dev).manual_seed(SEED + 32)
        n, w, nq = IVF["n"], IVF["w"], CABI["exact_q"]
        data = cast_rows(unit_rows(n, w, tgen, dev), ScalarKind.F32, ScalarKind.I8).cpu().numpy()
        member = np.sort(torch.randperm(n, generator=tgen, device=dev)[:nq].cpu().numpy())
        eq = np.ascontiguousarray(data[member])
        ekeys, edists = np.zeros((nq, k), np.uint64), np.zeros((nq, k), np.float32)
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c_call(lib, "usearch_exact_search", data.ctypes.data, n, w, eq.ctypes.data, nq, w, kinds["i8"], w,
               metrics["ip"], k, 0, ekeys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), k * 8,
               edists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), k * 4)
        exact_s = time.perf_counter() - t0
        launches = counters()
        t0 = time.perf_counter()
        torch.from_numpy(data).to(dev)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        m = exact_search(data, eq, k, metric="ip", device=dev)
        ok = ties_aside(BatchMatches(keys=ekeys, distances=edists, counts=np.full(nq, k, np.uint64)), m)
        recall1 = float(np.mean(ekeys[:, 0] == member))
        log(f"  usearch_exact_search of {nq} member queries over {n} x {w} i8 rows in host memory, k={k}: "
            f"{exact_s:.3f} s ({nq / exact_s:.0f} QPS), the upload of the rows alone {upload_s:.3f} s "
            f"({upload_s / exact_s:.1%}); recall@1 {recall1:.4f}; against exact_search: "
            f"{'distances bit for bit, keys apart from ties' if ok else 'DIFFERENT'}; launches {launches}; {card}")
        if not ok or not (launches["binned_minima"] and launches["block_dots"]):
            fail(f"usearch_exact_search: equal to exact_search {ok}, launches {launches}")
        del data

        rows = unit_rows(CABI["adds"], w, tgen, dev).cpu().numpy()
        fresh = c_call(lib, "usearch_init", ctypes.byref(cabi.InitOptions(
            metric_kind=metrics["ip"], quantization=kinds["i8"], dimensions=w)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(rows)):
            c_call(lib, "usearch_add", fresh, ctypes.c_uint64(i), rows[i].ctypes.data, kinds["f32"])
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        c_call(lib, "usearch_save", fresh, str(tmp / "adds.usearch").encode())
        c_call(lib, "usearch_free", fresh)
        found = Index.restore(str(tmp / "adds.usearch"), device=dev).search(rows, k, exact=True)
        recall1 = float(np.mean(found.keys[:, 0] == np.arange(len(rows))))
        log(f"  {len(rows)} one-row usearch_add calls (f32 rows into a fresh i8 ip index): {add_s:.2f} s = "
            f"{len(rows) / add_s:.0f} adds/s; an exact search finds {recall1:.4f} of them first; {card}")
        if recall1 < 1.0:
            fail(f"rows added through usearch_add: recall@1 {recall1:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  step (j) {time.perf_counter() - t_step:.1f} s; {card}")


#: seconds between a profile's unmeasured call and its measured one. The
#: runtime's and the device's events carry CUPTI's clock, which can stand
#: off the host's: without a pause, the window of a call as short as the
#: sharded merge (11 launches) once took in the unmeasured call's launches
#: too (22). The window opens half the pause before the measured call.
PROFILE_GAP_S = 0.05


def profiled(fn):
    """``(wall ms, events, launches)`` of one warm call of ``fn`` under
    torch.profiler: the session's first call is not measured (a captured
    search captures its graphs there: a session replays only graphs
    captured within it, `graphs.profiler_epoch`), the second is,
    `PROFILE_GAP_S` later; its events are those that start within its
    window, its launches what each kernel wrapper's counter gained in it."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_GAP_S)
        before = counters()
        with record_function("measured call"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        after = counters()
    events = prof.events()
    start = min(ev.time_range.start for ev in events if ev.name == "measured call") - PROFILE_GAP_S * 1e6 / 2
    events = [ev for ev in events if ev.time_range.start >= start and ev.name != "measured call"]
    return wall_ms, events, {name: after[name] - before[name] for name in after}


#: the kernels of the captured paths by the name of their device function,
#: and the wrappers that launch them
CAPTURED_KERNELS = {"scan.cu": (("wgmma_scan", "simt_scan"), ("binned_scan", "binned_minima")),
                    "rescore.cu": (("block_dots_kernel",), ("block_dots",)),
                    "probe.cu": (("grouped_wgmma",), ("grouped_probe", "grouped_probe_nofold", "binned_probe",
                                                      "pair_probe")),
                    "pair.cu": (("pair_fold",), ("pair_probe",)),
                    "bitscan.cu": (("bit_scan_wgmma",), ("bit_scan",))}


def api_profile(fn, label: str):
    """One warm call of ``fn`` under torch.profiler (`profiled`): its wall
    ms, device busy ms, idle share, the CUDA runtime's graph launches and
    kernel launches (any ``*LaunchKernel*`` call) on the host, and, for
    each source of CAPTURED_KERNELS, its kernels' executions on the device
    beside the launches its wrappers counted in the call, and the device's
    events (kernels and copies) of all sources. Fails when the profiler
    recorded no runtime call."""
    wall_ms, events, launched = profiled(fn)
    busy, graph, kernels, runtime, device_events = 0.0, 0, 0, 0, 0
    ran = {src: 0 for src in CAPTURED_KERNELS}
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            busy += ev.time_range.elapsed_us() / 1e3
            device_events += 1
            for src, (names, _) in CAPTURED_KERNELS.items():
                ran[src] += any(name in ev.name for name in names)
        elif ev.name.startswith("cuda") or (ev.name.startswith("cu") and ev.name[2:3].isupper()):
            runtime += 1
            graph += ev.name == "cudaGraphLaunch"
            kernels += "LaunchKernel" in ev.name
    if not runtime:
        fail(f"the profile of {label} recorded no CUDA runtime call")
    counted = {src: sum(launched[w] for w in wrappers) for src, (_, wrappers) in CAPTURED_KERNELS.items()}
    return dict(wall=wall_ms, busy=busy, idle=max(0.0, 1 - busy / wall_ms) if busy else None, graph=graph,
                kernels=kernels, ran=ran, counted=counted, label=label, device_events=device_events)


def held_caches(target) -> list:
    """The graph caches of an `Index` or of a `ShardedIndex`'s cards."""
    if isinstance(target, sharded.ShardedIndex):
        return list({id(c): c for c in target._graphs.values()}.values())
    return [target._graphs]


def capture_path(label: str, target, queries, k: int, card: str, exact: bool = False, expansion: int = 1024,
                 mode: str = "group"):
    """Step (k), one path in probe flavour ``mode``: its replay
    (``target.search``) equal to its eager body bit for bit, then both
    timed CAPTURE["reps"] times in turns (medians): the whole search,
    results on the host, and its prepared part alone, prepared queries to
    results on the card; one replay profiled with host queries (a graph
    launch a graph; no kernel launch outside the merge of a sharded search;
    the path's kernels run on the device as often as the graphs' recorded
    launches say), the captures made and the pool's GiB."""
    ivf.PROBE_MODE = mode
    try:
        return capture_path_in_mode(label, target, queries, k, card, exact, expansion)
    finally:
        ivf.PROBE_MODE = "group"


def capture_path_in_mode(label: str, target, queries, k: int, card: str, exact: bool, expansion: int):
    pool_search = isinstance(target, sharded.ShardedIndex)
    if pool_search:
        replay = lambda qs: target.search(qs, k, exact=exact, expansion_search=expansion)  # noqa: E731
        eager = lambda qs: sharded_eager_search(target, qs, k, exact, expansion)  # noqa: E731
        q, _ = target._queries(queries)
        kk = min(k, len(target), target._per)
        prepared = dict(eager=lambda: sharded_eager_prepared(target, q, k, exact, expansion),
                        replay=lambda: target._search_prepared(q, kk, exact, expansion))
    else:
        replay = lambda qs: target.search(qs, k, exact=exact)  # noqa: E731
        eager = lambda qs: eager_search(target, qs, k, exact)  # noqa: E731
        q = target._cast_device(*target._device_rows(queries))
        approx, use_ivf = target._route(exact)
        kk = min(k, len(target))
        _, body, _ = target._search_plan(pad_queries(q.shape[0]), kk, target._valid, approx, use_ivf)
        qp = target._padded_queries(q)
        prepared = dict(eager=lambda: body(qp, target._valid),
                        replay=lambda: target._search_prepared(q, kk, target._valid, approx, use_ivf))
    got = replay(queries)
    if not same_search(got, eager(queries)) or not same_search(replay(queries), got):
        fail(f"(k) {label}: the replay differs from the eager body")
    walls = dict(eager=[], replay=[], eager_prepared=[], replay_prepared=[])
    for _ in range(CAPTURE["reps"]):
        for name, fn in (("eager", eager), ("replay", replay)):
            walls[name].append(timed(lambda: fn(queries))[1] * 1e3)
            walls[f"{name}_prepared"].append(timed(prepared[name])[1] * 1e3)
    host_q = queries.cpu().numpy()
    eager_prof = api_profile(lambda: eager(host_q), f"eager {label}")
    n_graphs = len(target.mesh.devices) if pool_search else 1  # a graph a shard
    merge_kernels = 0
    if pool_search:
        q, _ = target._queries(queries)
        cands = sharded_eager_prepared(target, q, k, exact, expansion, merge=False)
        merge_kernels = api_profile(lambda: sharded.merge_candidates(cands, kk, target.mesh), "merge")["kernels"]
    prof = api_profile(lambda: replay(host_q), f"replay of {label}")  # last: its graphs stay held
    caches = held_caches(target)
    if prof["graph"] != n_graphs or prof["kernels"] - merge_kernels != 0:
        fail(f"(k) {label}: the profiled replay made {prof['graph']} graph launches (want {n_graphs}) and "
             f"{prof['kernels']} kernel launches ({merge_kernels} of them the merge's)")
    if prof["ran"] != prof["counted"] or not sum(prof["ran"].values()):
        fail(f"(k) {label}: the profiled replay ran {prof['ran']} kernels on the device, its graphs' recorded "
             f"launches say {prof['counted']}")
    pool_gib = [c.pool_bytes() for c in caches]
    pool_txt = "not measured" if None in pool_gib else f"{sum(pool_gib) / 2**30:.3f} GiB"
    med = {name: float(np.median(v)) for name, v in walls.items()}
    idle = "not measured" if prof["idle"] is None else f"{prof['idle']:.3f}"
    # the profiler's own host cost stretches a short call's wall: the idle
    # share of the unprofiled median replay beside the profiled one
    idle_med = "not measured" if not prof["busy"] else f"{max(0.0, 1 - prof['busy'] / med['replay']):.3f}"
    log(f"  (k) {label}, Q={queries.shape[0]}: replay equal to the eager body bit for bit; wall eager "
        f"{med['eager']:.3f} ms, replay {med['replay']:.3f} ms (medians of {CAPTURE['reps']}, in turns; device "
        f"queries, results on the host), of it the prepared search (results on the card) eager "
        f"{med['eager_prepared']:.3f} ms, replay {med['replay_prepared']:.3f} ms; the profiled replay (host "
        f"queries): wall {prof['wall']:.3f} ms, device busy "
        f"{prof['busy']:.3f} ms, idle share {idle} ({idle_med} of the median replay's wall), cudaGraphLaunch "
        f"{prof['graph']}, kernel launches {prof['kernels']}"
        f"{f' ({merge_kernels} the merge outside the graphs)' if pool_search else ''}, kernels run on the device by "
        f"source {prof['ran']} (the graphs' recorded launches the same); the profiled eager body "
        f"{eager_prof['wall']:.3f} ms, busy {eager_prof['busy']:.3f} ms, kernel launches {eager_prof['kernels']}; "
        f"captures {sum(c.captures for c in caches)}, {sum(len(c) for c in caches)} graphs held, pool {pool_txt} "
        f"({card})")
    return dict(label=label, eager_ms=med["eager"], replay_ms=med["replay"], busy_ms=prof["busy"], idle=prof["idle"],
                pool_bytes=None if None in pool_gib else sum(pool_gib), prepared=(med["eager_prepared"],
                                                                                  med["replay_prepared"]))


def capture_updates(dev, card: str) -> None:
    """Step (k)'s updates on an IVF of its own (CAPTURE): a replay after a
    removal (no recapture: the mask is updated in place), after fresh adds
    (a recapture: the fresh list is new) and after an add that grows the
    table (a recapture of the flat search), each equal to the eager body
    bit for bit; no removed key comes back."""
    spec = CAPTURE
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    x = unit_rows(spec["n"], 256, gen, dev)
    index = Index(ndim=256, metric="ip", dtype="i8", device=dev)
    keys = index.add(None, x)
    index.optimize(n_partitions=spec["partitions"], reorder=True, spill=spec["spill"])
    index.expansion_search = spec["expansion"]
    q = x[torch.randperm(spec["n"], generator=gen, device=dev)[: spec["q"]]]
    cache, k = index._graphs, spec["k"]

    def held(step: str, captures: int):
        got = index.search(q, k)
        if not same_search(got, eager_search(index, q, k)) or cache.captures != captures:
            fail(f"(k) after {step}: the replay differs from the eager body, or {cache.captures} captures "
                 f"(want {captures})")
        return got

    index.search(q, k)
    held("the first capture", 1)
    gone = keys[torch.randperm(spec["n"], generator=gen, device=dev)[: int(spec["n"] * spec["removed"])].cpu().numpy()]
    index.remove(gone)
    m = held("a removal", 1)
    hits = int(np.isin(m.keys, gone).sum())
    index.add(None, unit_rows(spec["fresh"], 256, gen, dev))
    held("fresh adds", 2)
    cap, generation = index.capacity, index._generation
    index.add(None, unit_rows(spec["grow"], 256, gen, dev))
    if index.capacity <= cap or index._generation == generation or not index._ivf_dirty:
        fail(f"(k) the growing add: capacity {cap} -> {index.capacity}, generation {generation} -> "
             f"{index._generation}, the IVF kept")
    held("a growing add", 3)
    if hits:
        fail(f"(k) {hits} removed keys came back from the replay")
    log(f"  (k) updates on an i8 ip IVF of {spec['n']} rows: after removing {len(gone)} keys the graph replayed "
        f"(no removed key returned), after {spec['fresh']} fresh adds and after {spec['grow']} more rows (capacity "
        f"{cap} -> {index.capacity}, the flat search) it was captured again; each replay equal to the eager body "
        f"bit for bit ({card})")


def drive_capture(dev, runs: dict, card: str) -> list:
    """Phase 3 (k), whole-search capture (graphs.py) on phase 3's indexes:
    `Index.jit` true on the card; each captured path's replay against its
    eager body (`capture_path`): B1 i8 and compact, B2 i8, B3 i8 IVF with
    shadows and fresh rows at 16,384 queries and at one, B6 (`pair`) and
    B7 (`bin`) on that IVF, B3 f32 cos IVF,
    b1 hamming (B4) and tanimoto (B5), both b1 indexes' exact flat
    searches (the bit scan), 4 shards on one card exact and probed; then
    the updates (`capture_updates`)."""
    t_step = time.perf_counter()
    head, comp, ivf_run, f32_ivf, binary, sh = (runs[name] for name in ("head", "comp", "ivf", "f32_ivf", "binary",
                                                                          "sharded"))
    if not head["index"].jit:
        fail("(k) Index.jit is False on the card")
    paths = [
        ("B1 i8 ip flat, 1M rows", head["index"], head["queries"], MAIN["k"], {}),
        ("B1 compact f32 cos flat, 262,144 rows", comp["index"], comp["queries"], COMPACT["k"], {}),
        ("B2 i8 ip exact, 1M rows", head["index"], head["queries"][: MAIN["exact_q"]], MAIN["k"], dict(exact=True)),
        ("B3 i8 ip IVF (shadows, fresh rows)", ivf_run["index"], ivf_run["queries"], IVF["k"], {}),
        ("B3 i8 ip IVF, one query", ivf_run["index"], ivf_run["queries"][:1], IVF["k"], {}),
        ("B6 i8 ip IVF `pair` (shadows, fresh rows)", ivf_run["index"], ivf_run["queries"], IVF["k"],
         dict(mode="pair")),
        ("B7 i8 ip IVF `bin` (shadows, fresh rows)", ivf_run["index"], ivf_run["queries"], IVF["k"],
         dict(mode="bin")),
        ("B3 f32 cos IVF", f32_ivf["index"], f32_ivf["queries"], IVF["k"], {}),
    ] + [(f"b1 {metric} IVF ({'B4' if metric == 'hamming' else 'B5 + re-rank'})", run["index"], run["queries"],
          BINARY["k"], {}) for metric, run in binary.items()] + [
        (f"b1 {metric} exact flat (bit_scan)", run["index"], run["queries"], BINARY["k"], dict(exact=True))
        for metric, run in binary.items()] + [
        ("4 shards on one card, exact (B2 a shard)", sh["pool"], sh["qx"], SHARDED["k"], dict(exact=True)),
        ("4 shards on one card, probed (B3 a shard)", sh["pool"], sh["queries"], SHARDED["k"],
         dict(expansion=SHARDED["expansion"])),
    ]
    rows = [capture_path(label, target, qs, k, card, **kw) for label, target, qs, k, kw in paths]
    capture_threads("B3 i8 ip IVF", ivf_run["index"], ivf_run["queries"], IVF["k"], card)
    capture_updates(dev, card)
    card_dev = torch.device("cuda", torch.cuda.current_device())
    held = [c.pool_bytes() for c in list(graphs._CACHES) if c.device == card_dev]
    budget = graphs.pool_budget(card_dev)
    if None not in held and sum(held) > budget:
        fail(f"(k) the card's graph pools hold {sum(held)} bytes, past their budget of {budget}")
    held_txt = "not measured" if None in held else f"{sum(held) / 2**30:.3f} GiB"
    log(f"  (k) the graph pools of the card's {len(held)} caches hold {held_txt} together, the budget "
        f"{budget / 2**30:.3f} GiB ({graphs.POOL_BUDGET_SHARE} of the card's memory); {card}")
    log(f"  step (k) {time.perf_counter() - t_step:.1f} s; {card}")
    return rows


def same_bits(got, want) -> bool:
    """Arrays equal bit for bit, dtype and shape included."""
    return all(g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g.view(np.uint8), w.view(np.uint8))
               for g, w in zip(got, want))


def fit_both_ways(label: str, fn, card: str):
    """Step (l), one fit: ``fn()`` through its captured steps, eagerly (no
    graph cache, `kmeans._fit_cache`) and captured again, each timed; the
    results and the Lloyd loop's step counts equal bit for bit, or the step
    fails. Returns the first captured run's caches."""
    make, caches = kmeans._fit_cache, []

    def recorded(device):
        caches.append(make(device))
        return caches[-1]

    runs = []
    for cache_of in (recorded, lambda device: None, recorded):  # captured, eager, captured again
        kmeans._fit_cache = cache_of
        try:
            with CallTimer(kmeans, "_lloyd_loop", sync=False) as loops:
                out, secs = timed(fn)
        finally:
            kmeans._fit_cache = make
        runs.append((out, secs, [r[-1] for r in loops.results]))
    (got, got_s, got_steps), (want, want_s, want_steps), (again, again_s, _) = runs
    if not (same_bits(got, want) and same_bits(again, want)) or got_steps != want_steps:
        fail(f"(l) {label}: the captured fit differs from the eager one (steps {got_steps} and {want_steps})")
    cache = caches[0]
    log(f"  (l) {label}: assignments and centroids equal bit for bit to the eager steps'"
        f"{f', the same exit after {got_steps[0]} steps' if got_steps else ''}; captured {got_s:.3f} s and "
        f"{again_s:.3f} s (each {cache.captures} captures, {cache.replays} replays), eager {want_s:.3f} s between "
        f"them ({card})")
    return caches[:1]


def eager_builds(dev) -> dict:
    """Step (l): phase 3's two builds again over the rows they were given
    (the IVF path's, step (b)'s, drawn from the same seeds on the card),
    their fits eager (`kmeans._fit_cache` gives no graph cache), split as
    phase 3 splits them."""
    make = kmeans._fit_cache
    kmeans._fit_cache = lambda device: None
    out = {}
    try:
        for name, spec, seed, timer, spill in (("flat", IVF, SEED + 3, timed_flat_build, IVF["spill"]),
                                               ("two_level", LIFECYCLE, SEED + 16, timed_build, 0.0)):
            gen = torch.Generator(device=dev).manual_seed(seed)
            index = Index(ndim=spec["w"], metric="ip", dtype="i8", device=dev)
            index.add(None, unit_rows(spec["n"], spec["w"], gen, dev))
            out[name] = timer(index, n_partitions=spec["partitions"], reorder=True, spill=spill)
            del index
    finally:
        kmeans._fit_cache = make
    return out


def drive_fits(dev, builds: dict, card: str) -> None:
    """Phase 3 (l), the k-means fits captured (FITS): the splits of phase
    3's builds (``builds``: the IVF path's `optimize(1024)`, step (b)'s
    `optimize(8192)`) again, and the same builds' splits with their fits
    eager (`eager_builds`); a two-level fit whose sub-fits fall in at
    least two size buckets and a flat fit with its early exits, each held
    bit for bit against its eager steps at the same seed and timed both
    ways (`fit_both_ways`); then one sub-fit's launches, eager and
    replayed, profiled (`api_profile`): the replay makes one graph launch a
    step; and replayed seeding steps of a flat fit at `optimize(1024)`'s
    size, their device time by kernel (`profile_call`)."""
    t_step = time.perf_counter()
    flat, two = builds["flat"], builds["two_level"]
    log(f"  (l) the builds' fits, replayed: optimize({IVF['partitions']}, spill {IVF['spill']}) {flat['total']:.3f} s: "
        f"{flat_split_text(flat)}; optimize({LIFECYCLE['partitions']}) {two['total']:.3f} s: level 1 "
        f"{two['level1']:.3f} s, level 2 {two['level2']:.3f} s ({two['sub_fits']} sub-fits) ({card})")
    eager = eager_builds(dev)
    flat, two = eager["flat"], eager["two_level"]
    log(f"  (l) the same builds, their fits eager: optimize({IVF['partitions']}, spill {IVF['spill']}) "
        f"{flat['total']:.3f} s: {flat_split_text(flat)}; optimize({LIFECYCLE['partitions']}) {two['total']:.3f} s: "
        f"level 1 {two['level1']:.3f} s, coarse assignment {two['coarse']:.3f} s, level 2 {two['level2']:.3f} s "
        f"({two['sub_fits']} sub-fits), flat pass {two['flat']:.3f} s, the quantizer's rest "
        f"{two['quantize_rest']:.3f} s, layout {two['layout']:.3f} s ({card})")
    spec = FITS
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    centers = unit_rows(spec["blobs"], 256, gen, dev)
    weights = torch.arange(1, spec["blobs"] + 1, dtype=torch.float32, device=dev)
    near = centers[torch.multinomial(weights, spec["n"], replacement=True, generator=gen)]
    x = near + 0.5 * unit_rows(spec["n"], 256, gen, dev)
    rows = torch.round(x / x.norm(dim=1, keepdim=True) * 100).clamp(-127, 127).to(torch.int8)
    k, iters = spec["k"], spec["iters"]
    k1 = math.ceil(math.sqrt(k))
    k2 = math.ceil(k / k1)
    (cache,) = fit_both_ways(
        f"two-level fit of {spec['n']} i8 rows x 256 into {k} ({k1} coarse, {k2} a sub-fit, {iters} steps)",
        lambda: kmeans.kmeans_hierarchical(rows, k, metric=MetricKind.L2sq, max_iterations=iters,
                                           seed=spec["seed"]), card)
    sub_buckets = {key[4] for key in cache.keys() if key[6] == k2}
    if len(sub_buckets) < 2:
        fail(f"(l) the sub-fits took {len(sub_buckets)} size buckets, not two or more: {sorted(sub_buckets)}")
    log(f"  (l) the sub-fits' size buckets (padded rows): {sorted(sub_buckets)}")
    flat_rows = rows[: spec["flat_n"]]
    fit_both_ways(f"flat fit of {spec['flat_n']} rows into {spec['flat_k']}",
                  lambda: kmeans.kmeans_fit(flat_rows, spec["flat_k"], metric=MetricKind.IP, max_iterations=iters,
                                            seed=spec["seed"]),
                  card)

    # one sub-fit of `optimize(8192)`'s level 2 over 2^20 rows (91 coarse
    # clusters of ~11,500 rows, 91 centroids each), in the bucket of 16,384
    m, k2 = spec["sub_rows"], spec["sub_k"]
    members = torch.randperm(spec["n"], generator=gen, device=dev)[:m].sort().values
    profiles = {}
    for name, cached in (("eager", False), ("replayed", True)):
        units = kmeans._Units(dev)
        if not cached:
            units.cache = None
        bucket = kmeans._sub_bucket(units, MetricKind.L2sq, rows, m, k2)
        profiles[name] = api_profile(lambda: kmeans._sub_fit(bucket, rows, members, k2, iters, spec["seed"]),
                                     f"one sub-fit {name}")
    steps = k2 - 1 + iters + 1  # the seeding's, the Lloyd steps and the final assignment's
    eager_p, replay_p = profiles["eager"], profiles["replayed"]
    if replay_p["graph"] != steps or eager_p["graph"]:
        fail(f"(l) one sub-fit: {replay_p['graph']} graph launches replayed (want {steps}), {eager_p['graph']} eager")
    log(f"  (l) one sub-fit of {m} rows into {k2} ({iters} steps): eager {eager_p['kernels']} kernel launches, wall "
        f"{eager_p['wall']:.2f} ms, device busy {eager_p['busy']:.2f} ms in {eager_p['device_events']} device events; "
        f"replayed {replay_p['graph']} graph launches and {replay_p['kernels']} kernel launches outside them, wall "
        f"{replay_p['wall']:.2f} ms (profiled), device busy {replay_p['busy']:.2f} ms in {replay_p['device_events']} "
        f"device events ({card})")
    # seeding steps of `optimize(1024)`'s flat fit, over its 2^20 rows
    pts = rows.repeat(spec["seed_rows"] // spec["n"], 1)
    bucket = kmeans._Bucket(kmeans._Units(dev), MetricKind.L2sq, pts, spec["seed_k"], kmeans.ASSIGN_TILE)
    profile_call(lambda: kmeans._kmeanspp_init(pts, bucket.gen, spec["seed_k"], bucket),
                 f"the replayed k-means++ seeding of {spec['seed_k']} centroids over {pts.shape[0]} i8 rows x 256")
    log(f"  step (l) {time.perf_counter() - t_step:.1f} s; {card}")


def capture_threads(label: str, index, queries, k: int, card: str, reps: int = 12) -> None:
    """Step (k): two threads search one index at once with two keys of its
    cache (one query, and the whole batch), whose graphs share one pool:
    every result equal to the eager body's bit for bit."""
    batches = (queries[:1], queries)
    want = [eager_search(index, qs, k) for qs in batches]
    wrong = []

    def hammer(qs, w):
        for _ in range(reps):
            if not same_search(index.search(qs, k), w):
                wrong.append(qs.shape[0])

    threads = [threading.Thread(target=hammer, args=(qs, w)) for qs, w in zip(batches, want)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if wrong:
        fail(f"(k) {label}: searches from two threads at once differ from the eager body at Q={sorted(set(wrong))}")
    log(f"  (k) {label}: two threads, Q=1 and Q={queries.shape[0]}, {reps} searches each at once, each equal to the "
        f"eager body bit for bit ({card})")


def sharded_rows(sh: dict, card: str) -> list:
    """Phase 4 of the sharded index: a pool of step (i)'s rows as they were
    before its updates (`from_index` of the single-device index, then
    `optimize` per shard), its launches per search, B2 and B3 at one shard's
    shapes (rows held, timed and bound as the other paths'; launches those
    of step (i)), and each sharded search's wall and device time beside the
    single-device index's (its IVF of `shards` times the partitions, no
    spill), split into the shards' work, the merge and the host."""
    spec = SHARDED
    k, e, single, qx, queries = spec["k"], spec["expansion"], sh["single"], sh["qx"], sh["queries"]
    pool = sharded.ShardedIndex.from_index(single, make_mesh(spec["shards"]))
    q8, _ = pool._queries(qx)
    b2 = kernel_row("binned_minima", "sharded i8 ip, one shard", "ip", q8, pool._tables[0], pool._stats[0],
                    pool._valids[0], False, sh["exact_launches"]["binned_minima"], "i8")
    pool.optimize(n_partitions=spec["partitions"])
    single.optimize(n_partitions=spec["partitions"] * spec["shards"], reorder=True)
    single.expansion_search = e
    calls = []

    def recorded(*args):
        calls.append(args)
        return probe.grouped_probe(*args)

    per_search = {}
    for exact, kerns, qs in ((True, (scan.binned_minima, scan.block_dots), qx), (False, (probe.grouped_probe,),
                                                                                 queries)):
        before = [kern.launches for kern in kerns]
        ivf.grouped_probe = recorded
        try:
            pool.search(qs, k, exact=exact, expansion_search=e)
        finally:
            ivf.grouped_probe = probe.grouped_probe
        per_search.update({kern.__name__: kern.launches - was for kern, was in zip(kerns, before)})
    log(f"  launches per search, sharded i8 ip ({pool.mesh}): {per_search}")
    b3 = b3_row(dict(launches=sh["probe_launches"], probe_args=calls[0]), label="sharded i8 ip, one shard")

    for label, exact, qs in (("exact", True, qx), ("probed", False, queries)):
        q, _ = pool._queries(qs)
        cands = lambda: sharded_eager_prepared(pool, q, k, exact, e, merge=False)  # noqa: E731
        shards_ms = time_ms(cands, 3)
        out = cands()
        merge_ms = time_ms(lambda: sharded.merge_candidates(out, k, pool.mesh), 10)
        search = lambda: pool.search(qs, k, exact=exact, expansion_search=e)  # noqa: E731
        alone = lambda: single.search(qs, k, exact=exact)  # noqa: E731
        search()
        alone()
        walls = [timed(fn)[1] * 1e3 for fn in (search, alone, alone, search)]  # in turns
        busy = profile_call(search, f"sharded {label} search of {qs.shape[0]} queries")
        busy_one = profile_call(alone, f"single-device {label} search of {qs.shape[0]} queries")
        log(f"  sharded {label} search of {qs.shape[0]} queries: wall {walls[0]:.2f} and {walls[3]:.2f} ms "
            f"(single-device {walls[1]:.2f} and {walls[2]:.2f} ms), device busy {busy:.2f} ms (single-device "
            f"{busy_one:.2f} ms); the shards' work {shards_ms:.3f} ms, the merge {merge_ms:.3f} ms "
            f"({merge_ms / (shards_ms + merge_ms):.1%} of the two), the host the rest of the wall; {card}")
    return [b2, b3]


def profile_search(index, queries, k: int, exact: bool, label: str = "") -> None:
    """Device time by kernel over one warm search, and the device's idle
    share of the search's wall time (torch.profiler)."""
    label = f"{label or ('exact' if exact else 'approximate')} search of {queries.shape[0]} queries"
    profile_call(lambda: index.search(queries, k, exact=exact), label)


def profile_call(fn, label: str) -> float:
    """Device time by kernel over one warm call of ``fn`` (`profiled`), and
    the device's idle share of its wall time; returns the device's busy
    milliseconds (0 when the profiler saw no device events)."""
    wall_ms, events, _ = profiled(fn)
    by_name = {}
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy == 0:
        log(f"  profile of {label}: wall {wall_ms:.2f} ms, device time not measured (no device events)")
        return 0.0
    log(f"  profile of {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:9.3f} ms  {ms / busy:6.1%}  {name[:100]}")
    return busy


def main() -> int:
    faulthandler.enable(all_threads=True)  # a crash inside torch or a kernel library prints the Python stacks
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    global T_START
    t_start = T_START = time.perf_counter()
    log("== phase 1: setup")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("USEARCH_TORCH_DEVICE", None)  # the C library on the card, as a C caller gets it
    programs = concurrent.futures.ThreadPoolExecutor(1).submit(run_c_programs)
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, entry in build.build_log.items():
        log(f"nvcc {name}.cu:\n{entry['report'].strip()}")
    t0 = time.perf_counter()
    native = dict(keymap=keymap.NATIVE, casts=casts.NATIVE)  # reading them builds the libraries
    log(f"native host helpers (g++, native/keymap.cc and casts.cc) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: {native}")
    if not all(native.values()):
        fail(f"a native host helper did not build or load: {native}")

    sass = concurrent.futures.ThreadPoolExecutor(1).submit(sass_functions)  # dumped while phase 2 runs
    stamp("phase 1")

    log("== phase 2: kernels against their plain versions")
    check_kernels(dev)
    stamp("check_kernels")
    check_scan_edges(dev)
    stamp("check_scan_edges")
    check_rescore(dev)
    stamp("check_rescore")
    check_probe(dev)
    stamp("check_probe")
    check_probe_edges(dev)
    stamp("check_probe_edges")
    check_binary_probe(dev)
    stamp("check_binary_probe")
    check_bitscan(dev)
    stamp("check_bitscan")
    check_pair(dev)
    stamp("check_pair")
    check_binned(dev)
    stamp("check_binned")
    check_flavours(dev)
    stamp("check_flavours")
    check_scan_sass(sass.result())
    check_probe_sass(sass.result())
    check_bitscan_sass(sass.result())
    stamp("the SASS checks")

    log("== phase 3: main paths")
    head, comp = run_main_path(dev)
    stamp("the flat paths")
    flavours = drive_flavours(head)
    f32_valid, f32_gone = f32_removal(comp, torch.Generator(device=dev).manual_seed(SEED + 12))
    f32_flavours = drive_flavours(comp, f32_valid, f32_gone)
    stamp("the flat-scan flavours")
    ivf_run = drive_ivf(dev)
    stamp("the i8 IVF path")
    f32_ivf = drive_f32_ivf(dev)
    stamp("the f32 IVF path")
    binary = run_binary_paths(dev)
    stamp("the binary paths")
    log("== phase 3: the index lifecycle, " + card)
    life = drive_lifecycle(dev, ivf_run, card)
    stamp("step (a)-(d)")
    log("== phase 3: serving, " + card)
    streamed_row = drive_streamed(dev, card)
    stamp("step (e)")
    drive_async(dev, ivf_run, card)
    stamp("step (f)")
    drive_serving(dev, ivf_run, card)
    stamp("step (g)")
    log("== phase 3: metric tail and host modules, " + card)
    drive_metric_tail(dev, ivf_run, card)
    stamp("step (h)")
    log("== phase 3: the sharded index, " + card)
    sharded_run = drive_sharded(dev, card)
    stamp("step (i)")
    log("== phase 3: the C ABI, " + card)
    drive_cabi(dev, ivf_run, card, programs)
    stamp("step (j)")
    log("== phase 3: whole-search capture, " + card)
    drive_capture(dev, dict(head=head, comp=comp, ivf=ivf_run, f32_ivf=f32_ivf, binary=binary, sharded=sharded_run),
                  card)
    stamp("step (k)")
    log("== phase 3: the k-means fits captured, " + card)
    drive_fits(dev, dict(flat=ivf_run["build_split"], two_level=life["build"]), card)
    stamp("step (l)")

    log("== phase 4: kernels at the main path's shapes, " + card)
    for run, spec in ((head, MAIN), (comp, COMPACT)):
        ix = run["index"]
        per_search = {}
        for exact, kerns in ((False, (scan.binned_scan,)), (True, (scan.binned_minima, scan.block_dots))):
            before = [kern.launches for kern in kerns]
            ix.search(run["queries"][: spec["exact_q"]] if exact else run["queries"], spec["k"], exact=exact)
            per_search.update({kern.__name__: kern.launches - was for kern, was in zip(kerns, before)})
        log(f"  launches per search, {ix.dtype.value} {ix.metric.value}: {per_search}")
    before = probe.grouped_probe.launches
    ivf_run["index"].search(ivf_run["queries"], IVF["k"])
    log(f"  launches per search, i8 ip IVF: {{'grouped_probe': {probe.grouped_probe.launches - before}}}")
    before = probe.grouped_probe.launches
    f32_ivf["index"].search(f32_ivf["queries"], IVF["k"])
    log(f"  launches per search, f32 cos IVF: {{'grouped_probe': {probe.grouped_probe.launches - before}}}")
    before = probe.grouped_probe.launches
    life["index"].search(life["queries"], LIFECYCLE["k"])
    log(f"  launches per search, i8 ip IVF of {LIFECYCLE['partitions']} partitions: "
        f"{{'grouped_probe': {probe.grouped_probe.launches - before}}}")
    for label, run in (("i8 ip IVF", ivf_run), ("f32 cos IVF", f32_ivf)):
        for mode, res in run["modes"].items():
            kern = getattr(probe, res["kern"])
            before = kern.launches
            ivf.PROBE_MODE = mode
            run["index"].search(run["queries"], IVF["k"])
            ivf.PROBE_MODE = "group"
            res["launches_per_search"] = kern.launches - before
            log(f"  launches per search, {label} {mode}: {{'{res['kern']}': {res['launches_per_search']}}}")
    for metric, run in binary.items():
        kern = getattr(probe, run["kern"])
        before = kern.launches
        run["index"].search(run["queries"], BINARY["k"])
        run["launches_per_search"] = kern.launches - before
        log(f"  launches per search, b1 {metric} IVF: {{'{run['kern']}': {run['launches_per_search']}}}")
        before = bitscan.bit_scan.launches
        run["index"].search(run["queries"], BINARY["k"], exact=True)
        log(f"  launches per search, b1 {metric} exact: {{'bit_scan': {bitscan.bit_scan.launches - before}}}")
    for label, runs in (("i8", flavours), ("f32", f32_flavours)):
        per_search = {FLAVOURS[name][1].__name__: res["launches"] for name, res in runs.items()}
        log(f"  launches per search, the {label} flat-scan flavours: {per_search}")
    stamp("phase 4's launches a search")
    ix, cx = head["index"], comp["index"]
    profile_search(ix, head["queries"], MAIN["k"], exact=False)
    profile_search(ix, head["queries"][: MAIN["exact_q"]], MAIN["k"], exact=True)
    profile_search(cx, comp["queries"], COMPACT["k"], exact=False)
    profile_search(cx, comp["queries"][: COMPACT["exact_q"]], COMPACT["k"], exact=True)
    profile_search(ivf_run["index"], ivf_run["queries"], IVF["k"], exact=False, label="IVF")
    profile_search(f32_ivf["index"], f32_ivf["queries"], IVF["k"], exact=False, label="f32 cos IVF")
    profile_search(life["index"], life["queries"], LIFECYCLE["k"], exact=False,
                   label=f"IVF of {LIFECYCLE['partitions']} partitions")
    for mode in MODES:
        ivf.PROBE_MODE = mode
        profile_search(ivf_run["index"], ivf_run["queries"], IVF["k"], exact=False, label=f"IVF {mode}")
        ivf.PROBE_MODE = "group"
    for metric, run in binary.items():
        profile_search(run["index"], run["queries"], BINARY["k"], exact=False, label=f"b1 {metric} IVF")
        profile_search(run["index"], run["queries"], BINARY["k"], exact=True, label=f"b1 {metric} exact (bit_scan)")
    q8 = ix._cast_device(head["queries"], ScalarKind.F32)
    for name, (search, _, _, _) in FLAVOURS.items():
        profile_call(lambda: search(ix.metric, q8, ix._table, ix._stats, ix._valid, MAIN["k"]),
                     f"{name} search of {q8.shape[0]} queries")
    f32_args = flavour_args(comp, f32_valid)
    for name, (search, _, _, _) in FLAVOURS.items():
        profile_call(lambda: search(*f32_args, COMPACT["k"]), f"{name} f32 cos search of {q8.shape[0]} queries")
    stamp("phase 4's profiles")
    qf = cx._cast_device(comp["queries"], ScalarKind.F32)
    hl, cl = head["launches"], comp["launches"]
    rows = [
        kernel_row("binned_scan", "i8 ip", "ip", q8, ix._table, ix._stats, ix._valid, False,
                   hl["binned_scan"], "i8"),
        kernel_row("binned_minima", "i8 ip", "ip", q8[: MAIN["exact_q"]].contiguous(), ix._table, ix._stats,
                   ix._valid, False, hl["binned_minima"], "i8"),
        kernel_row("binned_scan", "f32 cos compact", "cos", qf, cx._table, cx._stats, cx._valid, True,
                   cl["binned_scan"], "bf16"),
        kernel_row("binned_minima", "f32 cos", "cos", qf[: COMPACT["exact_q"]].contiguous(), cx._table,
                   cx._stats, cx._valid, False, cl["binned_minima"], "f32"),
        rescore_row("i8 ip exact", head, MAIN, "i8"),
        rescore_row("f32 cos exact", comp, COMPACT, "f32"),
        b3_row(ivf_run),
        b3_row(ivf_run, bf16_probe_args(ivf_run["probe_args"]), "bf16 ip IVF pairs", "bf16"),
        b3_row(ivf_run, small_probe_args(ivf_run), f"i8 ip IVF Q={SMALL_Q}"),
        b3_row(life, label=f"i8 ip IVF {LIFECYCLE['partitions']} partitions"),
    ] + [binary_row(run) for run in binary.values()] + [mode_row(ivf_run, mode) for mode in MODES]
    rows += [bitscan_row(run) for run in binary.values()]
    rows += [streamed_row, b3_row(f32_ivf, label="f32 cos IVF", peak="tf32x3")]
    rows += [mode_row(f32_ivf, mode, "f32 cos IVF", "tf32x3") for mode in F32_IVF["modes"]]
    i8_lib_ms = rows[0]["library_ms"]  # B1's yardstick: one product of the same operands
    rows += [flavour_row(name, head, res["launches"], i8_lib_ms) for name, res in flavours.items()]
    f32_lib_ms = library_ms(qf, cx._table)
    rows += [flavour_row(name, comp, res["launches"], f32_lib_ms, f32_valid, "f32 cos", "tf32x3")
             for name, res in f32_flavours.items()]
    rows += sharded_rows(sharded_run, card)
    stamp("phase 4")

    log("== phase 5: micro-benchmarks, " + card)
    micro = drive_micro()
    rows += loop_rows(dev, micro["i8_matmul_probe"])
    rows += select_rows(dev, micro["select_microbench"])
    rows += bisect_rows(dev, micro["probe_v2_bisect"])
    stamp("phase 5")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"total {time.perf_counter() - t_start:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
