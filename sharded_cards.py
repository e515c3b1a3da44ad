#!/usr/bin/env python3
"""The sharded index across cards: the same pool on four shards of one
card, on a shard a card in one process, and on 2 and 4 processes merging
over an NCCL group (`distributed_initialize`), each process's shards on its
own card. Every layout's exact and probed searches must equal the one-card
answer bit for bit; their times are printed beside it. On the cards each
shard's search replays its CUDA graph (usearch_torch/graphs.py); every
layout also times the eager code those graphs capture (the shards' searches
launched op by op from Python, `sharded.eager_candidates`, then the
merge), which must equal the replay bit for bit. In this
process, one warm search of each kind, replayed and eager, on one card and
on a shard a card is profiled: the host's milliseconds to launch it, each
card's busy milliseconds (torch.profiler) and the host syncs inside it.

    python3 sharded_cards.py [--rows 1048576] [--partitions 256] [--device cuda]

Needs at least 4 cards on "cuda"; with ``--device cpu`` the processes
merge over gloo, at a small ``--rows``. The pool is ``--rows`` unit rows x
256 in an i8 ip `ShardedIndex`, 4 shards, 4,096 member queries at k=10,
probed after `optimize(--partitions)` per shard at `expansion_search`
1,024. Exits non-zero on a mismatch or a failed process; every process it
starts is waited for (300 s each) or killed. The workers hand their answers
back through files in a temporary directory of this run.
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from usearch_torch import build
from usearch_torch.parallel.mesh import distributed_initialize, make_mesh
from usearch_torch.parallel.sharded import ShardedIndex, _replicate, eager_candidates, merge_candidates

W, K, NQ, EXPANSION, SHARDS, REPS = 256, 10, 4096, 1024, 4, 5
#: seconds between a profile's unmeasured call and its measured one: the
#: device's events carry CUPTI's clock, which can stand off the host's, so
#: the window opens half the pause before the measured call
PROFILE_GAP_S = 0.05
#: seconds a worker process may take
WORKER_TIMEOUT = 300


def rows(n: int, dev) -> torch.Tensor:
    """The same unit rows in every process: drawn on the host from a seed."""
    x = torch.randn(n, W, generator=torch.Generator().manual_seed(7))
    return (x / x.norm(dim=1, keepdim=True)).to(dev)


def median_ms(fn, dev) -> float:
    """The median wall milliseconds of ``REPS`` synchronised calls, after a
    warm one."""
    fn()
    times = []
    for _ in range(REPS):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def eager_prepared(pool, q8, exact: bool):
    """The eager code a search's graphs capture, called directly: each
    shard's search launched op by op (`sharded.eager_candidates`: B2 and
    its rescore a shard at a time in turn), then the merge; ``[Q, K]``
    distances and global rows."""
    plans = pool._shard_plans(q8.shape[0], K, exact, EXPANSION)
    return merge_candidates(eager_candidates(plans, _replicate(q8, pool.mesh.devices)), K, pool.mesh)


def host_syncs(fn) -> int:
    """The host syncs inside ``fn()`` (`torch.cuda.set_sync_debug_mode`)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def profiled(pool, q, exact: bool, label: str) -> None:
    """One warm search, replayed and eager: its wall milliseconds, the
    host's milliseconds until every shard and the merge are launched
    (`_search_prepared` returns), each card's busy milliseconds
    (torch.profiler's kernels and copies) and the host syncs before the
    read-back."""
    q8, _ = pool._queries(q)
    for how, launch in (("replayed", lambda: pool._search_prepared(q8, K, exact, EXPANSION)),
                        ("eager", lambda: eager_prepared(pool, q8, exact))):
        profiled_launch(launch, f"{label}, {how}", exact, q.shape[0])


def profiled_launch(launch, label: str, exact: bool, n_q: int) -> None:
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        launch()  # not measured: a session replays only graphs captured within it (graphs.profiler_epoch)
        torch.cuda.synchronize()
        time.sleep(PROFILE_GAP_S)
        with record_function("measured call"):
            t0 = time.perf_counter()
            launch()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    start = min(ev.time_range.start for ev in events if ev.name == "measured call") - PROFILE_GAP_S * 1e6 / 2
    busy = {}
    for ev in events:
        if ev.device_type == DeviceType.CUDA and ev.time_range.start >= start:
            busy[ev.device_index] = busy.get(ev.device_index, 0.0) + ev.time_range.elapsed_us() / 1e3
    cards = ", ".join(f"cuda:{d} {ms:.2f}" for d, ms in sorted(busy.items())) or "not measured (no device events)"
    print(f"  profile, {label}, {'exact' if exact else 'probed'} search of {n_q} queries: wall {wall_ms:.2f} "
          f"ms, launched in {host_ms:.2f} ms of host time; busy ms a card: {cards}; host syncs before the "
          f"read-back: {host_syncs(launch)}", flush=True)


def answer(mesh, n: int, partitions: int, label=None):
    """The pool on ``mesh``: its exact and probed matches and the median
    wall milliseconds of each search, replayed and eager (``[exact,
    probed, exact eager, probed eager]``); with a ``label``, each search
    also `profiled`. The eager search must equal the replayed one."""
    dev = mesh.devices[0]
    x = rows(n, dev)
    pool = ShardedIndex.build(x, metric="ip", dtype="i8", mesh=mesh)
    q = x[:NQ]
    q8, _ = pool._queries(q)
    out, ms, eager_ms = [], [], []
    for exact in (True, False):
        if not exact:
            pool.optimize(n_partitions=partitions)
        ms.append(median_ms(lambda: pool._search_prepared(q8, K, exact, EXPANSION), dev))
        eager_ms.append(median_ms(lambda: eager_prepared(pool, q8, exact), dev))
        out.append(pool.search(q, K, exact=exact, expansion_search=EXPANSION))
        replayed, eager = pool._search_prepared(q8, K, exact, EXPANSION), eager_prepared(pool, q8, exact)
        if not all(torch.equal(a, b) for a, b in zip(replayed, eager)):
            raise SystemExit(f"{mesh}: the eager {'exact' if exact else 'probed'} search differs from the replay")
        if label:
            profiled(pool, q, exact, label)
    return out[0], out[1], ms + eager_ms


def worker(address: str, rank: int, world: int, device: str, n: int, partitions: int, out: str) -> None:
    import torch.distributed as dist

    distributed_initialize(coordinator_address=address, num_processes=world, process_id=rank, device=device)
    try:
        exact, probed, ms = answer(make_mesh(SHARDS // world, device=device), n, partitions)
        if rank == 0:
            np.savez(out, exact=exact.keys, exact_d=exact.distances, probed=probed.keys, probed_d=probed.distances,
                     ms=ms)
    finally:
        dist.destroy_process_group()


def times(ms) -> str:
    return (f"exact {ms[0]:.2f} ms (eager {ms[2]:.2f}), probed {ms[1]:.2f} ms (eager {ms[3]:.2f}), each to "
            f"its results on the first card")


def same(got, want) -> bool:
    return np.array_equal(got.keys, want.keys) and np.array_equal(got.distances, want.distances)


def run_group(world: int, device: str, n: int, partitions: int, out: str):
    """``world`` worker processes: rank 0's saved answer."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", address, str(rank), str(world),
                               "--device", device, "--rows", str(n), "--partitions", str(partitions), "--out", out])
             for rank in range(world)]
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=WORKER_TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    if rcs != [0] * world:
        raise SystemExit(f"{world} processes: exit codes {rcs}")
    with np.load(out) as z:
        return dict(z)


def main(args) -> int:
    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < SHARDS:
            print(f"sharded_cards: needs {SHARDS} cards", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
        t0 = time.perf_counter()
        build.build_all(("scan", "probe"))  # once, before the workers load the libraries
        print(f"{torch.cuda.device_count()} x {card}; kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    one = make_mesh(SHARDS, device="cuda:0" if dev.type == "cuda" else "cpu")
    want = answer(one, args.rows, args.partitions, "4 shards on one card" if dev.type == "cuda" else None)
    print(f"{SHARDS} shards on {one.devices[0]}: {times(want[2])} ({NQ} queries, k={K}, {args.rows} rows; medians "
          f"of {REPS})", flush=True)
    ok = True
    if dev.type == "cuda":
        spread = make_mesh(SHARDS)
        got = answer(spread, args.rows, args.partitions, "a shard a card")
        equal = same(got[0], want[0]) and same(got[1], want[1])
        ok &= equal
        print(f"one process, a shard a card ({spread}): {times(got[2])}; equal to the one-card answer {equal}",
              flush=True)
    for world in (2, SHARDS):
        with tempfile.TemporaryDirectory() as tmp:
            z = run_group(world, args.device, args.rows, args.partitions, os.path.join(tmp, "rank0.npz"))
        equal = all(np.array_equal(z[a], b) for a, b in (("exact", want[0].keys), ("exact_d", want[0].distances),
                                                           ("probed", want[1].keys), ("probed_d", want[1].distances)))
        ok &= equal
        print(f"{world} processes, {SHARDS // world} shards each: {times(z['ms'])}; equal to the one-card answer "
              f"{equal}", flush=True)
    print(f"{'ok' if ok else 'MISMATCH'}; {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=1 << 20)
    parser.add_argument("--partitions", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--worker", nargs=3, metavar=("ADDRESS", "RANK", "WORLD"))
    parser.add_argument("--out")
    args = parser.parse_args()
    if args.worker:
        worker(args.worker[0], int(args.worker[1]), int(args.worker[2]), args.device, args.rows, args.partitions,
               args.out)
        sys.exit(0)
    sys.exit(main(args))
