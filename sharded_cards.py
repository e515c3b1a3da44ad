#!/usr/bin/env python3
"""The sharded index across cards: the same pool on four shards of one
card, on a shard a card in one process, and on 2 and 4 processes merging
over an NCCL group (`distributed_initialize`), each process's shards on its
own card. Every layout's exact and probed searches must equal the one-card
answer bit for bit; their times are printed beside it. In this process, one
warm search of each kind on one card and on a shard a card is profiled: the
host's milliseconds to launch it, each card's busy milliseconds
(torch.profiler) and the host syncs inside it.

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
from torch.profiler import ProfilerActivity, profile

from usearch_torch import build
from usearch_torch.parallel.mesh import distributed_initialize, make_mesh
from usearch_torch.parallel.sharded import ShardedIndex

W, K, NQ, EXPANSION, SHARDS, REPS = 256, 10, 4096, 1024, 4, 5
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
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


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
    """One warm search: its wall milliseconds, the host's milliseconds until
    every shard and the merge are launched (`_search_prepared` returns),
    each card's busy milliseconds (torch.profiler's kernels and copies) and
    the host syncs before the read-back."""
    q8, _ = pool._queries(q)
    launch = lambda: pool._search_prepared(q8, K, exact, EXPANSION)  # noqa: E731
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        launch()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            busy[ev.device_index] = busy.get(ev.device_index, 0.0) + ev.time_range.elapsed_us() / 1e3
    cards = ", ".join(f"cuda:{d} {ms:.2f}" for d, ms in sorted(busy.items())) or "not measured (no device events)"
    print(f"  profile, {label}, {'exact' if exact else 'probed'} search of {q.shape[0]} queries: wall {wall_ms:.2f} "
          f"ms, launched in {host_ms:.2f} ms of host time; busy ms a card: {cards}; host syncs before the "
          f"read-back: {host_syncs(launch)}", flush=True)


def answer(mesh, n: int, partitions: int, label=None):
    """The pool on ``mesh``: its exact and probed matches and their median
    wall milliseconds; with a ``label``, each search also `profiled`."""
    dev = mesh.devices[0]
    x = rows(n, dev)
    pool = ShardedIndex.build(x, metric="ip", dtype="i8", mesh=mesh)
    q = x[:NQ]
    exact_ms = median_ms(lambda: pool.search(q, K, exact=True), dev)
    exact = pool.search(q, K, exact=True)
    if label:
        profiled(pool, q, True, label)
    pool.optimize(n_partitions=partitions)
    probed_ms = median_ms(lambda: pool.search(q, K, expansion_search=EXPANSION), dev)
    if label:
        profiled(pool, q, False, label)
    return exact, pool.search(q, K, expansion_search=EXPANSION), exact_ms, probed_ms


def worker(address: str, rank: int, world: int, device: str, n: int, partitions: int, out: str) -> None:
    import torch.distributed as dist

    distributed_initialize(coordinator_address=address, num_processes=world, process_id=rank, device=device)
    try:
        exact, probed, exact_ms, probed_ms = answer(make_mesh(SHARDS // world, device=device), n, partitions)
        if rank == 0:
            np.savez(out, exact=exact.keys, exact_d=exact.distances, probed=probed.keys, probed_d=probed.distances,
                     ms=[exact_ms, probed_ms])
    finally:
        dist.destroy_process_group()


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
    print(f"{SHARDS} shards on {one.devices[0]}: exact {want[2]:.2f} ms, probed {want[3]:.2f} ms "
          f"({NQ} queries, k={K}, {args.rows} rows; medians of {REPS})", flush=True)
    ok = True
    if dev.type == "cuda":
        spread = make_mesh(SHARDS)
        got = answer(spread, args.rows, args.partitions, "a shard a card")
        equal = same(got[0], want[0]) and same(got[1], want[1])
        ok &= equal
        print(f"one process, a shard a card ({spread}): exact {got[2]:.2f} ms, probed {got[3]:.2f} ms; equal to "
              f"the one-card answer {equal}", flush=True)
    for world in (2, SHARDS):
        with tempfile.TemporaryDirectory() as tmp:
            z = run_group(world, args.device, args.rows, args.partitions, os.path.join(tmp, "rank0.npz"))
        equal = all(np.array_equal(z[a], b) for a, b in (("exact", want[0].keys), ("exact_d", want[0].distances),
                                                           ("probed", want[1].keys), ("probed_d", want[1].distances)))
        ok &= equal
        print(f"{world} processes, {SHARDS // world} shards each: exact {z['ms'][0]:.2f} ms, probed "
              f"{z['ms'][1]:.2f} ms; equal to the one-card answer {equal}", flush=True)
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
