"""Benchmarking CLI with the reference's `bench_cpp` flags (vectors,
queries and neighbors files, metric, quantization, k, batch size), the
counterpart of `usearch_tpu/bench_cli.py`, plus ``--device`` (the card,
"cuda", by default; "cpu" runs the plain versions of the kernels).

    python -m usearch_torch.bench_cli --vectors base.fbin --queries q.fbin \
        --neighbors gt.ibin --metric cos --quantization bf16 -k 10
    python -m usearch_torch.bench_cli --synthetic 100000 --ndim 96

It prints one JSON line: rows added per second, queries per second, and
with ``--neighbors`` recall@k and recall@1.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="usearch_torch benchmark")
    parser.add_argument("--vectors", help=".fbin/.hbin/.i8bin dataset matrix")
    parser.add_argument("--queries", help="queries matrix (default: dataset)")
    parser.add_argument("--neighbors", help="ground-truth neighbor ids (.ibin)")
    parser.add_argument("--synthetic", type=int, default=0, help="generate N random vectors")
    parser.add_argument("--ndim", type=int, default=96)
    parser.add_argument("--metric", default="ip")
    parser.add_argument("--quantization", default="bf16")
    parser.add_argument("-k", "--count", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8192)
    parser.add_argument("--exact", action="store_true", help="force exact scans")
    parser.add_argument("--ivf", action="store_true", help="build IVF partitions")
    parser.add_argument("--reorder", action="store_true", help="in-place cluster-major IVF")
    parser.add_argument(
        "--probe-curve", action="store_true",
        help="with --ivf: print the recall/QPS vs probe-budget sweep",
    )
    parser.add_argument("--connectivity", type=int, default=16)
    parser.add_argument("--expansion-add", type=int, default=128)
    parser.add_argument("--expansion-search", type=int, default=64)
    parser.add_argument("--limit", type=int, default=None, help="cap dataset rows")
    parser.add_argument("--device", default="cuda", help='"cuda" (the default) or "cpu"')
    args = parser.parse_args(argv)

    from . import Index
    from .eval import recall_at_k
    from .io import load_matrix

    if args.vectors:
        vectors = load_matrix(args.vectors, count_rows=args.limit)
        queries = load_matrix(args.queries) if args.queries else vectors[: args.batch]
        neighbors = load_matrix(args.neighbors) if args.neighbors else None
    else:
        n = args.synthetic or 100_000
        rng = np.random.default_rng(0)
        vectors = rng.standard_normal((n, args.ndim), dtype=np.float32)
        vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
        queries = vectors[rng.integers(0, n, min(args.batch, n))]
        neighbors = None

    index = Index(
        ndim=vectors.shape[1],
        metric=args.metric,
        dtype=args.quantization,
        connectivity=args.connectivity,
        expansion_add=args.expansion_add,
        expansion_search=args.expansion_search,
        device=args.device,
    )
    index.reserve(len(vectors))

    t0 = time.perf_counter()
    index.add(np.arange(len(vectors), dtype=np.uint64), vectors)
    if index.device.type == "cuda":
        torch.cuda.synchronize(index.device)
    add_dt = time.perf_counter() - t0

    if args.ivf:
        t0 = time.perf_counter()
        index.optimize(reorder=args.reorder)
        print(f"ivf build: {time.perf_counter()-t0:.2f}s", flush=True)
        if args.probe_curve:
            from .eval import probe_curve

            for point in probe_curve(index, queries, args.count):
                print(json.dumps(point), flush=True)

    index.search(queries, args.count, exact=args.exact)  # warm-up
    t0 = time.perf_counter()
    matches = index.search(queries, args.count, exact=args.exact)
    search_dt = time.perf_counter() - t0

    report = {
        "vectors": int(len(vectors)),
        "ndim": int(vectors.shape[1]),
        "metric": args.metric,
        "quantization": args.quantization,
        "device": str(index.device),
        "add_per_second": round(len(vectors) / add_dt, 1),
        "qps": round(len(queries) / search_dt, 1),
        "k": args.count,
    }
    if neighbors is not None:
        report["recall_at_k"] = round(recall_at_k(matches, neighbors, args.count), 4)
        report["recall_at_1"] = round(
            float(np.mean(matches.keys[:, 0] == neighbors[:, 0])), 4
        )
    print(json.dumps(report))


if __name__ == "__main__":
    main()
