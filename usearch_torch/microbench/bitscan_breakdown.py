"""Where the time of the exact b1 scan (csrc/bitscan.cu `bit_scan_wgmma`)
goes.

    python -m usearch_torch.microbench.bitscan_breakdown [--against CHECKOUT]

Builds csrc/bitscan.cu again with parts of `bit_scan_wgmma` taken out, each
a copy of the source with one or more lines replaced (`PARTS`), as
`scan_breakdown` and `probe_breakdown` do, and times each through
`ops/bitscan.bit_scan` at the exact b1 searches' arguments (chip_smoke.py's
BINARY): 2^20 packed 1,024-bit rows, the first 1,000,000 of them live rows
of the clustered corpus (400 template rows, 8% of the bits flipped) and the
rest zero and dead, as the index's capacity pads them; 4,096 member
queries; k = 10; under hamming and tanimoto, and beside them a uniformly
random table of 2^20 live rows with 4,096 random queries. The variants:
the full kernel; the product alone (no waits on, and no refills of, the
table ring; nothing after the product); the product and the prefilter (no
turns and no insertions: no list ever changes); the product, the
prefilter and the turns without `insert_pair`'s shift (a passing pair
takes the list's last place); the full kernel without the splits' shared
bound (each split's line drawn from its own list alone). Each variant but
the last computes garbage where its part is missing; only its time means
anything.

A counting build (`COUNTS`) runs each case once and prints, over the whole
launch: the pairs that pass the prefilter, those of them in the first 16
tiles of a split, the insertions into a list, and the `select_query` calls
that run a turn and the turns they run. It prints each instantiation's
registers and spills from nvcc's report. With ``--against CHECKOUT`` it
also builds that checkout's csrc/bitscan.cu (e.g. the parent commit's,
unpacked with `git archive`), checks that it gives the same results on the
same inputs, prints its registers and spills, and times it first and last:
``other``, the variants, ``full`` again, ``other`` again. Needs a CUDA card
and nvcc; the copies are built into usearch_torch/_build/.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
import sys
import time
from pathlib import Path

import torch

from .. import build
from ..enums import MetricKind, ScalarKind
from ..ops import bitscan
from ..ops.distances import row_stats
from ..ops.packbits import pack_bits
from . import time_once
from .scan_breakdown import build_other, build_variants, card_line, run

SEED = 0
#: the exact b1 searches of chip_smoke.py: padded rows, bits a row, live
#: rows, template rows, share of the bits flipped, queries, k
N, BITS, LIVE, TEMPLATES, FLIP, Q, K = 1 << 20, 1024, 1_000_000, 400, 0.08, 4096, 10
#: source lines of csrc/bitscan.cu and what each variant puts in their place
_LOADS = [("    mbar_wait(full + slot, ic.phase);\n", ""),
          ("    if (old % 2 == 1 && c.n + L.stages < steps)", "    if (false)")]
_FILTER = ("        filter_tile<kMetric>(acc[u], buf,",
           "        if (acc[u][0] == 12345) out_d[0] = 1.0f;\n        if (false) filter_tile<kMetric>(acc[u], buf,")
_SELECT = ("  if (!__any_sync(0xffffffffu, some[0] || some[1])) return;\n",
           "  if (!__any_sync(0xffffffffu, (some[0] || some[1]) && row0 == -7)) return;\n")
_SHIFT = ("  while (j > 0) {\n", "  while (j > 0 && k < 0) {\n")
_SHARED = ("  int* bound_q = splits > 1 ? reinterpret_cast<int*>(out_d) : nullptr;\n", "  int* bound_q = nullptr;\n")
PARTS = {
    "full": [],
    "product_only": _LOADS + [_FILTER],
    "product_prefilter": [_SELECT],
    "no_insert_shift": [_SHIFT],
    "no_shared_bound": [_SHARED],
}
#: the counting build: a device array of counts, added to where a pair
#: passes, a warp enters the selection, a list takes an entry and a warp
#: runs a turn, the rows of a split (to tell its first 2,048 rows), and a C
#: function that copies the counts out and zeroes them
COUNT_NAMES = ("prefilter passes", "passes in a split's first 2,048 rows", "insertions", "select_query calls",
               "turns", "warp tiles past the prefilter")
COUNTS = [
    ("constexpr int kMergeThreads = 128;\n",
     "constexpr int kMergeThreads = 128;\n__device__ unsigned long long bitscan_counts[6];\n"
     "__device__ int bitscan_split_rows;\n"),
    ("  const uint32_t todo = __ballot_sync(0xffffffffu, cand != 0u);\n",
     "  if (cand) {\n"
     "    atomicAdd(&bitscan_counts[0], static_cast<unsigned long long>(__popc(cand)));\n"
     "    if (row0 - static_cast<int>(blockIdx.y) * bitscan_split_rows < 2048)\n"
     "      atomicAdd(&bitscan_counts[1], static_cast<unsigned long long>(__popc(cand)));\n"
     "  }\n"
     "  const uint32_t todo = __ballot_sync(0xffffffffu, cand != 0u);\n"),
    ("        if (before(v, row, s.thr, s.thr_r)) {\n",
     "        if (before(v, row, s.thr, s.thr_r)) {\n          atomicAdd(&bitscan_counts[2], 1ull);\n"),
    ("  if (todo == 0u) return;\n",
     "  if (todo == 0u) return;\n  if (lane == 0) atomicAdd(&bitscan_counts[3], 1ull);\n"),
    ("    if (!(todo & (0x11111111u << turn))) continue;\n",
     "    if (!(todo & (0x11111111u << turn))) continue;\n    if (lane == 0) atomicAdd(&bitscan_counts[4], 1ull);\n"),
    ("  uint32_t cand[2] = {0u, 0u};\n",
     "  uint32_t cand[2] = {0u, 0u};\n  if (lane == 0) atomicAdd(&bitscan_counts[5], 1ull);\n"),
    ("  CUtensorMap q_map, t_map;\n",
     "  if (cudaMemcpyToSymbolAsync(bitscan_split_rows, &split_rows, sizeof(int), 0, cudaMemcpyHostToDevice,\n"
     "                              static_cast<cudaStream_t>(stream)) != cudaSuccess)\n"
     "    return cudaErrorInvalidValue;\n"
     "  CUtensorMap q_map, t_map;\n"),
    ('}  // extern "C"\n',
     "int usearch_bit_scan_counts(unsigned long long* out) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, bitscan_counts, sizeof(bitscan_counts));\n"
     "  const unsigned long long zero[6] = {};\n"
     "  if (err == cudaSuccess) err = cudaMemcpyToSymbol(bitscan_counts, zero, sizeof(zero));\n"
     "  return static_cast<int>(err);\n"
     "}\n\n"
     '}  // extern "C"\n'),
]
_FUNCTION = re.compile(r"Function properties for (\S+)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def usage(report: str) -> dict:
    """Registers and spill bytes (stores, loads) of each `bit_scan_*`
    function in nvcc's ``-Xptxas -v`` report, by a short name."""
    out, name = {}, None
    for line in report.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            continue
        if name is None or "bit_scan_" not in name:
            continue
        m = _SPILLS.search(line)
        if m:
            out.setdefault(short(name), {})["spills"] = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m:
            out.setdefault(short(name), {})["registers"] = int(m.group(1))
    return out


def short(mangled: str) -> str:
    """``bit_scan_wgmma<3, 1>`` for a mangled `bit_scan_*` name."""
    m = re.search(r"\d+(bit_scan_[a-z_]+)(I(?:L[a-z]\d+E)+E)?", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def print_usage(label: str, report: str) -> None:
    for line in report.splitlines():
        if "warning" in line.lower():
            print(f"{label:26s} {line.strip()}", flush=True)
    for name, u in sorted(usage(report).items()):
        spills = u.get("spills", (0, 0))
        print(f"{label:26s} {name:45s} {u.get('registers', 0):4d} registers, spill stores {spills[0]} B, "
              f"loads {spills[1]} B", flush=True)


def clustered(dev, gen):
    """chip_smoke.py's binary corpus at the index's capacity: LIVE rows of
    a template each with FLIP of the bits flipped, zero rows past them, and
    Q member queries."""
    templates = torch.randint(0, 2, (TEMPLATES, BITS), generator=gen, device=dev, dtype=torch.uint8)
    x = torch.zeros((N, BITS // 8), dtype=torch.uint8, device=dev)
    for lo in range(0, LIVE, 1 << 17):
        m = min(1 << 17, LIVE - lo)
        pick = torch.randint(0, TEMPLATES, (m,), generator=gen, device=dev)
        flips = torch.rand((m, BITS), generator=gen, device=dev) < FLIP
        x[lo : lo + m] = pack_bits(templates[pick] ^ flips)
    valid = torch.arange(N, device=dev) < LIVE
    return x, x[torch.randperm(LIVE, generator=gen, device=dev)[:Q]], valid


def cases(dev) -> dict:
    """`bit_scan`'s arguments of each case, by tag."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    tables = {"clustered": clustered(dev, gen)}
    uniform = torch.randint(0, 256, (N, BITS // 8), generator=gen, device=dev, dtype=torch.uint8)
    tables["uniform"] = (uniform, torch.randint(0, 256, (Q, BITS // 8), generator=gen, device=dev,
                                                dtype=torch.uint8), torch.ones(N, dtype=torch.bool, device=dev))
    for name, (table, q, valid) in tables.items():
        t_pop, q_pop = row_stats(table, ScalarKind.B1)[:, 0], row_stats(q, ScalarKind.B1)[:, 0]
        for metric in (MetricKind.Hamming, MetricKind.Tanimoto):
            tag = f"{metric.value} {name}, Q={Q:,} N=2^20 k={K}"
            out[tag] = (metric, q, table, q_pop, t_pop, valid, K)
    return out


def count(lib, args_by_tag: dict) -> None:
    """Each case once through the counting build: its counts."""
    build._libs["bitscan"] = lib
    fn = lib.usearch_bit_scan_counts
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    counts = (ctypes.c_ulonglong * len(COUNT_NAMES))()
    try:
        fn(counts)  # zero them
        for tag, args in args_by_tag.items():
            bitscan.bit_scan(*args)
            torch.cuda.synchronize()
            if fn(counts):
                raise RuntimeError("usearch_bit_scan_counts failed")
            pairs = args[1].shape[0] * args[2].shape[0]
            text = ", ".join(f"{name} {int(c):,}" for name, c in zip(COUNT_NAMES, counts))
            print(f"{'counts':26s} {tag:45s} of {pairs:,} pairs: {text} "
                  f"(passes {counts[0] / pairs:.2e} of the pairs)", flush=True)
    finally:
        build._libs.pop("bitscan", None)


def blocks_per_sm(checkout: Path) -> int:
    """The blocks an SM that another checkout's scan kernel declares (its
    kBlocksPerSM; one where it declares none, as PR 25's kernel did): its
    splits are cut for that many."""
    text = (checkout / "usearch_torch" / "csrc" / "bitscan.cu").read_text()
    m = re.search(r"constexpr int kBlocksPerSM = (\d+);", text)
    return int(m.group(1)) if m else 1


@contextlib.contextmanager
def bound(lib, blocks: int):
    """``lib`` in the place of csrc/bitscan.cu's library, its splits cut for
    ``blocks`` an SM."""
    saved = bitscan.BLOCKS_PER_SM
    build._libs["bitscan"], bitscan.BLOCKS_PER_SM = lib, blocks
    try:
        yield
    finally:
        build._libs.pop("bitscan", None)
        bitscan.BLOCKS_PER_SM = saved


def against(other, blocks: int, libs: dict, runs: dict, dev) -> None:
    """The other checkout's kernel held against this one's on the same
    inputs (equal results), then timed first and last around this
    checkout's variants."""
    want = {tag: fn() for tag, fn in runs.items()}
    with bound(other, blocks):
        for tag, fn in runs.items():
            same = all(torch.equal(a, b) for a, b in zip(fn(), want[tag]))
            print(f"{'other':26s} {tag:45s} {'the same results' if same else 'OTHER RESULTS'}", flush=True)

    def timed(label):
        with bound(other, blocks):
            for tag, fn in runs.items():
                print(f"{label:26s} {tag:45s} {time_once(fn, dev, reps=5) * 1e3:9.3f} ms", flush=True)

    timed("other")
    run({**libs, "full again": libs["full"]}, "bitscan", runs, dev)
    timed("other again")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bitscan_breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()
    libs = build_variants({**PARTS, "counts": COUNTS}, "bitscan.cu")
    other = build_other(Path(argv[1]), "bitscan") if argv[:1] == ["--against"] else None
    print(f"{card}; {len(libs) + (other is not None)} builds in {time.perf_counter() - t0:.1f} s", flush=True)
    print_usage("full", libs["full"].report)
    if other is not None:
        print_usage("other", other.report)
    dev = torch.device("cuda")
    args = cases(dev)
    runs = {tag: functools.partial(bitscan.bit_scan, *a) for tag, a in args.items()}
    counter = libs.pop("counts")
    if other is not None:
        against(other, blocks_per_sm(Path(argv[1])), libs, runs, dev)
    else:
        run(libs, "bitscan", runs, dev)
    count(counter, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
