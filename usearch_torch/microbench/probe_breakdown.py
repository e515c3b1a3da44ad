"""Where the time of the tensor-core grouped probe kernels (csrc/probe.cu
`grouped_wgmma`: B3 and B5 over i8, bf16 and packed b1, B6's lists and B7
over i8) goes.

    python -m usearch_torch.microbench.probe_breakdown [--against CHECKOUT]

Builds csrc/probe.cu again with parts of `grouped_wgmma` taken out, each a
copy of the source with one or more lines replaced (`PARTS`), as
`scan_breakdown` and `fused_breakdown` do, and times B3 and B5 i8 through
their wrappers at the IVF path's pairs (chip_smoke.py's IVF): an i8 ip
index of 1M unit rows of width 256, `optimize(n_partitions=1024,
reorder=True, spill=0.05)`, `expansion_search = 1024`, 16,384 member
queries at k=10, the grouped probe's arguments (B3) and the `nofold`
flavour's (B5) captured from one search each, and B3's for the first
1,024 of the queries (a small batch: few pairs share a window); and B3
over b1 (B4) and B5 over b1 at the binary IVF paths' pairs (chip_smoke.py's
BINARY, scripts/tpu_binary_ivf_bench.py's shape): 1M packed 1024-bit rows
of a clustered corpus (400 template rows, 8% of the bits flipped), a
hamming and a tanimoto index, each `optimize(n_partitions=976,
reorder=True)`, `expansion_search = 1024`, 4,096 member queries at k=10,
the hamming search's B3 call and the tanimoto search's B5 call (its
hamming select) captured, and B3 over B4's pairs with their bytes read as
i8 rows (l2sq; the s8 product at B4's steps, to hold the b1 product's rate
against); and at the i8 index's `pair` and `bin` searches, B6 whole and
in its three steps (the pairs' sort `pair_cells`, the lists `pair_lists`
on `grouped_wgmma`, the fold `pair_fold` of csrc/pair.cu) and B7; and B3,
B5 and B6 over f32 rows (the three-pass TF32 product) at an f32 cos IVF of
the same rows and queries, built as the i8 one. The variants replace the
same lines for every storage type (b1 differs from i8 in its product
alone, f32 in its K-block loop: the split and three products a k-step):
the full kernel;
no fold or stores (B3's merges into the lanes' lists, so the lists
never fill and never prune a row, and B5's and B7's stores of the bins'
lists); no selection (the rows are scored, but no thread keeps a list and
the quads merge none; B7 takes no round); no epilogue (nothing after
the product); the product alone (no waits for, and no refills of, the
table ring, no epilogue: the product runs on whatever the slots hold); the
table stream alone (no product, no epilogue; over f32 the split stays);
no split (f32: the bin's K-block is not split; its barriers stay). Each
variant computes garbage where its part is missing; only its time means
anything. It prints the card's name and power limit and one line per
variant and kernel. With ``--against CHECKOUT`` it also builds that checkout's
csrc/probe.cu (e.g. the parent commit's, unpacked with `git archive`),
checks that it gives the same results on the same inputs (over f32, whose
product the parent took in SIMT FMAs, prints how far apart), and times it as
one more variant, first and last: ``other``, ``full``, the parts, ``full``
again, ``other`` again (B6's lists and steps only where that checkout has
``usearch_pair_lists``). Needs a CUDA card and nvcc; the copies are built
into usearch_torch/_build/.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

from .. import Index, ivf
from ..enums import MetricKind
from ..ops import probe
from ..ops.packbits import pack_bits
from .scan_breakdown import against, build_other, build_variants, card_line, run

SEED = 0
#: the IVF path of chip_smoke.py
N, W, Q, K, PARTITIONS, SPILL, EXPANSION = 1_000_000, 256, 16384, 10, 1024, 0.05, 1024
#: its binary IVF paths: bits a row, queries, template rows, share of bits
#: flipped, partitions (N rows, K and EXPANSION as above)
BITS, BIT_Q, TEMPLATES, FLIP, BIT_PARTITIONS = 1024, 4096, 400, 0.08, 976
#: the small batch of chip_smoke.py's B3 row: the first SMALL_Q queries
SMALL_Q = 1024
#: the tag of B6's cases, which need B6's lists in the probe library
B6 = "B6"
#: source lines of csrc/probe.cu and what each variant puts in their place
_FOLD_STORES = [("        if (m > 0) {\n", "        if (m > 0 && cv[0] == 12345.0f) {\n"),
                ("                if (j >= p.bin_m || bi[u][j] == INT_MAX) break;\n",
                 "                if (j >= p.bin_m || bi[u][j] == INT_MAX || bv[u][j] != 12345.0f) break;\n"),
                ("              const bool writer = act[h] && (l & (sharing - 1)) == (t & (sharing - 1));\n",
                 "              const bool writer =\n"
                 "                  act[h] && (l & (sharing - 1)) == (t & (sharing - 1)) && bk[h][0] == 12345;\n")]
_SELECTION = [("                if (!act[h] || !in || !(v <= thr[u]) || !(v < bv[u][kM - 1])) continue;\n",
               "                if (!act[h] || !in || v != 12345.0f) continue;\n"),
              ("            quad_merge<kM>(bv[u], bi[u]);\n", ""),
              ("          for (int t = 0; t < p.keep; ++t) {\n", "          for (int t = 0; t < 0; ++t) {\n")]
_EPILOGUE = ("      if (!warp_active) continue;\n",
             "      if (dot_value<kSmall>(acc[0]) == 12345.0f && warp_active) p.out_d[0] = 1.0f;\n      continue;\n")
_PRODUCT = [("          for (int k = 0; k < kKB / 32; ++k) {\n"
             "            if constexpr (kB1) mma_popc(acc, da + 2 * k, db + 2 * k, kb | k);\n"
             "            else mma_k(acc, da + 2 * k, db + 2 * k, kb | k);\n"
             "          }\n",
             "          (void)da;\n          (void)db;\n"),
            ("          for (int k = 0; k < kKB / 32; ++k) "
             "mma_tf32x3(acc, qh, ql, k, db + 2 * k, dl + 2 * k, kb | k);\n",
             "          (void)dl;\n")]
_LOADS = [("          mbar_wait(full + slot, (n / L.stages) & 1);\n", ""),
          ("        mbar_wait(full + n % L.stages, (n / L.stages) & 1);\n", ""),
          ("  if (old % kUsers == kUsers - 1 && m < steps)", "  if (false)")]
#: f32: the split of the bin's K-block (the barriers stay)
_SPLIT = [("        if constexpr (kTF32) probe_split(ring + n % L.stages * L.stage_bytes, tid);",
           "        if constexpr (kTF32) {\n          block_sync();\n          block_sync();\n        }"),
          ("          probe_split(buf, tid);\n", "          block_sync();\n          block_sync();\n")]
PARTS = {
    "full": [],
    "no_fold_or_stores": _FOLD_STORES,
    "no_selection": _SELECTION,
    "no_epilogue": [_EPILOGUE],
    "product_only": _LOADS + [_EPILOGUE],
    "stream_only": [_EPILOGUE] + _PRODUCT,
    "no_split": _SPLIT,
}


def capture(index, queries, mode: str, name: str):
    """The arguments of the one call of probe kernel ``name`` that an eager
    search of ``queries`` in probe flavour ``mode`` makes (no graph: a
    capture would call it again, a replay not at all)."""
    calls = []
    kern = getattr(probe, name)

    def spy(*args):
        calls.append(args)
        return kern(*args)

    setattr(ivf, name, spy)
    ivf.PROBE_MODE = mode
    graphs, index._graphs = index._graphs, None
    try:
        index.search(queries, K)
    finally:
        setattr(ivf, name, kern)
        ivf.PROBE_MODE = "group"
        index._graphs = graphs
    if len(calls) != 1:
        raise RuntimeError(f"the {mode} search called {name} {len(calls)} times")
    return calls[0]


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(N, W, generator=gen, device=dev)
    x = x / x.norm(dim=1, keepdim=True)
    index = Index(ndim=W, metric="ip", dtype="i8", device=dev)
    index.add(None, x)
    index.optimize(n_partitions=PARTITIONS, reorder=True, spill=SPILL)
    index.expansion_search = EXPANSION
    queries = x[torch.randperm(N, generator=gen, device=dev)[:Q]]
    b3 = capture(index, queries, "group", "grouped_probe")
    b5 = capture(index, queries, "nofold", "grouped_probe_nofold")
    small = capture(index, queries[:SMALL_Q], "group", "grouped_probe")
    b6 = capture(index, queries, "pair", "pair_probe")
    b7 = capture(index, queries, "bin", "binned_probe")
    metric, q, q_sq, table, t_sq, penalty, starts, offs, lens, k, w_pad, bin_m = b6
    cells = probe.pair_cells(starts, offs, lens, table.shape[0], w_pad)
    lists = probe.pair_lists(metric, q, q_sq, table, t_sq, penalty, cells, k, min(bin_m, k))
    f32 = f32_cases(x, queries)
    b4, b5_b1 = bit_cases(dev, gen)
    # B4's pairs over the same bytes read as i8 rows (l2sq): the s8 product
    # at B4's steps, beside which `product_only` times the b1 product
    b4_s8 = (MetricKind.L2sq, b4[1].view(torch.int8), b4[2], b4[3].view(torch.int8), *b4[4:])
    return {
        f"B3 i8 ip, IVF pairs P={b3[1].shape[0]:,}, k={b3[8]}": lambda: probe.grouped_probe(*b3),
        f"B5 i8 ip nofold, P={b5[1].shape[0]:,}, {b5[-1]} per bin": lambda: probe.grouped_probe_nofold(*b5),
        f"B3 i8 ip, Q={SMALL_Q:,}: P={small[1].shape[0]:,}": lambda: probe.grouped_probe(*small),
        f"B4 b1 hamming, P={b4[1].shape[0]:,}, k={b4[8]}": lambda: probe.grouped_probe(*b4),
        f"B5 b1 tanimoto, P={b5_b1[1].shape[0]:,}, {b5_b1[-1]} per bin": lambda: probe.grouped_probe_nofold(*b5_b1),
        f"B3 i8 l2sq over B4's bytes, P={b4[1].shape[0]:,}": lambda: probe.grouped_probe(*b4_s8),
        f"B7 i8 bin, P={b7[0].shape[0]:,}, {b7[4]} rows x {b7[5]} {b7[6]}": lambda: probe.binned_probe(*b7),
        f"{B6} i8 ip pair, Q={q.shape[0]:,} x {starts.shape[1]}, k={k}": lambda: probe.pair_probe(*b6),
        f"{B6} i8 ip sort, P={cells[1].shape[0]:,}":
            lambda: probe.pair_cells(starts, offs, lens, table.shape[0], w_pad),
        f"{B6} i8 ip lists, {min(bin_m, k)} per bin":
            lambda: probe.pair_lists(metric, q, q_sq, table, t_sq, penalty, cells, k, min(bin_m, k)),
        f"{B6} i8 ip fold": lambda: probe.pair_fold(metric, *lists, cells[3], q_sq, k),
        **f32,
    }


def f32_cases(x, queries) -> dict:
    """B3, B5 and B6 over f32 rows (the three-pass TF32 product) at an f32
    cos IVF of the same rows (chip_smoke.py's F32_IVF), each from one
    search of the queries in its flavour."""
    index = Index(ndim=W, metric="cos", dtype="f32", device=x.device)
    index.add(None, x)
    index.optimize(n_partitions=PARTITIONS, reorder=True, spill=SPILL)
    index.expansion_search = EXPANSION
    b3 = capture(index, queries, "group", "grouped_probe")
    b5 = capture(index, queries, "nofold", "grouped_probe_nofold")
    b6 = capture(index, queries, "pair", "pair_probe")
    return {
        f"B3 f32 cos, IVF pairs P={b3[1].shape[0]:,}, k={b3[8]}": lambda: probe.grouped_probe(*b3),
        f"B5 f32 cos nofold, P={b5[1].shape[0]:,}, {b5[-1]} per bin": lambda: probe.grouped_probe_nofold(*b5),
        f"{B6} f32 cos pair, Q={b6[1].shape[0]:,}, k={b6[9]}": lambda: probe.pair_probe(*b6),
    }


def bit_cases(dev, gen):
    """B3's arguments from a hamming search and B5's from a tanimoto search
    of the binary IVF paths' corpus, each on its own index."""
    templates = torch.randint(0, 2, (TEMPLATES, BITS), generator=gen, device=dev, dtype=torch.uint8)
    x = torch.empty((N, BITS // 8), dtype=torch.uint8, device=dev)
    for lo in range(0, N, 1 << 17):
        m = min(1 << 17, N - lo)
        pick = torch.randint(0, TEMPLATES, (m,), generator=gen, device=dev)
        flips = torch.rand((m, BITS), generator=gen, device=dev) < FLIP
        x[lo : lo + m] = pack_bits(templates[pick] ^ flips)
    queries = x[torch.randperm(N, generator=gen, device=dev)[:BIT_Q]]
    out = []
    for metric, name in (("hamming", "grouped_probe"), ("tanimoto", "grouped_probe_nofold")):
        index = Index(ndim=BITS, metric=metric, dtype="b1", device=dev)
        index.add(None, x)
        index.optimize(n_partitions=BIT_PARTITIONS, reorder=True)
        index.expansion_search = EXPANSION
        out.append(capture(index, queries, "group", name))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("probe_breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()
    libs = build_variants(PARTS, "probe.cu")
    if argv[:1] == ["--against"]:
        libs["other"] = build_other(Path(argv[1]), "probe")
    print(f"{card}; {len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    runs = cases(dev)
    if "other" in libs:
        mine = {tag: fn for tag, fn in runs.items()
                if hasattr(libs["other"], "usearch_pair_lists") or not tag.startswith(B6)}
        against(libs, "probe", runs, dev, mine)
        return 0
    run(libs, "probe", runs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
