"""Where the time of the tensor-core flat-scan flavours (csrc/fused.cu
`fused_wgmma`: B8, B9 and B10) goes.

    python -m usearch_torch.microbench.fused_breakdown [--against CHECKOUT]

Builds csrc/fused.cu again with parts of `fused_wgmma` taken out or
changed, each a copy of the source with one or more lines replaced
(`PARTS`), as `scan_breakdown` does for B1/B2, and times B8, B9 and B10
through their wrappers at the main path's shape (chip_smoke.py's MAIN): i8
ip over 2^20 x 256 rows, 1% of them deleted, 16,384 queries, k=10; and
over f32 rows (the three-pass TF32 product) at the f32 cos table's shape
(chip_smoke.py's COMPACT): 262,144 x 256 unit rows, 1% deleted, 16,384
queries, k=10. The variants: the full kernel; no merges (B8's inserts,
B9's gathered merges); no stores (B10's [n_bins, n_q] minima and rows); no
epilogue (bin minima, merges and stores); the product alone (no waits for,
and no refills of, the table ring: the product runs on whatever the slots
hold); the table stream alone (over f32 with the split); no split (f32:
the table K-block is not split, the barrier stays). A variant that takes
out another flavour's part times the full kernel. Each variant computes
garbage where its part is missing; only its time means anything. It prints
the card's name and power limit and one line per variant and kernel. With
``--against CHECKOUT`` it also builds that checkout's csrc/fused.cu (e.g.
the parent commit's, unpacked with `git archive`), prints whether it gives
the same results on the same inputs (over f32, how far apart), and times it
first and last: ``other``, ``full``, the parts, ``full`` again, ``other``
again. Needs a CUDA card and nvcc; the copies are built into
usearch_torch/_build/.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

from ..enums import MetricKind, ScalarKind
from ..ops import scan
from ..ops.casts import cast_rows
from ..ops.distances import row_stats
from .scan_breakdown import against, build_other, build_variants, card_line, run

SEED = 0
#: source lines of csrc/fused.cu and what each variant puts in their place
_MERGES = [("        if (owner) insert(list_d, list_i, k, ls, thr, v, id);\n",
            "        if (owner && v == 12345.0f) list_d[0] = v + id;\n"),
           ("          if (owner) merge(list_d, list_i, k, ls, thr, cand_v + col, cand_i + col, n_cand, kQT);\n",
            "          if (owner && cand_v[col] == 12345.0f) list_d[0] = cand_i[col];\n")]
_EPILOGUE = ("    bool exact_all[2];\n#pragma unroll\n    for (int h = 0; h < 2; ++h) exact_all[h] = (kMetric",
             "    if (dot_value<kSmall>(acc[0]) == 12345.0f && flag) out_d[0] = 1.0f;\n    continue;\n"
             "    bool exact_all[2];\n#pragma unroll\n    for (int h = 0; h < 2; ++h) exact_all[h] = (kMetric")
_STORES = ("        if (owner) {\n          out_d[(size_t)(2 * i + b) * n_q + qi] = v;\n",
           "        if (owner && v == 12345.0f) {\n          out_d[(size_t)(2 * i + b) * n_q + qi] = v;\n")
_PRODUCT = [("        for (int s = 0; s < kKB / 32; ++s) mma_k(acc, da + 2 * s, db + 2 * s, kb | s);\n",
             "        (void)da;\n        (void)db;\n"),
            ("        for (int s = 0; s < kKB / 32; ++s) "
             "mma_tf32x3(acc, qh, ql, s, db + 2 * s, dl + 2 * s, kb | s);\n",
             "        (void)dl;\n")]
_LOADS = [("        mbar_wait(full + slot, (n / L.stages) & 1);\n", ""),
          ("  if (old % kUsers == kUsers - 1 && n + L.stages < steps)", "  if (false)")]
#: f32: the split of the table K-block (the barrier stays)
_SPLIT = ("        split_tile(buf, lo, kTStage, tid, kBlock);\n", "")
PARTS = {
    "full": [],
    "no_merges": _MERGES,
    "no_stores": [_STORES],
    "no_epilogue": [_EPILOGUE],
    "product_only": _LOADS + [_EPILOGUE],
    "stream_only": [_EPILOGUE] + _PRODUCT,
    "no_split": [_SPLIT],
}


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 1 << 20
    t8 = cast_rows(torch.randn(n, 256, generator=gen, device=dev), ScalarKind.F32, ScalarKind.I8)
    q8 = cast_rows(torch.randn(16384, 256, generator=gen, device=dev), ScalarKind.F32, ScalarKind.I8)
    v8 = torch.rand(n, generator=gen, device=dev) >= 0.01
    ip = MetricKind.IP
    a8 = (ip, q8, t8, *scan.scan_aux(ip, q8, row_stats(t8, ScalarKind.I8), v8))
    tf = torch.randn(262144, 256, generator=gen, device=dev)
    tf /= tf.norm(dim=1, keepdim=True)
    qf = tf[torch.randperm(262144, generator=gen, device=dev)[:16384]]
    vf = torch.rand(262144, generator=gen, device=dev) >= 0.01
    cos = MetricKind.Cos
    af = (cos, qf, tf, *scan.scan_aux(cos, qf, row_stats(tf, ScalarKind.F32), vf))
    return {
        "B8 i8 ip, 2^20 x 256, Q=16,384, k=10": lambda: scan.fused_topk(*a8, 10),
        "B9 i8 ip, 2^20 x 256, Q=16,384, k=10": lambda: scan.fused_topk_stream(*a8, 10),
        "B10 i8 ip, 2^20 x 256, Q=16,384": lambda: scan.binned_scan_lanes(*a8),
        "B8 f32 cos, 262,144 x 256, Q=16,384, k=10": lambda: scan.fused_topk(*af, 10),
        "B9 f32 cos, 262,144 x 256, Q=16,384, k=10": lambda: scan.fused_topk_stream(*af, 10),
        "B10 f32 cos, 262,144 x 256, Q=16,384": lambda: scan.binned_scan_lanes(*af),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("fused_breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    t0 = time.perf_counter()
    libs = build_variants(PARTS, "fused.cu")
    if argv[:1] == ["--against"]:
        libs["other"] = build_other(Path(argv[1]), "fused")
    print(f"{card}; {len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    runs = cases(dev)
    if "other" in libs:
        against(libs, "fused", runs, dev, runs)
    else:
        run(libs, "fused", runs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
