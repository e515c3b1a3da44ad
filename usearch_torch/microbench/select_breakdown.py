"""Where the time of kernel B12 (csrc/select.cu, the selection loop) goes.

    python -m usearch_torch.microbench.select_breakdown [--against CHECKOUT]

Builds csrc/select.cu again with parts of the kernel changed, each a copy of
the source with one or more lines replaced (`PARTS`), and times every
variant of `ops.microbench.select_loop` through the wrapper at the TPU
script's shape (select_microbench's W, G, IT and SEED), as chip_smoke.py's
phase 5 does: the mean of 20 launches of 1, IT and 2 IT passes, one pass
taken as (t(IT) - t(1)) / (IT - 1), and the same at 2 IT, whose distance
is PASS_STEADY's. `PARTS`: the full kernel; `reads_only`, the reducing
variants reading their tiles (and nothing else: the loads are volatile,
so they stay) with the selects taken out; `two_tiles`, two tiles of
registers, the next one's loads issued before this one is reduced;
`one_slot`, one pass at a time a block. A variant with a part missing computes
garbage; only its time means anything. With ``--against CHECKOUT`` it also
builds that checkout's csrc/select.cu (e.g. the parent commit, unpacked
with `git archive`), holds its results against this checkout's, and times
it first and last: other, every part, full again, other again. Prints the
card's name and power limit and the grid's blocks. Needs a CUDA card and
nvcc; the copies are built into usearch_torch/_build/.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from .. import build
from ..ops import microbench
from . import select_microbench, time_once
from .scan_breakdown import build_other, build_variants, card_line

#: source lines of csrc/select.cu and what each part puts in their place
PARTS = {
    "full": [],
    "reads_only": [("  for (int b = 0; b < 128 / kGroup; ++b) group_select<kV, kGroup>(a, add, b, c2, isum, fsum);\n",
                    "  (void)a;\n")],
    "two_tiles": [("""    uint32_t a[16][2][2];
#pragma unroll 1
    for (int t0 = 0; t0 < w; t0 += 128) {
      load_tile(xr, t0, a);
      tile_select<kV, kGroup>(a, add, c2, isum, fsum);
    }
""", """    uint32_t a[16][2][2], b[16][2][2];
    load_tile(xr, 0, a);
#pragma unroll 1
    for (int t0 = 0; t0 < w; t0 += 256) {
      if (t0 + 128 < w) load_tile(xr, t0 + 128, b);
      tile_select<kV, kGroup>(a, add, c2, isum, fsum);
      if (t0 + 128 < w) {
        if (t0 + 256 < w) load_tile(xr, t0 + 256, a);
        tile_select<kV, kGroup>(b, add, c2, isum, fsum);
      }
    }
""")],
    "one_slot": [("constexpr int kSlots = 2; ", "constexpr int kSlots = 1; ")],
}
#: launches a timed call averages, as chip_smoke.py's
REPS = 20


def pass_times(x: torch.Tensor, variant: str, it: int, dev) -> dict:
    """ms of 1, IT and 2 IT passes and the time of one pass (us) at IT and
    at 2 IT, as chip_smoke.py's `select_rows` takes them."""
    ms1, ms, ms2 = (time_once(lambda: microbench.select_loop(x, variant, n), dev, reps=REPS) * 1e3
                    for n in (1, it, 2 * it))
    pp, pp2 = (ms - ms1) / (it - 1) * 1e3, (ms2 - ms1) / (2 * it - 1) * 1e3
    return dict(ms1=ms1, ms=ms, ms2=ms2, us_per_pass=pp, us_per_pass2=pp2, steady=abs(pp2 - pp) / pp)


def run(libs: dict, x: torch.Tensor, it: int, dev) -> None:
    """One line per library and variant, each library bound in the place
    of csrc/select.cu's."""
    try:
        for name, lib in libs.items():
            build._libs["select"] = lib
            for variant in microbench.SELECT_VARIANTS:
                blocks = microbench.select_blocks(x.shape[1], variant, dev) if hasattr(lib, "usearch_select_blocks") \
                    else "-"
                t = pass_times(x, variant, it, dev)
                print(f"{name:13s} {variant:14s} blocks {blocks!s:4s} 1 pass {t['ms1'] * 1e3:8.3f} us, {it} passes "
                      f"{t['ms'] * 1e3:9.3f} us, {2 * it} passes {t['ms2'] * 1e3:9.3f} us; one pass "
                      f"{t['us_per_pass']:.5f} us at {it}, {t['us_per_pass2']:.5f} at {2 * it} "
                      f"({t['steady']:.1%} apart)", flush=True)
    finally:
        build._libs.pop("select", None)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("select_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    w, g, it = select_microbench.W, select_microbench.G, select_microbench.IT
    x = select_microbench.buffer(w, g, select_microbench.SEED, dev)
    libs = build_variants(PARTS, source="select.cu")
    print(f"B12 at W={w} G={g} IT={it}: {REPS} launches a time", flush=True)
    if argv[:1] == ["--against"]:
        other = build_other(Path(argv[1]), "select")
        build._libs["select"] = libs["full"]
        want = {v: microbench.select_loop(x, v, it) for v in microbench.SELECT_VARIANTS}
        build._libs["select"] = other
        try:
            for v in microbench.SELECT_VARIANTS:
                got = microbench.select_loop(x, v, it)
                print(f"other         {v:14s} {'the same results' if torch.equal(got, want[v]) else 'OTHER RESULTS'}"
                      f" (max abs difference {float((got - want[v]).abs().max()):.3g})", flush=True)
        finally:
            build._libs.pop("select", None)
        run({"other": other}, x, it, dev)
        run({**libs, "full again": libs["full"]}, x, it, dev)
        run({"other again": other}, x, it, dev)
    else:
        run({**libs, "full again": libs["full"]}, x, it, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
