"""Where the time of the scan kernels (csrc/scan.cu, B1/B2) goes.

    python -m usearch_torch.microbench.scan_breakdown

Builds csrc/scan.cu again with parts of a kernel taken out, each a copy of
the source with one or more lines replaced, and times B1 and B2 through
their wrappers at the main paths' shapes (chip_smoke.py's MAIN and
COMPACT). `PARTS` take parts out of the tensor-core kernel `wgmma_scan`,
timed on i8 ip over 2^20 x 256 rows with 16,384 and 1,024 queries and on
the f32 cos compact path over 262,144 x 256 rows with 16,384 queries;
`SIMT_PARTS` out of the SIMT f32 kernel `simt_scan` (the exact f32 path),
timed on B2 and B1 f32 cos over 262,144 x 256 rows with 1,024 queries
(no TF32): the full kernel, the product alone (no copies, no epilogue),
the copies alone (no product, no epilogue) and no epilogue. Each variant
computes garbage where its part is missing; only its time means anything.
It prints the card's name and power limit, one line per variant and shape,
and f32 `torch.matmul` of the SIMT shape's operands as its yardstick.
Needs a CUDA card and nvcc; the copies are built into usearch_torch/_build/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

from .. import build
from ..enums import MetricKind, ScalarKind
from ..ops import scan
from ..ops.casts import cast_rows
from ..ops.distances import row_stats
from . import time_once

SEED = 0
#: source lines of csrc/scan.cu and what each variant puts in their place
_EPILOGUE = ("  const int c2 = 2 * (lane % 4);\n  float qs[2], qr[2], iqr[2];\n",
             "  const int c2 = 2 * (lane % 4);\n"
             "  if (dot_value<kSmall>(acc[0]) == 12345.0f) static_cast<char*>(out_v)[0] = 1;\n"
             "  return;\n  float qs[2], qr[2], iqr[2];\n")
_PRODUCT = ("      for (int k = 0; k < kKB / 32; ++k) mma_k(acc, da + 2 * k, db + 2 * k, kb | k);\n",
            "      (void)da;\n      (void)db;\n")
_LOADS = [("      mbar_wait(ring_full + slot, (n / L.stages) & 1);\n", ""),
          ("        if (done + L.stages < steps)\n", "        if (false)\n"),
          ("    if (last + L.stages < steps)\n", "    if (false)\n")]
_STORES = ("  if (qi >= n_q) return;\n  const float v0", "  if (qi >= n_q || n_bins != -1) return;\n  const float v0")
PARTS = {
    "full": [],
    "no_stores": [_STORES],
    "no_epilogue": [_EPILOGUE],
    "no_product": [_PRODUCT],
    "no_query_loads": _LOADS,
    "product_only": _LOADS + [_EPILOGUE],
    "query_loads_only": [_EPILOGUE, _PRODUCT],
}
_SIMT_COPIES = [("    if (s < n_slabs) fetch_slab(ring + s * kSlab, copies, width, s);\n", ""),
                ("    if (next < n_slabs) fetch_slab(ring + next % kStages * kSlab, copies, width, next);\n", "")]
_SIMT_PRODUCT = ("    slab_fma(acc, slot + ty * kSP, slot + (kBin + tx) * kSP);\n", "    (void)slot;\n")
_SIMT_EPILOGUE = ("  __syncthreads();  // every slab is read: the ring holds the dots and the rows' values now\n",
                  "  __syncthreads();\n"
                  "  float sum = 0.0f;\n#pragma unroll\n  for (int i = 0; i < kTM; ++i)\n#pragma unroll\n"
                  "    for (int j = 0; j < kTN; ++j) sum += acc[i][j];\n"
                  "  if (sum == 12345.0f) static_cast<float*>(out_v)[0] = 1.0f;\n  return;\n")
SIMT_PARTS = {
    "full": [],
    "simt_product_only": _SIMT_COPIES + [_SIMT_EPILOGUE],
    "simt_copies_only": [_SIMT_PRODUCT, _SIMT_EPILOGUE],
    "simt_no_epilogue": [_SIMT_EPILOGUE],
}


def _variant_source(edits, source: str = "scan.cu") -> str:
    text = (build._CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"csrc/{source} no longer has the line this variant replaces: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(parts=None, source: str = "scan.cu") -> dict:
    """One library per variant of ``parts`` (default PARTS and SIMT_PARTS)
    of csrc/<source>, all nvcc processes started together."""
    parts = {**PARTS, **SIMT_PARTS} if parts is None else parts
    lib_name = source.rsplit(".", 1)[0]
    out = build.BUILD_DIR / f"{lib_name}_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in parts.items():
        src = out / f"{name}.cu"
        src.write_text(_variant_source(edits, source))
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC), "-o", str(out / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{report}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, argtypes in build.SIGNATURES[lib_name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.report = report  # nvcc's -Xptxas -v lines: registers and spills
        libs[name] = lib
    return libs


def build_other(checkout: Path, lib_name: str):
    """csrc/<lib_name>.cu of another checkout (e.g. the parent commit,
    unpacked with `git archive`), built from its own csrc/ and loaded."""
    csrc = checkout.resolve() / "usearch_torch" / "csrc"
    out = build.BUILD_DIR / f"{lib_name}_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libother.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(csrc / f"{lib_name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {csrc / f'{lib_name}.cu'}:\n{proc.stdout}{proc.stderr}")
    loaded = ctypes.CDLL(str(lib))
    for fn, argtypes in build.SIGNATURES[lib_name].items():
        if hasattr(loaded, fn):  # an older checkout may lack an entry point
            getattr(loaded, fn).argtypes = argtypes
            getattr(loaded, fn).restype = ctypes.c_int
    loaded.report = proc.stdout + proc.stderr
    return loaded


def against(libs: dict, lib_name: str, runs: dict, dev, mine: dict) -> None:
    """``libs["other"]`` (`build_other`) held against this checkout's full
    kernel on the same inputs (equal results, or for f32 the largest
    distance difference), then timed in turns around this checkout's
    variants: ``other``, every variant, ``full again``, ``other again``.
    ``mine``: the cases the other checkout can run."""
    want = {tag: fn() for tag, fn in runs.items()}
    other = libs.pop("other")
    build._libs[lib_name] = other
    try:
        for tag, fn in mine.items():
            got = fn()
            if all(torch.equal(a, b) for a, b in zip(got, want[tag])):
                print(f"{'other':26s} {tag:45s} the same results", flush=True)
            else:
                diff = float((got[0].float() - want[tag][0].float()).abs().max())
                print(f"{'other':26s} {tag:45s} OTHER RESULTS: distances up to {diff:.3g} apart", flush=True)
    finally:
        build._libs.pop(lib_name, None)
    run({"other": other}, lib_name, mine, dev)
    run({**libs, "full again": libs["full"]}, lib_name, runs, dev)
    run({"other again": other}, lib_name, mine, dev)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def run(libs: dict, lib_name: str, runs: dict, dev) -> None:
    """Times every case of ``runs`` with each variant's library bound in
    the place of csrc/<lib_name>.cu's, one line per variant and case."""
    try:
        for name, lib in libs.items():
            build._libs[lib_name] = lib
            for tag, fn in runs.items():
                print(f"{name:26s} {tag:45s} {time_once(fn, dev, reps=5) * 1e3:9.3f} ms", flush=True)
    finally:
        build._libs.pop(lib_name, None)


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t8 = cast_rows(torch.randn(1 << 20, 256, generator=gen, device=dev), ScalarKind.F32, ScalarKind.I8)
    q8 = cast_rows(torch.randn(16384, 256, generator=gen, device=dev), ScalarKind.F32, ScalarKind.I8)
    v8 = torch.ones(1 << 20, dtype=torch.bool, device=dev)
    s8 = row_stats(t8, ScalarKind.I8)
    tf = torch.randn(262144, 256, generator=gen, device=dev)
    qf = torch.randn(16384, 256, generator=gen, device=dev)
    vf = torch.ones(262144, dtype=torch.bool, device=dev)
    sf = row_stats(tf, ScalarKind.F32)
    ip, cos = MetricKind.IP, MetricKind.Cos
    a8 = (ip, q8, t8, *scan.scan_aux(ip, q8, s8, v8))
    q2 = q8[:1024].contiguous()
    a2 = (ip, q2, t8, *scan.scan_aux(ip, q2, s8, v8))
    af = (cos, qf, tf, *scan.scan_aux(cos, qf, sf, vf))
    return {
        "B1 i8 ip, 2^20 x 256, Q=16,384": lambda: scan.binned_scan(*a8),
        "B2 i8 ip, 2^20 x 256, Q=1,024": lambda: scan.binned_minima(*a2),
        "B1 compact f32 cos, 262,144 x 256, Q=16,384": lambda: scan.binned_scan(*af, compact=True),
    }


def simt_cases(dev):
    """B2 and B1 over f32 rows outside compact mode (the SIMT kernel) at the
    f32 exact path's shape, and f32 torch.matmul of the same operands."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tf = torch.randn(262144, 256, generator=gen, device=dev)
    qf = torch.randn(1024, 256, generator=gen, device=dev)
    vf = torch.ones(262144, dtype=torch.bool, device=dev)
    cos = MetricKind.Cos
    af = (cos, qf, tf, *scan.scan_aux(cos, qf, row_stats(tf, ScalarKind.F32), vf))
    return {
        "B2 f32 cos, 262,144 x 256, Q=1,024": lambda: scan.binned_minima(*af),
        "B1 f32 cos, 262,144 x 256, Q=1,024": lambda: scan.binned_scan(*af),
    }, lambda: torch.matmul(qf, tf.t())


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_breakdown: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"{card}; {len(libs)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    run({name: libs[name] for name in PARTS}, "scan", cases(dev), dev)
    runs, product = simt_cases(dev)
    run({name: libs[name] for name in SIMT_PARTS}, "scan", runs, dev)
    print(f"{'torch.matmul f32, no TF32':26s} {'the SIMT shape':45s} {time_once(product, dev, reps=5) * 1e3:9.3f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
