"""Where a step of the loop-carried product (csrc/matmul_probe.cu, B11) goes.

    python -m usearch_torch.microbench.loop_breakdown

Builds csrc/matmul_probe.cu again with `%globaltimer` stamps in the step
loop of `loop_wgmma` (thread 0 of two blocks of row tile 0: a lead block,
x = 0, and a block that is not a lead, x = 1), runs B11 and its chain alone
(`ops.microbench.loop_chain`) at the script's shape in every mode, and
prints, per block, the mean nanoseconds of a step and of its phases over
the steps 10 to REPS - 10: the build of A with warp 0's handshake and the
products' issue; the copy of the lead's bits (blocks that are not leads);
the wait for the product; acc's update; the parity and its stores (lead
blocks); the step's last barrier. Thread 0's clock: a phase also holds its
waits for the other threads. The stamps cost a global store each. Needs a
CUDA card and nvcc; the copy is built into usearch_torch/_build/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from .. import build
from ..ops import microbench
from . import i8_matmul_probe, time_once
from .scan_breakdown import _variant_source, card_line

#: lines of csrc/matmul_probe.cu and the stamped lines put in their place
_TRACE = "__device__ unsigned long long* g_trace;  // [2][reps][8] stamps of blocks (0, 0) and (1, 0)\n"
_STAMP = ("#define STAMP(pt)                                                                          \\\n"
          "  do {                                                                                     \\\n"
          "    if (tid == 0 && blockIdx.y == 0 && blockIdx.x < 2) {                                   \\\n"
          "      unsigned long long t;                                                                \\\n"
          "      asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));                               \\\n"
          "      g_trace[(blockIdx.x * p.reps + s) * 8 + (pt)] = t;                                   \\\n"
          "    }                                                                                      \\\n"
          "  } while (0)\n")
STAMPS = [
    ('#include "wgmma_common.cuh"\n', '#include "wgmma_common.cuh"\n' + _TRACE + _STAMP),
    ("    const bool more = s + 1 < p.reps;\n", "    const bool more = s + 1 < p.reps;\n    STAMP(0);\n"),
    ("    if (!lead && more) copy_bits(s);  // flag s acquired before the barrier above\n",
     "    STAMP(1);\n    if (!lead && more) copy_bits(s);\n    STAMP(2);\n"),
    ("    if constexpr (!kChain) {\n      asm volatile(\"wgmma.wait_group.sync.aligned 0;\" ::: \"memory\");\n",
     "    STAMP(3);\n    if constexpr (!kChain) {\n      asm volatile(\"wgmma.wait_group.sync.aligned 0;\" ::: \"memory\");\n"),
    ("    // acc += this step's product: i32 wraps, f32 rounds once\n",
     "    STAMP(4);\n    // acc += this step's product: i32 wraps, f32 rounds once\n"),
    ("    if (lead && more) {\n      // the parity", "    STAMP(5);\n    if (lead && more) {\n      // the parity"),
    ("        copy_bits(s);\n      }\n    }\n    __syncthreads();\n  }\n",
     "        copy_bits(s);\n      }\n    }\n    STAMP(6);\n    __syncthreads();\n    STAMP(7);\n  }\n"),
    ('extern "C" {\n', 'extern "C" {\n\nint usearch_loop_trace(void* p) {\n'
     "  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &p, sizeof(p)));\n}\n"),
]
#: the phases between stamps (a, b), by name
PHASES = {"build+handshake+issue": (0, 1), "copy": (1, 3), "product wait": (3, 4), "update": (4, 5),
          "parity+stores": (5, 6), "last barrier": (6, 7)}
WARMUP = 10


def build_stamped() -> ctypes.CDLL:
    out = build.BUILD_DIR / "loop_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "matmul_probe.cu"
    src.write_text(_variant_source(STAMPS, "matmul_probe.cu"))
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build._CSRC), "-o", str(out / "libloop.so"), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for the stamped B11:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out / "libloop.so"))
    for fn, argtypes in build.SIGNATURES["matmul_probe"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.usearch_loop_trace.argtypes = [ctypes.c_void_p]
    return lib


def phases(trace: np.ndarray) -> dict:
    """Mean nanoseconds of a step and of each phase, by block, over the
    steps past WARMUP and before the last WARMUP."""
    out = {}
    for blk, name in ((0, "lead"), (1, "follower")):
        t = trace[blk, WARMUP:-WARMUP].astype(np.float64)
        out[name] = {"step": float(np.diff(t[:, 0]).mean()),
                     **{ph: float((t[:, b] - t[:, a]).mean()) for ph, (a, b) in PHASES.items()}}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("loop_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    lib = build_stamped()
    m, k, n, reps = i8_matmul_probe.M, i8_matmul_probe.K, i8_matmul_probe.N, i8_matmul_probe.REPS
    trace = torch.zeros((2, reps, 8), dtype=torch.int64, device=dev)
    if lib.usearch_loop_trace(trace.data_ptr()):
        raise RuntimeError("usearch_loop_trace failed")
    a8, b8 = i8_matmul_probe.operands((m, k), (n, k), i8_matmul_probe.SEED, dev)
    build._libs["matmul_probe"] = lib
    try:
        for _, mode, dtype in i8_matmul_probe.LOOP_LINES:
            a, b = a8.to(dtype), b8.to(dtype)
            for label, fn in (("B11", microbench.loop_matmul), ("chain alone", microbench.loop_chain)):
                ms = time_once(lambda: fn(a, b, mode, reps), dev, reps=3) * 1e3
                fn(a, b, mode, reps)
                torch.cuda.synchronize()
                for blk, ph in phases(trace.cpu().numpy()).items():
                    parts = ", ".join(f"{name} {v:.0f}" for name, v in ph.items() if name != "step")
                    print(f"{mode:6s} {label:12s} {ms:.4f} ms  {blk:9s} step {ph['step']:.0f} ns: {parts}",
                          flush=True)
    finally:
        build._libs.pop("matmul_probe", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
