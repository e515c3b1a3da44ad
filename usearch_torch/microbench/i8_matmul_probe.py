"""Kernel B11 on the card: the tensor cores' i8 and bf16 rates on
loop-carried products, beside single large library products.

    python -m usearch_torch.microbench.i8_matmul_probe

The counterpart of scripts/tpu_i8_matmul_probe.py. Its first four lines
time `ops.microbench.loop_matmul` (REPS products of ``[M, K] x [N, K]^T``
that depend on each other) in each mode; the rest time one large product
through a PyTorch library call (``torch.matmul`` in bf16, ``torch._int_mm``
in i8), where the script timed XLA's. Each line reads ``name  T(FL)OPS
(ms)``.
"""

from __future__ import annotations

import torch

from ..ops.microbench import loop_matmul
from . import resolve_device, time_once

#: the binned kernel's cell shape (q_tile, D, t_tile) and the steps
M, K, N = 256, 256, 8192
REPS = 512
SEED = 0
#: the library products: rows, columns and depths
MM, NN, KKS = 4096, 65536, (256, 2048)
#: (line, mode, operand dtype) of the loop-carried products
LOOP_LINES = (("pallas bf16xbf16->f32", "bf16", torch.bfloat16), ("pallas i8xi8->i32", "i8", torch.int8),
              ("pallas i8xi8->f32", "i8f32", torch.int8), ("pallas i8 cast bf16->f32", "cast", torch.int8))


def operands(shape_a, shape_b, seed: int, device) -> tuple:
    """i8 operands in [-127, 126], as ``jax.random.randint(key, shape, -127,
    127)`` draws them, so ``a + 1`` is still an i8."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(-127, 127, shape_a, generator=gen, device=device, dtype=torch.int8)
    b = torch.randint(-127, 127, shape_b, generator=gen, device=device, dtype=torch.int8)
    return a, b


def line(name: str, ops: float, seconds: float) -> str:
    return f"{name:32s} {ops / seconds / 1e12:7.1f} T(FL)OPS  ({seconds * 1e3:.1f} ms)"


def main(device="cuda") -> list:
    """Print and return the lines; the library products run on the card
    only."""
    dev = resolve_device(device)
    a8, b8 = operands((M, K), (N, K), SEED, dev)
    out = []
    for name, mode, dtype in LOOP_LINES:
        a, b = a8.to(dtype), b8.to(dtype)
        out.append(line(name, 2.0 * M * K * N * REPS, time_once(lambda: loop_matmul(a, b, mode, REPS), dev)))
        print(out[-1], flush=True)
    for kk in KKS if dev.type == "cuda" else ():
        ka, kb = operands((MM, kk), (NN, kk), SEED + 2, dev)
        ops = 2.0 * MM * kk * NN
        kab, kbb = ka.to(torch.bfloat16), kb.to(torch.bfloat16)
        calls = ((f"torch K={kk} bf16->bf16out", lambda: torch.matmul(kab, kbb.t())),
                 (f"torch K={kk} i8->i32out", lambda: torch._int_mm(ka, kb.t())),
                 (f"torch K={kk} i8->bf16out", lambda: torch._int_mm(ka, kb.t()).to(torch.bfloat16)))
        for name, fn in calls:
            out.append(line(name, ops, time_once(fn, dev)))
            print(out[-1], flush=True)
    return out


if __name__ == "__main__":
    main()
