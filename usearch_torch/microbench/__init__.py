"""The TPU micro-benchmarks of `scripts/` on the card, one module each:

- `i8_matmul_probe` (scripts/tpu_i8_matmul_probe.py): kernel B11's
  loop-carried tensor-core products, then single large library products;
- `select_microbench` (scripts/tpu_select_microbench.py): kernel B12's
  selection loop, one line per variant;
- `probe_v2_bisect` (scripts/tpu_probe_v2_bisect.py): kernel B13, B3's
  window stream cut to each select.

`scan_breakdown`, `fused_breakdown`, `probe_breakdown` and
`bitscan_breakdown` are the port's own: the flat-scan kernels B1/B2,
B8-B10, the grouped probe B3/B5 and the b1 bit scan rebuilt with parts of
them taken out, to see where their time goes;
`loop_breakdown` rebuilds B11 with clock stamps in its step loop and
splits a step into its phases; `sass_diff` compares the kernels' SASS with
another checkout's (card only).

Each runs with ``python -m usearch_torch.microbench.<name>`` and prints its
TPU script's lines. Nothing runs at import. Each ``main`` runs at its
script's shape (the module's constants), makes its data on the card from the
module's ``SEED`` and runs there unless given ``device="cpu"`` (where the
kernels' plain versions run); without a card it raises.
"""

from __future__ import annotations

import time

import torch

from ..exact import resolve_device


#: cycles the card sleeps before a timed call, while the host enqueues it
#: (about 10 ms)
SLEEP_CYCLES = 20_000_000


def time_once(fn, device: torch.device, warm=None, reps: int = 1) -> float:
    """Seconds a call of ``fn`` takes, the mean of ``reps`` calls after a
    warm call of ``warm`` (``fn`` itself by default): CUDA events on the
    card, the host clock on the CPU. On the card the events bracket the
    calls' work alone: the card sleeps first, so the calls are enqueued
    before the card reaches them and the host's launch time does not
    count."""
    (warm or fn)()
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / reps


__all__ = ["resolve_device", "time_once"]
