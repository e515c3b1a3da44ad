"""Profiling hooks on `torch.profiler`: a trace of everything inside a
block, named spans on its timeline, and the device's memory counters.

Counterpart of `usearch_tpu/profiling.py`. Per-search counters
(`computed_distances`, `visited_members`) ride on search results
(matches.py); this module adds whole-program traces, written as a Chrome
trace (``trace.json``, viewable in chrome://tracing or Perfetto)::

    with usearch_torch.profiling.trace("/tmp/usearch-trace"):
        index.search(queries, 10)

The trace holds CPU operators and, where a CUDA card is present, the
card's kernels and copies (CUPTI).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace everything inside the block into ``logdir/trace.json``; yields
    the `torch.profiler.profile`, whose ``key_averages()`` read the same
    events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span on the profiler's timeline (`record_function`)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """The CUDA caching allocator's counters of ``device`` (the current
    card by default), `torch.cuda.memory_stats`; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
