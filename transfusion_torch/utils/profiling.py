"""Profiling and tracing utilities (port of
``transfusion_tpu/utils/profiling.py``).

``trace(logdir)`` wraps a region in a ``torch.profiler`` trace (host
activity, and the card's kernels when CUDA is initialised) and writes it to
``<logdir>/trace.json`` in the Chrome trace format (chrome://tracing,
Perfetto); ``annotate`` names a region inside the trace; ``StepTimer`` is a
wall-clock accumulator for host-side stages (decode, collate, device wait).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the region; yields the ``torch.profiler.profile`` (its
    ``key_averages()`` sum the region by name) and writes the trace to
    ``logdir/trace.json`` when the region ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates wall-clock per named stage; report() returns ms averages."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, float]:
        return {
            k: round(1000.0 * self.totals[k] / max(self.counts[k], 1), 2) for k in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()
