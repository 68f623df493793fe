"""Profiling hooks: device traces, named ranges and phase timers.

Counterpart of ``ilqr_tpu/utils/profiling.py``.  The reference has no
profiling at all (SURVEY.md §5).  These are thin wrappers so that
benchmark and production code annotate the solver's phases the same way
and can capture device traces: ``torch.profiler`` with CPU and CUDA
activity, written as a Chrome trace (open it in ``chrome://tracing`` or
Perfetto), and NVTX ranges for tools that read them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU and, where a card is
    present, CUDA activity) and write ``<log_dir>/trace.json``, a Chrome
    trace.  Yields the profiler."""

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region: a ``torch.profiler.record_function`` range in traces,
    and an NVTX range where a card is present."""

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class PhaseTimer:
    """Host wall-clock phase accumulator that synchronizes the device before
    and after each phase, so a phase's time includes its queued kernels.

    Example::

        timer = PhaseTimer()
        with timer.phase("backward"):
            out = backward_pass(...)
        print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        rows = [
            f"{name}: {total*1e3:.2f} ms over {self.counts[name]} calls"
            for name, total in sorted(self.totals.items())
        ]
        return "\n".join(rows)
