"""Profiling helpers (mirrors devc_tpu/utils/profiling.py; the reference
has only wall-clock prints, train.py:536,731-732).

`span` marks a stretch of host code with a name of the form
"<layer>::<part>"; `trace` records a torch.profiler trace (CPU and, with
a card, CUDA activity, the spans among them) as a Chrome trace file;
`StepTimer` keeps a wall-clock EMA of a step; `device_memory_stats` reads
the caching allocator's live and peak bytes per card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the host code inside it `name`.

    While a profiler records on this thread it is a
    `torch.profiler.record_function(name)` range, so the span lands in the
    profiler's trace beside the kernels it launches, on the clock the
    trace shares between host and device; otherwise it is one shared
    no-op, after one check. A span entered while no profiler records
    records nothing, even if a profiler starts inside it; one entered
    while a profiler records closes when it exits, on an exception too.
    The profiler records the thread that started it (and the autograd
    engine's), so spans on other threads record nothing."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace into log_dir/trace.json (viewable in
    Perfetto or chrome://tracing): the device's kernels and copies, the
    host's operators, and the `span`s the port opens on this thread
    (names "clip::*", "frame::*", "sched::*", "train::*")."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock EMA of step time + throughput."""

    def __init__(self, ema: float = 0.9):
        self._ema = ema
        self._avg = None
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t
        self._avg = dt if self._avg is None else (
            self._ema * self._avg + (1 - self._ema) * dt
        )
        return dt

    @property
    def avg(self):
        return self._avg


def device_memory_stats():
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} for each card
    (empty without one)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {
        "bytes_in_use": torch.cuda.memory_allocated(i),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
        for i in range(torch.cuda.device_count())}
