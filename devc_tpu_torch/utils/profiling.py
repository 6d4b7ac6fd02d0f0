"""Profiling helpers (mirrors devc_tpu/utils/profiling.py; the reference
has only wall-clock prints, train.py:536,731-732).

`trace` records a torch.profiler trace (CPU and, with a card, CUDA
activity) as a Chrome trace file; `StepTimer` keeps a wall-clock EMA of a
step; `device_memory_stats` reads the caching allocator's live and peak
bytes per card.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace into log_dir/trace.json (viewable in
    Perfetto or chrome://tracing)."""
    import torch
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
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {
        "bytes_in_use": torch.cuda.memory_allocated(i),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
        for i in range(torch.cuda.device_count())}
