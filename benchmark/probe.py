"""The traced stretch of a run: the profiler, the window range, and the
ranges the benchmark puts around the port's entry functions.

An entry ("module:function") is wrapped, in traced runs only, so that
each call runs inside a `record_function` range "bench::<function>" and
its arguments' shapes are kept while the profiler records. The wrapper
takes the function's attributes (its `.launches` counter goes on
counting) and is put back in place when the run ends."""

from __future__ import annotations

import functools
import importlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness
from benchmark import trace as tr


def range_name(entry: str) -> str:
    return "bench::" + entry.split(":")[1]


def _describe(x):
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype)}
    if isinstance(x, (int, float, bool, str)) or x is None:
        return x
    return type(x).__name__


class Probe:
    """Profiler and entry ranges of one run (traced) or nothing (untraced)."""

    def __init__(self, entries, traced: bool, device):
        self.traced = traced
        self.cuda = torch.device(device).type == "cuda"
        self.calls = {range_name(e): [] for e in entries}
        self.recording = False
        self._saved = []
        self._prof = None
        self._window = None
        if traced:
            for entry in entries:
                self._wrap(entry)

    def _wrap(self, entry: str):
        modname, fname = entry.split(":")
        mod = importlib.import_module(modname)
        orig = getattr(mod, fname)
        name = range_name(entry)
        calls = self.calls[name]
        probe = self

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if not probe.recording:
                return orig(*args, **kwargs)
            calls.append({"args": [_describe(a) for a in args],
                          "kwargs": {k: _describe(v)
                                     for k, v in kwargs.items()}})
            with record_function(name):
                return orig(*args, **kwargs)

        setattr(mod, fname, wrapper)
        self._saved.append((mod, fname, orig, wrapper))

    def _new_profiler(self):
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def start(self):
        """Open the traced window (at a point where the device is idle)."""
        self._prof = self._new_profiler()
        self._prof.start()
        self._window = record_function(tr.WINDOW)
        self._window.__enter__()
        self.recording = True

    def stop(self):
        self.recording = False
        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()

    def read(self):
        harness.note("writing the trace")
        """The traced window as a trace.Trace (the Chrome trace file is
        written inside the checkout and removed once read)."""
        path = os.path.join(harness.CACHE_DIR, "trace.json")
        os.makedirs(harness.CACHE_DIR, exist_ok=True)
        try:
            self._prof.export_chrome_trace(path)
            return tr.from_chrome(path)
        finally:
            if os.path.exists(path):
                os.remove(path)

    def restore(self):
        for mod, fname, orig, wrapper in reversed(self._saved):
            for k in orig.__dict__:  # the counters go back
                orig.__dict__[k] = wrapper.__dict__[k]
            setattr(mod, fname, orig)
        self._saved = []
