"""Read a profiler trace (the Chrome trace format that
`torch.profiler.profile.export_chrome_trace` writes) into what the
per-layer metrics need: the device's busy time as the union of its
operations' intervals, the device time of the kernels launched inside a
named host range, and the breakdown of device time and idle gaps.

Times are microseconds on the trace's clock, which the profiler shares
between host and device events. The traced window is the host range named
WINDOW, which the benchmark opens and closes around the traced stretch.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

WINDOW = "bench::window"
# device-side events: kernels, copies and fills all occupy the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
NAME_CHARS = 120  # kernel names are long C++ templates; the head says enough


@dataclass
class Trace:
    device: list = field(default_factory=list)    # (start, end, name, corr, cat)
    launches: dict = field(default_factory=dict)  # corr -> (ts, tid)
    host: list = field(default_factory=list)      # (start, end, name, tid)
    window: tuple | None = None                   # (start, end)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


def from_chrome(trace) -> Trace:
    """A Trace from a Chrome trace: a path, or the loaded dict."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    out = Trace()
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts = float(ev["ts"])
        end = ts + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            out.device.append((ts, end, ev.get("name", ""),
                               args.get("correlation"), cat))
        elif cat in LAUNCH_CATS:
            if args.get("correlation") is not None:
                out.launches[args["correlation"]] = (ts, ev.get("tid"))
        elif cat in HOST_CATS:
            name = ev.get("name", "")
            if name == WINDOW:
                out.window = (ts, end)
            else:
                out.host.append((ts, end, name, ev.get("tid")))
    out.device.sort()
    out.host.sort()
    return out


def _in_window(trace: Trace):
    """Device intervals clipped to the window (all, without a window)."""
    lo, hi = trace.window if trace.window else (float("-inf"), float("inf"))
    for start, end, name, corr, cat in trace.device:
        s, e = max(start, lo), min(end, hi)
        if e > s:
            yield s, e, name, corr, cat


def busy_intervals(trace: Trace) -> list:
    """The union of the device's operation intervals inside the window, as
    sorted disjoint (start, end): operations that overlap count once."""
    merged = []
    for s, e, *_ in _in_window(trace):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_us(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def kernel_count(trace: Trace) -> int:
    """Kernels that ran inside the window."""
    return sum(1 for *_, cat in _in_window(trace) if cat == "kernel")


def range_device_us(trace: Trace, name: str) -> float | None:
    """Device time of every operation launched from inside a host range
    called `name` (on the launching thread), or None when no such range
    launched anything: which kernels they are does not matter."""
    spans = {}
    for start, end, rname, tid in trace.host:
        if rname == name:
            spans.setdefault(tid, []).append((start, end))
    if not spans:
        return None
    starts = {tid: [s for s, _ in v] for tid, v in spans.items()}
    total, found = 0.0, False
    for start, end, _name, corr, _cat in trace.device:
        launch = trace.launches.get(corr)
        if launch is None or launch[1] not in spans:
            continue
        ts, tid = launch
        i = bisect.bisect_right(starts[tid], ts) - 1
        # ranges of one name do not nest, so the latest start is the one
        if i >= 0 and spans[tid][i][1] >= ts:
            total += end - start
            found = True
    return total if found else None


def _main_thread(trace: Trace):
    counts = {}
    for ts, tid in trace.launches.values():
        counts[tid] = counts.get(tid, 0) + 1
    return max(counts, key=counts.get) if counts else None


def _idle_gaps(trace: Trace) -> list:
    busy = busy_intervals(trace)
    if trace.window:
        lo, hi = trace.window
    elif busy:
        lo, hi = busy[0][0], busy[-1][1]
    else:
        return []
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _host_activity(trace: Trace, points: list) -> list:
    """For each time point, the innermost host range of the launching
    thread that covers it (its name), by one sweep over the ranges."""
    tid = _main_thread(trace)
    ranges = [(s, e, n) for s, e, n, t in trace.host if t == tid]
    order = sorted(range(len(points)), key=lambda i: points[i])
    out = [None] * len(points)
    stack, j = [], 0
    for i in order:
        p = points[i]
        while j < len(ranges) and ranges[j][0] <= p:
            stack.append(ranges[j])
            j += 1
        stack = [r for r in stack if r[1] >= p]
        inner = min(stack, key=lambda r: r[1] - r[0]) if stack else None
        out[i] = inner[2] if inner else "host code outside any op"
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, summed by
    name, and the idle gaps' time summed by what the host was doing at
    each gap's midpoint, in seconds."""
    ops = {}
    for s, e, name, _corr, _cat in _in_window(trace):
        key = name[:NAME_CHARS]
        ops[key] = ops.get(key, 0.0) + (e - s)
    gaps = _idle_gaps(trace)
    names = _host_activity(trace, [(s + e) / 2 for s, e in gaps])
    idle = {}
    for (s, e), name in zip(gaps, names):
        key = name[:NAME_CHARS]
        idle[key] = idle.get(key, 0.0) + (e - s)

    def head(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": head(ops), "idle_gaps": head(idle)}
