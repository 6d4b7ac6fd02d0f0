"""Read the port's own spans in a traced run: the host ranges that
`devc_tpu_torch.utils.profiling.span` opens ("clip::*", "frame::*",
"sched::*", "train::*"), on the trace's shared clock.

Two readings of a span, both None where the trace has no such span:
  * the device time of the operations launched, on any thread, inside one
    of its intervals, as the union of their intervals (operations that
    overlap count once, as in the busy time): the backward kernels that
    the autograd engine's thread launches while the main thread waits in
    "train::g_grad" count there, which `trace.range_device_us` (by
    launching thread) would miss;
  * the device's idle time under it: the traced window's idle gaps
    intersected with its intervals on the main thread (the thread that
    launches most), which is where the host was while the device waited.

A program without spans (an older commit) gives None for both, and its
metrics are left out of the result line; one whose spans did not occur
in the traced stretch (no clip ended, so no refill) reads 0 where
`present` names a span that did.
"""

from __future__ import annotations

import bisect

from benchmark import trace as tr


def intervals(trace: tr.Trace, name: str, tid=None) -> list:
    """The host ranges called `name` (on thread tid, or any thread), as
    sorted disjoint (start, end)."""
    merged = []
    for start, end, rname, rtid in trace.host:  # sorted by start
        if rname != name or (tid is not None and rtid != tid):
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def device_us(trace: tr.Trace, name: str) -> float | None:
    """Device time of the operations launched, on any thread, inside an
    interval of span `name`: the union of their intervals; None without
    the span."""
    spans = intervals(trace, name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total, reach = 0.0, float("-inf")
    for start, end, _name, corr, _cat in trace.device:  # sorted by start
        launch = trace.launches.get(corr)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and spans[i][1] >= launch[0] and end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def idle_us(trace: tr.Trace, name: str) -> float | None:
    """The traced window's idle gaps intersected with span `name`'s
    intervals on the main thread; None without the span there."""
    spans = intervals(trace, name, tr._main_thread(trace))
    if not spans:
        return None
    total, i = 0.0, 0
    for gs, ge in tr._idle_gaps(trace):  # both sorted and disjoint
        while i < len(spans) and spans[i][1] <= gs:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < ge:
            total += max(0.0, min(ge, spans[j][1]) - max(gs, spans[j][0]))
            j += 1
    return total


def per_item_ms(run, read, names, items_key: str, present: str = None):
    """read(trace, name) summed over `names`, in ms per traced item
    (run.record[items_key]). A name without its span counts 0 where span
    `present` is in the trace; with neither, None."""
    if run.trace is None or not run.record.get(items_key):
        return None
    values = [read(run.trace, n) for n in names]
    if all(v is None for v in values):
        if present is None or read(run.trace, present) is None:
            return None
    return sum(v or 0.0 for v in values) / 1e3 / run.record[items_key]


def device_ms(run, name: str, items_key: str):
    return per_item_ms(run, device_us, [name], items_key)


def idle_ms(run, names, items_key: str, present: str = None):
    return per_item_ms(run, idle_us, names, items_key, present)
