"""The card's busy time over a run's measured window, for an end-to-end
metric read from the device (metrics/frame_device_ms.py): how long the
card worked for the window's frames, whatever the host's pace.

The profiler records the card's activity alone (kernels, copies and
fills, and the runtime calls that launch them; no host ranges, shapes or
stacks), in one recording from the window's start until the driver has
waited for the window's last work. Its raw result is read after that,
without the tables the profiler's own stop would build. The recording
costs the host some microseconds a launch; starting it (CUPTI's set-up)
costs seconds, before the window, in set-up. A run whose metrics read no
device time never starts the clock: its window is untouched. One
recording holds a 30 s stream432 window, 900,000 operations, whole (PERF.md).
"""

from __future__ import annotations

import torch


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals: overlapping
    operations count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _device_intervals(result, copies: list | None = None) -> list:
    """(start_ns, end_ns) of every operation that ran on the card in one
    raw profiler result; those of copies and fills also go to `copies`."""
    from torch.autograd import DeviceType

    out = []
    for ev in result.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns(), ev.duration_ns()
        else:  # older releases report microseconds
            s, d = 1e3 * ev.start_us(), 1e3 * ev.duration_us()
        out.append((s, s + d))
        if copies is not None and ev.name().startswith(("Memcpy", "Memset")):
            copies.append((s, s + d))
    return out


class DeviceClock:
    """Off where the device is not a card or `on` is false: start and stop
    are then no-ops and busy_s stays None."""

    def __init__(self, device, on: bool):
        self.on = on and torch.device(device).type == "cuda"
        self.busy_s = None
        self.copy_s = None  # of busy_s, copies and fills (a diagnostic)
        self.operations = 0
        self._prof = None

    def start(self):
        """Synchronize, then record from here on."""
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.prepare_trace()
        self._prof.start_trace()

    def stop(self):
        """Wait for the card and close the recording; busy_s is then the
        union of the recorded operations' intervals, in seconds."""
        if self._prof is None:
            return
        torch.cuda.synchronize()
        # the raw result: the profiler's own stop would build its tables
        result = torch.autograd._disable_profiler()
        from torch.autograd import profiler as autograd_profiler

        on_stop = getattr(autograd_profiler, "_run_on_profiler_stop", None)
        if on_stop is not None:
            on_stop()
        self._prof = None
        copies = []
        intervals = _device_intervals(result, copies)
        self.operations = len(intervals)
        self.busy_s = union_length(intervals) / 1e9
        self.copy_s = union_length(copies) / 1e9
