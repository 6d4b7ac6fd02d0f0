"""The trace readers on a synthetic Chrome trace: busy time as the union
of the device's intervals inside the window, kernel time by the host
range that launched it (whatever the kernels are called), the breakdown."""

import pytest

from benchmark import readers
from benchmark import trace as tr


def _ev(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _trace():
    """Window 0-100 us on thread 1. Host: bench::corr_fwd 10-20 launches
    kernel A (corr 1, device 30-40) and B (corr 2, device 35-50, which
    overlaps A); later a range of another name launches C (corr 3,
    device 60-70); D (corr 4) runs outside the window, 120-130."""
    return {"traceEvents": [
        _ev("user_annotation", tr.WINDOW, 0, 100),
        _ev("user_annotation", "bench::corr_fwd", 10, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 15, 1, corr=2),
        _ev("cpu_op", "aten::conv", 50, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 1, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 1, corr=4),
        _ev("kernel", "A_some_kernel", 30, 10, tid=7, corr=1),
        _ev("kernel", "B_other_name", 35, 15, tid=8, corr=2),
        _ev("kernel", "C_conv", 60, 10, tid=7, corr=3),
        _ev("kernel", "D_late", 120, 10, tid=7, corr=4),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1, "id": 1},
    ]}


def test_busy_is_the_union_of_intervals_in_the_window():
    t = tr.from_chrome(_trace())
    assert t.window == (0.0, 100.0)
    assert tr.busy_intervals(t) == [(30.0, 50.0), (60.0, 70.0)]
    assert tr.busy_us(t) == 30.0  # A and B overlap: 20, not 25
    assert tr.kernel_count(t) == 3


def test_kernel_time_by_launching_range_not_by_name():
    t = tr.from_chrome(_trace())
    assert tr.range_device_us(t, "bench::corr_fwd") == 25.0  # A + B
    assert tr.range_device_us(t, "bench::smooth_pass") is None


def test_breakdown_names_device_ops_and_idle_gaps():
    b = tr.breakdown(tr.from_chrome(_trace()))
    assert b["device_ops"][0] == ["B_other_name", 15e-6]
    assert len(b["device_ops"]) == 3
    idle = dict(b["idle_gaps"])
    # gaps 0-30, 50-60, 70-100: midpoints 15 (inside bench::corr_fwd),
    # 55 (inside aten::conv), 85 (no op)
    assert idle == {"host code outside any op": 30e-6,
                    "bench::corr_fwd": 30e-6, "aten::conv": 10e-6}


class _Run:
    def __init__(self, trace, calls, frames=2):
        self.trace, self.entry_calls = trace, calls
        self.record = {"trace_frames": frames}


def test_readers_on_the_synthetic_trace():
    t = tr.from_chrome(_trace())
    call = {"args": [{"shape": [1, 5184, 256]}, {"shape": [1, 5184, 256]},
                     {"shape": [1, 5184, 3]}, 1e-10], "kwargs": {}}
    run = _Run(t, {"bench::corr_fwd": [call]})
    # bound 0.0834 ms over 25 us of kernels
    assert readers.kernel_roofline_pct(
        run, readers.K1_ENTRY, readers.k1_call_bound) == pytest.approx(
        100 * 83.4 / 25, rel=2e-3)
    assert readers.idle_pct(run) == pytest.approx(70.0)
    assert readers.launches_per_frame(run) == 1.5
    assert readers.kernel_roofline_pct(
        _Run(t, {}), readers.K2_ENTRY, readers.k2_call_bound) is None
    assert readers.idle_pct(_Run(None, {})) is None


def test_frame_times():
    class R:
        record = {"times": [0.02 * (i + 1) for i in range(40)]}
    assert readers.frame_ms(R) == pytest.approx(20.0)
    assert readers.frame_p95_ms(R) == pytest.approx(20.0)


def test_mfu_and_host_time_read_from_the_trace():
    """mfu: the model FLOPs of the traced items over the device's busy
    time (30 us of the 100 us window), against the peak; the scheduler's
    host time: the window less the busy time, per traced step."""
    from benchmark import roofline

    t = tr.from_chrome(_trace())
    run = _Run(t, {}, frames=2)
    run.config = {"image_size": [64, 128], "temperature": 1e-10,
                  "corr_channels": 256}
    run.record["trace_steps"] = 4
    flop = readers.flops.inference_frame_flop(run.config)
    assert readers.frame_mfu_pct(run) == pytest.approx(
        100 * 2 * flop / 30e-6 / roofline.PEAK_FP32_ACCURATE_FLOPS)
    assert readers.sched_host_ms(run) == pytest.approx(70e-3 / 4)
    assert readers.frame_mfu_pct(_Run(None, {})) is None
    assert readers.sched_host_ms(_Run(t, {})) is None


def test_served_frames_are_counted_over_the_whole_window():
    class R:
        seconds = 10.0
        record = {"times": [0.1 * (i + 1) for i in range(40)]}
    assert readers.served_frames_per_s(R) == pytest.approx(4.0)
