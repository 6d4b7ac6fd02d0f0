"""The readers of the port's spans (benchmark/spans.py) on synthetic
Chrome traces: device time by launch inside a span on any thread, idle
time under a span on the main thread, None where the span is absent."""

import json
import os

import pytest

from benchmark import harness, spans
from benchmark import trace as tr


def _reads_spans(name: str) -> bool:
    with open(os.path.join(harness.BENCH_DIR, "metrics", name + ".py")) as f:
        return "benchmark.spans" in f.read()


# the per-layer metrics that read the port's spans
SPAN_METRICS = [m["name"] for m in harness.load_manifest()["per_layer"]
                if _reads_spans(m["name"])]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _trace(extra=()):
    """Window 0-100 us; thread 1 is the main thread (three launches),
    thread 2 the autograd engine's (two). train::g_grad 10-40 on thread 1;
    inside it thread 2 launches A (device 30-45) and thread 1 launches B
    (42-50, overlapping A); thread 2 launches C at 50, after it (device
    60-70). Busy:
    30-50, 60-70; idle: 0-30, 50-60, 70-100. sched::decode_wait on thread
    1 at 5-12 and 55-65, and on thread 3 at 80-90."""
    return {"traceEvents": [
        _ev("user_annotation", tr.WINDOW, 0, 100),
        _ev("user_annotation", "train::g_grad", 10, 30),
        _ev("user_annotation", "sched::step", 2, 90),
        _ev("user_annotation", "sched::decode_wait", 5, 7),
        _ev("user_annotation", "sched::decode_wait", 55, 10),
        _ev("user_annotation", "sched::decode_wait", 80, 10, tid=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 15, 1, tid=2, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, tid=2, corr=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 95, 1, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 96, 1, corr=5),
        _ev("kernel", "A_autograd", 30, 15, tid=7, corr=1),
        _ev("kernel", "B_main", 42, 8, tid=7, corr=2),
        _ev("kernel", "C_after", 60, 10, tid=7, corr=3),
        *extra,
    ]}


def test_device_time_counts_launches_from_any_thread_inside_the_span():
    t = tr.from_chrome(_trace())
    # A and B, overlapping 42-45: their union, 30-50
    assert spans.device_us(t, "train::g_grad") == 20.0
    # by launching thread alone, the autograd engine's A is missed
    assert tr.range_device_us(t, "train::g_grad") == 8.0
    assert spans.device_us(t, "sched::decode_wait") == 0.0
    assert spans.device_us(t, "train::update") is None


def test_idle_under_a_span_is_its_intersection_with_the_gaps():
    t = tr.from_chrome(_trace())
    # gap 0-30 meets 5-12 (7 us), gap 50-60 meets 55-65 (5 us); thread 3's
    # 80-90 is not the main thread's
    assert spans.idle_us(t, "sched::decode_wait") == 12.0
    # train::g_grad 10-40 meets the gap 0-30 for 20 us
    assert spans.idle_us(t, "train::g_grad") == 20.0
    assert spans.idle_us(t, "sched::refill") is None


def test_readings_per_item_and_a_span_that_did_not_occur():
    class Run:
        trace = tr.from_chrome(_trace())
        record = {"trace_steps": 4, "trace_frames": 2}

    assert spans.idle_ms(Run, ["sched::decode_wait"], "trace_steps") == \
        pytest.approx(12e-3 / 4)
    assert spans.device_ms(Run, "train::g_grad", "trace_frames") == \
        pytest.approx(20e-3 / 2)
    # no refill in the traced steps of a program that has the spans: 0
    assert spans.idle_ms(Run, ["sched::refill"], "trace_steps",
                         present="sched::step") == 0.0
    assert spans.idle_ms(Run, ["sched::refill"], "trace_steps") is None
    Run.trace = None
    assert spans.idle_ms(Run, ["sched::decode_wait"], "trace_steps") is None


class _Run:
    def __init__(self, trace):
        self.trace = trace
        self.record = {"trace_frames": 48, "trace_steps": 24}


def test_every_span_metric_reads_nothing_from_a_program_without_spans():
    """A commit whose program opens no span (PR 14's) gives None in every
    reader, which then leaves its metric out; with the spans each reads a
    number."""
    assert len(SPAN_METRICS) == 15
    bare = tr.from_chrome({"traceEvents": [
        e for e in _trace()["traceEvents"]
        if e["cat"] != "user_annotation" or e["name"] == tr.WINDOW]})
    names = {"clip::frame", "clip::step", "clip::upload", "clip::download",
             "sched::step", "sched::refill", "sched::write_wait",
             *(f"frame::{s}" for s in ("vgg", "embed", "corr",
                                       "colorvidnet", "post")),
             *(f"train::{s}" for s in ("forward", "critic", "g_loss",
                                       "update"))}
    full = tr.from_chrome(_trace(extra=[
        _ev("user_annotation", n, 1, 98) for n in sorted(names)]))
    for name in SPAN_METRICS:
        reader = harness.metric_reader(name)
        assert reader.read(_Run(bare)) is None, name
        assert reader.read(_Run(None)) is None, name
        assert isinstance(reader.read(_Run(full)), float), name


def test_the_span_metrics_are_appended_with_their_cells():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        per_layer = json.load(f)["per_layer"]
    added = [m for m in per_layer if m["name"] in SPAN_METRICS]
    assert per_layer[-len(added):] == added
    for m in added:
        assert m["source"] == "device_trace" and len(m["workloads"]) == 1
        assert m["name"].split(".")[1] == {"stream432": "frame",
                                           "serve432-b4": "serve",
                                           "train-b16": "train"}[
            m["workloads"][0]]
