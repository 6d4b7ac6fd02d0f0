"""What the metric readers in metrics/ share: frame times from the
window, kernel roofline shares from the trace, mfu, the idle share.

A reader returns None where its run has nothing to read (an untraced run,
no call of its entry in the traced window); never 0 for a share."""

from __future__ import annotations

import statistics

from benchmark import flops, roofline
from benchmark import trace as tr
from benchmark.probe import range_name


def frame_ms(run):
    """The window over the frames delivered in it: from the window's start
    to the last delivery inside it (a whole number of scan chunks)."""
    times = run.record.get("times") or []
    if not times:
        return None
    return 1e3 * times[-1] / len(times)


def frame_p95_ms(run):
    """95th percentile of the intervals between consecutive deliveries
    over every frame of the window (the first from the window's start)."""
    times = run.record.get("times") or []
    if len(times) < 20:
        return None
    gaps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    return 1e3 * statistics.quantiles(gaps, n=20)[-1]


def busy_mfu_pct(run, flop_of, items_key: str):
    """Model FLOPs of the traced items (flop_of(config) each) over the
    device's busy time in the traced window (the union of its kernel,
    copy and fill intervals), against the peak, in percent: the whole
    step's share of the chip while the chip works, apart from the host's
    gaps (idle_pct)."""
    if run.trace is None or not run.record.get(items_key):
        return None
    busy_us = tr.busy_us(run.trace)
    if not busy_us:
        return None
    return 100.0 * flop_of(run.config) * run.record[items_key] \
        / (busy_us / 1e6) / roofline.PEAK_FP32_ACCURATE_FLOPS


def frame_mfu_pct(run):
    return busy_mfu_pct(run, flops.inference_frame_flop, "trace_frames")


def kernel_roofline_pct(run, entry: str, bound_of):
    """Summed bound of the entry's traced calls over the device time of
    every kernel launched inside those calls, in percent."""
    if run.trace is None:
        return None
    name = range_name(entry)
    calls = run.entry_calls.get(name) or []
    device_us = tr.range_device_us(run.trace, name)
    if not calls or not device_us:
        return None
    bound_ms = sum(bound_of(c)["bound_ms"] for c in calls)
    return 100.0 * bound_ms * 1e3 / device_us


def idle_pct(run):
    if run.trace is None or not run.trace.window_us:
        return None
    return 100.0 * (1.0 - tr.busy_us(run.trace) / run.trace.window_us)


def launches_per_frame(run):
    if run.trace is None or not run.record.get("trace_frames"):
        return None
    count = tr.kernel_count(run.trace)
    return count / run.record["trace_frames"] if count else None


K1_ENTRY = "devc_tpu_torch.ops.cuda_corr:corr_fwd"
K2_ENTRY = "devc_tpu_torch.ops.fgs:smooth_pass"


def k1_call_bound(call):
    """corr_fwd(theta [B, Nq, C], phi [B, Nk, C], values, T, emit_l)."""
    (b, nq, c), (_, nk, _) = (a["shape"] for a in call["args"][:2])
    emit_l = call["kwargs"].get(
        "emit_l", call["args"][4] if len(call["args"]) > 4 else False)
    return roofline.k1_bound(b, nq, nk, c, bool(emit_l))


def k2_call_bound(call):
    """smooth_pass(src [(B,) H, W, 2], guide [(B,) H, W], ...)."""
    src, guide = (a["shape"] for a in call["args"][:2])
    b = src[0] if len(src) == 4 else 1
    guides = guide[0] if len(guide) == 3 else 1
    return roofline.k2_pass_bound(b, src[-3], src[-2], guides)


CORR_BWD_ENTRY = "devc_tpu_torch.ops.cuda_corr:corr_bwd"


def corr_bwd_call_bound(call):
    """corr_bwd(theta [B, Nq, C], phi [B, Nk, C], ...): K3 and K2b, both
    launched inside it."""
    (b, nq, c), (_, nk, _) = (a["shape"] for a in call["args"][:2])
    bounds = roofline.bwd_bounds(b, nq, nk, c)
    return {"bound_ms": bounds["corr_bwd_dkv"]["bound_ms"]
            + bounds["corr_bwd_dq"]["bound_ms"]}


def step_ms(run):
    """The window over the training steps completed in it."""
    times = run.record.get("times") or []
    if not times:
        return None
    return 1e3 * times[-1] / len(times)


def train_mfu_pct(run):
    return busy_mfu_pct(run, flops.train_step_flop, "trace_steps")


def served_frames_per_s(run):
    """Frames written inside the window, over the window."""
    times = run.record.get("times")
    if times is None or not run.seconds:
        return None
    return len(times) / run.seconds if times else None


def sched_host_ms(run):
    """The traced window less the device's busy time, per traced step."""
    if run.trace is None or not run.record.get("trace_steps"):
        return None
    idle_us = run.trace.window_us - tr.busy_us(run.trace)
    return idle_us / 1e3 / run.record["trace_steps"]
