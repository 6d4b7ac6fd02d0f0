"""Driver of the one-clip inference cells: the window drives
`devc_tpu_torch.pipeline.video.colorize_frames` over one clip, in the
mode the traffic mix names ("stream": one device step per frame; "scan":
one captured CUDA graph replayed per frame, `chunk` frames per hand-off).

Set-up: weights and inputs from the seed, the models built from the state
dicts, one short clip of the same shapes and mode (every kernel loaded,
cuDNN's choices made, a graph captured). The window starts when the timed clip asks for
its first frame and ends `--seconds` later: the frame iterator stops
there (a scan clip at its next chunk boundary). A traced run then goes on
for the mix's `trace_frames` frames under the profiler. Where a metric of
the cell reads the card's busy time over the window (run.window_device),
benchmark/devclock.py records the card's activity from the window's start
to the clip's end; every frame the clip delivered under it counts.

Correctness: for the frames the mix's sample rule picks, the carry the
frame entered with, its output and its new carry are copied aside as the
program produces them (a wrapper around the module's `frame_step` in
stream mode; in scan mode, `CapturedStep.run` split around a sampled
frame, its replays unchanged). After the window, with the program freed,
the plain reference recomputes each of them from the same inputs and
weights (benchmark/compare.py)."""

from __future__ import annotations

import json
import sys
import time

import torch

from benchmark import compare, harness, scenes, weights
from benchmark import trace as tr
from benchmark.devclock import DeviceClock
from benchmark.probe import Probe


class _Recorder:
    """Delivery times, the window's phase and the sampled frames."""

    def __init__(self, every: int, offset: int):
        self.every, self.offset = every, offset
        self.phase = "setup"  # -> "window" -> "trace" -> "done"
        self.times = []       # seconds after t0 of each delivery
        self.samples = {}     # frame index -> (carry_in, out, carry_out)
        self.t0 = None
        self.trace_from = None

    def sampled(self, i: int) -> bool:
        return self.phase == "window" and (
            i == 0 or (i + self.offset) % self.every == 0)


def _install_hooks(video, rec, use_stream, use_scan):
    """Copy the sampled frames' carries and outputs aside as they are
    made; returns a function that removes the hooks."""
    orig_step, orig_captured = video.frame_step, video.CapturedStep
    count = [0]

    def frame_step(models, rgb, last, *args, **kwargs):
        i = count[0]
        count[0] += 1
        take = rec.sampled(i)
        carry_in = last.clone() if take else None
        out, new = orig_step(models, rgb, last, *args, **kwargs)
        if take:
            rec.samples[i] = (carry_in, out.clone(), new.clone())
        return out, new

    class RecordingStep(orig_captured):
        def run(self, frames):
            base, k = self.replays, frames.shape[0]
            picks = [j for j in range(k) if rec.sampled(base + j)]
            if not picks:
                return super().run(frames)
            parts, j0 = [], 0
            for j in picks:
                if j > j0:
                    parts.append(super().run(frames[j0:j]))
                carry_in = self.carry.clone()
                one = super().run(frames[j:j + 1])
                rec.samples[base + j] = (carry_in, one[0].clone(),
                                         self.carry.clone())
                parts.append(one)
                j0 = j + 1
            if j0 < k:
                parts.append(super().run(frames[j0:]))
            return torch.cat(parts)

    if use_stream:
        video.frame_step = frame_step
    if use_scan:
        video.CapturedStep = RecordingStep

    def remove():
        video.frame_step, video.CapturedStep = orig_step, orig_captured

    return remove


def run(run, entries) -> dict:
    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import PipelineModels

    cfg, trf = run.config, run.traffic
    device = torch.device(run.device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the config's fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    h, w = cfg["image_size"]
    mode, chunk = trf["mode"], trf.get("chunk", 1)
    frames = scenes.panned_clip(run.seed, (h, w), trf["distinct_frames"],
                                trf["pan_px"])
    ref_rgb = scenes.exemplar(run.seed, (h, w))
    models = PipelineModels.from_state_dicts(
        weights.pipeline_state_dicts(run.seed, device), device)
    kwargs = dict(temperature=cfg["temperature"], wls=cfg["wls"], mode=mode,
                  chunk=chunk)
    probe = Probe(entries, run.traced, device)
    video.colorize_frames(models, frames[:trf["warm_frames"]], ref_rgb,
                          lambda i, o: None, **kwargs)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    rng = scenes.rng_for(run.seed, 2)
    rec = _Recorder(trf["sample_every"], int(rng.integers(trf["sample_every"])))
    remove = _install_hooks(video, rec, use_stream=mode == "stream" or not cuda,
                            use_scan=mode == "scan" and cuda)
    n_trace = trf["trace_frames"] if run.traced else 0
    clock = DeviceClock(device, run.window_device)

    def clip_frames():
        i = 0
        clock.start()
        rec.t0 = time.perf_counter()
        run.record["setup_s"] = harness.process_age_s(run.record["t_start"])
        rec.phase = "window"
        while True:
            at_boundary = mode == "stream" or i % chunk == 0
            if (rec.phase == "window" and at_boundary
                    and time.perf_counter() - rec.t0 >= run.seconds):
                if not n_trace:
                    rec.phase = "done"
                    return
                rec.phase, rec.trace_from = "trace", i
                probe.start()
            if rec.phase == "done" or (
                    rec.phase == "trace" and i >= rec.trace_from + n_trace):
                return
            yield frames[i % len(frames)]
            i += 1

    def on_frame(idx, out):
        t = time.perf_counter() - rec.t0
        rec.times.append(t)
        if rec.phase == "trace" and idx == rec.trace_from + n_trace - 1:
            probe.stop()
            rec.phase = "done"

    harness.note("set-up done")
    failed = 0
    try:
        video.colorize_frames(models, clip_frames(), ref_rgb, on_frame,
                              **kwargs)
    except Exception as e:  # a run that raises is reported, not hidden
        print(f"the timed clip raised: {e!r}", file=sys.stderr)
        failed = 1
    finally:
        clock.stop()
        remove()
        probe.restore()
    if cuda:
        torch.cuda.synchronize(device)
    in_window = [t for t in rec.times if t <= run.seconds]
    run.record.update(frames=len(in_window), times=in_window)
    if clock.busy_s is not None:
        run.record.update(device_busy_s=clock.busy_s,
                          device_items=len(rec.times))
        harness.note(f"device clock: {clock.busy_s:.4f} s busy over "
                     f"{len(rec.times)} frames, {clock.operations} "
                     f"operations ({clock.copy_s:.4f} s of copies)")
    card = harness.card(device)
    card["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0)
    outcome = {"attempted": len(in_window), "failed": failed,
               "device": card}
    harness.note(f"window done: {len(in_window)} frames")
    if run.traced and rec.trace_from is not None and rec.phase == "done":
        run.trace = probe.read()
        harness.note("trace read")
        run.record["trace_frames"] = n_trace
        run.entry_calls = probe.calls
        card["busy_s"] = tr.busy_us(run.trace) / 1e6
        card["window_s"] = run.trace.window_us / 1e6
        outcome["breakdown"] = tr.breakdown(run.trace)

    # the program's state goes before the reference runs
    samples = {i: tuple(t.cpu() for t in s) for i, s in rec.samples.items()
               if i < len(in_window)}
    del models, rec
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(run, samples, frames, ref_rgb, device)
    harness.note("reference done")
    print("readings: " + json.dumps(numbers), file=sys.stderr)
    correct, checks = compare.verdict(numbers, harness.limits(run))
    checks["sampled_frames"] = {"value": len(samples), "limit": 2,
                                "rule": "at least"}
    correct = correct and len(samples) >= 2 and failed == 0
    outcome.update(correct=correct, checks=checks)
    return outcome


def judge(run, samples, frames, ref_rgb, device) -> dict:
    """The compared numbers of the sampled frames {index: (carry_in, out,
    carry_out)} against the reference, in fp32 with TF32 off and its
    convolutions in float64 (reference/infer.py says why)."""
    from benchmark.reference import infer

    cfg = run.config
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        models = infer.Models.from_state_dicts(
            weights.pipeline_state_dicts(run.seed, device), device,
            float64_convolutions=True)
        with torch.no_grad():
            state = infer.prepare_reference(
                models, torch.from_numpy(ref_rgb)[None].to(device))
            pairs = []
            for i in sorted(samples):
                carry_in, out, carry_out = (t.to(device) for t in samples[i])
                frame = torch.from_numpy(frames[i % len(frames)])[None]
                ref_out, ref_carry = infer.step(
                    models, frame.to(device), carry_in, state,
                    cfg["temperature"], cfg["wls"])
                pairs.append((out, ref_out[0], carry_out, ref_carry))
        return compare.clip_numbers(pairs)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
