"""Driver of the batch-serving cells: the window is the first `--seconds`
of `devc_tpu_torch.pipeline.scheduler.ClipBatchScheduler.run()` (the
batch request of cli/serve.py) over a backlog of JPEG clips that outlasts
it, each job with an exemplar of its own: the mix's `slots` clips advance
one frame a batched step, a slot whose clip ends is refilled from the
backlog, and a writer thread encodes the outputs behind the card.

Set-up: the weights from the seed; under TMPDIR a folder of the mix's
`distinct_frames` frames (a panned textured scene) and `exemplars`
exemplars as JPEGs, and the backlog: `jobs` folders, each of links to a
run of those frames from a start of its own, its length drawn from
`clip_frames`; then a short run() of `slots` + 1 jobs of `warm_frames`
frames (a refill among them), so that every kernel is loaded and cuDNN's
choices are made at the batch.

The window starts when run() is called. A frame counts as served when the
writer has written it, inside `--seconds` from there. ClipBatchScheduler
has no stop of its own: the benchmark's wrapper of the scheduler's
batched step raises at the first step past the window (past the traced
stretch, in a traced run), run() releases its slots and the exception
comes back here; the writer goes on to write what was queued. Where a
metric of the cell reads the card's busy time over the window
(run.window_device), benchmark/devclock.py records the card's activity
from run()'s call until the writer has drained; every row stepped under
it counts as a frame.

Correctness: of each job its first frame (the zero carry, right after a
refill) and one frame in `sample_every` are copied aside as the step
makes them: the row's carry in, its output and its new carry. After the
window, with the program freed, the plain reference recomputes each from
the frame's and the exemplar's JPEG files and the weights, teacher-forced
as in drivers/clip.py; and each sampled frame's written file, decoded,
against the row's output encoded as the writer encodes (PIL, quality 95,
decoded): `written_off`, which is exact."""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import compare, harness, scenes, weights
from benchmark import trace as tr
from benchmark.devclock import DeviceClock
from benchmark.probe import Probe

JPEG_QUALITY = 95  # the port's writer (pipeline/video.py::_save)


class _WindowClosed(Exception):
    """Raised inside run() at its first step past the window."""


def read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img.convert("RGB"), dtype=np.uint8)


def jpeg_roundtrip(arr: np.ndarray) -> np.ndarray:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=JPEG_QUALITY)
    buf.seek(0)
    return read_rgb(buf)


class _Recorder:
    """The steps' rows, the writes' times and the sampled frames."""

    def __init__(self, every: int, offset: int, seconds: float,
                 trace_steps: int, probe: Probe):
        self.every, self.offset = every, offset
        self.seconds, self.trace_steps, self.probe = seconds, trace_steps, probe
        self.t0 = None
        self.phase = "window"  # -> "trace" -> "done"
        self.rows = []         # the run's _Slot objects, in row order
        self.queued = 0        # frames the steps handed to the writer
        self.writes = []       # seconds after t0 of each finished write
        self.samples = {}      # (job, frame) -> (carry_in, out, carry_out)
        self.traced_steps = self.traced_frames = 0

    def sampled(self, f: int) -> bool:
        return f == 0 or (f + self.offset) % self.every == 0

    def before_step(self):
        """Called at each batched step: close the window or the traced
        stretch where it is due."""
        t = time.perf_counter() - self.t0
        if self.phase == "window" and t >= self.seconds:
            if not self.trace_steps:
                self.phase = "done"
            else:
                self.phase = "trace"
                self.probe.start()
        if self.phase == "trace" and self.traced_steps >= self.trace_steps:
            self.probe.stop()
            self.phase = "done"
        if self.phase == "done":
            raise _WindowClosed


def _install_hooks(sched_mod, rec):
    """Wrap the scheduler's batched step, its writer's save and its slot
    class; returns a function that puts them back."""
    orig_step, orig_save, orig_slot = (sched_mod.batched_frame_step,
                                       sched_mod._save, sched_mod._Slot)

    class RecordingSlot(orig_slot):
        __slots__ = ()

        def __init__(self):
            super().__init__()
            rec.rows.append(self)

    def step(models, frames_u8, last_lab, *args, **kwargs):
        rec.before_step()
        rows = [(i, s.job["idx"], s.index) for i, s in enumerate(rec.rows)
                if s.job is not None]
        take = ([r for r in rows if rec.sampled(r[2])]
                if rec.phase == "window" else [])
        carry_in = {i: last_lab[i:i + 1].clone() for i, _, _ in take}
        out, new = orig_step(models, frames_u8, last_lab, *args, **kwargs)
        for i, j, f in take:
            rec.samples[(j, f)] = (carry_in[i], out[i].clone(),
                                   new[i:i + 1].clone())
        rec.queued += len(rows)
        if rec.phase == "trace":
            rec.traced_steps += 1
            rec.traced_frames += len(rows)
        return out, new

    def save(path, arr):
        orig_save(path, arr)
        rec.writes.append(time.perf_counter() - rec.t0)

    sched_mod.batched_frame_step, sched_mod._save = step, save
    sched_mod._Slot = RecordingSlot

    def remove():
        (sched_mod.batched_frame_step, sched_mod._save,
         sched_mod._Slot) = orig_step, orig_save, orig_slot

    return remove


def run(run, entries) -> dict:
    tmp = tempfile.mkdtemp(prefix="devc-bench-serve-")
    try:
        return _serve(run, entries, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _scheduler(models, cfg, trf):
    from devc_tpu_torch.pipeline.scheduler import ClipBatchScheduler

    return ClipBatchScheduler(models, image_size=tuple(cfg["image_size"]),
                              slots=trf["slots"],
                              temperature=cfg["temperature"], wls=cfg["wls"],
                              out_ext="jpg")


def _serve(run, entries, tmp) -> dict:
    from devc_tpu_torch.pipeline import scheduler as sched_mod
    from devc_tpu_torch.pipeline.frame import PipelineModels

    cfg, trf = run.config, run.traffic
    device = torch.device(run.device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the config's fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    jobs = scenes.write_serve_jobs(os.path.join(tmp, "in"), run.seed,
                                   tuple(cfg["image_size"]), trf)
    models = PipelineModels.from_state_dicts(
        weights.pipeline_state_dicts(run.seed, device), device)
    warm = _scheduler(models, cfg, trf)
    for k in range(trf["slots"] + 1):
        warm.submit(jobs["warm"][k]["clip"], jobs["warm"][k]["ref"],
                    os.path.join(tmp, "warm", str(k)))
    warm.run()
    del warm
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    sched = _scheduler(models, cfg, trf)
    out_dirs = []
    for j, job in enumerate(jobs["backlog"]):
        out_dirs.append(os.path.join(tmp, "out", f"j{j:03d}"))
        sched.submit(job["clip"], job["ref"], out_dirs[-1])
    probe = Probe(entries, run.traced, device)
    clock = DeviceClock(device, run.window_device)
    rec = _Recorder(trf["sample_every"],
                    int(scenes.rng_for(run.seed, 2).integers(
                        trf["sample_every"])),
                    run.seconds, trf["trace_steps"] if run.traced else 0,
                    probe)
    remove = _install_hooks(sched_mod, rec)
    harness.note("set-up done")
    failed, ended = 0, False
    clock.start()
    rec.t0 = time.perf_counter()
    run.record["setup_s"] = harness.process_age_s(run.record["t_start"])
    try:
        sched.run()
        ended = True  # the backlog ran out inside the window
    except _WindowClosed:
        pass
    except Exception as e:  # a run that raises is reported, not hidden
        print(f"the scheduler raised: {e!r}", file=sys.stderr)
        failed = 1
    finally:
        probe.restore()
        # the writer goes on with what was queued: every frame stepped is
        # written, late or not, before the hooks go and its file is judged
        deadline = time.perf_counter() + 60
        while (len(rec.writes) < rec.queued
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        clock.stop()
        remove()
    if cuda:
        torch.cuda.synchronize(device)
    served = sorted(t for t in rec.writes if t <= run.seconds)
    run.record.update(times=served, frames=len(served))
    if clock.busy_s is not None:
        run.record.update(device_busy_s=clock.busy_s,
                          device_items=rec.queued)
        harness.note(f"device clock: {clock.busy_s:.4f} s busy over "
                     f"{rec.queued} frames stepped, {clock.operations} "
                     f"operations ({clock.copy_s:.4f} s of copies)")
    card = harness.card(device)
    card["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0)
    outcome = {"attempted": len(served), "failed": failed + int(ended),
               "device": card}
    harness.note(f"window done: {len(served)} frames written")
    if ended:
        print("the backlog ran out inside the window", file=sys.stderr)
    if run.traced and rec.traced_steps and rec.phase == "done":
        run.trace = probe.read()
        run.record.update(trace_steps=rec.traced_steps,
                          trace_frames=rec.traced_frames)
        run.entry_calls = probe.calls
        card["busy_s"] = tr.busy_us(run.trace) / 1e6
        card["window_s"] = run.trace.window_us / 1e6
        outcome["breakdown"] = tr.breakdown(run.trace)
        harness.note("trace read")

    # the program's state goes before the reference runs
    samples = {k: tuple(t.cpu() for t in v) for k, v in rec.samples.items()}
    del models, sched, rec
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(run, samples, jobs["backlog"], out_dirs, device)
    harness.note("reference done")
    print("readings: " + json.dumps(numbers), file=sys.stderr)
    correct, checks = compare.verdict(numbers, harness.limits(run))
    checks["sampled_frames"] = {"value": len(samples), "limit": 2,
                                "rule": "at least"}
    correct = (correct and len(samples) >= 2 and not outcome["failed"])
    outcome.update(correct=correct, checks=checks)
    return outcome


def reference_outputs(run, samples, jobs, device):
    """{(job, frame): (ref_out, ref_carry)} of the plain reference (TF32
    off, convolutions in float64, as drivers/clip.py's judge) for the
    sampled frames {(job, frame): (carry_in, ...)}, each from its carry in,
    from the frame's and the exemplar's files."""
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
        out, state, state_of = {}, None, None
        with torch.no_grad():
            for j, f in sorted(samples):
                if state_of != j:
                    ref = torch.from_numpy(read_rgb(jobs[j]["ref"]))
                    state = infer.prepare_reference(models,
                                                    ref[None].to(device))
                    state_of = j
                frame = torch.from_numpy(read_rgb(jobs[j]["frames"][f]))
                ref_out, ref_carry = infer.step(
                    models, frame[None].to(device),
                    samples[(j, f)][0].to(device), state,
                    cfg["temperature"], cfg["wls"])
                out[(j, f)] = (ref_out[0], ref_carry)
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def judge(run, samples, jobs, out_dirs, device) -> dict:
    """The compared numbers of the sampled frames against the reference,
    and of their written files against their outputs."""
    ref = reference_outputs(run, samples, jobs, device)
    pairs, off, vals = [], 0, 0
    for key in sorted(samples):
        carry_in, out, carry_out = samples[key]
        ref_out, ref_carry = ref[key]
        pairs.append((out.to(device), ref_out, carry_out.to(device),
                      ref_carry))
        j, f = key
        path = os.path.join(out_dirs[j], f"{f:05d}.jpg")
        want = jpeg_roundtrip(out.numpy())
        got = read_rgb(path) if os.path.exists(path) else None
        if got is None or got.shape != want.shape:
            off += want.size
        else:
            off += int((got != want).sum())
        vals += want.size
    numbers = compare.clip_numbers(pairs)
    numbers["written_off"] = off / vals if vals else None
    return numbers
