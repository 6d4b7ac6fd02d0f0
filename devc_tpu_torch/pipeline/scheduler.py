"""Batched serving of many clips (mirrors devc_tpu/pipeline/scheduler.py).

B clip slots advance one frame per device step through
parallel/inference.py::batched_frame_step (one K1 launch at batch B, six
K2 launches with a guide per slot), and a slot whose clip has ended is
refilled from the job queue: its exemplar row is replaced in place and
its carry row reset to zero. The step's fixed costs (launches, small
stages) are shared by the slots.

Jobs may be frame folders or video files (cv2 decode), mixed freely. With
device_resize the host only decodes: each slot's raw frames are
zero-padded to the largest source size among the jobs, and the CenterPad
runs on the device through per-slot plans
(ops/device_resize.py::centerpad_plan_padded), so jobs of mixed
resolutions share the step.

Host side: one decode thread per active slot reads ahead, and a writer
thread encodes behind the device. Failures stay with their job: a bad clip
or exemplar, a decode error mid-clip or a failed write (a full disk) fails
that job's result and frees its slot; the batch runs on. Slots with no
job step on a zero frame (fixed shapes), and their carry rows are zeroed
after the step, so that a job that later takes the slot starts from zero
as it would alone.

Used by cli/serve.py's {"cmd": "batch", "jobs": [...]} request.
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import torch

from devc_tpu_torch.data.transforms import (
    centerpad_np,
    is_video_file,
    list_clip_frames,
    load_frame_rgb,
    read_rgb,
)
from devc_tpu_torch.ops.device_resize import centerpad_plan_padded
from devc_tpu_torch.parallel.inference import batched_frame_step
from devc_tpu_torch.pipeline.video import (
    _device_ref_features,
    _save,
    _to_device_u8,
    _video_frames_rgb,
)


class _Slot:
    __slots__ = ("job", "frames_q", "reader", "stop", "index", "written",
                 "t0")

    def __init__(self):
        self.job = None
        self.frames_q = None
        self.reader = None
        self.stop = None  # set: the job is dropped, its reader returns
        self.index = 0
        self.written = []
        self.t0 = 0.0

    def release(self):
        """Let the job's reader return though its frames are not taken (a
        job failed or the run ended): a reader blocked on a full queue
        would otherwise hold its frames, the job and the scheduler (with
        the models) for the life of the process."""
        if self.stop is not None:
            self.stop.set()


def _probe_source(clip_path: str):
    """(kind, frame names or None, (src_h, src_w)) without decoding the
    clip; kind is "video" or "frames". Raises on an empty or unreadable
    source, so that the scheduler fails that job alone."""
    if is_video_file(clip_path):
        import cv2

        cap = cv2.VideoCapture(clip_path)
        if not cap.isOpened():
            raise ValueError(f"cannot open video file {clip_path}")
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        cap.release()
        if h <= 0 or w <= 0:
            raise ValueError(f"no frames decoded from {clip_path}")
        return "video", None, (h, w)
    if not os.path.isdir(clip_path):
        raise ValueError(f"{clip_path}: not a directory of frames or a "
                         "video file")
    names = list_clip_frames(clip_path)
    if not names:
        raise ValueError(f"no frames in {clip_path}")
    from PIL import Image

    with Image.open(os.path.join(clip_path, names[0])) as im:
        w, h = im.size  # the header alone
    return "frames", names, (h, w)


class ClipBatchScheduler:
    """Run many (clip, exemplar, output_dir) jobs through one B-slot
    batched step on the models' device.

    run() returns one dict per job, in submission order: frames, seconds,
    fps and outputs, or error (with the outputs written before it).
    """

    def __init__(self, models, image_size=(432, 768), slots: int = 4,
                 temperature: float = 1e-10, wls: bool = True,
                 prefetch: int = 4, out_ext: str = "jpg",
                 device_resize: bool = False):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.models = models
        self.image_size = tuple(image_size)
        self.slots = slots
        self.temperature = temperature
        self.wls = wls
        self.prefetch = prefetch
        self.out_ext = out_ext
        self.device_resize = device_resize
        self.jobs = []
        self._max_hw = None
        self.steps = 0  # batched device steps run()'s last call took

    def submit(self, clip_path: str, ref_path: str, output_path: str) -> int:
        self.jobs.append(dict(clip_path=clip_path, ref_path=ref_path,
                              output_path=output_path))
        return len(self.jobs) - 1

    # -- internals ---------------------------------------------------------

    def _frame_iter(self, job):
        """One job's uint8 frames: CenterPadded to image_size on the host,
        or raw and zero-padded to the batch's largest source
        (device_resize)."""
        if job["kind"] == "video":
            raws = _video_frames_rgb(job["clip_path"])
        elif not self.device_resize:
            for n in job["names"]:  # decode and CenterPad in one helper
                yield load_frame_rgb(os.path.join(job["clip_path"], n),
                                     self.image_size)
            return
        else:
            raws = (read_rgb(os.path.join(job["clip_path"], n))
                    for n in job["names"])
        if not self.device_resize:
            for raw in raws:
                yield centerpad_np(raw, self.image_size)
            return
        mh, mw = self._max_hw
        for raw in raws:
            if raw.shape[:2] != tuple(job["src_hw"]):
                raise ValueError(
                    f"frame resolution changed mid-clip in "
                    f"{job['clip_path']}: {raw.shape[:2]} vs {job['src_hw']} "
                    "(device_resize needs one resolution per clip)")
            padded = np.zeros((mh, mw, 3), np.uint8)
            padded[:raw.shape[0], :raw.shape[1]] = raw
            yield padded

    def _start_slot(self, slot: _Slot, job_idx: int):
        job = dict(self.jobs[job_idx], idx=job_idx)
        job["kind"], job["names"], job["src_hw"] = _probe_source(
            job["clip_path"])
        os.makedirs(job["output_path"], exist_ok=True)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def reader():
            try:
                for frame in self._frame_iter(job):
                    if not put(frame):
                        return
                put(None)
            except Exception as e:  # a decode failure fails the job
                put(e)

        t = threading.Thread(target=reader, daemon=True,
                             name="devc-scheduler-reader")
        t.start()
        slot.job = job
        slot.frames_q = q
        slot.reader = t
        slot.stop = stop
        slot.index = 0
        slot.written = []
        slot.t0 = time.time()

    @torch.inference_mode()
    def run(self):
        h, w = self.image_size
        b = self.slots
        device = self.models.device

        self.steps = 0
        results = [None] * len(self.jobs)
        pending = list(range(len(self.jobs)))
        slots = [_Slot() for _ in range(b)]

        # device_resize: the batch's raw frame size is the largest source
        # of the runnable jobs; per-slot plans [B, th, maxH] / [B, tw, maxW]
        # live on the device, their rows replaced as jobs rotate in
        plans = None
        if self.device_resize:
            src_sizes = []
            for idx in list(pending):
                try:
                    src_sizes.append(
                        _probe_source(self.jobs[idx]["clip_path"])[2])
                except Exception as e:
                    results[idx] = dict(error=str(e))
                    pending.remove(idx)
            if not src_sizes:
                return results
            self._max_hw = (max(s[0] for s in src_sizes),
                            max(s[1] for s in src_sizes))
            mh, mw = self._max_hw
            plans = (torch.zeros((b, h, mh), device=device),
                     torch.zeros((b, w, mw), device=device))
            in_hw = (mh, mw)
        else:
            in_hw = (h, w)
        zero_frame = np.zeros((*in_hw, 3), np.uint8)

        # batched exemplar state, rows replaced in place as jobs rotate in
        ref_stack = None
        last = torch.zeros((b, h // 2, w // 2, 3), device=device)

        def set_ref_row(i, ref_path):
            nonlocal ref_stack
            # an exemplar is one image: always CenterPadded on the host
            ref = load_frame_rgb(ref_path, self.image_size)
            ref_u8 = _to_device_u8(ref, ref.shape, device)
            _, state = _device_ref_features(self.models, ref_u8)
            if ref_stack is None:
                ref_stack = {k: v.repeat(b, *([1] * (v.dim() - 1)))
                             for k, v in state.items()}
            else:
                for k, v in state.items():
                    ref_stack[k][i] = v[0]

        def set_plan_row(i, src_hw):
            for full, plan in zip(plans, centerpad_plan_padded(
                    src_hw, self.image_size, self._max_hw)):
                full[i] = torch.from_numpy(plan).to(device)

        def refill(i):
            while pending:
                job_idx = pending.pop(0)
                try:
                    self._start_slot(slots[i], job_idx)
                    set_ref_row(i, slots[i].job["ref_path"])
                    if self.device_resize:
                        set_plan_row(i, slots[i].job["src_hw"])
                except Exception as e:  # a bad clip or exemplar: this job
                    results[job_idx] = dict(error=str(e))
                    slots[i].release()
                    slots[i].job = None
                    continue
                last[i] = 0.0
                return
            slots[i].job = None

        for i in range(b):
            refill(i)
        if ref_stack is None:
            return results  # no runnable job

        # the writer: an encode or I/O error is recorded against its job,
        # and the batch runs on
        write_q: queue.Queue = queue.Queue(maxsize=2 * b)
        writer_errs: dict[int, str] = {}

        def writer():
            while True:
                item = write_q.get()
                if item is None:
                    return
                job_idx, path, arr = item
                if job_idx in writer_errs:
                    continue  # the job failed; drop its queued frames
                try:
                    _save(path, arr)
                except Exception as e:
                    writer_errs[job_idx] = str(e)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

        def finish_job(i, s):
            """Record a slot's result (done, or its write failed), refill."""
            dt = time.time() - s.t0
            job_idx = s.job["idx"]
            s.release()
            if job_idx in writer_errs:
                results[job_idx] = dict(
                    error=f"write failed: {writer_errs[job_idx]}",
                    outputs=sorted(s.written))
            else:
                results[job_idx] = dict(
                    frames=s.index, seconds=round(dt, 2),
                    fps=round(s.index / dt, 2) if dt > 0 else 0.0,
                    outputs=sorted(s.written))
            refill(i)

        try:
            while any(s.job is not None for s in slots):
                frames, active = [], []
                for i, s in enumerate(slots):
                    if s.job is None:
                        frames.append(zero_frame)
                        continue
                    # stop stepping a job whose write failed
                    if s.job["idx"] in writer_errs:
                        finish_job(i, s)
                        s = slots[i]
                        if s.job is None:
                            frames.append(zero_frame)
                            continue
                    frame = s.frames_q.get()
                    # a decode failure mid-clip
                    if isinstance(frame, Exception):
                        results[s.job["idx"]] = dict(error=str(frame),
                                                     outputs=sorted(s.written))
                        refill(i)
                        s = slots[i]
                        if s.job is None:
                            frames.append(zero_frame)
                            continue
                        frame = s.frames_q.get()
                        if isinstance(frame, Exception):
                            # two bad jobs in a row: fail it, idle this step
                            results[s.job["idx"]] = dict(error=str(frame),
                                                         outputs=[])
                            refill(i)
                            frames.append(zero_frame)
                            continue
                    if frame is None:  # the clip ended
                        finish_job(i, s)
                        s = slots[i]
                        if s.job is None:
                            frames.append(zero_frame)
                            continue
                        frame = s.frames_q.get()
                        if frame is None or isinstance(frame, Exception):
                            # a first-frame decode error fails the new job (an
                            # empty clip cannot get here: _probe_source)
                            if isinstance(frame, Exception):
                                results[s.job["idx"]] = dict(error=str(frame),
                                                             outputs=[])
                                slots[i].job = None
                            frames.append(zero_frame)
                            continue
                    frames.append(frame)
                    active.append(i)
                if not active:
                    continue

                out, last = batched_frame_step(
                    self.models, torch.from_numpy(np.stack(frames)).to(device),
                    last, ref_stack, self.temperature, self.wls,
                    resize_plans=plans)
                self.steps += 1
                # the step ran over all B rows; a row that idled on a zero
                # frame (e.g. refilled after two decode failures in a row) must
                # not keep that output as its carry, or the job that takes the
                # slot next would not start from zero as it would alone
                idle = [i for i in range(b) if i not in active]
                if idle:
                    last[idle] = 0.0
                out_np = out.cpu().numpy()
                for i in active:
                    s = slots[i]
                    path = os.path.join(s.job["output_path"],
                                        f"{s.index:05d}.{self.out_ext}")
                    write_q.put((s.job["idx"], path, out_np[i]))
                    s.written.append(path)
                    s.index += 1
        finally:
            for s in slots:
                s.release()
        write_q.put(None)
        wt.join()
        # write errors that came after the job's last frame
        for idx, msg in writer_errs.items():
            r = results[idx]
            if r is not None and "error" not in r:
                results[idx] = dict(error=f"write failed: {msg}",
                                    outputs=r.get("outputs", []))
        return results
