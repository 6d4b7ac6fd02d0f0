"""Clip driver: decode -> one device step per frame -> encode (mirrors
devc_tpu/pipeline/video.py).

The host decodes frames (a folder, or a video file through cv2) and
center-pads them to uint8, or, with device_resize, leaves the CenterPad to
the device (ops/device_resize.py). One device step per frame does the Lab
conversion, the x0.5 downscale, colourisation, the ab upsample x2 with the
1.25 chroma boost, the edge-aware smoother and Lab -> RGB back to uint8.

  * `frame_step`: one frame, one exemplar; `frame_step_multi`: one frame
    against R exemplars (one VGG / query embedding, K1 and ColorVidNet
    batched over R); `step_body`: B frames of B clips, each against its
    own exemplar (parallel/inference.py's batched step).
  * `colorize_frames` / `colorize_frames_multi`: the loop over decoded
    arrays, in mode "stream" (one step per frame, one uint8 frame across
    each way) or "scan" (chunks of frames; on the card one captured CUDA
    graph replayed per frame, pipeline/graph.py).
  * `colorize_video` / `colorize_video_multi`: those loops with a
    decode-ahead thread and an encode-behind writer thread.
PIL and cv2 are imported only where frames are read or written.

compute_dtype=torch.bfloat16 (cli.colorize --bf16, with models built in
bf16) runs the networks (VGG, WarpNet, ColorVidNet) and K1 in bf16, as
devc_tpu's `_frame_body(compute_dtype="bfloat16")`: the network input and
the carry are cast to bf16, the exemplar's state is prepared in bf16 from
its fp32 Lab; pre- and post-processing, the carry, the smoother (K2) and
Lab -> uint8 stay fp32. The batched-exemplar drivers take no
compute_dtype (nor does devc_tpu's): with bf16 models they compute in fp32
with bf16-rounded weights.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import warnings

import numpy as np
import torch

from devc_tpu_torch import colorspace as cs
from devc_tpu_torch.data.transforms import (
    VIDEO_EXTS,
    centerpad_np,
    is_video_file,
    list_clip_frames,
    load_frame_rgb,
    read_rgb,
)
from devc_tpu_torch.models.colorvidnet import colorvidnet_apply
from devc_tpu_torch.models.warpnet import warp_with_keys
from devc_tpu_torch.ops.device_resize import centerpad_plan, device_centerpad
from devc_tpu_torch.ops.fgs import fast_global_smoother
from devc_tpu_torch.ops.resize import resize_bilinear
from devc_tpu_torch.pipeline.frame import (
    PipelineModels,
    frame_colorization,
    prepare_reference,
    query_embedding,
)
from devc_tpu_torch.pipeline.graph import CapturedStep
from devc_tpu_torch.utils.convert import use_full_fp32
from devc_tpu_torch.utils.profiling import span


_PREFETCH = 4  # frames decoded ahead of, and encoded behind, the device


def check_image_size(h: int, w: int) -> None:
    """The network runs at (H/2, W/2); its H must divide by 8 (WarpNet
    replicate-pads the H % 16 == 8 case) and its W by 16."""
    if h % 16 or w % 32:
        raise ValueError(
            f"image size {h} {w}: H must be a multiple of 16 and W a "
            "multiple of 32 (the reference default is 432 768)")


class _AsyncWriter:
    """Encode-behind writer thread with failure propagation.

    A writer exception is re-raised in the producer at the next put() or
    at close(); after a failure the thread keeps draining the queue so a
    put() never blocks forever.
    """

    def __init__(self, write_fn, maxsize: int):
        self._write_fn = write_fn
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.err: Exception | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.err is not None:
                continue  # drain: the producer must never block post-failure
            try:
                self._write_fn(*item)
            except Exception as e:  # re-raised in the producer
                self.err = e

    def put(self, *item) -> None:
        if self.err is not None:
            raise self.err
        self._q.put(item)

    def close(self, raise_err: bool = True) -> None:
        self._q.put(None)
        self._t.join()
        if raise_err and self.err is not None:
            raise self.err


def _decode_ahead(produce, prefetch: int):
    """Yield produce()'s items, decoded up to `prefetch` ahead in a thread.
    A decode error is re-raised here; closing the generator stops the
    thread."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    end = object()

    def reader():
        try:
            for item in produce():
                if stop.is_set():
                    return
                q.put(item)
        except Exception as e:  # surfaced in the consumer
            q.put(e)
            return
        q.put(end)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():  # unblock a reader waiting on a full queue
            with contextlib.suppress(queue.Empty):
                q.get(timeout=0.05)
        t.join()


def _resize_nhwc(x, out_hw):
    return resize_bilinear(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def _preprocess_batch(rgb_u8):
    """uint8 RGB [B, H, W, 3] -> (lab_large [B, H, W, 3], lab_small
    [B, H/2, W/2, 3]), network-Lab."""
    lab_large = cs.center_lab(cs.rgb_to_lab(rgb_u8.float() / 255.0))
    h, w = rgb_u8.shape[1], rgb_u8.shape[2]
    return lab_large, _resize_nhwc(lab_large, (h // 2, w // 2))


def _preprocess_device(rgb_u8):
    """uint8 RGB [H, W, 3] -> (lab_large [1, H, W, 3], lab_small
    [1, H/2, W/2, 3]), network-Lab."""
    return _preprocess_batch(rgb_u8[None])


def _postprocess(lab_large, pred_ab, wls: bool):
    """pred_ab [B, h, w, 2] -> uint8 RGB [B, 2h, 2w, 3]: the ab upsample x2
    with the 1.25 chroma boost, the edge-aware smoother guided by the
    uint8-truncated L (as the reference feeds OpenCV's filter) and Lab ->
    RGB. lab_large: [B, H, W, 3], or [1, H, W, 3] for one frame shared by
    all B predictions (several exemplars: one guide for the whole batch)."""
    b = pred_ab.shape[0]
    h, w = lab_large.shape[1], lab_large.shape[2]
    with span("frame::post"):
        ab_up = _resize_nhwc(pred_ab, (h, w)) * 1.25
        l_large = lab_large[..., 0:1]
        if wls:
            guide = torch.clamp(
                torch.floor(cs.uncenter_l(l_large[..., 0]) * 255.0 / 100.0),
                0.0, 255.0)
            ab_up = fast_global_smoother(
                ab_up, guide if guide.shape[0] > 1 else guide[0])
        l_large = l_large.expand(b, h, w, 1)
        rgb_out = cs.lab_centered_to_rgb(torch.cat([l_large, ab_up], dim=-1))
        return torch.floor(torch.clamp(rgb_out, 0.0, 1.0) * 255.0).to(
            torch.uint8)


@torch.inference_mode()
def _device_ref_features_multi(models: PipelineModels, refs_rgb_u8,
                               compute_dtype=None):
    """Exemplar preparation for R stacked exemplars uint8 [R, H, W, 3]:
    (ref_lab_small [R, H/2, W/2, 3], ref_state batched over R). With
    compute_dtype the state is computed from the Lab cast to it;
    ref_lab_small stays fp32."""
    use_full_fp32()
    _, ref_lab_small = _preprocess_batch(refs_rgb_u8)
    net_lab = (ref_lab_small if compute_dtype is None
               else ref_lab_small.to(compute_dtype))
    return ref_lab_small, prepare_reference(models, net_lab)


def _device_ref_features(models: PipelineModels, ref_rgb_u8,
                         compute_dtype=None):
    """Exemplar preparation, once per clip: (ref_lab_small, ref_state)."""
    return _device_ref_features_multi(models, ref_rgb_u8[None], compute_dtype)


def _plan_on(resize_plan, device):
    """A numpy (A_h, A_w) CenterPad plan -> fp32 tensors on device."""
    if resize_plan is None:
        return None
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in resize_plan)


@torch.inference_mode()
def step_body(models: PipelineModels, frames_u8, last_lab, ref_state,
              temperature: float = 1e-10, wls: bool = True,
              compute_dtype=None, corr_sharding=None):
    """One step over B frames on the device, each with its own carry and
    exemplar row: uint8 [B, H, W, 3] -> (uint8 RGB [B, H, W, 3], new
    carry [B, H/2, W/2, 3] = [L, predicted ab]). One K1 launch at batch B
    and six K2 launches, one per smoother pass, each with a guide per
    frame. compute_dtype: the networks' dtype (module docstring); the
    carry stays fp32. corr_sharding: (mesh, axis, kind), the
    correspondence split over ranks (`frame_colorization`)."""
    use_full_fp32()
    lab_large, lab_small = _preprocess_batch(frames_u8)
    net_in, net_last = lab_small, last_lab
    if compute_dtype is not None:
        net_in, net_last = (lab_small.to(compute_dtype),
                            last_lab.to(compute_dtype))
    pred_ab = frame_colorization(models, net_in, net_last, ref_state,
                                 temperature, joint_training=False,
                                 corr_sharding=corr_sharding)[0].float()
    new_last = torch.cat([lab_small[..., 0:1], pred_ab], dim=-1)
    return _postprocess(lab_large, pred_ab, wls), new_last


@torch.inference_mode()
def frame_step(models: PipelineModels, rgb_u8, last_lab, ref_state,
               temperature: float = 1e-10, wls: bool = True,
               resize_plan=None, compute_dtype=None):
    """One frame on the device: uint8 [H, W, 3] -> (uint8 RGB [H, W, 3],
    new carry [1, H/2, W/2, 3] = [L, predicted ab]).

    resize_plan: optional (A_h, A_w) fp32 tensors on the device
    (ops/device_resize.py::centerpad_plan): rgb_u8 is then the raw decoded
    frame, and the CenterPad runs here as two matrix products.
    compute_dtype: see `step_body`; ref_state must be prepared with it."""
    if resize_plan is not None:
        rgb_u8 = device_centerpad(rgb_u8, *resize_plan)
    out, new_last = step_body(models, rgb_u8[None], last_lab, ref_state,
                              temperature, wls, compute_dtype)
    return out[0], new_last


@torch.inference_mode()
def frame_step_multi(models: PipelineModels, rgb_u8, last_lab, ref_state,
                     temperature: float = 1e-10, wls: bool = True,
                     resize_plan=None):
    """One frame against R exemplars at once: uint8 [H, W, 3], carries
    [R, H/2, W/2, 3] and exemplar state batched over R -> (uint8 RGB
    [R, H, W, 3], new carries [R, H/2, W/2, 3]).

    The reference re-runs the whole pipeline per exemplar; here the
    frame's VGG taps and query embedding run once, and only the
    correspondence (one K1 launch at batch R) and ColorVidNet are
    R-batched. The smoother runs the R predictions against the frame's one
    guide: six K2 launches. resize_plan: as in `frame_step`."""
    use_full_fp32()
    if resize_plan is not None:
        rgb_u8 = device_centerpad(rgb_u8, *resize_plan)
    lab_large, lab_small = _preprocess_device(rgb_u8)
    r = last_lab.shape[0]
    a_l = lab_small[..., 0:1]
    theta = query_embedding(models, a_l)
    with span("frame::corr"):
        # K1 takes contiguous inputs: theta repeated, 4 N C bytes an
        # exemplar
        theta_r = theta.expand(r, *theta.shape[1:]).contiguous()
        warped, sim = warp_with_keys(theta_r, ref_state["phi"],
                                     ref_state["values"],
                                     (a_l.shape[1], a_l.shape[2]),
                                     temperature)
    a_l_r = a_l.expand(r, *a_l.shape[1:])
    with span("frame::colorvidnet"):
        pred_ab = colorvidnet_apply(models.colorvid, torch.cat(
            [a_l_r, warped[..., 1:3], sim, last_lab], dim=-1)).float()
    new_last = torch.cat([a_l_r, pred_ab], dim=-1)
    return _postprocess(lab_large, pred_ab, wls), new_last


def _to_device_u8(arr, shape, device):
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch.from_numpy wants a writable array
        arr = arr.copy()
    if arr.dtype != np.uint8 or arr.shape != shape:
        raise ValueError(f"expected uint8 {shape}, got {arr.dtype} "
                         f"{arr.shape}")
    return torch.from_numpy(arr).to(device)


def _chunks(frames, chunk: int):
    buf = []
    for rgb in frames:
        buf.append(rgb)
        if len(buf) == chunk:
            yield buf
            buf = []
    if buf:
        yield buf


def _run_clip(step, frames, frame_shape, carry, on_frame, mode: str,
              chunk: int) -> int:
    """Drive step(frame_u8, carry) -> (out_u8, carry) over frames (host
    uint8 arrays of frame_shape), in order; on_frame(idx, out) gets each
    output on the host. Returns the frame count.

    mode "stream": one step per frame, one upload and one download each.
    mode "scan": `chunk` frames per upload and per download; on the card
    the step is captured once as a CUDA graph (`graph.CapturedStep`) and
    replayed per frame; on the CPU the same chunk loop runs the step
    eagerly. Spans (utils/profiling.py): "clip::frame" round each frame
    (scan: each chunk), with "clip::upload", "clip::step" (the host's
    dispatch) and "clip::download" (the synchronising copy) inside it."""
    if mode not in ("stream", "scan"):
        raise ValueError(f"unknown mode {mode!r} (expected 'stream' or "
                         "'scan')")
    device = carry.device
    n = 0
    if mode == "stream":
        for rgb in frames:
            with span("clip::frame"):
                with span("clip::upload"):
                    rgb = _to_device_u8(rgb, frame_shape, device)
                with span("clip::step"):
                    out, carry = step(rgb, carry)
                with span("clip::download"):
                    out = out.cpu().numpy()
                on_frame(n, out)
            n += 1
        return n
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    runner = (CapturedStep(step, frame_shape, carry)
              if device.type == "cuda" else None)
    for buf in _chunks(frames, chunk):
        with span("clip::frame"):
            with span("clip::upload"):
                batch = _to_device_u8(np.stack(buf), (len(buf), *frame_shape),
                                      device)
            with span("clip::step"):
                if runner is not None:
                    outs = runner.run(batch)
                else:
                    outs = []
                    for rgb in batch:
                        out, carry = step(rgb, carry)
                        outs.append(out)
                    outs = torch.stack(outs)
            with span("clip::download"):
                outs = outs.cpu().numpy()
            for out in outs:
                on_frame(n, out)
                n += 1
    return n


def _frame_shape(exemplar_shape, resize_plan):
    """The shape of the frames a driver takes: the exemplar's, or the raw
    source size a CenterPad plan reads."""
    if resize_plan is None:
        return exemplar_shape
    return (np.shape(resize_plan[0])[1], np.shape(resize_plan[1])[1], 3)


def _check_exemplars(refs_rgb_u8):
    shape = tuple(np.shape(refs_rgb_u8))
    if len(shape) != 4 or shape[3] != 3 or shape[0] < 1:
        raise ValueError(f"exemplars must be [R, H, W, 3], got {shape}")
    check_image_size(shape[1], shape[2])
    return shape[1:]


def colorize_frames(models: PipelineModels, frames, ref_rgb_u8, on_frame,
                    temperature: float = 1e-10, wls: bool = True,
                    frame_propagate: bool = False, mode: str = "stream",
                    chunk: int = 64, resize_plan=None,
                    compute_dtype=None) -> int:
    """Colourise decoded frames against one exemplar, in order.

    frames: iterable of uint8 [H, W, 3] arrays of the exemplar's shape
    (or, with resize_plan, raw frames of the plan's source size).
    ref_rgb_u8: uint8 [H, W, 3]. Runs on the models' device.
    frame_propagate starts the recurrence from the exemplar (the first
    frame used as its own exemplar) instead of zeros. on_frame(idx, rgb)
    receives each uint8 output on the host. mode / chunk: see `_run_clip`.
    resize_plan: an optional numpy (A_h, A_w) CenterPad plan
    (ops/device_resize.py), applied on the device. compute_dtype: the
    networks' dtype (torch.bfloat16 with bf16 models; module docstring).
    Returns the frame count.
    """
    shape = _check_exemplars(np.asarray(ref_rgb_u8)[None])
    device = models.device
    ref_lab_small, ref_state = _device_ref_features(
        models, _to_device_u8(ref_rgb_u8, shape, device), compute_dtype)
    last_lab = (ref_lab_small if frame_propagate
                else torch.zeros_like(ref_lab_small))
    plan = _plan_on(resize_plan, device)

    def step(rgb, last):
        return frame_step(models, rgb, last, ref_state, temperature, wls,
                          plan, compute_dtype)

    return _run_clip(step, frames, _frame_shape(shape, resize_plan),
                     last_lab, on_frame, mode, chunk)


def colorize_frames_multi(models: PipelineModels, frames, refs_rgb_u8,
                          on_frame, temperature: float = 1e-10,
                          wls: bool = True, mode: str = "stream",
                          chunk: int = 64, resize_plan=None) -> int:
    """Colourise decoded frames against R exemplars uint8 [R, H, W, 3] at
    once (`frame_step_multi`). on_frame(idx, rgb) receives uint8
    [R, H, W, 3]: frame idx under each exemplar. Otherwise as
    `colorize_frames`."""
    refs = np.asarray(refs_rgb_u8)
    shape = _check_exemplars(refs)
    device = models.device
    _, ref_state = _device_ref_features_multi(
        models, _to_device_u8(refs, refs.shape, device))
    h2, w2 = shape[0] // 2, shape[1] // 2
    last_lab = torch.zeros((refs.shape[0], h2, w2, 3), dtype=torch.float32,
                           device=device)
    plan = _plan_on(resize_plan, device)

    def step(rgb, last):
        return frame_step_multi(models, rgb, last, ref_state, temperature,
                                wls, plan)

    return _run_clip(step, frames, _frame_shape(shape, resize_plan),
                     last_lab, on_frame, mode, chunk)


def _video_frames_rgb(path: str):
    """uint8 RGB frames of a video file, in stream order (cv2 decode)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video file {path}")
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                return
            yield np.ascontiguousarray(bgr[..., ::-1])
    finally:
        cap.release()


def _frame_source(clip_path: str, image_size, device_resize: bool = False):
    """A frame folder or a video file -> (frames, resize_plan,
    first_frame_padded).

    frames() yields the clip's uint8 frames in order: CenterPadded to
    image_size on the host or, when resize_plan (a numpy (A_h, A_w)
    CenterPad plan) is set, raw, for the device to resize; then every
    frame must have the first frame's resolution. A clip already at
    image_size needs no plan. first_frame_padded() gives the CenterPadded
    first frame (the exemplar under frame_propagate).
    """
    video = is_video_file(clip_path)
    first_raw, names = None, None
    if video:
        frame_iter = _video_frames_rgb(clip_path)
        first_raw = next(frame_iter, None)
        if first_raw is None:
            raise ValueError(f"no frames decoded from {clip_path}")
    elif os.path.isdir(clip_path):
        names = list_clip_frames(clip_path)
        if not names:
            raise ValueError(f"no frames found in {clip_path}")
    else:
        raise ValueError(f"{clip_path}: not a directory of frames or a "
                         f"video file ({', '.join(VIDEO_EXTS)})")
    paths = [os.path.join(clip_path, n) for n in names or ()]

    resize_plan = src_hw = None
    if device_resize:
        if first_raw is None:
            first_raw = read_rgb(paths[0])
        src_hw = first_raw.shape[:2]
        if src_hw != tuple(image_size):  # else there is nothing to resize
            resize_plan = centerpad_plan(src_hw, image_size)

    def raw_frames():
        if video:
            yield first_raw
            yield from frame_iter
        else:
            yield from (read_rgb(p) for p in paths)

    def frames():
        if resize_plan is None and not video:
            yield from (load_frame_rgb(p, image_size) for p in paths)
            return
        for arr in raw_frames():
            if resize_plan is None:
                yield centerpad_np(arr, image_size)
            elif arr.shape[:2] != src_hw:
                raise ValueError(
                    f"device_resize needs one resolution per clip; got "
                    f"{arr.shape[:2]}, the first frame was {src_hw}")
            else:
                yield arr

    def first_frame_padded():
        if first_raw is not None:
            return centerpad_np(first_raw, image_size)
        return load_frame_rgb(paths[0], image_size)

    return frames, resize_plan, first_frame_padded


def folder_to_video(image_folder: str, output_path: str, fps: int = 24):
    """Assemble saved frames into a video (needs OpenCV)."""
    import cv2

    images = sorted(f for f in os.listdir(image_folder)
                    if f.endswith((".jpg", ".png")))
    if not images:
        return
    first = cv2.imread(os.path.join(image_folder, images[0]))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"DIVX"),
                             fps, (w, h))
    try:
        for name in images:
            writer.write(cv2.imread(os.path.join(image_folder, name)))
    finally:
        writer.release()


def _drive(frames, write_frame, run, prefetch: int = _PREFETCH):
    """run(decoded, on_frame) with frames() decoded ahead in a thread and
    write_frame(idx, arr) run behind it in another; a failure on either
    side raises here."""
    writer = _AsyncWriter(write_frame, maxsize=prefetch)
    try:
        with contextlib.closing(_decode_ahead(frames, prefetch)) as decoded:
            run(decoded, writer.put)
    except BaseException:
        writer.close(raise_err=False)
        raise
    writer.close()


def _save(path: str, arr) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path, quality=95)


def colorize_video(models: PipelineModels, clip_dir: str, ref_path: str,
                   output_dir: str, image_size=(432, 768),
                   temperature: float = 1e-10, wls: bool = True,
                   frame_propagate: bool = False, write_video: bool = True,
                   mode: str = "stream", chunk: int = 64,
                   device_resize: bool = False, out_ext: str = "jpg",
                   compute_dtype=None):
    """Colourise every frame of clip_dir, a folder of frames or a video
    file (.mp4, .avi, .mov, .mkv, .webm; cv2 decode), with the exemplar at
    ref_path (or, with frame_propagate, the first frame), at image_size
    (the network runs at half that). Writes 00000.jpg, ... (out_ext) and,
    with write_video, video.avi. Returns the written frame paths.

    mode "stream" runs one step per frame; mode "scan" hands the device
    `chunk` frames at a time and, on the card, replays one captured CUDA
    graph per frame (`pipeline/graph.py`); both give the same frames.
    device_resize runs the CenterPad on the device (two matrix products,
    ops/device_resize.py) and leaves the host only the decode; the clip
    must have one resolution; outputs may differ from the host path's by
    one uint8 step on truncation ties. compute_dtype=torch.bfloat16 (with
    bf16 models) runs the networks in bf16 (module docstring).
    """
    frames, plan, first_padded = _frame_source(clip_dir, image_size,
                                               device_resize)
    ref_rgb = (first_padded() if frame_propagate
               else load_frame_rgb(ref_path, image_size))
    os.makedirs(output_dir, exist_ok=True)
    written = []

    def write_frame(idx, arr):
        path = os.path.join(output_dir, f"{idx:05d}.{out_ext}")
        _save(path, arr)
        written.append(path)

    _drive(frames, write_frame, lambda decoded, put: colorize_frames(
        models, decoded, ref_rgb, put, temperature, wls, frame_propagate,
        mode, chunk, plan, compute_dtype))
    if write_video:
        folder_to_video(output_dir, os.path.join(output_dir, "video.avi"))
    return sorted(written)


def colorize_video_multi(models: PipelineModels, clip_dir: str, ref_paths,
                         output_dirs, image_size=(432, 768),
                         temperature: float = 1e-10, wls: bool = True,
                         write_video: bool = True, mode: str = "stream",
                         chunk: int = 64, device_resize: bool = False,
                         out_ext: str = "jpg"):
    """Colourise one clip against R exemplars in one pass: each frame is
    decoded once, and the exemplars are a batch on the device
    (`colorize_frames_multi`). An exemplar that fails to decode is dropped
    with a warning (the reference keeps going per exemplar); if none is
    left, ValueError. Returns, per kept exemplar, its written frame paths.
    Arguments as in `colorize_video`."""
    if len(ref_paths) != len(output_dirs) or not ref_paths:
        raise ValueError("one output directory per exemplar, at least one")
    frames, plan, _ = _frame_source(clip_dir, image_size, device_resize)
    decoded, kept = [], []
    for ref, out_dir in zip(ref_paths, output_dirs):
        try:
            decoded.append(load_frame_rgb(ref, image_size))
            kept.append(out_dir)
        except Exception as e:  # a corrupt or missing exemplar
            warnings.warn(f"skipping reference {ref}: {e}")
    if not decoded:
        raise ValueError("all reference images failed to decode")
    for d in kept:
        os.makedirs(d, exist_ok=True)
    written = [[] for _ in kept]

    def write_frame(idx, arr):  # arr: [R, H, W, 3]
        for out_dir, paths, img in zip(kept, written, arr):
            path = os.path.join(out_dir, f"{idx:05d}.{out_ext}")
            _save(path, img)
            paths.append(path)

    _drive(frames, write_frame, lambda frames_in, put: colorize_frames_multi(
        models, frames_in, np.stack(decoded), put, temperature, wls, mode,
        chunk, plan))
    if write_video:
        for d in kept:
            folder_to_video(d, os.path.join(d, "video.avi"))
    return [sorted(w) for w in written]
