"""The port's spans and the clip scheduler's counters on the CPU
(devc_tpu_torch/utils/profiling.py::span): no profiler call while none
records; under `profiling.trace` the frame loop's, the frame step's, the
scheduler's and the training step's spans, nested as the code nests
them; spans closed by an exception; `ClipBatchScheduler.stats` exact."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from devc_tpu_torch.pipeline import scheduler as tsched
from devc_tpu_torch.pipeline import video as tvideo
from devc_tpu_torch.pipeline.frame import PipelineModels
from devc_tpu_torch.pipeline.scheduler import ClipBatchScheduler
from devc_tpu_torch.utils import profiling
from devc_tpu_torch.utils.convert import state_dicts_from_numpy
from devc_tpu_torch.utils.init import host_pipeline_params
from test_torch_train import synthetic_batch_u8

H, W = 48, 96
FRAME_SPANS = ("frame::vgg", "frame::embed", "frame::corr",
               "frame::colorvidnet", "frame::post")
TRAIN_SPANS = ("train::forward", "train::critic", "train::g_loss",
               "train::g_grad", "train::update")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), "cpu")


def _textured(rng):
    coarse = rng.rand(H // 8 + 1, W // 8 + 1, 3)
    field = np.kron(coarse, np.ones((8, 8, 1)))[:H, :W]
    return np.clip(field * 200 + 20 + rng.randn(H, W, 3) * 12, 0,
                   255).astype(np.uint8)


def _spans(log_dir):
    """{name: [(start, end, tid)]} of the trace's host ranges."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            out.setdefault(ev["name"], []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev["tid"]))
    return out


def _inside(inner, outer) -> bool:
    """Each interval of `inner` lies in one of `outer` on its thread."""
    return all(any(os_ <= s and e <= oe and ot == t for os_, oe, ot in outer)
               for s, e, t in inner)


def test_span_without_a_profiler_calls_no_record_function(monkeypatch,
                                                          tmp_path):
    """No profiler: span is the one shared no-op and never builds a
    record_function; a span entered before the profiler starts records
    nothing; under the profiler it is a record_function."""
    made = []
    real = torch.profiler.record_function

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    spans = {id(profiling.span(f"clip::{i}")) for i in range(100)}
    with profiling.span("clip::step"):
        torch.ones(2).add_(1)
    assert made == [] and len(spans) == 1
    with profiling.span("clip::frame"), profiling.trace(str(tmp_path)):
        with profiling.span("clip::upload"):
            pass
    assert made == ["clip::upload"]
    got = _spans(str(tmp_path))
    assert "clip::upload" in got and "clip::frame" not in got


def test_stream_frames_write_the_frame_spans_nested(models, tmp_path):
    """colorize_frames in stream mode under profiling.trace: each frame a
    clip::frame holding clip::upload, clip::step and clip::download, the
    five frame::* stages inside clip::step."""
    rng = np.random.RandomState(0)
    frames = [_textured(rng) for _ in range(2)]
    with profiling.trace(str(tmp_path)):
        n = tvideo.colorize_frames(models, frames, _textured(rng),
                                   lambda i, o: None)
    assert n == 2
    got = _spans(str(tmp_path))
    assert len(got["clip::frame"]) == 2
    for part in ("clip::upload", "clip::step", "clip::download"):
        assert len(got[part]) == 2 and _inside(got[part], got["clip::frame"])
    for stage in FRAME_SPANS:
        assert len(got[stage]) == 2, stage
        assert _inside(got[stage], got["clip::step"]), stage


def test_a_training_step_writes_its_five_parts(tmp_path):
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train.state import make_optimizers
    from devc_tpu_torch.utils.convert import (
        frozen_vgg,
        train_state_from_numpy,
    )
    from devc_tpu_torch.utils.init import host_discriminator_init

    p = host_pipeline_params(0)
    params_d, sn = host_discriminator_init(3)
    tx_g, tx_d = make_optimizers()
    state = train_state_from_numpy(
        {"warpnet": p["warpnet"], "colorvid": p["colorvid"]}, params_d, sn,
        tx_g, tx_d, device="cpu")
    step = loop.make_train_step(tx_g, tx_d, frozen_vgg(p["vgg"], "cpu"),
                                loop.TrainConfig(), device_preprocess=True)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch_u8(2, 2, 64, 64).items()}
    with profiling.trace(str(tmp_path)):
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    got = _spans(str(tmp_path))
    parts = [got[name] for name in TRAIN_SPANS]
    assert all(len(p) == 1 for p in parts), {n: len(got.get(n, ()))
                                             for n in TRAIN_SPANS}
    # one after another on the calling thread
    for (a,), (b,) in zip(parts, parts[1:]):
        assert a[1] <= b[0] and a[2] == b[2]


def _jobs(tmp_path, lengths, rng):
    jobs = []
    for j, n in enumerate(lengths):
        d = tmp_path / f"clip{j}"
        d.mkdir()
        for i in range(n):
            Image.fromarray(_textured(rng)).save(d / f"{i:03d}.png")
        ref = tmp_path / f"ref{j}.png"
        Image.fromarray(_textured(rng)).save(ref)
        jobs.append((str(d), str(ref), str(tmp_path / f"out{j}")))
    return jobs


def test_scheduler_stats_are_exact(models, tmp_path):
    """3 jobs of 2, 1 and 3 frames through 2 slots: 4 batched steps (job
    2 takes row 1 after job 1's one frame; row 0 idles from step 3), one
    refill; the waits and the writer's encoding timed. Under the profiler
    the main loop's spans nest in sched::step."""
    rng = np.random.RandomState(1)
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=2,
                               out_ext="png")
    for job in _jobs(tmp_path, (2, 1, 3), rng):
        sched.submit(*job)
    with profiling.trace(str(tmp_path / "trace")):
        results = sched.run()
    assert [r["frames"] for r in results] == [2, 1, 3]
    stats = sched.stats
    assert set(stats) == {"steps", "refills", "decode_wait_s", "refill_s",
                          "write_wait_s", "encode_s"}
    assert stats["steps"] == 4 and stats["refills"] == 1
    assert stats["encode_s"] > 0 and stats["refill_s"] > 0
    assert min(stats[k] for k in ("decode_wait_s", "write_wait_s")) >= 0
    got = _spans(str(tmp_path / "trace"))
    assert len(got["sched::step"]) == 5  # the last finds every clip ended
    assert len(got["sched::device_step"]) == 4
    # a clip's end: job 1 -> job 2, then jobs 0 and 2 with none left
    assert len(got["sched::refill"]) == 3
    assert len(got["sched::write_wait"]) == 6
    for part in ("sched::decode_wait", "sched::refill", "sched::upload",
                 "sched::device_step", "sched::download",
                 "sched::write_wait"):
        assert _inside(got[part], got["sched::step"]), part
    assert _inside(got["frame::corr"], got["sched::device_step"])


def test_a_step_that_raises_closes_its_spans(models, tmp_path, monkeypatch):
    """The scheduler's batched step raises on its second call (as the
    benchmark stops a run): run() raises, every span it opened is closed
    before the next span starts, and the trace exports."""
    rng = np.random.RandomState(2)
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=2,
                               out_ext="png")
    for job in _jobs(tmp_path, (3, 3), rng):
        sched.submit(*job)
    orig, calls = tsched.batched_frame_step, []

    def step(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("stop")
        return orig(*args, **kwargs)

    monkeypatch.setattr(tsched, "batched_frame_step", step)
    with profiling.trace(str(tmp_path / "trace")):
        with pytest.raises(KeyboardInterrupt):
            sched.run()
        with profiling.span("after::raise"):
            pass
    assert sched.stats["steps"] == 1
    got = _spans(str(tmp_path / "trace"))
    (after,) = got["after::raise"]
    assert len(got["sched::step"]) == 2
    assert len(got["sched::device_step"]) == 2
    for name, spans in got.items():
        if name.startswith("sched::"):
            assert all(e <= after[0] for _, e, _ in spans), name
