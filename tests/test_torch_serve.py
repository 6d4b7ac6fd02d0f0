"""The port's serving path on the CPU: `ClipBatchScheduler` (slot
rotation, exemplar rows, carry resets, failure isolation, mixed video and
folder jobs under device_resize), `python -m devc_tpu_torch.cli.serve`
and the colorize CLI's batched exemplars, scan mode and video input.

The scheduler is held bit for bit against its own batched step, replayed
by hand with each job pinned to the row it ran in: every stage of the
step is per sample, so a row's bits do not depend on what the other rows
hold. Against devc_tpu's scheduler only frame 0 is compared, within +-1
(both start from a zero carry; later frames are free-running, where
random weights amplify any difference ~20x a frame).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from devc_tpu.utils.init import host_pipeline_params
from devc_tpu_torch.data.transforms import (
    list_clip_frames,
    load_frame_rgb,
    read_rgb,
)
from devc_tpu_torch.ops.device_resize import centerpad_plan_padded
from devc_tpu_torch.parallel.inference import batched_frame_step
from devc_tpu_torch.pipeline import video as tvideo
from devc_tpu_torch.pipeline.frame import PipelineModels
from devc_tpu_torch.pipeline.scheduler import ClipBatchScheduler
from devc_tpu_torch.utils.convert import state_dicts_from_numpy

H, W = 48, 96  # network at 24 x 48: WarpNet's replicate-pad path
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def textured(rng, hw=(H, W)):
    h, w = hw
    coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
    field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    img = field * 200 + 20 + rng.randn(h, w, 3) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


def _clip(tmp_path, name, n, rng, hw=(H, W)):
    d = tmp_path / name
    d.mkdir()
    for i in range(n):
        Image.fromarray(textured(rng, hw)).save(d / f"{i:03d}.png")
    return str(d)


def _ref(tmp_path, name, rng):
    p = tmp_path / name
    Image.fromarray(textured(rng)).save(p)
    return str(p)


def _write_avi(path, n, rng, hw):
    import cv2

    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"DIVX"), 24,
                         (hw[1], hw[0]))
    assert wr.isOpened()
    for _ in range(n):
        wr.write(textured(rng, hw)[..., ::-1])
    wr.release()
    return str(path)


@pytest.fixture(scope="module")
def models():
    return PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), "cpu")


def _replay(models, b, row, frames, ref_path, plans=None):
    """The scheduler's step replayed with one job pinned to `row` of a
    b-row batch, the other rows on zero frames: its uint8 outputs."""
    ref = load_frame_rgb(ref_path, (H, W))
    _, state = tvideo._device_ref_features(models, torch.from_numpy(
        np.array(ref)))
    stack = {k: v.repeat(b, *([1] * (v.dim() - 1))) for k, v in state.items()}
    last = torch.zeros((b, H // 2, W // 2, 3))
    outs = []
    for f in frames:
        batch = np.zeros((b, *f.shape), np.uint8)
        batch[row] = f
        out, last = batched_frame_step(models, torch.from_numpy(batch), last,
                                       stack, resize_plans=plans)
        outs.append(out[row].numpy())
    return outs


def test_scheduler_matches_its_batched_step(models, tmp_path):
    """3 jobs of 2, 1 and 3 frames through 2 slots: job 0 in row 0, job 1
    in row 1 and, when it ends, job 2 refilled into row 1 with its own
    exemplar and a zeroed carry; row 0 idles (re-zeroed) once job 0
    ends."""
    rng = np.random.RandomState(0)
    clips = [_clip(tmp_path, f"clip{i}", n, rng)
             for i, n in enumerate((2, 1, 3))]
    refs = [_ref(tmp_path, f"ref{i}.png", rng) for i in range(3)]
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=2,
                               out_ext="png")
    for i in range(3):
        sched.submit(clips[i], refs[i], str(tmp_path / f"out{i}"))
    results = sched.run()
    assert [r["frames"] for r in results] == [2, 1, 3]
    for i, row in enumerate((0, 1, 1)):
        frames = [load_frame_rgb(os.path.join(clips[i], n), (H, W))
                  for n in list_clip_frames(clips[i])]
        want = _replay(models, 2, row, frames, refs[i])
        assert len(results[i]["outputs"]) == len(want)
        for fi, (path, w) in enumerate(zip(results[i]["outputs"], want)):
            assert np.array_equal(np.asarray(Image.open(path)), w), (i, fi)


def test_scheduler_frame_0_matches_devc_tpu(models, tmp_path):
    """The same jobs through devc_tpu's scheduler (plain paths, PNG out):
    every job's frame 0 within +-1, the frame counts equal."""
    from devc_tpu.pipeline.scheduler import ClipBatchScheduler as JSched

    rng = np.random.RandomState(5)
    clips = [_clip(tmp_path, f"clip{i}", n, rng)
             for i, n in enumerate((2, 3, 2))]
    refs = [_ref(tmp_path, f"ref{i}.png", rng) for i in range(3)]
    runs = {}
    for name, sched in (
            ("jax", JSched(jax.tree.map(jnp.asarray, host_pipeline_params(0)),
                           image_size=(H, W), slots=2, use_pallas=False,
                           out_ext="png")),
            ("torch", ClipBatchScheduler(models, image_size=(H, W), slots=2,
                                         out_ext="png"))):
        for i in range(3):
            sched.submit(clips[i], refs[i], str(tmp_path / f"{name}{i}"))
        runs[name] = sched.run()
    assert [r["frames"] for r in runs["torch"]] == \
        [r["frames"] for r in runs["jax"]] == [2, 3, 2]
    for got, want in zip(runs["torch"], runs["jax"]):
        a = np.asarray(Image.open(got["outputs"][0])).astype(int)
        b = np.asarray(Image.open(want["outputs"][0])).astype(int)
        assert np.abs(a - b).max() <= 1


def test_scheduler_skips_a_bad_job(models, tmp_path):
    """An empty clip and a corrupt exemplar fail their jobs alone."""
    rng = np.random.RandomState(1)
    good = _clip(tmp_path, "good", 2, rng)
    empty = tmp_path / "empty"
    empty.mkdir()
    ref = _ref(tmp_path, "ref.png", rng)
    bad_ref = tmp_path / "bad.png"
    bad_ref.write_bytes(b"not an image")
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=2, wls=False)
    sched.submit(str(empty), ref, str(tmp_path / "out_empty"))
    sched.submit(good, str(bad_ref), str(tmp_path / "out_bad_ref"))
    sched.submit(good, ref, str(tmp_path / "out_good"))
    results = sched.run()
    assert "error" in results[0] and "error" in results[1]
    assert results[2]["frames"] == 2


def test_scheduler_leaves_no_reader_of_a_dropped_job(models, tmp_path):
    """A job dropped after its frames' reader started (its exemplar is
    corrupt) must not leave the reader blocked on a full queue: a blocked
    reader held the scheduler and its models for the process's life."""
    import threading

    rng = np.random.RandomState(5)
    clip = _clip(tmp_path, "long", 8, rng)  # more frames than the prefetch
    ref = _ref(tmp_path, "ref.png", rng)
    bad_ref = tmp_path / "bad.png"
    bad_ref.write_bytes(b"not an image")
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=1, wls=False,
                               prefetch=2)
    sched.submit(clip, str(bad_ref), str(tmp_path / "out_bad"))
    sched.submit(clip, ref, str(tmp_path / "out_good"))
    before = set(threading.enumerate())
    results = sched.run()
    assert "error" in results[0] and results[1]["frames"] == 8
    started = set(threading.enumerate()) - before
    for t in started:
        t.join(timeout=5)
    assert not [t for t in started if t.is_alive()]


def test_scheduler_isolates_a_writer_failure(models, tmp_path, monkeypatch):
    """A failed write (a full disk under one job's output) fails that job;
    the other job in the batch completes."""
    rng = np.random.RandomState(4)
    a = _clip(tmp_path, "wa", 4, rng)
    b = _clip(tmp_path, "wb", 4, rng)
    ref = _ref(tmp_path, "wref.png", rng)
    real_save = Image.Image.save

    def flaky_save(self, fp, *args, **kw):
        if "out_fail" in str(fp):
            raise OSError("disk full")
        return real_save(self, fp, *args, **kw)

    monkeypatch.setattr(Image.Image, "save", flaky_save)
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=2, wls=False)
    sched.submit(a, ref, str(tmp_path / "out_fail"))
    sched.submit(b, ref, str(tmp_path / "out_ok"))
    results = sched.run()
    assert "error" in results[0] and "disk full" in results[0]["error"]
    assert results[1]["frames"] == 4 and len(results[1]["outputs"]) == 4


def test_scheduler_fails_a_job_whose_decode_fails_mid_clip(models, tmp_path):
    rng = np.random.RandomState(6)
    broken = _clip(tmp_path, "broken", 3, rng)
    with open(os.path.join(broken, "001.png"), "wb") as f:
        f.write(b"truncated")
    good = _clip(tmp_path, "good", 3, rng)
    ref = _ref(tmp_path, "ref.png", rng)
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=1, wls=False)
    sched.submit(broken, ref, str(tmp_path / "o0"))
    sched.submit(good, ref, str(tmp_path / "o1"))
    results = sched.run()
    assert "error" in results[0] and len(results[0]["outputs"]) == 1
    assert results[1]["frames"] == 3


def test_scheduler_mixed_video_and_folder_under_device_resize(models,
                                                              tmp_path):
    """A folder at twice the target size and a video file at the target
    size in one batch, the CenterPad on the device through per-slot
    padded plans: bit for bit the batched step replayed with the same
    plans and rows."""
    pytest.importorskip("cv2")
    rng = np.random.RandomState(2)
    folder = _clip(tmp_path, "fold", 3, rng, hw=(2 * H, 2 * W))
    vid = _write_avi(tmp_path / "clip.avi", 3, rng, (H, W))
    refs = [_ref(tmp_path, f"mref{i}.png", rng) for i in range(2)]
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=2,
                               out_ext="png", device_resize=True)
    sched.submit(folder, refs[0], str(tmp_path / "dev0"))
    sched.submit(vid, refs[1], str(tmp_path / "dev1"))
    results = sched.run()
    assert [r["frames"] for r in results] == [3, 3]

    mh, mw = 2 * H, 2 * W
    plans = [centerpad_plan_padded(s, (H, W), (mh, mw))
             for s in ((2 * H, 2 * W), (H, W))]
    plans = tuple(torch.from_numpy(np.stack([p[k] for p in plans]))
                  for k in (0, 1))
    raws = [[read_rgb(os.path.join(folder, n))
             for n in list_clip_frames(folder)],
            list(tvideo._video_frames_rgb(vid))]
    for row, (r, frames) in enumerate(zip(results, raws)):
        padded = []
        for f in frames:
            p = np.zeros((mh, mw, 3), np.uint8)
            p[:f.shape[0], :f.shape[1]] = f
            padded.append(p)
        want = _replay(models, 2, row, padded, refs[row], plans)
        for path, w in zip(r["outputs"], want):
            assert np.array_equal(np.asarray(Image.open(path)), w), row


def _serve(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "2"  # as _two_threads
    return subprocess.Popen(
        [sys.executable, "-m", "devc_tpu_torch.cli.serve", *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)


def test_serve_on_cpu(tmp_path):
    """Ready line, ping, one job (scan mode), one batch of two jobs, bad
    JSON, shutdown: devc_tpu's protocol and response keys
    (tests/test_serve.py)."""
    rng = np.random.RandomState(0)
    clip = _clip(tmp_path, "clip", 2, rng)
    ref = _ref(tmp_path, "ref.png", rng)
    out_dir = tmp_path / "out"
    proc = _serve(["--random_init", "--device", "cpu", "--image_size",
                   str(H), str(W)])

    def ask(req):
        proc.stdin.write((req if isinstance(req, str) else json.dumps(req))
                         + "\n")
        proc.stdin.flush()
        return json.loads(proc.stdout.readline())

    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] is True and "warmup_seconds" in ready
        assert ask({"cmd": "ping"}) == {"ok": True, "pong": True}
        resp = ask({"clip_path": clip, "ref_path": ref,
                    "output_path": str(out_dir), "mode": "scan", "chunk": 1,
                    "split_embed": None})
        assert resp["ok"] is True, resp
        assert resp["frames"] == 2
        assert set(resp) == {"ok", "frames", "seconds", "fps", "outputs"}
        assert (out_dir / "00000.jpg").exists()
        dirs = [str(tmp_path / "b0"), str(tmp_path / "b1")]
        resp = ask({"cmd": "batch", "slots": 2, "jobs": [
            {"clip_path": clip, "ref_path": ref, "output_path": d}
            for d in dirs]})
        assert resp["ok"] is True, resp
        assert [r["frames"] for r in resp["results"]] == [2, 2]
        # two slots, two jobs of two frames: two steps, no slot refilled
        stats = resp["stats"]
        assert (stats["steps"], stats["refills"]) == (2, 0), stats
        assert set(stats) == {"steps", "refills", "decode_wait_s", "refill_s",
                              "write_wait_s", "encode_s"}
        assert stats["encode_s"] > 0
        assert min(stats[k] for k in ("decode_wait_s", "refill_s",
                                      "write_wait_s")) >= 0
        assert os.path.exists(os.path.join(dirs[1], "00001.jpg"))
        bad = ask({"clip_path": str(tmp_path / "nope"), "ref_path": ref,
                   "output_path": str(out_dir)})
        assert bad["ok"] is False and "error" in bad
        assert ask("not json")["ok"] is False
        assert ask({"cmd": "shutdown"})["bye"] is True
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_refuses_cuda_without_a_gpu():
    """--device defaults to cuda: without a GPU the server exits with an
    error before its ready line, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    proc = _serve(["--random_init", "--image_size", str(H), str(W)])
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "ready" not in out


def test_cli_batched_exemplars_scan_and_video(tmp_path):
    """The colorize CLI: a directory of exemplars in one batched pass in
    scan mode and with --serial_refs, each writing every frame per
    exemplar; a video file as --clip_path with --device_resize."""
    from devc_tpu_torch.cli import colorize as tcli

    rng = np.random.RandomState(7)
    clip = _clip(tmp_path, "clip", 3, rng)
    ref_dir = tmp_path / "refs"
    ref_dir.mkdir()
    for name in ("01", "02"):
        Image.fromarray(textured(rng)).save(ref_dir / f"{name}.png")
    base = ["--ref_path", str(ref_dir), "--image_size", str(H), str(W),
            "--random_init", "--device", "cpu", "--no_video"]
    tcli.main(["--clip_path", clip, "--output_path", str(tmp_path / "multi"),
               "--mode", "scan", "--chunk", "2", *base])
    tcli.main(["--clip_path", clip, "--output_path", str(tmp_path / "serial"),
               "--serial_refs", *base])
    for name in ("clip_01", "clip_02"):
        got = sorted(os.listdir(tmp_path / "multi" / name))
        assert got == sorted(os.listdir(tmp_path / "serial" / name)) == \
            ["00000.jpg", "00001.jpg", "00002.jpg"]
    pytest.importorskip("cv2")
    vid = _write_avi(tmp_path / "v.avi", 2, rng, (H, W))
    tcli.main(["--clip_path", vid, "--output_path", str(tmp_path / "vid"),
               "--ref_path", str(ref_dir / "01.png"), "--image_size", str(H),
               str(W), "--random_init", "--device", "cpu", "--no_video",
               "--device_resize"])
    assert sorted(os.listdir(tmp_path / "vid" / "v_01")) == [
        "00000.jpg", "00001.jpg"]
