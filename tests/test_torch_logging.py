"""The port's run logger and step timer (devc_tpu_torch/utils/{logging,
profiling}.py) against devc_tpu's, on the CPU.

render_lab_grids goes through each package's own colorspace (fp32 torch
against fp32 jax.numpy) and a truncating uint8 cast, so the grids may
differ by one step where a value sits on a boundary: the bound is +-1.
The JSONL logger and the EMA are plain Python: equal.
"""

import json

import numpy as np
import pytest

from devc_tpu.utils import logging as jlog
from devc_tpu.utils import profiling as jprof
from devc_tpu_torch.utils import logging as tlog
from devc_tpu_torch.utils import profiling as tprof


def _lab_batch(seed, n):
    rng = np.random.RandomState(seed)
    lab = np.empty((n, 12, 16, 3), np.float32)
    lab[..., 0] = rng.uniform(-50, 50, lab.shape[:3])
    lab[..., 1:] = rng.uniform(-90, 90, lab.shape[:3] + (2,))
    return lab


@pytest.mark.parametrize("n", [1, 3, 10])
def test_render_lab_grids_within_one_step_of_devc_tpu(n):
    tensors = {"current_gt": _lab_batch(n, n), "reference": _lab_batch(9, n)}
    got = tlog.render_lab_grids(tensors)
    want = jlog.render_lab_grids(tensors)
    assert sorted(got) == sorted(want)
    for tag in want:
        assert got[tag].dtype == np.uint8
        assert got[tag].shape == want[tag].shape == (12, 16 * min(n, 8), 3)
        assert np.abs(got[tag].astype(int) - want[tag].astype(int)).max() <= 1


def _records(logger_cls, log_dir):
    log = logger_cls(str(log_dir))
    for step, scalars in ((2, {"total_loss": np.float32(1.5), "l1": 0.25}),
                          (4, {"total_loss": 0.75, "l1": np.float64(1e-3)})):
        log.log_scalars(step, scalars)
    log.log_image(4, "grid", np.zeros((4, 6, 3), np.uint8))
    log.log_histogram(4, "h", np.arange(5.0))
    log.close()
    return [json.loads(line) for line in open(log_dir / "metrics.jsonl")]


def test_metrics_logger_writes_the_same_jsonl(tmp_path):
    got = _records(tlog.MetricsLogger, tmp_path / "port")
    want = _records(jlog.MetricsLogger, tmp_path / "jax")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k != "time"} == {
            k: v for k, v in w.items() if k != "time"}


def test_async_image_logger_renders_off_the_loop(tmp_path):
    logged = []

    class Recorder(tlog.MetricsLogger):
        def log_image(self, step, tag, img):
            logged.append((step, tag, img.shape))

    logger = Recorder(str(tmp_path))
    images = tlog.AsyncImageLogger(logger, tlog.render_lab_grids)
    images.put(3, {"current_gt": _lab_batch(0, 2)})
    images.close()
    logger.close()
    assert logged == [(3, "current_gt", (12, 32, 3))]


def test_async_image_logger_survives_a_failing_renderer(tmp_path):
    def broken(tensors):
        raise ValueError("bad image")

    logger = tlog.MetricsLogger(str(tmp_path))
    images = tlog.AsyncImageLogger(logger, broken)
    images.put(1, {})
    images.close()
    logger.close()


def test_moving_avg_and_dump_options_match_devc_tpu(tmp_path):
    ours, theirs = tlog.MovingAvg(3), jlog.MovingAvg(3)
    for v in (1.0, 2.0, 4.0, 8.0, 16.0):
        assert ours.update(v) == theirs.update(v)
    opts = {"b": 2, "a": [1, 2], "c": None}
    tlog.dump_options(opts, str(tmp_path / "port.txt"))
    jlog.dump_options(opts, str(tmp_path / "jax.txt"))
    got = open(tmp_path / "port.txt").read().splitlines()
    want = open(tmp_path / "jax.txt").read().splitlines()
    assert got[1:] == want[1:]  # the first line holds the wall clock


def test_step_timer_ema_equals_devc_tpus(monkeypatch):
    def run(timer):
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 4.0])
        monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
        dts = []
        for _ in range(3):
            timer.tic()
            dts.append(timer.toc())
        return dts, timer.avg

    ours, theirs = run(tprof.StepTimer(0.8)), run(jprof.StepTimer(0.8))
    assert ours == theirs
    assert ours[0] == [0.5, 0.25, 2.0]
    assert ours[1] == pytest.approx(0.8 * (0.8 * 0.5 + 0.2 * 0.25) + 0.2 * 2)


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with tprof.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").exists()
    assert tprof.device_memory_stats() == {}  # no card here
