"""Observability: scalar and image logging, with images rendered off the
training loop (mirrors devc_tpu/utils/logging.py).

The reference vendors tensorboardX and decouples image logging from the
train loop with a background thread fed by a queue
(utils/tb_image_recorder.py, train.py:442-444). Here scalars always go to
metrics.jsonl, and to TensorBoard too when its writer imports; images go
through a small thread that is handed host numpy copies, never tensors
the step still owns.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Callable

import numpy as np


class MovingAvg:
    """Fixed-window moving average (reference utils/util.py:34-52)."""

    def __init__(self, pool_size: int = 100):
        from collections import deque

        self._pool = deque(maxlen=pool_size)

    def update(self, val: float) -> float:
        self._pool.append(float(val))
        return sum(self._pool) / len(self._pool)


def dump_options(args, path: str = "opt.txt"):
    """Write sorted options to disk (reference utils/util.py:292-312)."""
    import sys
    import time as _time

    opts = vars(args) if not isinstance(args, dict) else args
    with open(path, "w") as f:
        f.write(
            os.path.basename(sys.argv[0])
            + " "
            + _time.strftime("%Y-%m-%d %H:%M:%S", _time.gmtime())
            + "\n"
        )
        f.write("------------ Options -------------\n")
        for k, v in sorted(opts.items()):
            f.write(f"{k}: {v}\n")
        f.write("-------------- End ----------------\n")


class MetricsLogger:
    """Scalars -> tensorboard (if available) + metrics.jsonl (always)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def log_scalars(self, step: int, scalars: dict):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_image(self, step: int, tag: str, image_hwc_uint8: np.ndarray):
        if self._tb is not None:
            self._tb.add_image(tag, image_hwc_uint8, int(step),
                               dataformats="HWC")

    def log_histogram(self, step: int, tag: str, values):
        """Histogram logging (reference utils/util_tensorboard.py
        histogram_logger)."""
        if self._tb is not None:
            self._tb.add_histogram(tag, np.asarray(values), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class AsyncImageLogger:
    """Background thread converting + writing image grids so the train loop
    never blocks on visualization (reference TBImageRecorder,
    utils/tb_image_recorder.py:6-28). Feed with put(); poison-pill close."""

    def __init__(self, logger: MetricsLogger,
                 render_fn: Callable[[dict], dict]):
        self._logger = logger
        self._render = render_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def put(self, step: int, tensors: dict):
        try:
            self._q.put_nowait((step, tensors))
        except queue.Full:
            pass  # drop rather than stall training

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tensors = item
            try:
                for tag, img in self._render(tensors).items():
                    self._logger.log_image(step, tag, img)
            except Exception:
                pass  # never take down training from the log path

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=10)


def render_lab_grids(tensors: dict) -> dict:
    """Default renderer: network-Lab NHWC arrays -> uint8 RGB grids (at
    most 8 images side by side), through the port's torch colorspace on
    the CPU."""
    import torch

    from devc_tpu_torch import colorspace as cs

    out = {}
    for tag, lab in tensors.items():
        lab = np.asarray(lab, dtype=np.float32)
        n = min(lab.shape[0], 8)
        rgb = cs.lab_centered_to_rgb(torch.from_numpy(lab[:n].copy())).numpy()
        out[tag] = np.concatenate(list((rgb * 255).astype(np.uint8)), axis=1)
    return out
