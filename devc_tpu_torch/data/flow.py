"""Middlebury .flo optical-flow I/O and flow helpers (mirrors
devc_tpu/data/flow.py; reference utils/flowlib.py:82-106).

The training videoloader consumes precomputed forward/backward .flo files
per frame pair (reference lib/videoloader.py:235-236). Files written by
either package read back bit for bit in the other.
"""

from __future__ import annotations

import numpy as np

_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> float32 [H, W, 2] (u, v)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _MAGIC:
            raise ValueError(f"{path}: not a .flo file (bad magic)")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    if data.size != 2 * w * h:
        # tolerate truncated files like the reference's np.resize does
        data = np.resize(data, 2 * w * h)
    return data.reshape(h, w, 2)


def _color_wheel() -> np.ndarray:
    """Middlebury flow color wheel (55 colors, RY/YG/GC/CB/BM/MR arcs)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    cols = []
    for n, (frm, to) in zip(
        (ry, yg, gc, cb, bm, mr),
        (
            ((255, 0, 0), (255, 255, 0)),
            ((255, 255, 0), (0, 255, 0)),
            ((0, 255, 0), (0, 255, 255)),
            ((0, 255, 255), (0, 0, 255)),
            ((0, 0, 255), (255, 0, 255)),
            ((255, 0, 255), (255, 0, 0)),
        ),
    ):
        t = np.linspace(0, 1, n, endpoint=False)[:, None]
        cols.append((1 - t) * np.array(frm) + t * np.array(to))
    return np.concatenate(cols, axis=0)  # [55, 3]


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """Flow [H, W, 2] -> uint8 RGB visualization (Middlebury convention;
    capability parity with reference utils/flowlib.py:240-278)."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    bad = ~(np.isfinite(u) & np.isfinite(v)) | (np.abs(u) > 1e7) | (np.abs(v) > 1e7)
    u = np.where(bad, 0, u)
    v = np.where(bad, 0, v)
    rad = np.sqrt(u * u + v * v)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-8)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u * u + v * v)

    wheel = _color_wheel()
    ncols = wheel.shape[0]
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.where(bad, 0, np.floor(255.0 * col)).astype(np.uint8)
    return img


def flow_epe(flow: np.ndarray, gt: np.ndarray) -> float:
    """Average endpoint error (reference utils/flowlib.py:186-238)."""
    d = flow[..., :2] - gt[..., :2]
    return float(np.sqrt((d * d).sum(-1)).mean())


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write float32 [H, W, 2] flow as .flo."""
    h, w, c = flow.shape
    assert c == 2, "flow must be HxWx2"
    with open(path, "wb") as f:
        np.array([_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)
