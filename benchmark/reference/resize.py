"""Frozen copy of devc_tpu_torch/ops/resize.py, plain path only, for the
benchmark's reference (it imports nothing of the port).

Resize and pooling primitives (NCHW; mirrors devc_tpu/ops/resize.py).

These run inside the NCHW networks, so they take PyTorch's layout; callers
holding NHWC images permute around them. `resize_bilinear` is
`F.interpolate(mode="bilinear", align_corners=False, antialias=False)`,
whose half-pixel map src = (dst + 0.5) * in / out - 0.5, clamped to the
image, is the one devc_tpu builds as interpolation matrices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x, out_hw):
    """[N, C, H, W] bilinear resize with torch's (half-pixel) semantics."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)


def upsample_nearest(x, scale: int):
    """[N, C, H, W] integer nearest upsample (pixel replication)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def avg_pool(x, window: int):
    """[N, C, H, W] average pooling, stride = window, no padding. Below
    fp32 (bf16) the window is summed in x's dtype, one rounded add at a
    time in row-major order, then divided: devc_tpu's reduce_window in
    bf16, bit for bit."""
    if x.dtype.itemsize >= 4:
        return F.avg_pool2d(x, window)
    h, w = x.shape[-2] // window * window, x.shape[-1] // window * window
    acc = torch.zeros_like(x[..., :h:window, :w:window])
    for dy in range(window):
        for dx in range(window):
            acc = acc + x[..., dy:h:window, dx:w:window]
    return acc / (window * window)


def max_pool(x, window: int):
    """[N, C, H, W] max pooling, stride = window, no padding, floor mode."""
    return F.max_pool2d(x, window)
