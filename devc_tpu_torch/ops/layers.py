"""Normalisation, activation and padding primitives (NCHW; mirrors
devc_tpu/ops/layers.py).

Semantics are those of the reference's PyTorch layers: InstanceNorm2d
(affine=False, biased variance, eps 1e-5), PReLU with one shared slope,
LeakyReLU, ReflectionPad2d and replicate padding. Convolutions are
`Conv2d`, an `nn.Conv2d` (same parameters and keys) that runs a batch
one sample at a time on the card under inference mode. `unfold_patches`
(the losses' F.unfold) takes devc_tpu's NHWC layout, as its callers do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d that, on the card under inference mode, convolves a batch
    one sample at a time.

    With TF32 off, cuDNN 9's heuristics pick FFT algorithms for these fp32
    layers at batch > 1: a serving step of 4 frames at 432x768 took
    487-586 ms and 17.9 GB, one sample at a time 78 ms and 1.4 GB (batch
    1: 21 ms; NVIDIA H100 80GB HBM3, 700 W; `chip_conv_probe.py`). A
    sample then gets batch 1's algorithm and bits. Training (autograd, no
    inference mode) and the CPU convolve the batch whole.
    `Conv2d.per_sample = False` turns it off (the probe measures the whole
    batch that way).

    Training keeps the batch whole on purpose. cuDNN runs FFT algorithms
    there too (560 ms of a 2076 ms step at batch 16, 216x384), but they
    do not cost the accuracy they cost at inference: at batch 16,
    128x256, each generator network's gradients lie 1.8% (the critic's
    0.8%) from a float64 step, against 1.7-1.8% (0.4%) one sample at a
    time, while per-sample convolutions make the 216x384 step 2778 ms
    (`chip_conv_probe.py --train`, same card)."""

    per_sample = True

    def forward(self, x):
        if (self.per_sample and x.shape[0] > 1 and x.is_cuda
                and torch.is_inference_mode_enabled()):
            return torch.cat([super(Conv2d, self).forward(s)
                              for s in x.split(1)])
        return super().forward(x)


def instance_norm(x, eps: float = 1e-5):
    """Normalise each (n, c) plane of [N, C, H, W]; statistics in fp32
    (fp64 for fp64 input)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    """Parameter-free module form of `instance_norm` (for nn.Sequential)."""

    def forward(self, x):
        return instance_norm(x)


def prelu(x, a):
    """PReLU with a single shared slope `a` (a 1-element tensor)."""
    return torch.clamp(x, min=0) + a * torch.clamp(x, max=0)


def leaky_relu(x, negative_slope: float = 0.2):
    return torch.clamp(x, min=0) + negative_slope * torch.clamp(x, max=0)


def reflect_pad(x, pad: int):
    """ReflectionPad2d(pad) on the spatial dims. A dimension of size 1
    reflects onto itself (numpy's and devc_tpu's rule; torch's reflect mode
    refuses it): at net H = 24, WarpNet's relu5_1 is one row high."""
    if x.shape[-1] > pad and x.shape[-2] > pad:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    for size, pads in ((x.shape[-1], (pad, pad, 0, 0)),
                       (x.shape[-2], (0, 0, pad, pad))):
        if size > pad:
            x = F.pad(x, pads, mode="reflect")
        elif size == 1:
            x = F.pad(x, pads, mode="replicate")
        else:
            raise ValueError(f"reflect_pad: pad {pad} on a dimension of {size}")
    return x


class ReflectPad(nn.Module):
    """Parameter-free module form of `reflect_pad` (for nn.Sequential)."""

    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return reflect_pad(x, self.pad)


def replicate_pad(x, pad_h=(0, 0), pad_w=(0, 0)):
    """Edge padding on the spatial dims: pad_h = (top, bottom), pad_w =
    (left, right)."""
    return F.pad(x, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]), mode="replicate")


def unfold_patches(x, patch_size: int):
    """F.unfold of NHWC x with zero padding patch_size // 2: [N, H, W, C]
    -> [N, H, W, C * k * k], channel-major (index c * k * k + dy * k + dx),
    as devc_tpu/ops/layers.py::unfold_patches."""
    pad = patch_size // 2
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    views = [xp[:, dy:dy + h, dx:dx + w, :]
             for dy in range(patch_size) for dx in range(patch_size)]
    stacked = torch.stack(views, dim=4)  # [N, H, W, C, k * k]
    return stacked.reshape(n, h, w, c * patch_size * patch_size)
