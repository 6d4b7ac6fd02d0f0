"""Frozen copy of devc_tpu_torch/ops/layers.py, plain path only, for the
benchmark's reference (it imports nothing of the port).

Normalisation, activation and padding primitives (NCHW; mirrors
devc_tpu/ops/layers.py).

Semantics are those of the reference's PyTorch layers: InstanceNorm2d
(affine=False, biased variance, eps 1e-5), PReLU with one shared slope,
LeakyReLU, ReflectionPad2d and replicate padding. Convolutions are
`Conv2d`, an `nn.Conv2d` (same parameters and keys) that runs a batch
one sample at a time on the card under inference mode; with its
`float64` set (the inference cells' judge) it computes in float64 and
rounds the result to the input's dtype. `unfold_patches`
(the losses' F.unfold) takes devc_tpu's NHWC layout, as its callers do.

Every layer computes in its input's dtype: `Conv2d`, `PReLU` and `prelu`
cast their parameters to it, as devc_tpu's conv2d / prelu do, so bf16
weights under an fp32 activation compute in fp32 with bf16-rounded
weights (devc_tpu's batched-exemplar path under --bf16). Where the
weights are stored in the compute dtype the cast is skipped. In bf16 the
rounding points are devc_tpu's: a convolution's bias is added after its
output is rounded, and a Python scalar factor is rounded to bf16 first
(`scalar`), as JAX's weakly typed scalars are; PyTorch would otherwise
round once after the bias and keep the scalar in fp32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def scalar(value: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX applies it to `like`: rounded to like's dtype
    when that is narrower than fp32 (bf16), else unchanged (PyTorch's fp32
    and fp64 arithmetic already takes it at that precision)."""
    if like.dtype.itemsize >= 4:
        return value
    return _rounded(value, like.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (same parameters and keys) that casts its parameters to
    the input's dtype; the batch is convolved whole. With `float64` set,
    input, weight and bias are widened, convolved in float64 and the
    result rounded once to the input's dtype."""

    float64 = False

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.float64:
            y = self._conv_forward(x.double(), w.double(),
                                   b.double() if b is not None else None)
            return y.to(x.dtype)
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
            b = b.to(x.dtype) if b is not None else None
        return self._conv_forward(x, w, b)


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
    """PReLU with a single shared slope `a` (a 1-element tensor), in x's
    dtype."""
    return torch.clamp(x, min=0) + a.to(x.dtype) * torch.clamp(x, max=0)


class PReLU(nn.PReLU):
    """nn.PReLU (same parameter and key) whose slope takes the input's
    dtype."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


def leaky_relu(x, negative_slope: float = 0.2):
    return (torch.clamp(x, min=0)
            + scalar(negative_slope, x) * torch.clamp(x, max=0))


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
