"""Normalisation, activation and padding primitives (NCHW; mirrors
devc_tpu/ops/layers.py).

Semantics are those of the reference's PyTorch layers: InstanceNorm2d
(affine=False, biased variance, eps 1e-5), PReLU with one shared slope,
LeakyReLU, ReflectionPad2d and replicate padding. Convolutions are
`Conv2d`, an `nn.Conv2d` (same parameters and keys) that, on the card
under inference mode, runs fp32 on the TF32 tensor cores at fp32
accuracy (`ops/conv_split.py`) and a batch one sample at a time. `unfold_patches`
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

from devc_tpu_torch.ops import conv_split


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
    """nn.Conv2d (same parameters and keys) that, on the card under
    inference mode, runs fp32 convolutions on the TF32 tensor cores at fp32
    accuracy and convolves a batch one sample at a time.

    The split path (`ops/conv_split.py`). cuDNN runs these fp32 layers on
    the CUDA cores (`*_ffma_*` kernels, ~20 TFLOP/s at 432x768). A call
    that `conv_split.engages` takes instead runs `csrc/conv_split.cu`: the
    input and the weight split into TF32 halves, x = x_hi + x_lo, w = w_hi
    + w_lo, and the three products fp32 keeps summed on the tensor cores
    by K1's score rule (a fresh accumulator every 32 input channels, fp32
    adds), nearer a float64 convolution than cuDNN's fp32 one. The bias
    is added in the kernel, and a batch is one call, each sample alike.
    The rule uses only what the call observes: an fp32 input on the card,
    inference mode, groups 1, a square kernel with the same stride,
    dilation and zero padding on both axes, cuDNN's TF32 flag off (the
    caller asked for fp32; with TF32 allowed the plain call runs TF32
    already), and the shape rule (`conv_split.shape_rule`: C_in a multiple
    of 32, C_out at least 16). No TF32 flag is touched. Training
    (autograd, no inference mode), the CPU, bf16 and a global TF32
    setting take the plain call. A split call that fails raises.
    `Conv2d.split_calls` and `Conv2d.plain_calls` count the calls that
    took each path (a call on a batch counts once);
    `conv_split.split_conv2d.launches` counts the kernels the split calls
    launch (one, or two where the depth is split).

    The split weight is made on the first split call (a driver's warm-up,
    `CapturedStep`'s side-stream warm-up) and kept on the module, keyed on
    the weight's storage and version, so `load_state_dict` or an in-place
    update makes it again; it is never made inside a graph capture (that
    raises). It takes 2x the weight's memory.

    One sample at a time. With TF32 off, cuDNN 9's heuristics pick FFT
    algorithms for these fp32 layers at batch > 1: a serving step of 4
    frames at 432x768 took 487-586 ms and 17.9 GB, one sample at a time
    78 ms and 1.4 GB (batch 1: 21 ms; NVIDIA H100 80GB HBM3, 700 W;
    `chip_conv_probe.py`). A sample then gets batch 1's algorithm and
    bits (on the split path each sample is computed alike in one launch).
    Training and the CPU convolve the batch whole. `Conv2d.per_sample =
    False` turns it off (the probe measures the whole batch that way).

    Training keeps the batch whole on purpose. cuDNN runs FFT algorithms
    there too (560 ms of a 2076 ms step at batch 16, 216x384), but they
    do not cost the accuracy they cost at inference: at batch 16,
    128x256, each generator network's gradients lie 1.8% (the critic's
    0.8%) from a float64 step, against 1.7-1.8% (0.4%) one sample at a
    time, while per-sample convolutions make the 216x384 step 2778 ms
    (`chip_conv_probe.py --train`, same card)."""

    per_sample = True
    split_calls = 0
    plain_calls = 0

    def _engages(self, x) -> bool:
        k, stride, pad, dil = (self.kernel_size, self.stride, self.padding,
                               self.dilation)
        return (self.padding_mode == "zeros" and not isinstance(pad, str)
                and k[0] == k[1] and stride[0] == stride[1]
                and pad[0] == pad[1] and dil[0] == dil[1]
                and conv_split.engages(
                    x.dtype, x.is_cuda, torch.is_inference_mode_enabled(),
                    self.groups, torch.backends.cudnn.allow_tf32,
                    self.in_channels, self.out_channels, k, x.shape[-2:]))

    def _split_weight(self, w):
        """`conv_split.weight_split(w)`, made once per weight."""
        p = self.weight
        key = (p.data_ptr(), None if p.is_inference() else p._version,
               w.dtype, w.device)
        cached = getattr(self, "_w_split", None)
        if cached is None or cached[0] != key:
            if w.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "Conv2d: the split weight is made outside a graph "
                    "capture; run the step once before capturing it")
            cached = (key, conv_split.weight_split(w))
            self._w_split = cached
        return cached[1]

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
            b = b.to(x.dtype) if b is not None else None
        per_sample = (self.per_sample and x.shape[0] > 1 and x.is_cuda
                      and torch.is_inference_mode_enabled())
        if self._engages(x):
            Conv2d.split_calls += 1
            return conv_split.split_conv2d(
                x, self._split_weight(w), b, self.stride[0], self.padding[0],
                self.dilation[0], self.kernel_size[0], w)
        Conv2d.plain_calls += 1
        # bf16: the bias goes on after the convolution's output is rounded
        # (devc_tpu's `conv(x, w) + b`); fused, PyTorch rounds once
        late_bias = b if b is not None and x.dtype.itemsize < 4 else None
        if late_bias is not None:
            b = None
        if per_sample:
            y = torch.cat([self._conv_forward(s, w, b) for s in x.split(1)])
        else:
            y = self._conv_forward(x, w, b)
        if late_bias is not None:
            y = y + late_bias.reshape(1, -1, 1, 1)
        return y


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
