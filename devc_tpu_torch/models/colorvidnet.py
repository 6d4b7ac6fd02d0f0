"""ColorVidNet, the recurrent colourisation generator (mirrors
devc_tpu/models/colorvidnet.py, direct lowering).

A U-Net over the 7-channel input [L, warped ab, similarity, previous Lab]
that predicts ab. Downsampling is a learned per-channel 1x1 stride-2 conv
on the InstanceNorm'd activation (the `*norm_ss` convs), computed as a
strided slice times a per-channel weight; stages 5-6 use dilation-2 convs;
upsampling is nearest x2 + conv with additive skips from the encoder; the
output is tanh(.) * 128. Parameter names follow the reference
(`conv1_1.0`, `conv1_1.2`, `conv8_1.1`, ...), so a reference
`colornet_iter_*.pth` loads with strict=True.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from devc_tpu_torch.ops.layers import Conv2d, instance_norm, leaky_relu

# name -> (in, out, ksize, groups, bias, dilation)
_CONVS = {
    "conv1_1a": (7, 32, 3, 1, True, 1),  # reference conv1_1.0
    "conv1_1b": (32, 64, 3, 1, True, 1),  # reference conv1_1.2
    "conv1_2": (64, 64, 3, 1, True, 1),
    "conv1_2norm_ss": (64, 64, 1, 64, False, 1),
    "conv2_1": (64, 128, 3, 1, True, 1),
    "conv2_2": (128, 128, 3, 1, True, 1),
    "conv2_2norm_ss": (128, 128, 1, 128, False, 1),
    "conv3_1": (128, 256, 3, 1, True, 1),
    "conv3_2": (256, 256, 3, 1, True, 1),
    "conv3_3": (256, 256, 3, 1, True, 1),
    "conv3_3norm_ss": (256, 256, 1, 256, False, 1),
    "conv4_1": (256, 512, 3, 1, True, 1),
    "conv4_2": (512, 512, 3, 1, True, 1),
    "conv4_3": (512, 512, 3, 1, True, 1),
    "conv5_1": (512, 512, 3, 1, True, 2),
    "conv5_2": (512, 512, 3, 1, True, 2),
    "conv5_3": (512, 512, 3, 1, True, 2),
    "conv6_1": (512, 512, 3, 1, True, 2),
    "conv6_2": (512, 512, 3, 1, True, 2),
    "conv6_3": (512, 512, 3, 1, True, 2),
    "conv7_1": (512, 512, 3, 1, True, 1),
    "conv7_2": (512, 512, 3, 1, True, 1),
    "conv7_3": (512, 512, 3, 1, True, 1),
    "conv8_1": (512, 256, 3, 1, True, 1),  # after nearest x2
    "conv3_3_short": (256, 256, 3, 1, True, 1),
    "conv8_2": (256, 256, 3, 1, True, 1),
    "conv8_3": (256, 256, 3, 1, True, 1),
    "conv9_1": (256, 128, 3, 1, True, 1),  # after nearest x2
    "conv2_2_short": (128, 128, 3, 1, True, 1),
    "conv9_2": (128, 128, 3, 1, True, 1),
    "conv10_1": (128, 128, 3, 1, True, 1),  # after nearest x2
    "conv1_2_short": (64, 128, 3, 1, True, 1),
    "conv10_2": (128, 128, 3, 1, True, 1),
    "conv10_ab": (128, 2, 1, 1, True, 1),
}


def _make_conv(name, in_ch=None):
    ci, co, ks, g, bias, d = _CONVS[name]
    pad = d if ks == 3 else 0
    stride = 2 if name.endswith("norm_ss") else 1
    return Conv2d(in_ch or ci, co, ks, stride=stride, padding=pad,
                     dilation=d, groups=g, bias=bias)


class ColorVidNet(nn.Module):
    def __init__(self, in_ch: int = 7):
        super().__init__()
        for name in _CONVS:
            if name in ("conv1_1a", "conv1_1b"):
                continue
            conv = _make_conv(name)
            if name in ("conv8_1", "conv9_1", "conv10_1"):
                # reference: Sequential(Upsample, Conv2d) -> "<name>.1"
                conv = nn.Sequential(
                    nn.Upsample(scale_factor=2, mode="nearest"), conv)
            self.add_module(name, conv)
        # reference: Sequential(Conv2d, ReLU, Conv2d) -> conv1_1.0 / .2
        self.conv1_1 = nn.Sequential(
            _make_conv("conv1_1a", in_ch), nn.ReLU(), _make_conv("conv1_1b"))

    def _c(self, name, x, relu=True):
        y = getattr(self, name)(x)
        return F.relu(y) if relu else y

    def _down(self, name, x):
        """The depthwise 1x1 stride-2 *_ss conv, as a strided slice times a
        per-channel weight (the same values)."""
        w = getattr(self, name).weight  # [C, 1, 1, 1]
        return x[:, :, ::2, ::2] * w.reshape(1, -1, 1, 1)

    def forward(self, x):
        """x: [B, 7, H, W] -> ab [B, 2, H, W] in [-128, 128]."""
        c1 = F.relu(self.conv1_1(x))
        c1 = F.relu(self._c("conv1_2", c1, relu=False))
        n1 = instance_norm(c1)

        c2 = self._c("conv2_1", self._down("conv1_2norm_ss", n1))
        c2 = F.relu(self._c("conv2_2", c2, relu=False))
        n2 = instance_norm(c2)

        c3 = self._c("conv3_1", self._down("conv2_2norm_ss", n2))
        c3 = self._c("conv3_2", c3)
        c3 = self._c("conv3_3", c3)
        n3 = instance_norm(c3)

        c4 = self._c("conv4_1", self._down("conv3_3norm_ss", n3))
        c4 = self._c("conv4_2", c4)
        c4 = self._c("conv4_3", c4)
        h = instance_norm(c4)

        for stage in ("conv5", "conv6", "conv7"):
            h = self._c(f"{stage}_1", h)
            h = self._c(f"{stage}_2", h)
            h = self._c(f"{stage}_3", h)
            h = instance_norm(h)

        # decoder with additive skips
        h = F.relu(self._c("conv8_1", h, relu=False)
                   + self._c("conv3_3_short", n3, relu=False))
        h = self._c("conv8_2", h)
        h = instance_norm(self._c("conv8_3", h))

        h = F.relu(self._c("conv9_1", h, relu=False)
                   + self._c("conv2_2_short", n2, relu=False))
        h = instance_norm(self._c("conv9_2", h))

        h = F.relu(self._c("conv10_1", h, relu=False)
                   + self._c("conv1_2_short", n1, relu=False))
        h = leaky_relu(self._c("conv10_2", h, relu=False), 0.2)
        return torch.tanh(self._c("conv10_ab", h, relu=False)) * 128.0


def colorvidnet_apply(model: ColorVidNet, x):
    """x: NHWC [B, H, W, 7] -> ab NHWC [B, H, W, 2]."""
    return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

