"""VGG19 fine-tuned on grayscale: a feature extractor in torchvision's layout
(mirrors devc_tpu/models/vgg19_gray.py; reference models/vgg19_gray.py).

The module is torchvision's `vgg19().features` as an integer-named
Sequential (convs at indices 0, 2, 5, ..., 34, each followed by a ReLU,
max pools at 4, 9, 18, 27, 36), so the reference's `vgg19_gray.pth`
loads with strict=True (`utils/convert.py::vgg19_gray_from_state_dict`).
Unlike the main VGG19 extractor, its pools use ceil mode (reference
vgg19_gray.py:86). `vgg19_gray_extract` taps relu3_1 / relu4_1 / relu5_1
(plus relu2_1 with include_r21, the reference's "_new" variant) of [LLL]
grayscale replicated to RGB in [0, 255].

It is off the live path, as in devc_tpu: WarpNet consumes the main
VGG19's features (reference models/FrameColor.py:6-10).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from devc_tpu_torch.ops.layers import Conv2d

# torchvision vgg19.features indices of the sixteen convs, in order
TORCHVISION_CONV_INDICES = (
    0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34,
)
_CHANNELS = [
    (3, 64), (64, 64),
    (64, 128), (128, 128),
    (128, 256), (256, 256), (256, 256), (256, 256),
    (256, 512), (512, 512), (512, 512), (512, 512),
    (512, 512), (512, 512), (512, 512), (512, 512),
]
# conv number (0-based) after which a pool sits; the last pool closes block 5
_POOL_AFTER = (1, 3, 7, 11, 15)
# the relu outputs tapped: conv2_1 (#2), conv3_1 (#4), conv4_1 (#8),
# conv5_1 (#12)
_TAPS = {2: "r21", 4: "r31", 8: "r41", 12: "r51"}


class VGG19Gray(nn.Sequential):
    """torchvision's vgg19().features with ceil-mode pools."""

    def __init__(self):
        layers = []
        for i, (ci, co) in enumerate(_CHANNELS):
            layers += [Conv2d(ci, co, 3, padding=1), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        super().__init__(*layers)

    def convs(self):
        return [self[i] for i in TORCHVISION_CONV_INDICES]


def vgg19_gray_extract(model: VGG19Gray, x, include_r21: bool = False):
    """x: NHWC [LLL] in [0, 255]. Returns NHWC (relu3_1, relu4_1, relu5_1),
    or (relu2_1, relu3_1, relu4_1, relu5_1) with include_r21."""
    x = x.permute(0, 3, 1, 2)
    taps = {}
    for i, conv in enumerate(model.convs()):
        x = F.relu(conv(x))
        if i in _TAPS:
            taps[_TAPS[i]] = x.permute(0, 2, 3, 1)
            if i == 12:
                break
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
    names = ("r21", "r31", "r41", "r51") if include_r21 else ("r31", "r41",
                                                               "r51")
    return tuple(taps[n] for n in names)
