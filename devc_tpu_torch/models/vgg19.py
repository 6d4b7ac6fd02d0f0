"""VGG19 feature extractor (frozen; Caffe-BGR preprocessing).

Mirrors devc_tpu/models/vgg19.py. The module holds the sixteen 3x3 convs
under the reference's names (conv1_1 .. conv5_4), so a reference
`vgg19_conv.pth` loads with strict=True. Callers ask for named ReLU taps
("r12", ..., "r52") or pool taps ("p1", ...), and the forward stops at the
deepest one requested.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from devc_tpu_torch import colorspace as cs
from devc_tpu_torch.ops.layers import Conv2d
from devc_tpu_torch.ops.resize import max_pool

# (name, in_ch, out_ch); pools sit between blocks
_CFG = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), ("conv4_4", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), ("conv5_4", 512, 512),
]

# execution schedule: ("conv", name, tap) and ("pool", block, tap)
_SCHEDULE = []
_prev_block = "1"
for _name, _i, _o in _CFG:
    if _name[4] != _prev_block:
        _SCHEDULE.append(("pool", _prev_block, "p" + _prev_block))
        _prev_block = _name[4]
    _SCHEDULE.append(("conv", _name, "r" + _name[4] + _name[6]))
_SCHEDULE.append(("pool", _prev_block, "p" + _prev_block))


class VGG19(nn.Module):
    def __init__(self):
        super().__init__()
        for name, ci, co in _CFG:
            self.add_module(name, Conv2d(ci, co, 3, padding=1))

    def forward(self, x, out_keys):
        """x: [N, 3, H, W] preprocessed BGR*255 -> taps in out_keys order."""
        wanted = set(out_keys)
        last = max(i for i, step in enumerate(_SCHEDULE) if step[2] in wanted)
        taps = {}
        for kind, name, tap in _SCHEDULE[: last + 1]:
            if kind == "conv":
                x = F.relu(getattr(self, name)(x))
            else:
                x = max_pool(x, 2)
            taps[tap] = x
        return [taps[k] for k in out_keys]


def vgg19_extract(model: VGG19, rgb, out_keys):
    """NHWC RGB in [0, 1] -> list of NHWC taps in out_keys order."""
    feats = model(cs.vgg_preprocess(rgb).permute(0, 3, 1, 2), out_keys)
    return [f.permute(0, 2, 3, 1) for f in feats]

