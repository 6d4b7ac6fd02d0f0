"""Host-side (numpy) random initialisation of the pipeline's weights.

Mirrors devc_tpu/utils/init.py draw for draw: the same `RandomState`
seeds, the same kaiming-uniform bounds (sqrt(1 / fan_in), as
torch.nn.Conv2d), the same draws in the same order, so `--random_init
--seed s` gives identical weights in both packages. The result is the
devc_tpu parameter pytree (HWIO numpy arrays); `utils/convert.py` turns it
into the modules' state dicts. devc_tpu has no host init of the critic;
`host_discriminator_init` draws one in the same style, in devc_tpu's
layout, so both packages can be given the same critic.
"""

from __future__ import annotations

import math

import numpy as np

from devc_tpu_torch.models.colorvidnet import _CONVS
from devc_tpu_torch.models.discriminator import layer_table
from devc_tpu_torch.models.vgg19 import _CFG


def _conv(rng, in_ch, out_ch, ksize, groups=1, bias=True):
    kh, kw = (ksize, ksize) if isinstance(ksize, int) else ksize
    fan_in = (in_ch // groups) * kh * kw
    bound = math.sqrt(1.0 / fan_in)
    p = {"w": rng.uniform(-bound, bound,
                          (kh, kw, in_ch // groups, out_ch)).astype(np.float32)}
    if bias:
        p["b"] = rng.uniform(-bound, bound, (out_ch,)).astype(np.float32)
    return p


def host_vgg19_init(seed=0):
    rng = np.random.RandomState(seed)
    return {n: _conv(rng, ci, co, 3) for n, ci, co in _CFG}


# cli.train's VGG when --vgg_ckpt is missing: the seed-1 host draw, recorded
# in the run's metadata as RANDOM_VGG_SOURCE; cli.colorize, cli.serve and
# cli.export take the same draw for such a run. (devc_tpu records the same
# string for its jax.random draw at PRNGKey(1): other numbers, and its
# orbax checkpoints cannot be read here anyway.)
RANDOM_VGG_SEED = 1
RANDOM_VGG_SOURCE = "random:seed1"


def host_train_vgg_init():
    """The VGG a training run without --vgg_ckpt trains against."""
    return host_vgg19_init(RANDOM_VGG_SEED)


def host_warpnet_init(seed=1):
    rng = np.random.RandomState(seed)

    def pyr(ci, cm):
        return {
            "conv1": _conv(rng, ci, cm, 3),
            "prelu1": {"a": np.full((1,), 0.25, np.float32)},
            "conv2": _conv(rng, cm, 64, 3),
            "prelu2": {"a": np.full((1,), 0.25, np.float32)},
        }

    def res():
        return {
            "conv1": _conv(rng, 256, 256, 3),
            "conv2": _conv(rng, 256, 256, 3),
            "prelu": {"a": np.full((1,), 0.25, np.float32)},
        }

    return {
        "layer2_1": pyr(128, 128),
        "layer3_1": pyr(256, 128),
        "layer4_1": pyr(512, 256),
        "layer5_1": pyr(512, 256),
        "res": [res(), res(), res()],
        "theta": _conv(rng, 256, 256, 1),
        "phi": _conv(rng, 256, 256, 1),
    }


def host_colorvidnet_init(seed=2, in_ch=7):
    rng = np.random.RandomState(seed)
    out = {}
    for name, (ci, co, ks, g, b, _d) in _CONVS.items():
        if name == "conv1_1a":
            ci = in_ch
        out[name] = _conv(rng, ci, co, ks, groups=g, bias=b)
    return out


def host_pipeline_params(seed=0, in_ch=7):
    return {
        "vgg": host_vgg19_init(seed),
        "warpnet": host_warpnet_init(seed + 1),
        "colorvid": host_colorvidnet_init(seed + 2, in_ch),
    }


def _l2n(v):
    return (v / (np.linalg.norm(v) + 1e-12)).astype(np.float32)


def host_discriminator_init(seed=3, in_size=6, ndf=64):
    """(params, sn_state) of the critic in devc_tpu's layout (HWIO convs
    with bias, gamma [1] = 0; u [out] and v [in * kh * kw], unit vectors).
    Per layer in order: the conv's weight and bias, then u and v."""
    rng = np.random.RandomState(seed)
    params = {"gamma": np.zeros((1,), np.float32)}
    sn_state = {}
    for name, (_path, ci, co, kh, kw, _s, _p) in layer_table(in_size,
                                                              ndf).items():
        params[name] = _conv(rng, ci, co, (kh, kw))
        sn_state[name] = {"u": _l2n(rng.randn(co)),
                          "v": _l2n(rng.randn(ci * kh * kw))}
    return params, sn_state
