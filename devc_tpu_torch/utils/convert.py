"""devc_tpu parameter pytrees (numpy) -> the port's state dicts.

The key layout is the reference's `.pth` layout, the one
devc_tpu/utils/convert.py::{vgg19,warpnet,colorvidnet}_to_torch write:
conv weights go HWIO -> OIHW; WarpNet's pyramid convs sit at Sequential
indices 1 and 5 (6 in layer5_1) and their PReLUs at 3 and 7 (8 in
layer5_1); ColorVidNet's first convs are `conv1_1.0` / `conv1_1.2` and its
upsampling convs `conv8_1.1`, `conv9_1.1`, `conv10_1.1`. The modules load
these with strict=True. The critic's layout is the reference's
SpectralNorm one (`layerK.0.module.weight_bar` / `.bias` / `.weight_u` /
`.weight_v`, `attention.{query,key,value}_conv.module.*`,
`attention.gamma`), the inverse of devc_tpu's discriminator_from_torch.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv(p, prefix: str, out: dict):
    w = np.asarray(p["w"], dtype=np.float32).transpose(3, 2, 0, 1)
    out[prefix + ".weight"] = torch.from_numpy(np.array(w, order="C"))
    if "b" in p:
        out[prefix + ".bias"] = torch.from_numpy(
            np.asarray(p["b"], dtype=np.float32).reshape(-1).copy())


def _prelu(p, prefix: str, out: dict):
    out[prefix + ".weight"] = torch.from_numpy(
        np.asarray(p["a"], dtype=np.float32).reshape(-1).copy())


def vgg19_state_dict(params) -> dict:
    out = {}
    for name, p in params.items():
        _conv(p, name, out)
    return out


def warpnet_state_dict(params) -> dict:
    out = {}
    for name, conv2_idx, prelu2_idx in (("layer2_1", 5, 7), ("layer3_1", 5, 7),
                                        ("layer4_1", 5, 7), ("layer5_1", 6, 8)):
        p = params[name]
        _conv(p["conv1"], f"{name}.1", out)
        _prelu(p["prelu1"], f"{name}.3", out)
        _conv(p["conv2"], f"{name}.{conv2_idx}", out)
        _prelu(p["prelu2"], f"{name}.{prelu2_idx}", out)
    for i, r in enumerate(params["res"]):
        _conv(r["conv1"], f"layer.{i}.conv1", out)
        _conv(r["conv2"], f"layer.{i}.conv2", out)
        _prelu(r["prelu"], f"layer.{i}.prelu", out)
    _conv(params["theta"], "theta", out)
    _conv(params["phi"], "phi", out)
    return out


_COLORVID_KEYS = {"conv1_1a": "conv1_1.0", "conv1_1b": "conv1_1.2",
                  "conv8_1": "conv8_1.1", "conv9_1": "conv9_1.1",
                  "conv10_1": "conv10_1.1"}


def colorvidnet_state_dict(params) -> dict:
    out = {}
    for name, p in params.items():
        _conv(p, _COLORVID_KEYS.get(name, name), out)
    return out


def state_dicts_from_numpy(params) -> dict:
    """{"vgg", "warpnet", "colorvid"} numpy pytree -> the same keys mapped
    to state dicts in the reference layout."""
    return {
        "vgg": vgg19_state_dict(params["vgg"]),
        "warpnet": warpnet_state_dict(params["warpnet"]),
        "colorvid": colorvidnet_state_dict(params["colorvid"]),
    }


def discriminator_state_dict(params, sn_state) -> dict:
    """devc_tpu critic (params, sn_state) -> the reference-layout state
    dict, spectral-norm vectors included."""
    from devc_tpu_torch.models.discriminator import layer_table

    f32 = lambda x: torch.from_numpy(
        np.asarray(x, dtype=np.float32).reshape(-1).copy())
    out = {"attention.gamma": f32(params["gamma"])}
    for name, (path, *_rest) in layer_table().items():
        p, uv = params[name], sn_state[name]
        w = np.asarray(p["w"], dtype=np.float32).transpose(3, 2, 0, 1)
        out[path + ".module.weight_bar"] = torch.from_numpy(
            np.array(w, order="C"))
        out[path + ".module.bias"] = f32(p["b"])
        out[path + ".module.weight_u"] = f32(uv["u"])
        out[path + ".module.weight_v"] = f32(uv["v"])
    return out


def checked_device(device) -> torch.device:
    """torch.device(device); a CUDA device without a GPU raises, so that
    nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False")
    return device


def frozen_vgg(params, device="cuda"):
    """VGG19 from devc_tpu's numpy params on `device`, frozen (eval, no
    parameter gradients; its input can still receive gradient)."""
    from devc_tpu_torch.models.vgg19 import VGG19

    with torch.device("meta"):
        vgg = VGG19()
    vgg.load_state_dict(vgg19_state_dict(params), strict=True, assign=True)
    return vgg.to(checked_device(device)).eval().requires_grad_(False)


def train_state_from_numpy(params_g, params_d, sn_state, tx_g, tx_d,
                           device="cuda"):
    """devc_tpu TrainState contents -> the port's TrainState on `device`.

    params_g: {"warpnet", "colorvid"} numpy pytrees; params_d, sn_state:
    the critic's (devc_tpu layout, e.g. host_discriminator_init). The
    optimizer states start fresh from tx_g / tx_d (train.state.FlatAdam).
    """
    from torch import nn

    from devc_tpu_torch.models.colorvidnet import ColorVidNet
    from devc_tpu_torch.models.discriminator import (
        Discriminator,
        split_state_dict,
    )
    from devc_tpu_torch.models.warpnet import WarpNet
    from devc_tpu_torch.train.state import TrainState, param_groups

    device = checked_device(device)
    in_ch = np.shape(params_g["colorvid"]["conv1_1a"]["w"])[2]
    with torch.device("meta"):
        gen = nn.ModuleDict({"warpnet": WarpNet(),
                             "colorvid": ColorVidNet(in_ch)})
        disc = Discriminator()
    gen["warpnet"].load_state_dict(warpnet_state_dict(params_g["warpnet"]),
                                   strict=True, assign=True)
    gen["colorvid"].load_state_dict(
        colorvidnet_state_dict(params_g["colorvid"]), strict=True,
        assign=True)
    d_params, sn = split_state_dict(discriminator_state_dict(params_d,
                                                             sn_state))
    disc.load_state_dict(d_params, strict=True, assign=True)
    gen, disc = gen.to(device), disc.to(device)
    return TrainState(
        step=0, params_g=gen, params_d=disc,
        sn_state={k: {n: t.to(device) for n, t in uv.items()}
                  for k, uv in sn.items()},
        opt_state_g=tx_g.init(param_groups(gen)),
        opt_state_d=tx_d.init(param_groups(disc)))
