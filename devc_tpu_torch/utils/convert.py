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


def use_full_fp32() -> None:
    """Keep cuDNN convolutions and CUDA matmuls in full fp32 (PyTorch runs
    cuDNN convolutions in TF32 by default). At T = 1e-10 the warp is an
    argmax, which flips on differences far below TF32's precision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def frozen_vgg(params, device="cuda"):
    """VGG19 from devc_tpu's numpy params on `device`, frozen (eval, no
    parameter gradients; its input can still receive gradient)."""
    return frozen_vgg_from_state_dict(vgg19_state_dict(params), device)


def frozen_vgg_from_state_dict(sd: dict, device="cuda"):
    """VGG19 from a reference-layout state dict (vgg19_conv.pth), frozen,
    on `device`; strict load."""
    from devc_tpu_torch.models.vgg19 import VGG19

    with torch.device("meta"):
        vgg = VGG19()
    vgg.load_state_dict(sd, strict=True, assign=True)
    return vgg.to(checked_device(device)).eval().requires_grad_(False)


def train_state_from_numpy(params_g, params_d, sn_state, tx_g, tx_d,
                           device="cuda"):
    """devc_tpu TrainState contents -> the port's TrainState on `device`.

    params_g: {"warpnet", "colorvid"} numpy pytrees; params_d, sn_state:
    the critic's (devc_tpu layout, e.g. host_discriminator_init). The
    optimizer states start fresh from tx_g / tx_d (train.state.FlatAdam).
    """
    return train_state_from_state_dicts(
        warpnet_state_dict(params_g["warpnet"]),
        colorvidnet_state_dict(params_g["colorvid"]),
        discriminator_state_dict(params_d, sn_state), tx_g, tx_d, device)


def train_state_from_state_dicts(warpnet_sd, colorvid_sd, critic_sd, tx_g,
                                 tx_d, device="cuda"):
    """A fresh TrainState (step 0, optimizer states from tx_g / tx_d) on
    `device` from reference-layout state dicts: WarpNet's, ColorVidNet's
    (its input width read from conv1_1) and the critic's with its
    spectral-norm vectors. Each loads with strict=True."""
    from torch import nn

    from devc_tpu_torch.models.colorvidnet import ColorVidNet
    from devc_tpu_torch.models.discriminator import (
        Discriminator,
        split_state_dict,
    )
    from devc_tpu_torch.models.warpnet import WarpNet
    from devc_tpu_torch.train.state import TrainState, param_groups

    device = checked_device(device)
    in_ch = colorvid_sd["conv1_1.0.weight"].shape[1]
    with torch.device("meta"):
        gen = nn.ModuleDict({"warpnet": WarpNet(),
                             "colorvid": ColorVidNet(in_ch)})
        disc = Discriminator()
    gen["warpnet"].load_state_dict(warpnet_sd, strict=True, assign=True)
    gen["colorvid"].load_state_dict(colorvid_sd, strict=True, assign=True)
    d_params, sn = split_state_dict(critic_sd)
    disc.load_state_dict(d_params, strict=True, assign=True)
    gen, disc = gen.to(device), disc.to(device)
    return TrainState(
        step=0, params_g=gen, params_d=disc,
        sn_state={k: {n: t.to(device) for n, t in uv.items()}
                  for k, uv in sn.items()},
        opt_state_g=tx_g.init(param_groups(gen)),
        opt_state_d=tx_d.init(param_groups(disc)))


# --- the reference's .pth files from the port's weights --------------------
# The port's modules already hold the reference key layout, so a state
# dict is the file's content; these only split, gather and place on the CPU.


def _cpu(sd: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in sd.items()}


def save_reference_checkpoints(params_g: dict, out_dir: str,
                               iteration: int = 0):
    """Write a generator ({"warpnet": state dict, "colorvid": state dict},
    e.g. train/checkpoint.py::load_train_params_g) as the two .pth files
    the reference's test.py:150-159 loads (nonlocal_net_iter_N.pth,
    colornet_iter_N.pth). Returns the paths."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = (os.path.join(out_dir, f"nonlocal_net_iter_{iteration}.pth"),
             os.path.join(out_dir, f"colornet_iter_{iteration}.pth"))
    torch.save(_cpu(params_g["warpnet"]), paths[0])
    torch.save(_cpu(params_g["colorvid"]), paths[1])
    return paths


def discriminator_reference_state_dict(params_d: dict, sn_state: dict) -> dict:
    """The port's critic (Discriminator.state_dict() and its sn_state) ->
    the reference's discriminator_iter_N.pth layout, each conv's u / v
    back beside its weight (the inverse of split_state_dict)."""
    from devc_tpu_torch.models.discriminator import layer_table

    out = _cpu(params_d)
    for name, (path, *_rest) in layer_table().items():
        for k in ("u", "v"):
            out[f"{path}.module.weight_{k}"] = (
                sn_state[name][k].detach().to("cpu", copy=True).reshape(-1))
    return out


def vgg19_gray_state_dict(params) -> dict:
    """devc_tpu's vgg19_gray params ({"conv0" .. "conv15"}, HWIO) -> the
    torchvision layout ("0.weight", "2.weight", ..., "34.bias"), the
    inverse of devc_tpu's vgg19_gray_from_torch."""
    from devc_tpu_torch.models.vgg19_gray import TORCHVISION_CONV_INDICES

    out = {}
    for i, idx in enumerate(TORCHVISION_CONV_INDICES):
        _conv(params[f"conv{i}"], str(idx), out)
    return out


def vgg19_gray_from_state_dict(sd: dict, device="cuda"):
    """The reference's vgg19_gray.pth (torchvision layout) -> a frozen
    VGG19Gray on `device`; strict load."""
    from devc_tpu_torch.models.vgg19_gray import VGG19Gray

    with torch.device("meta"):
        model = VGG19Gray()
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(checked_device(device)).eval().requires_grad_(False)
