"""Seeded random weights, drawn by the benchmark on the device and handed
as state dicts to the port and to the reference alike.

The distributions are the port's random initialisation
(`devc_tpu_torch/utils/init.py`): every convolution's weight and bias
uniform in +-sqrt(1 / fan_in), as torch.nn.Conv2d, each PReLU slope 0.25;
the critic's attention gamma 0 and its spectral-norm vectors u, v unit
vectors of normal draws. One `torch.rand` and one `torch.randn` call on
the device's generator draw every number; each leaf is a view of them,
scaled in place."""

from __future__ import annotations

import math

import torch
from torch import nn


def draw(modules: dict, seed: int, device) -> dict:
    """{name: state dict} for {name: module built on the meta device}."""
    leaves = []  # (net, key, shape, kind, bound)
    for net, module in modules.items():
        for mname, m in module.named_modules():
            prefix = f"{mname}." if mname else ""
            if isinstance(m, nn.Conv2d):
                bound = math.sqrt(1.0 / math.prod(m.weight.shape[1:]))
                leaves.append((net, prefix + "weight", m.weight.shape,
                               "uniform", bound))
                if m.bias is not None:
                    leaves.append((net, prefix + "bias", m.bias.shape,
                                   "uniform", bound))
            elif isinstance(m, nn.PReLU):
                leaves.append((net, prefix + "weight", m.weight.shape,
                               "fill", 0.25))
        for key, t in module.state_dict().items():
            if key.endswith(".weight_bar"):  # the critic's convs
                bound = math.sqrt(1.0 / math.prod(t.shape[1:]))
                base = key[:-len("weight_bar")]
                leaves.append((net, key, t.shape, "uniform", bound))
                leaves.append((net, base + "bias", t.shape[:1], "uniform",
                               bound))
                leaves.append((net, base + "weight_u", t.shape[:1], "unit",
                               0.0))
                leaves.append((net, base + "weight_v",
                               (math.prod(t.shape[1:]),), "unit", 0.0))
            elif key.endswith("gamma"):
                leaves.append((net, key, t.shape, "fill", 0.0))
        known = {k for n, k, *_ in leaves if n == net}
        missing = set(module.state_dict()) - known
        if missing:
            raise ValueError(f"{net}: no rule to draw {sorted(missing)}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    pools = {}
    for kind, fn in (("uniform", torch.rand), ("unit", torch.randn)):
        n = sum(math.prod(s) for _, _, s, k, _ in leaves if k == kind)
        pools[kind] = [fn(n, generator=gen, device=device), 0]
    out = {net: {} for net in modules}
    for net, key, shape, kind, value in leaves:
        n = math.prod(shape)
        if kind == "fill":
            leaf = torch.full(shape, value, device=device)
        else:
            flat, offset = pools[kind]
            leaf = flat[offset:offset + n].view(shape)
            pools[kind][1] = offset + n
            if kind == "uniform":
                leaf.mul_(2 * value).sub_(value)
            else:
                leaf.div_(leaf.norm() + 1e-12)
        out[net][key] = leaf
    return out


def pipeline_state_dicts(seed: int, device) -> dict:
    """{"vgg", "warpnet", "colorvid"} in the reference's layout."""
    from benchmark.reference.infer import Models

    with torch.device("meta"):
        models = Models()
    return draw({"vgg": models.vgg, "warpnet": models.warpnet,
                 "colorvid": models.colorvid}, seed, device)


def train_state_dicts(seed: int, device, in_ch: int = 7) -> dict:
    """{"vgg", "warpnet", "colorvid", "critic"} in the reference's layout;
    the critic's dict holds its u, v beside each conv."""
    from benchmark.reference.colorvidnet import ColorVidNet
    from benchmark.reference.discriminator import Discriminator
    from benchmark.reference.vgg19 import VGG19
    from benchmark.reference.warpnet import WarpNet

    with torch.device("meta"):
        nets = {"vgg": VGG19(), "warpnet": WarpNet(),
                "colorvid": ColorVidNet(in_ch), "critic": Discriminator()}
    return draw(nets, seed, device)
