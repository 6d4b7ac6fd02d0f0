"""The GAN video critic: spectral-normalised convs and self-attention
(mirrors devc_tpu/models/discriminator.py; reference Discriminator_x64).

Input is a 6-channel pair [current Lab (uncentered L), last Lab]; six
spectrally normalised stride-2 convs with a self-attention block after the
second, then a [3, 6] head, average-pooled to one logit per sample.

Spectral norm keeps power-iteration vectors u, v per conv. Here they are
explicit state, as in devc_tpu: `discriminator_apply(model, sn_state, x)`
returns the new vectors beside its outputs and changes nothing in place,
so the training step decides which state it keeps. The module holds only
the parameters, under the reference's names (`layer1.0.module.weight_bar`,
`attention.query_conv.module.bias`, `attention.gamma`, ...); the reference
checkpoint's `weight_u` / `weight_v` are the state, split off by
`split_state_dict`. `sn_state` is keyed by devc_tpu's layer names
("layer1", "attn_q", ..., "last").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from devc_tpu_torch.ops.layers import instance_norm, leaky_relu

_EPS = 1e-12


def layer_table(in_size: int = 6, ndf: int = 64) -> dict:
    """devc_tpu name -> (reference module path, in, out, kh, kw, stride,
    pad), in devc_tpu's order."""
    return {
        "layer1": ("layer1.0", in_size, ndf, 4, 4, 2, 1),
        "layer2": ("layer2.0", ndf, ndf, 4, 4, 2, 1),
        "attn_q": ("attention.query_conv", ndf, ndf, 1, 1, 1, 0),
        "attn_k": ("attention.key_conv", ndf, ndf, 1, 1, 1, 0),
        "attn_v": ("attention.value_conv", ndf, ndf, 1, 1, 1, 0),
        "layer3": ("layer3.0", ndf, ndf * 2, 4, 4, 2, 1),
        "layer4": ("layer4.0", ndf * 2, ndf * 4, 4, 4, 2, 1),
        "layer5": ("layer5.0", ndf * 4, ndf * 8, 4, 4, 2, 1),
        "layer6": ("layer6.0", ndf * 8, ndf * 16, 4, 4, 2, 1),
        "last": ("last", ndf * 16, 1, 3, 6, 1, 0),
    }


class _ConvParams(nn.Module):
    """The wrapped conv's parameters: weight_bar (OIHW) and bias."""

    def __init__(self, ci, co, kh, kw):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(co, ci, kh, kw))
        self.bias = nn.Parameter(torch.empty(co))


class _SpectralNorm(nn.Module):
    """Reference SpectralNorm(conv): the conv under `.module`."""

    def __init__(self, ci, co, kh, kw):
        super().__init__()
        self.module = _ConvParams(ci, co, kh, kw)


class _Attention(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.query_conv = _SpectralNorm(ch, ch, 1, 1)
        self.key_conv = _SpectralNorm(ch, ch, 1, 1)
        self.value_conv = _SpectralNorm(ch, ch, 1, 1)
        self.gamma = nn.Parameter(torch.zeros(1))


class Discriminator(nn.Module):
    def __init__(self, in_size: int = 6, ndf: int = 64):
        super().__init__()
        self.table = layer_table(in_size, ndf)
        for name, (path, ci, co, kh, kw, _s, _p) in self.table.items():
            if name.startswith("attn"):
                continue
            sn = _SpectralNorm(ci, co, kh, kw)
            if path == "last":
                self.last = sn
            else:  # reference: Sequential(SpectralNorm(conv), ...) -> ".0"
                self.add_module(path.split(".")[0], nn.ModuleList([sn]))
        self.attention = _Attention(ndf)

    def conv_params(self, name: str) -> _ConvParams:
        return self.get_submodule(self.table[name][0]).module


def split_state_dict(sd: dict):
    """Reference-layout state dict -> (parameter state dict, sn_state)."""
    params, sn = {}, {}
    for name, (path, *_rest) in layer_table().items():
        prefix = path + ".module."
        sn[name] = {"u": sd[prefix + "weight_u"].reshape(-1),
                    "v": sd[prefix + "weight_v"].reshape(-1)}
    for k, v in sd.items():
        if not (k.endswith(".weight_u") or k.endswith(".weight_v")):
            params[k] = v
    return params, sn


def _l2n(v):
    return v / (torch.linalg.vector_norm(v) + _EPS)


def _sn_conv(model: Discriminator, sn_state, new_sn, name, x):
    """Spectral-normalised conv of NCHW x; records the new (u, v) in
    new_sn. One power iteration on the [out, in * kh * kw] weight matrix,
    without gradient; sigma = u . (W v) carries gradient to W."""
    _path, _ci, co, _kh, _kw, stride, pad = model.table[name]
    p = model.conv_params(name)
    wmat = p.weight_bar.reshape(co, -1)
    with torch.no_grad():
        v = _l2n(wmat.t() @ sn_state[name]["u"])
        u = _l2n(wmat @ v)
    sigma = u @ (wmat @ v)
    new_sn[name] = {"u": u, "v": v}
    return F.conv2d(x, p.weight_bar / sigma, p.bias, stride=stride,
                    padding=pad)


def _self_attention(model, sn_state, new_sn, x):
    """Self-attention (reference GAN_models.py:68-101), NCHW."""
    b, c, h, w = x.shape
    flat = lambda t: t.reshape(b, c, h * w).transpose(1, 2)  # [B, N, C]
    q = flat(_sn_conv(model, sn_state, new_sn, "attn_q", x))
    k = flat(_sn_conv(model, sn_state, new_sn, "attn_k", x))
    v = flat(_sn_conv(model, sn_state, new_sn, "attn_v", x))
    attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1)
    out = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, h, w)
    return model.attention.gamma * out + x


def discriminator_apply(model: Discriminator, sn_state, x):
    """x: NHWC [B, H, W, 6] -> (logit [B, 1], stage-4 features NHWC,
    new sn_state). Nothing is updated in place."""
    new_sn = {}
    h = x.permute(0, 3, 1, 2)
    h = leaky_relu(_sn_conv(model, sn_state, new_sn, "layer1", h), 0.2)
    h = _sn_conv(model, sn_state, new_sn, "layer2", h)
    h = leaky_relu(instance_norm(h), 0.2)
    h = _self_attention(model, sn_state, new_sn, h)
    for name in ("layer3", "layer4", "layer5", "layer6"):
        h = leaky_relu(instance_norm(
            _sn_conv(model, sn_state, new_sn, name, h)), 0.2)
        if name == "layer4":
            h4 = h
    # the [3, 6] head fits the 216 x 384 training size (stage 6 is 3 x 6);
    # smaller inputs are zero-padded up to it, as devc_tpu does
    kh, kw = model.conv_params("last").weight_bar.shape[-2:]
    ph, pw = max(0, kh - h.shape[2]), max(0, kw - h.shape[3])
    if ph or pw:
        h = F.pad(h, (0, pw, 0, ph))
    out = _sn_conv(model, sn_state, new_sn, "last", h)
    return out.mean(dim=(2, 3)), h4.permute(0, 2, 3, 1), new_sn
