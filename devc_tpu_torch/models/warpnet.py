"""WarpNet, the dense-correspondence network (mirrors
devc_tpu/models/warpnet.py).

Four conv + InstanceNorm + PReLU pyramids project VGG relu2_1..relu5_1 to
64 channels each at H/4 x W/4; three residual blocks fuse the 256-channel
concat; 1x1 theta/phi convs project to 256-d; features are mean-centered
over space and L2-normalised over channels; the correspondence op warps
the exemplar's avg-pooled Lab onto the frame.

Module and parameter names follow the reference's layout (`layer2_1.1`,
`layer2_1.3`, ..., `layer5_1.6`, `layer.0.conv1`, `theta`, `phi`), so a
reference `nonlocal_net_iter_*.pth` loads with strict=True. The public
functions keep devc_tpu's layouts: NHWC feature maps in, [B, N, C]
embeddings, NHWC warped Lab and similarity out.
"""

from __future__ import annotations

import torch
from torch import nn

from devc_tpu_torch.ops.correspondence import correspondence_warp
from devc_tpu_torch.ops.layers import (
    Conv2d,
    InstanceNorm,
    ReflectPad,
    instance_norm,
    prelu,
    reflect_pad,
    replicate_pad,
)
from devc_tpu_torch.ops.resize import avg_pool, upsample_nearest

FEATURE_CH = 64
INTER_CH = 256


def _conv_block(ci, co, stride=1):
    # indices 0..3 of the reference's pyramid Sequential
    return [ReflectPad(1), Conv2d(ci, co, 3, stride=stride),
            InstanceNorm(), nn.PReLU()]


def _pyramid(kind: str, ci: int, cm: int) -> nn.Sequential:
    up = nn.Upsample(scale_factor=2, mode="nearest")
    if kind == "2_1":  # H/2: the second conv has stride 2
        layers = _conv_block(ci, cm) + _conv_block(cm, FEATURE_CH, stride=2)
    elif kind == "3_1":  # already H/4
        layers = _conv_block(ci, cm) + _conv_block(cm, FEATURE_CH)
    elif kind == "4_1":  # H/8: upsample at the end
        layers = _conv_block(ci, cm) + _conv_block(cm, FEATURE_CH) + [up]
    else:  # "5_1", H/16: upsample between the convs and at the end
        layers = (_conv_block(ci, cm) + [up] + _conv_block(cm, FEATURE_CH)
                  + [nn.Upsample(scale_factor=2, mode="nearest")])
    return nn.Sequential(*layers)


class ResidualBlock(nn.Module):
    """Two reflect-padded 3x3 convs with InstanceNorm; one PReLU slope is
    shared by both activations."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = Conv2d(ch, ch, 3)
        self.conv2 = Conv2d(ch, ch, 3)
        self.prelu = nn.PReLU()

    def forward(self, x):
        a = self.prelu.weight
        y = prelu(instance_norm(self.conv1(reflect_pad(x, 1))), a)
        y = instance_norm(self.conv2(reflect_pad(y, 1)))
        return prelu(y + x, a)


class WarpNet(nn.Module):
    def __init__(self):
        super().__init__()
        ch = FEATURE_CH * 4
        self.layer2_1 = _pyramid("2_1", 128, 128)
        self.layer3_1 = _pyramid("3_1", 256, 128)
        self.layer4_1 = _pyramid("4_1", 512, 256)
        self.layer5_1 = _pyramid("5_1", 512, 256)
        self.layer = nn.Sequential(*(ResidualBlock(ch) for _ in range(3)))
        self.theta = Conv2d(ch, INTER_CH, 1)
        self.phi = Conv2d(ch, INTER_CH, 1)

    def embed(self, feats):
        """Pyramids + residual blocks for one image's NCHW features
        (relu2_1, relu3_1, relu4_1, relu5_1) -> [B, 256, H/4, W/4]."""
        f2, f3, f4, f5 = feats
        p2 = self.layer2_1(f2)
        p3 = self.layer3_1(f3)
        p4 = self.layer4_1(f4)
        p5 = self.layer5_1(f5)
        if p5.shape[-2:] != p2.shape[-2:]:
            # net H % 16 == 8: relu5_1 lost a row; replicate-pad H by 1
            p5 = replicate_pad(p5, pad_h=(1, 1))
        return self.layer(torch.cat([p2, p3, p4, p5], dim=1))


def _nchw(feats):
    return [f.permute(0, 3, 1, 2) for f in feats]


def _flatten(x):
    """[B, C, h, w] -> contiguous [B, h*w, C]."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c).contiguous()


def _center_normalize(feat_flat, eps: float = 2.220446049250313e-16):
    """[B, N, C]: subtract the mean over N per channel, then L2-normalise
    over C per position (eps added to the norm). Statistics in fp32 (fp64
    for fp64 input)."""
    ff = feat_flat.to(torch.promote_types(feat_flat.dtype, torch.float32))
    feat = ff - ff.mean(dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(feat, ord=2, dim=-1, keepdim=True) + eps
    return (feat / norm).to(feat_flat.dtype)


def embed_queries(model: WarpNet, a_feats):
    """Frame side: NHWC features -> centered, normalised theta [B, N, 256]."""
    return _center_normalize(_flatten(model.theta(model.embed(_nchw(a_feats)))))


def embed_keys(model: WarpNet, b_lab, b_feats):
    """Exemplar side: NHWC Lab [B, H, W, 3] and features -> (phi [B, N,
    256], values [B, N, 3], the Lab avg-pooled by 4). Computed once per
    exemplar and carried."""
    phi = _center_normalize(_flatten(model.phi(model.embed(_nchw(b_feats)))))
    values = _flatten(avg_pool(b_lab.permute(0, 3, 1, 2), 4))
    return phi, values


def warp_with_keys(theta, phi, values, out_hw, temperature: float = 0.005,
                   differentiable: bool = False):
    """Correspondence, then nearest x4 up to out_hw. Returns NHWC
    warped Lab [B, H, W, 3] and similarity [B, H, W, 1]. differentiable:
    the correspondence may be differentiated (on the card: K1 with the
    backward kernels K2b/K3)."""
    b = theta.shape[0]
    fh, fw = out_hw[0] // 4, out_hw[1] // 4
    warped, sim = correspondence_warp(theta, phi, values, temperature,
                                      differentiable=differentiable)
    warped = warped.reshape(b, fh, fw, 3).permute(0, 3, 1, 2)
    sim = sim.reshape(b, fh, fw, 1).permute(0, 3, 1, 2)
    return (upsample_nearest(warped, 4).permute(0, 2, 3, 1),
            upsample_nearest(sim, 4).permute(0, 2, 3, 1))


def warpnet_apply(model: WarpNet, b_lab, a_feats, b_feats,
                  temperature: float = 0.005, differentiable: bool = False):
    """Warp the exemplar's colours onto the frame, both embeddings computed
    here (devc_tpu/models/warpnet.py::warpnet_apply). The training path:
    the exemplar's phi is recomputed every step under gradient.

    b_lab: [B, H, W, 3] exemplar network-Lab; a_feats / b_feats: NHWC
    relu2_1..relu5_1 of frame and exemplar, feature_normalized. Returns
    NHWC warped Lab [B, H, W, 3] and similarity [B, H, W, 1].
    """
    theta = embed_queries(model, a_feats)
    phi, values = embed_keys(model, b_lab, b_feats)
    return warp_with_keys(theta, phi, values, (b_lab.shape[1], b_lab.shape[2]),
                          temperature, differentiable)
