"""Training losses (mirrors devc_tpu/train/losses.py).

All take devc_tpu's NHWC layout and network-Lab conventions (L centered by
-50). Terms that devc_tpu wraps in stop_gradient (the perceptual target,
the contextual exemplar side, the nonlocal feature) are detached here.
"""

from __future__ import annotations

import torch

from devc_tpu_torch import colorspace as cs
from devc_tpu_torch.ops.layers import instance_norm, unfold_patches
from devc_tpu_torch.ops.resize import avg_pool, resize_bilinear

_EPS = 2.220446049250313e-16


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- basics
def mse(x, y=0.0):
    return torch.mean(torch.square(x - y))


def l1(x, y=0.0):
    return torch.mean(torch.abs(x - y))


def weighted_mse(x, y, w):
    """Per-element weighted MSE (reference utils/util.py:212-215)."""
    return torch.mean(torch.square(x - y) * w)


def weighted_l1(x, y, w):
    """Per-element weighted L1 (reference utils/util.py:218-221)."""
    return torch.mean(torch.abs(x - y) * w)


def total_variation(x):
    """TV loss on NHWC x (reference utils/util.py:197-200)."""
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    return torch.mean(torch.square(dx)) + torch.mean(torch.square(dy))


def colorfulness(ab):
    """Hasler-Suesstrunk colourfulness of NHWC ab, per sample [B]
    (reference utils/util.py:224-242)."""
    n = ab.shape[0]
    a = ab[..., 0].reshape(n, -1)
    b = ab[..., 1].reshape(n, -1)
    sig = torch.sqrt(torch.var(a, dim=-1, correction=1)
                     + torch.var(b, dim=-1, correction=1))
    mu = torch.sqrt(a.mean(dim=-1) ** 2 + b.mean(dim=-1) ** 2)
    return sig + 0.37 * mu


# ---------------------------------------------------------- perceptual
def perceptual_loss(pred_feat, target_feat, domain_invariant: bool = False):
    """MSE between the deepest VGG taps (NHWC); the target is detached
    (reference train.py:638-647)."""
    target_feat = target_feat.detach()
    if domain_invariant:
        return mse(_nhwc(instance_norm(_nchw(pred_feat))),
                   _nhwc(instance_norm(_nchw(target_feat))))
    return mse(pred_feat, target_feat)


# ---------------------------------------------------------- contextual
def contextual_loss(x_feat, y_feat, h: float = 0.1,
                    direction: str = "forward",
                    feature_centering: bool = True):
    """Contextual loss between NHWC feature maps, per sample [B]
    (reference models/ContextualLoss.py:29-126). y (the exemplar) is
    detached."""
    b, c = x_feat.shape[0], x_feat.shape[-1]
    x = x_feat.reshape(b, -1, c)
    y = y_feat.detach().reshape(b, -1, c)
    if feature_centering:
        y_mean = y.mean(dim=1, keepdim=True)
        x = x - y_mean
        y = y - y_mean
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS)
    y = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + _EPS)
    d = 1.0 - torch.bmm(x, y.transpose(1, 2))
    # a cosine past 1 by round-off would make d_min + 1e-5 tiny and the
    # affinities overflow: clamp at 0, as devc_tpu does
    d = torch.clamp(d, min=0.0)
    d_min = d.amin(dim=-1, keepdim=True)
    a_ij = torch.softmax((1.0 - d / (d_min + 1e-5)) / h, dim=-1)
    if direction == "forward":
        cx = a_ij.amax(dim=-1).mean(dim=1)
    else:
        cx = a_ij.amax(dim=1).mean(dim=-1)
    return -torch.log(cx)


def contextual_loss_multiscale(pred_feats, ref_feats, h: float = 0.1,
                               direction: str = "forward"):
    """The 3-scale contextual total (reference train.py:649-668):
    r52 x8 + r42 x4 + avgpool2(r32) x2. Tuples (r32, r42, r52), NHWC."""
    p32, p42, p52 = pred_feats
    r32, r42, r52 = ref_feats
    pool = lambda t: _nhwc(avg_pool(_nchw(t), 2))
    c5 = contextual_loss(p52, r52, h, direction).mean() * 8.0
    c4 = contextual_loss(p42, r42, h, direction).mean() * 4.0
    c3 = contextual_loss(pool(p32), pool(r32), h, direction).mean() * 2.0
    return c5 + c4 + c3


# ---------------------------------------------------------- smoothness
def weighted_average(lab, patch_size: int = 3, alpha: float = 1.0):
    """Luminance-weighted local average of ab (reference WeightedAverage,
    models/NonlocalNet.py:21-45). Returns [B, H, W, 2]."""
    l = lab[..., 0:1]
    local_l = unfold_patches(l, patch_size)
    local_a = unfold_patches(lab[..., 1:2], patch_size)
    local_b = unfold_patches(lab[..., 2:3], patch_size)
    corr = torch.softmax(-torch.square(local_l - l) / alpha, dim=-1)
    return torch.cat([(corr * local_a).sum(dim=-1, keepdim=True),
                      (corr * local_b).sum(dim=-1, keepdim=True)], dim=-1)


def weighted_average_color(lab_gt, lab_pred, patch_size: int = 3,
                           alpha: float = 1.0):
    """Local average of the predicted ab, weighted by a softmax over the
    3x3 neighbourhood of the ground truth's Lab distance (L uncentered)
    (reference WeightedAverage_color, models/NonlocalNet.py:48-83).
    Returns [B, H, W, 2]."""
    l = cs.uncenter_l(lab_gt[..., 0:1])
    a = lab_gt[..., 1:2]
    b = lab_gt[..., 2:3]
    local_l = unfold_patches(l, patch_size)
    local_a = unfold_patches(a, patch_size)
    local_b = unfold_patches(b, patch_size)
    local_ap = unfold_patches(lab_pred[..., 1:2], patch_size)
    local_bp = unfold_patches(lab_pred[..., 2:3], patch_size)
    dist = (torch.square(local_l - l) + torch.square(local_a - a)
            + torch.square(local_b - b))
    corr = torch.softmax(-dist / alpha, dim=-1)
    return torch.cat([(corr * local_ap).sum(dim=-1, keepdim=True),
                      (corr * local_bp).sum(dim=-1, keepdim=True)], dim=-1)


def smoothness_loss(lab_gt, pred_ab, alpha: float = 10.0):
    """Pull the prediction toward its colour-weighted local average
    (reference train.py:670-680)."""
    lab_pred = torch.cat([lab_gt[..., 0:1], pred_ab], dim=-1)
    return mse(pred_ab, weighted_average_color(lab_gt, lab_pred, 3, alpha))


def nonlocal_weighted_average(lab_pred, feature, patch_size: int = 3,
                              alpha: float = 0.1, scale_factor=0.25):
    """Feature-correlation weighted average of the predicted ab
    (reference NonlocalWeightedAverage, models/NonlocalNet.py:86-111).
    Returns (weighted [B, h, w, 2], the resized Lab)."""
    b, h, w, _ = lab_pred.shape
    oh, ow = int(h * scale_factor), int(w * scale_factor)
    lab_s = _nhwc(resize_bilinear(_nchw(lab_pred), (oh, ow)))
    feat_s = _nhwc(resize_bilinear(_nchw(feature), (oh, ow)))
    ab = lab_s[..., 1:3].reshape(b, oh * ow, 2)
    local_feat = unfold_patches(feat_s, patch_size).reshape(b, oh * ow, -1)
    corr = torch.softmax(torch.bmm(local_feat, local_feat.transpose(1, 2))
                         / alpha, dim=-1)
    return torch.bmm(corr, ab).reshape(b, oh, ow, 2), lab_s


def nonlocal_smoothness_loss(lab_pred, feature, alpha: float = 0.5,
                             scale_factor=0.25):
    """reference train.py:682-700 (weight 0 by default)."""
    weighted, lab_s = nonlocal_weighted_average(
        lab_pred, feature.detach(), 3, alpha, scale_factor)
    return mse(lab_s[..., 1:3], weighted)


# ---------------------------------------------------------- temporal
def flow_warp(x, flow):
    """Warp NHWC x by the pixel-space flow [B, H, W, 2] (u horizontal, v
    vertical): bilinear, zeros outside, as the reference's WarpingLayer
    (utils/warping.py:16-30: grid_sample, align_corners=True, zero pad)
    and devc_tpu's four-corner gather."""
    b, h, w, _ = x.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
    grid_x = xs[None, None, :] + flow[..., 0]
    grid_y = ys[None, :, None] + flow[..., 1]
    x0 = torch.floor(grid_x)
    y0 = torch.floor(grid_y)
    wx = grid_x - x0
    wy = grid_y - y0
    batch_idx = torch.arange(b, device=x.device)[:, None, None]

    def sample(yy, xx):
        valid = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xi = torch.clamp(xx, 0, w - 1).long()
        yi = torch.clamp(yy, 0, h - 1).long()
        return x[batch_idx, yi, xi] * valid[..., None].to(x.dtype)

    return (sample(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + sample(y0, x0 + 1) * (wx * (1 - wy))[..., None]
            + sample(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
            + sample(y0 + 1, x0 + 1) * (wx * wy)[..., None])


def consistency_loss(pred_lab_current, pred_ab_last, flow_forward, mask):
    """Temporal consistency (reference train.py:702-707): the current
    prediction warped by the forward flow against the last frame's, masked
    MSE. mask: [B, H, W, 1]."""
    warped = flow_warp(pred_lab_current, flow_forward)
    return weighted_mse(warped[..., 1:3], pred_ab_last, mask)


# ---------------------------------------------------------- GAN (RaLSGAN)
def ralsgan_d_loss(real_logits, fake_logits):
    """Relativistic average LSGAN, critic side (reference train.py:594-599)."""
    return (torch.mean(torch.square(real_logits - fake_logits.mean() - 1.0))
            + torch.mean(torch.square(fake_logits - real_logits.mean() + 1.0))
            ) / 2.0


def ralsgan_g_loss(real_logits, fake_logits):
    """Generator side (reference train.py:629-636)."""
    return (torch.mean(torch.square(real_logits - fake_logits.mean() + 1.0))
            + torch.mean(torch.square(fake_logits - real_logits.mean() - 1.0))
            ) / 2.0
