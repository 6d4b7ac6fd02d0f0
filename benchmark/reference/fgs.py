"""The fast global smoother, plain: a frozen copy of the plain path of
devc_tpu_torch/ops/fgs.py (Min et al. 2014, "Fast Global Image Smoothing
Based on Weighted Least Squares"): three iterations of a horizontal and a
vertical 1-D weighted-least-squares pass, each a batch of tridiagonal
solves by parallel cyclic reduction. No kernel: every device runs this."""

from __future__ import annotations

import torch


def _tridiag_pcr(a, b, c, d):
    """Plain parallel cyclic reduction. a, b, c, d: [B, L] sub-diagonal,
    diagonal, super-diagonal, right-hand side (a[:, 0], c[:, -1] ignored).
    ceil(log2 L) steps; every step reads pre-step neighbours; neighbours
    outside the system take a = 0, b = 1, c = 0, d = 0. Returns x [B, L]."""
    a, b, c, d = (t.float() for t in (a, b, c, d))
    length = a.shape[-1]

    def down(x, s, fill):  # row i takes row i - s
        return torch.cat([torch.full_like(x[:, :s], fill), x[:, :-s]], dim=1)

    def up(x, s, fill):  # row i takes row i + s
        return torch.cat([x[:, s:], torch.full_like(x[:, :s], fill)], dim=1)

    s = 1
    while s < length:
        am, bm, cm, dm = (down(x, s, f) for x, f in
                          ((a, 0.0), (b, 1.0), (c, 0.0), (d, 0.0)))
        ap, bp, cp, dp = (up(x, s, f) for x, f in
                          ((a, 0.0), (b, 1.0), (c, 0.0), (d, 0.0)))
        alpha = -a / bm
        gamma = -c / bp
        a = alpha * am
        b = b + alpha * cm + gamma * ap
        c = gamma * cp
        d = d + alpha * dm + gamma * dp
        s *= 2
    return d / b


def _weights(guide, sigma_color: float):
    """exp(-|g_{j+1} - g_j| / sigma_color) along the last axis of guide
    [Bg, H, W] -> [Bg, H, W - 1], image by image: the CPU's vector exp and
    its scalar tail differ in the last bit, so a batched call takes each
    image's weights bit for bit from the same call on it alone."""
    return torch.stack([
        torch.exp(-torch.abs(g[:, 1:] - g[:, :-1]) / sigma_color)
        for g in guide])


def _smooth_axis(src, guide, lam_t: float, sigma_color: float):
    """Plain version of one horizontal WLS pass. src [B, H, W, C], guide
    [Bg, H, W] with Bg = B (one per image) or 1 (shared) -> [B, H, W, C].
    The systems run along W, one per (image, row, channel), built into
    [B*H*C, W] and solved by the plain PCR."""
    b, h, w, ch = src.shape
    wgt = _weights(guide, sigma_color).expand(b, h, w - 1)
    zeros_col = torch.zeros((b, h, 1), dtype=src.dtype, device=src.device)
    w_left = torch.cat([zeros_col, wgt], dim=2)  # weight to col - 1
    w_right = torch.cat([wgt, zeros_col], dim=2)  # weight to col + 1
    diag = 1.0 + lam_t * (w_left + w_right)

    def per_channel(x):  # [B, H, W] -> [B*H*C, W]
        return x[:, :, None, :].expand(b, h, ch, w).reshape(b * h * ch, w)

    x = _tridiag_pcr(per_channel(-lam_t * w_left), per_channel(diag),
                     per_channel(-lam_t * w_right),
                     src.permute(0, 1, 3, 2).reshape(b * h * ch, w))
    return x.reshape(b, h, ch, w).permute(0, 1, 3, 2)


def _batch_form(src, guide, fn: str):
    """(src [B, H, W, C], guide [Bg, H, W], batched) from src [H, W, C]
    or [B, H, W, C] and guide [H, W] (shared) or [B, H, W]."""
    batched = src.dim() == 4
    if src.dim() not in (3, 4) or guide.dim() not in (2, 3) or (
            guide.dim() == 3 and (not batched or guide.shape[0] != src.shape[0])
    ) or tuple(guide.shape[-2:]) != tuple(src.shape[-3:-1]):
        raise ValueError(f"{fn}: expected src [H, W, C] or [B, H, W, C] and "
                         "guide [H, W] or [B, H, W], got "
                         f"{tuple(src.shape)} and {tuple(guide.shape)}")
    return (src if batched else src[None],
            guide if guide.dim() == 3 else guide[None], batched)


def smooth_pass_plain(src, guide, lam_t: float, sigma_color: float,
                      axis: int):
    """Plain version of `smooth_pass`, on any device, with its shapes:
    `_smooth_axis`, on the transposed images for axis 0."""
    src4, guide3, batched = _batch_form(src, guide, "smooth_pass_plain")
    if axis == 1:
        out = _smooth_axis(src4, guide3, lam_t, sigma_color)
    else:
        out = _smooth_axis(src4.transpose(1, 2), guide3.transpose(1, 2),
                           lam_t, sigma_color).transpose(1, 2)
    return out if batched else out[0]


# the reference's WLS settings (lambda, sigma_color) and OpenCV's
# default number of iterations
LAMBDA = 500.0
SIGMA_COLOR = 4.0
NUM_ITER = 3


def fast_global_smoother(src, guide):
    """Edge-aware smoothing of src [H, W, C] or [B, H, W, C] guided by
    guide [H, W] (shared) or [B, H, W] (one per image), in [0, 255].
    Returns src's shape, fp32. Each iteration is one row pass and one
    column pass, each a batch of tridiagonal solves by the plain PCR."""
    out = src.float().contiguous()
    guide = guide.float().contiguous()
    denom = 4.0 ** NUM_ITER - 1.0
    for t in range(1, NUM_ITER + 1):
        lam_t = 1.5 * LAMBDA * (4.0 ** (NUM_ITER - t)) / denom
        out = smooth_pass_plain(out, guide, lam_t, SIGMA_COLOR, axis=1)
        out = smooth_pass_plain(out, guide, lam_t, SIGMA_COLOR, axis=0)
    return out
