"""Device-side CenterPad: the host's anti-aliased resize and center crop as
two matrix products (mirrors devc_tpu/ops/device_resize.py).

The host path (`data/transforms.py::center_pad_crop`) is a gaussian
prefilter (separable, mirror boundary), a half-pixel bilinear resample
and a center crop: linear per axis. So it composes into one sampling
matrix per axis, built on the host in float64 once per (source, target)
shape pair:

    out = crop_h(S_h @ G_h) @ img @ crop_w(S_w @ G_w)^T = A_h @ img @ A_w^T

and each frame costs two small products on the card. The plans are
devc_tpu's float64 numpy plans, copied (the port imports nothing of
devc_tpu). They are applied with `torch.einsum` in fp32 with TF32 off
(`utils/convert.py::use_full_fp32`): plain matrix products, which
devc_tpu also leaves to its compiler outside any Pallas kernel. The only
deviation from the host path is fp32 accumulation, which flips
truncation ties by at most one uint8 step.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_matrix(n: int, sigma: float) -> np.ndarray:
    """[n, n] float64 matrix G with G @ x == scipy.ndimage.gaussian_filter1d(
    x, sigma, mode="mirror"), built by filtering identity columns so the
    kernel (truncate 4, sampled gaussian) and the mirror fold match scipy
    bit for bit."""
    if sigma <= 0.0:
        return np.eye(n, dtype=np.float64)
    from scipy.ndimage import gaussian_filter1d

    return gaussian_filter1d(np.eye(n, dtype=np.float64), sigma, axis=0,
                             mode="mirror")


def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float64 half-pixel bilinear sampling matrix
    (src = (dst + 0.5) * in/out - 0.5, clamped: the host resize's gather)."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = src - lo
    m = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    np.add.at(m, (rows, lo), 1.0 - w_hi)
    np.add.at(m, (rows, hi), w_hi)
    return m


def centerpad_plan(src_hw, out_hw, dtype=np.float32):
    """Per-axis sampling matrices for CenterPad(src -> out) + center crop:
    the aspect-filling branch, int()-truncated resize sizes, the
    anti-aliasing sigma = (factor - 1) / 2 per axis and the centered crop
    of the overflowing axis, as the host path does them.

    Returns (A_h [th, src_h], A_w [tw, src_w]) as `dtype` numpy arrays.
    """
    sh, sw = int(src_hw[0]), int(src_hw[1])
    th, tw = int(out_hw[0]), int(out_hw[1])

    if sh / sw == th / tw and sh == th:
        new_h, new_w = sh, sw  # identity branch (no resize)
    elif sh / sw > th / tw:
        # too tall: match width, crop height
        new_h, new_w = int(sh * tw / sw), int(sw * tw / sw)
    else:
        # too wide / equal aspect with sh != th: match height, crop width
        new_h, new_w = int(sh * th / sh), int(sw * th / sh)
    if new_h < th or new_w < tw:
        raise ValueError(
            f"CenterPad plan {src_hw}->{out_hw} underflows the target "
            f"(resize gives {(new_h, new_w)}); the host path would crop "
            "out of bounds too")

    # the host resize prefilters iff either axis downsamples, with the
    # per-axis sigma clamped at 0; the identity branch skips it entirely
    fh, fw = sh / new_h, sw / new_w
    prefilter = (new_h, new_w) != (sh, sw) and (fh > 1 or fw > 1)

    def axis_plan(n_src, n_new, n_target, sigma):
        if n_new == n_src and sigma <= 0.0:
            a = np.eye(n_src, dtype=np.float64)
        else:
            a = _bilinear_matrix(n_src, n_new) @ _gaussian_matrix(n_src, sigma)
        off = (n_new - n_target) // 2
        return a[off:off + n_target]

    a_h = axis_plan(sh, new_h, th, max(0.0, (fh - 1) / 2) if prefilter else 0.0)
    a_w = axis_plan(sw, new_w, tw, max(0.0, (fw - 1) / 2) if prefilter else 0.0)
    return a_h.astype(dtype), a_w.astype(dtype)


def centerpad_plan_padded(src_hw, out_hw, max_hw, dtype=np.float32):
    """centerpad_plan with the source axes zero-padded to max_hw, for
    batched serving of clips of mixed resolutions
    (pipeline/scheduler.py): each slot's raw frames are zero-padded on the
    host to a common (max_h, max_w), and its plan gets matching zero
    columns, so one batched step serves every source size. Exact in
    meaning (padded pixels multiply zero coefficients); the longer
    contraction may reassociate the fp32 sums and flip truncation ties by
    one uint8 step.

    Returns (A_h [th, max_h], A_w [tw, max_w]).
    """
    a_h, a_w = centerpad_plan(src_hw, out_hw, dtype)
    mh, mw = int(max_hw[0]), int(max_hw[1])
    if a_h.shape[1] > mh or a_w.shape[1] > mw:
        raise ValueError(f"max_hw {max_hw} smaller than source {src_hw}")
    pad_h = np.zeros((a_h.shape[0], mh), dtype)
    pad_h[:, :a_h.shape[1]] = a_h
    pad_w = np.zeros((a_w.shape[0], mw), dtype)
    pad_w[:, :a_w.shape[1]] = a_w
    return pad_h, pad_w


def _to_u8(x):
    """The host path's truncating cast."""
    return torch.floor(torch.clamp(x, 0.0, 255.0)).to(torch.uint8)


def device_centerpad(frames_u8, a_h, a_w):
    """Apply a centerpad_plan on the frames' device: uint8 [..., H, W, 3]
    with A_h [th, H], A_w [tw, W] (fp32 tensors on that device) -> uint8
    [..., th, tw, 3]."""
    from devc_tpu_torch.utils.convert import use_full_fp32

    use_full_fp32()
    x = frames_u8.float()
    x = torch.einsum("ts,...swc->...twc", a_h, x)  # rows
    x = torch.einsum("uw,...twc->...tuc", a_w, x)  # columns
    return _to_u8(x)


def device_centerpad_batched(frames_u8, a_h, a_w):
    """Per-slot plans: frames [B, H, W, 3] with A_h [B, th, H] and A_w
    [B, tw, W] -> uint8 [B, th, tw, 3]; one batched product per axis."""
    from devc_tpu_torch.utils.convert import use_full_fp32

    use_full_fp32()
    x = frames_u8.float()
    x = torch.einsum("bts,bswc->btwc", a_h, x)
    x = torch.einsum("buw,btwc->btuc", a_w, x)
    return _to_u8(x)
