"""Training-time augmentations (mirrors devc_tpu/data/distortion.py;
reference utils/util_distortion.py).

Synthetic "video" generation from stills: smooth random elastic flow
fields, forward-flow warping (the host C++ kernel, `data/native.py`),
photoconsistency masks, brightness jitter, random erasing, gaussian
luminance noise. numpy and scipy on the host: every draw comes from the
caller's `RandomState`, in devc_tpu's order, so one seed gives the same
sample in both packages.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates

from devc_tpu_torch.data.native import forward_warp


def _gaussian_blur_constant(x: np.ndarray, sigma: float) -> np.ndarray:
    """gaussian_filter(x, sigma, mode="constant", cval=0), computed by FFT
    convolution with scipy's exact truncated discrete kernel.

    Identical operator (zero-padded separable convolution with the
    truncate=4 sampled gaussian), so results match scipy.ndimage to fp
    rounding (~1e-12 relative) — but O(N log N) instead of O(N·sigma):
    at the loader's sigma=50 the direct path is ~80 ms per 216x384 field
    and dominates sample synthesis; the FFT path is ~2 ms.
    """
    if sigma < 8.0:  # small kernels: direct separable conv is faster
        return gaussian_filter(x, sigma, mode="constant", cval=0)
    from scipy.signal import fftconvolve

    r = int(4.0 * sigma + 0.5)
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    x = fftconvolve(x, k[:, None], mode="same")
    return fftconvolve(x, k[None, :], mode="same")


def random_elastic_flow(
    shape, alpha_max: float = 3.0, sigma: float = 50.0, rng=None
):
    """Smooth random flow field pair (dx vertical, dy horizontal), the
    synthetic-video distortion of the ImageNet loader
    (reference lib/videoloader_imagenet.py:204-217)."""
    rng = rng or np.random.RandomState(None)
    alpha = rng.rand() * alpha_max
    dx = _gaussian_blur_constant(rng.rand(*shape) * 2 - 1, sigma) * alpha * 1000
    dy = _gaussian_blur_constant(rng.rand(*shape) * 2 - 1, sigma) * alpha * 1000
    return dx.astype(np.float32), dy.astype(np.float32)


def distort_with_flow(img_u8: np.ndarray, dx: np.ndarray, dy: np.ndarray):
    """Forward-warp an image by (dx vertical, dy horizontal)
    (reference Distortion_with_flow, utils/util_distortion.py:70-82,
    which calls forward_mapping(inputs, u=dy, v=dx))."""
    return forward_warp(img_u8, dy, dx, max_iter=3, precision=1e-3)


def elastic_distort_backward(img_u8: np.ndarray, distortion_level: float = 3.0,
                             rng=None):
    """Backward-mapping elastic distortion (reference Distortion,
    utils/util_distortion.py:42-67: cv2.remap with a smoothed random
    displacement field)."""
    rng = rng or np.random.RandomState(None)
    h, w = img_u8.shape[:2]
    dx, dy = random_elastic_flow((h, w), distortion_level, rng=rng)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack(((gy + dx).ravel(), (gx + dy).ravel()))
    out = np.stack(
        [
            map_coordinates(img_u8[..., c].astype(np.float32), coords,
                            order=1, mode="constant").reshape(h, w)
            for c in range(img_u8.shape[2])
        ],
        axis=-1,
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def backward_warp_np(img: np.ndarray, flow_hw2: np.ndarray, cval=-1.0):
    """Backward warp by per-pixel flow [H,W,2] (u horizontal, v vertical)
    with constant fill, matching the loader's map_coordinates usage
    (reference lib/videoloader_imagenet.py:239-252)."""
    h, w = img.shape[:2]
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    loc_x = (gy + flow_hw2[..., 1]).ravel()  # row coordinate
    loc_y = (gx + flow_hw2[..., 0]).ravel()  # col coordinate
    chans = []
    for c in range(img.shape[2]):
        chans.append(
            map_coordinates(img[..., c].astype(float),
                            np.stack((loc_x, loc_y)), order=1, cval=cval
                            ).reshape(h, w)
        )
    return np.stack(chans, axis=-1)


def occlusion_mask(i1_rgb: np.ndarray, i2_rgb: np.ndarray, flow_forward: np.ndarray,
                   threshold: float = 50.0):
    """Round-trip photoconsistency mask (reference
    lib/videoloader_imagenet.py:238-259): warp I2 back by the forward flow;
    pixels landing outside or differing from I1 by > threshold get mask 0.
    Returns float32 [H, W, 1]."""
    i21 = backward_warp_np(i2_rgb.astype(float), flow_forward, cval=-1.0)
    mask = np.ones(i1_rgb.shape[:2], np.float32)
    outside = (i21[..., 0] == -1) & (i21[..., 1] == -1) & (i21[..., 2] == -1)
    mask[outside] = 0.0
    mask[np.abs(i21 - i1_rgb.astype(float)).sum(axis=-1) > threshold] = 0.0
    return mask[..., None]


def binary_mask_from_image(mask_u8: np.ndarray, threshold: int = 240):
    """Occlusion mask file -> binary {0,1}
    (reference lib/videoloader.py:238-241)."""
    return (mask_u8 >= threshold).astype(np.float32)


def gaussian_luminance_noise(lab: np.ndarray, sigma: float = 0.1, rng=None):
    """Per-pixel gaussian noise on L (reference Guassian_noise,
    utils/util_distortion.py:26-39)."""
    rng = rng or np.random.RandomState(None)
    out = lab.copy()
    out[..., 0] += rng.randn(*lab.shape[:2]) * sigma
    return out


def random_erasing(img_u8: np.ndarray, probability: float = 0.6,
                   sl: float = 0.05, sh: float = 0.6, rng=None):
    """Random-noise rectangle erasing (reference RandomErasing,
    utils/util_distortion.py:103-140)."""
    rng = rng or np.random.RandomState(None)
    if rng.uniform(0, 1) > probability:
        return img_u8
    h0, w0, c = img_u8.shape
    h = int(round(rng.uniform(sl, sh) * h0))
    w = int(round(rng.uniform(sl, sh) * w0))
    if h < h0 and w < w0 and h > 0 and w > 0:
        x1 = rng.randint(0, h0 - h + 1)
        y1 = rng.randint(0, w0 - w + 1)
        out = img_u8.copy()
        out[x1 : x1 + h, y1 : y1 + w] = (rng.rand(h, w, c) * 255).astype(
            img_u8.dtype
        )
        return out
    return img_u8


def random_horizontal_flip(img_u8: np.ndarray, p: float = 0.5, rng=None):
    rng = rng or np.random.RandomState(None)
    if rng.rand() < p:
        return img_u8[:, ::-1].copy()
    return img_u8


def random_resized_crop(
    img_u8: np.ndarray,
    size: int = 480,
    scale=(0.98, 1.0),
    ratio=(0.8, 1.2),
    rng=None,
):
    """Random crop of random area/aspect, resized to size x size.

    Mirrors torchvision RandomResizedCrop as used for the self-reference
    exemplar (reference train.py:251-254): sample an area fraction in
    `scale` and a log-uniform aspect ratio in `ratio`, crop, then resize to
    (size, size) bilinear. Falls back to a clamped center crop after 10
    failed attempts.
    """
    from PIL import Image as _Image

    rng = rng or np.random.RandomState(None)
    h0, w0 = img_u8.shape[:2]
    area = h0 * w0
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * ar)))
        h = int(round(np.sqrt(target_area / ar)))
        if 0 < w <= w0 and 0 < h <= h0:
            i = rng.randint(0, h0 - h + 1)
            j = rng.randint(0, w0 - w + 1)
            break
    else:
        # center-crop fallback, aspect clamped to the ratio range
        in_ratio = w0 / h0
        if in_ratio < ratio[0]:
            w, h = w0, min(int(round(w0 / ratio[0])), h0)
        elif in_ratio > ratio[1]:
            h, w = h0, min(int(round(h0 * ratio[1])), w0)
        else:
            w, h = w0, h0
        i = (h0 - h) // 2
        j = (w0 - w) // 2
    crop = img_u8[i : i + h, j : j + w]
    out = _Image.fromarray(crop).resize((size, size), _Image.BILINEAR)
    return np.asarray(out, dtype=np.uint8)
