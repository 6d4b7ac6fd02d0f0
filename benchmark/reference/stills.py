"""Frozen plain copy of the training loader's batch for the benchmark's
reference (it imports nothing of the port): devc_tpu_torch/data/
videoloader.py's ImageNetPairsDataset in its device-preprocess form and
PrefetchLoader's batch rule, with data/distortion.py and data/
transforms.py's helpers, each on its numpy path (the forward warp and the
anti-aliased resize that the port runs in C++ are their plain versions).

Batch s of a loader seeded `seed` is a pure function of
RandomState(seed + s) and the stills tree: `batch(root, seed + s, ...)`
rebuilds it from the files alone.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image
from scipy.ndimage import gaussian_filter, map_coordinates


def pairs(root: str) -> list:
    """(dir, subdir, name_a, name_b) in the dataset's order: each listed
    pair both ways; pairs.txt needs a positive score."""
    items = []
    for target in sorted(os.listdir(root)):
        d = os.path.join(root, target)
        if not os.path.isdir(d):
            continue
        for fname, subdir, check_score in (("pairs.txt", "input", True),
                                           ("pairs_mid.txt", "input_mid",
                                            False),
                                           ("pairs_bad.txt", "input_bad",
                                            False)):
            pf = os.path.join(d, fname)
            if not os.path.exists(pf):
                continue
            with open(pf) as f:
                for line in f:
                    pair = line.strip().split(" ")
                    if len(pair) < 2:
                        continue
                    n0, n1 = pair[0].split(".")[0], pair[1].split(".")[0]
                    if check_score and (len(pair) < 3
                                        or float(pair[2]) <= 0):
                        continue
                    items.append((d, subdir, n0, n1))
                    items.append((d, subdir, n1, n0))
    return items


def resize_aa(img, out_hw):
    """skimage's resize(anti_aliasing=True, mode='reflect',
    preserve_range=True) in float64."""
    arr = np.asarray(img, dtype=np.float64)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    fh, fw = arr.shape[0] / oh, arr.shape[1] / ow
    if fh > 1 or fw > 1:
        sigma = [max(0.0, (fh - 1) / 2), max(0.0, (fw - 1) / 2)]
        sigma += [0.0] * (arr.ndim - 2)
        arr = gaussian_filter(arr, sigma, mode="mirror")

    def axis_interp(a, axis, n_out):
        n_in = a.shape[axis]
        src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5,
                      0, n_in - 1)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        shape = [1] * a.ndim
        shape[axis] = n_out
        wgt = (src - lo).reshape(shape)
        return (np.take(a, lo, axis=axis) * (1 - wgt)
                + np.take(a, hi, axis=axis) * wgt)

    return axis_interp(axis_interp(arr, 0, oh), 1, ow)


def center_pad_crop(arr, size):
    th, tw = size
    h, w = arr.shape[:2]
    if h / w == th / tw:
        new_hw = (h, w) if h == th else [int(x * th / h) for x in (h, w)]
    elif h / w > th / tw:
        new_hw = [int(x * tw / w) for x in (h, w)]
    else:
        new_hw = [int(x * th / h) for x in (h, w)]
    if tuple(new_hw) != (h, w):
        arr = resize_aa(arr, new_hw).astype(np.uint8)
    top, left = (arr.shape[0] - th) // 2, (arr.shape[1] - tw) // 2
    return np.ascontiguousarray(arr[top:top + th, left:left + tw])


def center_pad_threshold(img, size, threshold=3 / 4):
    th, tw = size
    w, h = img.size
    if h / w > threshold:
        new_h = int(w * threshold)
        top = (h - new_h) // 2
        return img.crop((0, top, w, top + new_h)).resize((tw, th),
                                                         Image.BILINEAR)
    return Image.fromarray(center_pad_crop(np.asarray(img), size))


def crop_pad(arr, size):
    """Center crop, zero-padding first where smaller."""
    th, tw = size
    h, w = arr.shape[:2]
    if h < th or w < tw:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        pad = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)]
        if arr.ndim == 3:
            pad.append((0, 0))
        arr = np.pad(arr, pad)
    h, w = arr.shape[:2]
    top, left = (h - th) // 2, (w - tw) // 2
    return arr[top:top + th, left:left + tw]


def blur(x, sigma):
    """gaussian_filter(x, sigma, mode="constant"), by FFT convolution with
    its truncated kernel where the kernel is wide."""
    if sigma < 8.0:
        return gaussian_filter(x, sigma, mode="constant", cval=0)
    from scipy.signal import fftconvolve

    r = int(4.0 * sigma + 0.5)
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    return fftconvolve(fftconvolve(x, k[:, None], mode="same"), k[None, :],
                       mode="same")


def elastic_flow(shape, alpha_max, rng, sigma=50.0):
    alpha = rng.rand() * alpha_max
    dx = blur(rng.rand(*shape) * 2 - 1, sigma) * alpha * 1000
    dy = blur(rng.rand(*shape) * 2 - 1, sigma) * alpha * 1000
    return dx.astype(np.float32), dy.astype(np.float32)


def _gather(img, x, y):
    h, w = img.shape[:2]
    x, y = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    wx = (x - x0)[..., None] if img.ndim == 3 else (x - x0)
    wy = (y - y0)[..., None] if img.ndim == 3 else (y - y0)
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
            + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)


def forward_warp(src, u, v, max_iter, precision):
    """The forward-flow warp's fixed-point search (u horizontal, v
    vertical), reflected at the borders."""
    h, w = u.shape
    xr, yr = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    du = np.empty_like(u)
    du[:, :-1] = u[:, 1:] - u[:, :-1]
    du[:, -1] = u[:, -1] - u[:, -2]
    dv = np.empty_like(v)
    dv[:-1, :] = v[1:, :] - v[:-1, :]
    dv[-1, :] = v[-1, :] - v[-2, :]
    i = xr - u / (1.0 + du)
    j = yr - v / (1.0 + dv)
    small = (np.abs(u) < precision) & (np.abs(v) < precision)
    active = ~small
    for _ in range(max_iter):
        act = active & (i >= 0) & (i <= w - 1) & (j >= 0) & (j <= h - 1)
        i_next = xr - _gather(u, i, j)
        j_next = yr - _gather(v, i, j)
        conv = ((np.abs(i - i_next) < precision)
                & (np.abs(j - j_next) < precision))
        i = np.where(act, i_next, i)
        j = np.where(act, j_next, j)
        active = act & ~conv
    i = np.abs(np.where(small, xr, i))
    i = np.clip(np.where(i > w - 1, 2 * (w - 1) - i, i), 0, w - 1)
    j = np.abs(np.where(small, yr, j))
    j = np.clip(np.where(j > h - 1, 2 * (h - 1) - j, j), 0, h - 1)
    out = _gather(src.astype(np.float32), i, j)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def occlusion_mask(i1, i2, flow, threshold=50.0):
    """Warp I2 back by the forward flow: pixels that land outside or
    differ from I1 by more than `threshold` are 0."""
    h, w = i1.shape[:2]
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack(((gy + flow[..., 1]).ravel(),
                       (gx + flow[..., 0]).ravel()))
    i21 = np.stack([map_coordinates(i2[..., c].astype(float), coords,
                                    order=1, cval=-1.0).reshape(h, w)
                    for c in range(3)], axis=-1)
    mask = np.ones((h, w), np.float32)
    mask[(i21 == -1).all(axis=-1)] = 0.0
    mask[np.abs(i21 - i1.astype(float)).sum(axis=-1) > threshold] = 0.0
    return mask[..., None]


def resized_crop(img, size, scale, ratio, rng):
    """torchvision's RandomResizedCrop on a uint8 array, bilinear."""
    h0, w0 = img.shape[:2]
    area = h0 * w0
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        w = int(round(np.sqrt(target * ar)))
        h = int(round(np.sqrt(target / ar)))
        if 0 < w <= w0 and 0 < h <= h0:
            i = rng.randint(0, h0 - h + 1)
            j = rng.randint(0, w0 - w + 1)
            break
    else:
        in_ratio = w0 / h0
        if in_ratio < ratio[0]:
            w, h = w0, min(int(round(w0 / ratio[0])), h0)
        elif in_ratio > ratio[1]:
            h, w = h0, min(int(round(h0 * ratio[1])), w0)
        else:
            w, h = w0, h0
        i, j = (h0 - h) // 2, (w0 - w) // 2
    out = Image.fromarray(img[i:i + h, j:j + w]).resize((size, size),
                                                        Image.BILINEAR)
    return np.asarray(out, dtype=np.uint8)


def item(entry, rng, size, real_p, nonzero_p, distortion=4.0, jitter=5.0):
    """One sample of the ImageNet-pairs dataset, device-preprocess form."""
    d, subdir, name_a, name_b = entry
    path_a = os.path.join(d, subdir, name_a + ".JPEG")
    path_b = os.path.join(d, subdir, name_b + ".JPEG")
    if rng.random_sample() > 0.5:
        path_a, path_b = path_b, path_a
    img_a = Image.open(path_a).convert("RGB")
    i1 = crop_pad(np.asarray(center_pad_threshold(img_a, size), np.uint8),
                  size)
    dx, dy = elastic_flow(size, distortion, rng)
    i2 = forward_warp(i1, dy, dx, max_iter=3, precision=1e-3)
    shift = np.float32(rng.randn() * jitter)
    flow = np.stack((dy, dx), axis=-1).astype(np.float32)
    mask = occlusion_mask(i1, i2, flow)
    if rng.random_sample() < real_p:
        img_b = Image.open(path_b).convert("RGB")
        ref = crop_pad(np.asarray(center_pad_threshold(img_b, size),
                                  np.uint8), size)
        nonzero, flag = False, 0.0
    else:
        raw = np.asarray(img_a, dtype=np.uint8)
        if rng.rand() < 0.5:
            raw = raw[:, ::-1].copy()
        raw = resized_crop(raw, 480, (0.98, 1.0), (0.8, 1.2), rng)
        ref = crop_pad(np.asarray(center_pad_threshold(Image.fromarray(raw),
                                                       size), np.uint8), size)
        nonzero, flag = rng.random_sample() < nonzero_p, 1.0
    f16 = np.clip(flow, -6.0e4, 6.0e4).astype(np.float16)
    return dict(last_rgb=i1, current_rgb=i2, ref_rgb=ref, flow_forward=f16,
                flow_backward=np.zeros_like(f16),
                mask=mask.astype(np.uint8),
                jitter=np.full((1,), shift, np.float32),
                placeholder_flag=np.full((1,), float(nonzero), np.float32),
                self_ref_flag=np.full((1,), flag, np.float32))


def batch(root, rng_seed, batch_size, size, real_p, nonzero_p) -> dict:
    """The loader's batch drawn from RandomState(rng_seed): each row a
    uniform draw over the pairs."""
    entries = pairs(root)
    rng = np.random.RandomState(rng_seed)
    rows = []
    for _ in range(batch_size):
        rows.append(item(entries[rng.randint(len(entries))], rng,
                         tuple(size), real_p, nonzero_p))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
