"""Host-side frame loading: decode, CenterPad, CenterCrop to uint8 RGB.

The same host transforms as devc_tpu/data/transforms.py (which mirror the
reference's CenterPad, utils/util_distortion.py:217-258): resize so the
target aspect is filled, with the reference's anti-aliased float resize
(gaussian prefilter, sigma = (factor - 1) / 2 per axis, mirror boundary,
then half-pixel bilinear), truncate to uint8, and center-crop. Kept in the
port so that it runs with neither JAX nor the JAX package installed; this
is the numpy formulation of devc_tpu's (which also has a C++ path). PIL
and scipy are imported where they are used.
"""

from __future__ import annotations

import os

import numpy as np

FRAME_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def is_video_file(path: str) -> bool:
    """A file whose extension names a video container (decoded by cv2)."""
    return os.path.isfile(path) and path.lower().endswith(VIDEO_EXTS)


def list_clip_frames(clip_dir: str) -> list[str]:
    """Image file names in clip_dir, sorted by the integer their digits
    form (the reference's frame order)."""

    def key(name):
        digits = "".join(ch for ch in name if ch.isdigit())
        return int(digits) if digits else -1

    return sorted((f for f in os.listdir(clip_dir)
                   if f.lower().endswith(FRAME_EXTS)), key=key)


def resize_antialiased(img: np.ndarray, out_hw) -> np.ndarray:
    """Anti-aliased float64 resize of an [H, W, C] array (skimage's
    resize(anti_aliasing=True, mode='reflect', preserve_range=True))."""
    from scipy.ndimage import gaussian_filter

    arr = np.asarray(img, dtype=np.float64)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    fh, fw = arr.shape[0] / oh, arr.shape[1] / ow
    if fh > 1 or fw > 1:
        sigma = [max(0.0, (fh - 1) / 2), max(0.0, (fw - 1) / 2), 0.0]
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


def center_pad_crop(arr: np.ndarray, size) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> uint8 [th, tw, 3]: aspect-preserving resize
    that fills (th, tw) (sizes by int() truncation of the scale, result
    truncated to uint8), then a center crop."""
    th, tw = size
    h, w = arr.shape[:2]
    if h / w == th / tw:
        new_hw = (h, w) if h == th else [int(x * th / h) for x in (h, w)]
    elif h / w > th / tw:  # too tall: match width
        new_hw = [int(x * tw / w) for x in (h, w)]
    else:  # too wide: match height
        new_hw = [int(x * th / h) for x in (h, w)]
    if tuple(new_hw) != (h, w):
        arr = resize_antialiased(arr, new_hw).astype(np.uint8)
    top = (arr.shape[0] - th) // 2
    left = (arr.shape[1] - tw) // 2
    return np.ascontiguousarray(arr[top:top + th, left:left + tw])


def centerpad_np(arr_u8: np.ndarray, size) -> np.ndarray:
    """CenterPad + CenterCrop of a decoded uint8 RGB array (a video
    frame): the same transform `load_frame_rgb` applies to a file."""
    return center_pad_crop(np.asarray(arr_u8, dtype=np.uint8), size)


def read_rgb(path: str) -> np.ndarray:
    """Decode an image file -> uint8 RGB [H, W, 3], as stored."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def load_frame_rgb(path: str, size) -> np.ndarray:
    """Decode an image file -> uint8 RGB [th, tw, 3], center-padded."""
    return center_pad_crop(read_rgb(path), size)
