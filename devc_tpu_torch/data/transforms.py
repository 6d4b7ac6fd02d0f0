"""Host-side frame loading: decode, CenterPad, CenterCrop to uint8 RGB, and
the training data path's numpy Lab helpers (mirrors
devc_tpu/data/transforms.py).

CenterPad mirrors the reference's (utils/util_distortion.py:217-258):
resize so the target aspect is filled, with the reference's anti-aliased
float resize (gaussian prefilter, sigma = (factor - 1) / 2 per axis,
mirror boundary, then half-pixel bilinear), truncate to uint8, and
center-crop. A uint8 image takes the C++ kernel (`data/native.py`, built
at first use; ~5x the numpy path), as devc_tpu's does, so the two
packages give the same bits; `resize_antialiased_plain` is the numpy
version of the same float64 arithmetic. Kept in the port so that it runs
with neither JAX nor the JAX package installed. PIL and scipy are
imported where they are used.
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


def resize_antialiased_plain(img: np.ndarray, out_hw) -> np.ndarray:
    """Anti-aliased float64 resize of an [H, W] or [H, W, C] array
    (skimage's resize(anti_aliasing=True, mode='reflect',
    preserve_range=True)), in numpy: the plain version of
    native/resize_aa.cpp."""
    from scipy.ndimage import gaussian_filter

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


def resize_antialiased(img: np.ndarray, out_hw) -> np.ndarray:
    """The same resize; a uint8 image goes through the C++ kernel
    (`data/native.py::resize_aa_native`, which raises if it cannot be
    built), any other dtype through the numpy version (the kernel reads
    uint8 only)."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        from devc_tpu_torch.data.native import resize_aa_native

        return resize_aa_native(arr, out_hw)
    return resize_antialiased_plain(arr, out_hw)


def center_pad_crop(arr: np.ndarray, size) -> np.ndarray:
    """uint8 [H, W(, C)] -> uint8 [th, tw(, C)]: aspect-preserving resize
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


def center_pad(img, size):
    """The reference's CenterPad on a PIL image -> PIL image of (th, tw):
    `center_pad_crop`, whose crop only trims the axis the resize made
    overflow."""
    from PIL import Image

    return Image.fromarray(center_pad_crop(np.asarray(img), size))


def center_crop(arr: np.ndarray, size):
    """Center crop an [H, W(, C)] array to (height, width)."""
    th, tw = size
    h, w = arr.shape[:2]
    top, left = (h - th) // 2, (w - tw) // 2
    return arr[top:top + th, left:left + tw]


# numpy colour helpers of the training data path (the inference path
# converts on the device, `colorspace.py`)
_XYZ_FROM_RGB = np.array([[0.412453, 0.357580, 0.180423],
                          [0.212671, 0.715160, 0.072169],
                          [0.019334, 0.119193, 0.950227]])
_WHITE = np.array([0.95047, 1.0, 1.08883])


def rgb_to_lab_np(rgb_uint8: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> float32 raw Lab (skimage's rgb2lab math)."""
    s = rgb_uint8.astype(np.float64) / 255.0
    lin = np.where(s > 0.04045, ((s + 0.055) / 1.055) ** 2.4, s / 12.92)
    xyz = lin @ _XYZ_FROM_RGB.T / _WHITE
    f = np.where(xyz > 0.008856451679035631, np.cbrt(xyz),
                 7.787 * xyz + 16.0 / 116.0)
    lab_l = 116.0 * f[..., 1] - 16.0
    lab_a = 500.0 * (f[..., 0] - f[..., 1])
    lab_b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([lab_l, lab_a, lab_b], axis=-1).astype(np.float32)


def lab_to_network(lab: np.ndarray) -> np.ndarray:
    """Raw Lab -> network Lab (L centred by -50; the reference's
    Normalize)."""
    out = lab.astype(np.float32).copy()
    out[..., 0] -= 50.0
    return out
