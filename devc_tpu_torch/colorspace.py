"""Color-space conversions on tensors (NHWC, mirrors devc_tpu/colorspace.py).

The network works in a shifted CIELAB space: L is centered by -50 so L is
in [-50, 50]; a and b are raw, roughly in [-128, 128]. RGB <-> Lab follows
the sRGB / D65 definitions; `lab_to_rgb` keeps the reference converter's
z-clamp and final clip, because its output feeds the frozen VGG network.
All functions take and return float tensors with channels last.
"""

from __future__ import annotations

import functools

import torch

L_MEAN = 50.0

_XYZ_FROM_RGB = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_RGB_FROM_XYZ = (
    (3.24048134, -1.53715152, -0.49853633),
    (-0.96925495, 1.87599, 0.04155593),
    (0.05564664, -0.20404134, 1.05731107),
)
_WHITE = (0.95047, 1.0, 1.08883)
# Caffe-VGG BGR channel means
_VGG_BGR_MEAN = (0.40760392, 0.45795686, 0.48501961)


@functools.lru_cache(maxsize=None)
def _const_on(values, dtype, device) -> torch.Tensor:
    with torch.inference_mode(False):  # usable inside and outside it
        return torch.tensor(values, dtype=dtype, device=device)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """A small constant on `like`'s device, uploaded once per device/dtype
    (a frame step then copies nothing to the device but its frame)."""
    return _const_on(values, like.dtype, like.device)


def center_l(l):
    """L in [0, 100] -> centered L in [-50, 50]."""
    return l - L_MEAN


def uncenter_l(l):
    """Centered L -> L in [0, 100]."""
    return l + L_MEAN


def center_lab(lab):
    """Raw Lab (L in [0, 100]) -> network Lab (L centered)."""
    return lab - _const((L_MEAN, 0.0, 0.0), lab)


def uncenter_lab(lab):
    """Network Lab -> raw Lab (L in [0, 100])."""
    return lab + _const((L_MEAN, 0.0, 0.0), lab)


def srgb_to_linear(s):
    return torch.where(s > 0.04045, ((s + 0.055) / 1.055) ** 2.4, s / 12.92)


def _lab_f(t):
    safe = torch.clamp(t, min=1e-12)
    return torch.where(t > 0.008856451679035631, torch.pow(safe, 1.0 / 3.0),
                       7.787 * t + 16.0 / 116.0)


def rgb_to_lab(rgb):
    """sRGB in [0, 1] -> raw CIELAB (L in [0, 100], ab ~ [-128, 128])."""
    lin = srgb_to_linear(rgb)
    xyz = lin @ _const(_XYZ_FROM_RGB, lin).T
    f = _lab_f(xyz / _const(_WHITE, lin))
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack(
        [116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1
    )


def lab_to_rgb(lab):
    """Raw CIELAB -> sRGB in [0, 1], with z clamped at 0 before the cube
    and the result clipped, as the reference's device converter does."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = (L + 16.0) / 116.0
    x = a / 500.0 + y
    z = torch.clamp(y - b / 200.0, min=0.0)
    f = torch.stack([x, y, z], dim=-1)
    f3 = torch.clamp(f, min=1e-12) ** 3.0
    xyz = torch.where(f > 0.2068966, f3, (f - 16.0 / 116.0) / 7.787)
    xyz = xyz * _const(_WHITE, lab)
    rgb_lin = xyz @ _const(_RGB_FROM_XYZ, lab).T
    srgb = torch.where(
        rgb_lin > 0.0031308,
        1.055 * torch.clamp(rgb_lin, min=1e-12) ** (1.0 / 2.4) - 0.055,
        rgb_lin * 12.92,
    )
    return torch.clamp(srgb, 0.0, 1.0)


def lab_centered_to_rgb(lab_centered):
    """Network Lab (centered L) -> sRGB in [0, 1]."""
    return lab_to_rgb(uncenter_lab(lab_centered))


def gray_to_rgb(l_centered):
    """Centered L [..., 1] -> pseudo-RGB [..., 3] in [0, 1]."""
    l01 = uncenter_l(l_centered) / (2.0 * L_MEAN)
    return torch.cat([l01, l01, l01], dim=-1)


def vgg_preprocess(rgb):
    """RGB in [0, 1] -> Caffe-style mean-subtracted BGR * 255."""
    return (rgb.flip(-1) - _const(_VGG_BGR_MEAN, rgb)) * 255.0


def feature_normalize(feat, dim: int = -1, eps: float = 2.220446049250313e-16):
    """L2-normalize along `dim`, with eps added to the norm (not under the
    square root), as the reference does. The norm is taken in fp32 (fp64
    for fp64 input)."""
    norm = torch.linalg.vector_norm(
        feat.to(torch.promote_types(feat.dtype, torch.float32)), ord=2,
        dim=dim, keepdim=True)
    return feat / (norm.to(feat.dtype) + eps)
