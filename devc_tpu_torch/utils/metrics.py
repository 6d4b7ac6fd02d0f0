"""Image and video quality metrics: PSNR, SSIM, flow-warped temporal error
(the port's own copy of devc_tpu/utils/metrics.py, in PyTorch).

Each function takes uint8 or float images (numpy arrays or tensors,
channels last) and computes on `device`: in float64 on the CPU and in
float32 on the card, where the port scores a run's frames (cli.evaluate,
chip_smoke.py's bf16 phase). The definitions are devc_tpu's:

  * `psnr`: 10 log10(range^2 / MSE); identical images give inf;
  * `ssim`: mean SSIM (Wang et al. 2004) over 11-tap Gaussian windows
    (sigma 1.5, truncate 3.5), separable, with edge-replicated borders;
    colour images average their channels;
  * `warp_backward`: out[y, x] = img[y + v, x + u], bilinear, zero
    outside the frame (the reference's WarpingLayer sampling);
  * `temporal_warp_error`: the mean over t of the (masked) RMSE between
    frame t and frame t + 1 warped back to t by the forward flow t -> t+1
    (no flows: zero flow).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from devc_tpu_torch.utils.convert import checked_device


def _dtype(device: torch.device) -> torch.dtype:
    return torch.float64 if device.type == "cpu" else torch.float32


def _on(x, device: torch.device) -> torch.Tensor:
    """x (numpy or tensor) as a float tensor on device (fp64 on the CPU,
    fp32 on the card)."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # torch.from_numpy wants a writable array
            x = x.copy()
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=_dtype(device))


def psnr(a, b, data_range: float = 255.0, device="cpu") -> float:
    """Peak signal-to-noise ratio in dB. Identical images -> inf."""
    device = checked_device(device)
    a, b = _on(a, device), _on(b, device)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    mse = float(((a - b) ** 2).mean())
    if mse == 0:
        return float("inf")
    return float(10.0 * math.log10(data_range * data_range / mse))


def _gaussian_kernel1d(sigma: float, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter_sep(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable filter of planes [P, H, W] with edge-replicate padding."""
    r = k.numel() // 2
    x = img[:, None]
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), k.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), k.view(1, 1, 1, -1))
    return x[:, 0]


def ssim(a, b, data_range: float = 255.0, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03, device="cpu") -> float:
    """Mean SSIM with Gaussian windows, of grayscale [H, W] or colour
    [H, W, C] images (the channels' mean)."""
    device = checked_device(device)
    a, b = _on(a, device), _on(b, device)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    # one plane per channel: [C, H, W]
    a = a[None] if a.dim() == 2 else a.permute(2, 0, 1)
    b = b[None] if b.dim() == 2 else b.permute(2, 0, 1)
    k = torch.as_tensor(_gaussian_kernel1d(sigma), dtype=a.dtype,
                        device=device)
    mu_a, mu_b = _filter_sep(a, k), _filter_sep(b, k)
    va = _filter_sep(a * a, k) - mu_a * mu_a
    vb = _filter_sep(b * b, k) - mu_b * mu_b
    vab = _filter_sep(a * b, k) - mu_a * mu_b
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * vab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)
    return float((num / den).mean(dim=(1, 2)).mean())


def warp_backward(img, flow, device="cpu") -> torch.Tensor:
    """Bilinear backward warp: out[y, x] = img[y + v, x + u], zero outside
    the frame. img [H, W] or [H, W, C]; flow [H, W, 2] (u horizontal, v
    vertical, in pixels). Returns a tensor on device."""
    device = checked_device(device)
    img, flow = _on(img, device), _on(flow, device)
    h, w = img.shape[:2]
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=img.dtype),
                            torch.arange(w, device=device, dtype=img.dtype),
                            indexing="ij")
    sx, sy = xx + flow[..., 0], yy + flow[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    out = torch.zeros_like(img)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            px = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            out = out + px * (wgt[..., None] if img.dim() == 3 else wgt)
    return out


def temporal_warp_error(frames, flows=None, masks=None, device="cpu") -> float:
    """Mean masked RMSE between frame t and frame t + 1 warped back to t.

    frames: T >= 2 images [H, W, C]; flows: optional T - 1 forward flows
    t -> t+1 ([H, W, 2], (u, v)); without them a zero flow (raw frame
    differences). masks: optional occlusion masks (1 = valid), [H, W] or
    [H, W, C]. Lower is more stable."""
    device = checked_device(device)
    if len(frames) < 2:
        raise ValueError("need at least two frames")
    errs = []
    for t in range(len(frames) - 1):
        nxt = _on(frames[t + 1], device)
        warped = (warp_backward(nxt, flows[t], device) if flows is not None
                  else nxt)
        diff2 = (warped - _on(frames[t], device)) ** 2
        if masks is not None:
            m = _on(masks[t], device)
            if m.dim() == diff2.dim() - 1:
                m = m[..., None]
            denom = max(float(m.sum()) * diff2.shape[-1], 1.0)
            errs.append(math.sqrt(float((diff2 * m).sum()) / denom))
        else:
            errs.append(math.sqrt(float(diff2.mean())))
    return float(np.mean(errs))
