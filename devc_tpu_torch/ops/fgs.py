"""Fast Global Smoother: edge-aware smoothing of the predicted ab channels
(mirrors devc_tpu/ops/fgs.py).

Min et al. 2014, "Fast Global Image Smoothing Based on Weighted Least
Squares": T alternating horizontal and vertical 1-D weighted-least-squares
passes, each a batch of tridiagonal solves. Per iteration t = 1..T,
lambda_t = 1.5 lam 4^(T-t) / (4^T - 1), and the neighbour weights are
w = exp(-|g_i - g_j| / sigma_color) on the guide (luminance in [0, 255]).

Kernel K2 (`csrc/tridiag_pcr.cu`, replacing
devc_tpu/ops/fgs.py::_tridiag_pcr_pallas) has two entries:
  * `smooth_pass`: one whole pass on [H, W, 2], or on a batch [B, H, W, 2]
    with a guide per image or one shared guide, in one launch
    (coefficients from the guide, both channels, rows or columns in
    place). CUDA tensors launch it; CPU tensors take its plain version,
    `_smooth_axis` with the plain PCR. `fast_global_smoother` is six of
    these, whatever B is.
  * `tridiag_pcr`: the general solve of [B, L] systems, coefficients
    given (plain versions `_tridiag_pcr`, `_tridiag_thomas`).
"""

from __future__ import annotations

import torch

from devc_tpu_torch.utils.build import check, load_kernels


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


def _tridiag_thomas(a, b, c, d):
    """Plain Thomas algorithm on [B, L] systems (L sequential steps)."""
    a, b, c, d = (t.float() for t in (a, b, c, d))
    length = a.shape[-1]
    cp = torch.zeros_like(b)
    dp = torch.zeros_like(b)
    cp_prev = torch.zeros_like(b[:, 0])
    dp_prev = torch.zeros_like(b[:, 0])
    for i in range(length):
        denom = b[:, i] - a[:, i] * cp_prev
        cp_prev = c[:, i] / denom
        dp_prev = (d[:, i] - a[:, i] * dp_prev) / denom
        cp[:, i] = cp_prev
        dp[:, i] = dp_prev
    x = torch.empty_like(b)
    x_next = torch.zeros_like(b[:, 0])
    for i in range(length - 1, -1, -1):
        x_next = dp[:, i] - cp[:, i] * x_next
        x[:, i] = x_next
    return x


MAX_LEN = 4096  # the longest system K2 takes: 8 unknowns x 512 threads


def tridiag_pcr(a, b, c, d):
    """Kernel K2's general entry on the card: solve [B, L] systems (PCR
    steps, then Thomas per thread; see csrc/tridiag_pcr.cu). Takes CUDA
    tensors only (fp32, contiguous, one shape, L <= MAX_LEN): launches or
    raises. `tridiag_pcr.launches` counts its launches."""
    for name, t in (("a", a), ("b", b), ("c", c), ("d", d)):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"tridiag_pcr: {name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"tridiag_pcr: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"tridiag_pcr: {name} must be contiguous")
        if t.dim() != 2 or t.shape != a.shape or t.device != a.device:
            raise ValueError("tridiag_pcr: a, b, c, d must share one [B, L] "
                             "shape and device")
    n_sys, length = a.shape
    if n_sys == 0 or not 0 < length <= MAX_LEN:
        raise ValueError(f"tridiag_pcr: systems of length 1..{MAX_LEN}, "
                         f"got {n_sys} of length {length}")
    lib = load_kernels()
    x = torch.empty_like(d)
    with torch.cuda.device(a.device):
        code = lib.devc_tridiag_pcr(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            x.data_ptr(), n_sys, length,
            torch.cuda.current_stream().cuda_stream,
        )
    check(code, "tridiag_pcr")
    tridiag_pcr.launches += 1
    return x


tridiag_pcr.launches = 0


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


def smooth_pass(src, guide, lam_t: float, sigma_color: float, axis: int):
    """One WLS pass of the smoother: src [H, W, 2] or [B, H, W, 2], guide
    [H, W] (shared by every image) or [B, H, W] (one per image) -> src's
    shape, fp32. axis 1 runs the systems along W (one per row), axis 0
    along H (one per column).

    CUDA tensors launch kernel K2 once for the whole batch (fp32,
    contiguous, one device) or raise; CPU tensors take the plain version.
    `smooth_pass.launches` counts the launches."""
    if axis not in (0, 1):
        raise ValueError(f"smooth_pass: axis must be 0 or 1, got {axis}")
    if src.device.type == "cpu" and guide.device.type == "cpu":
        return smooth_pass_plain(src, guide, lam_t, sigma_color, axis)
    if src.device.type != "cuda" or guide.device != src.device:
        raise ValueError("smooth_pass: src and guide must be on one CUDA "
                         f"device or both on the CPU, got {src.device} and "
                         f"{guide.device}")
    src4, guide3, _ = _batch_form(src, guide, "smooth_pass")
    if src4.shape[3] != 2:
        raise ValueError(f"smooth_pass: src needs 2 channels, got "
                         f"{tuple(src.shape)}")
    for name, t in (("src", src), ("guide", guide)):
        if t.dtype != torch.float32:
            raise TypeError(f"smooth_pass: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"smooth_pass: {name} must be contiguous and "
                             "8-byte aligned")
    batch, h, w = src4.shape[:3]
    if batch == 0 or batch > 65535:
        raise ValueError(f"smooth_pass: 1..65535 images, got {batch}")
    if h == 0 or w == 0 or (h if axis == 0 else w) > MAX_LEN:
        raise ValueError(f"smooth_pass: systems of length 1..{MAX_LEN}, got "
                         f"{h if axis == 0 else w}")
    lib = load_kernels()
    out = torch.empty_like(src)
    with torch.cuda.device(src.device):
        code = lib.devc_smooth_pass(
            src.data_ptr(), guide.data_ptr(), out.data_ptr(), batch, h, w,
            axis, h * w if guide.dim() == 3 else 0,
            float(lam_t), float(sigma_color),
            torch.cuda.current_stream().cuda_stream)
    check(code, "smooth_pass")
    smooth_pass.launches += 1
    return out


smooth_pass.launches = 0


# the reference's WLS settings (lambda, sigma_color) and OpenCV's
# default number of iterations
LAMBDA = 500.0
SIGMA_COLOR = 4.0
NUM_ITER = 3


def fast_global_smoother(src, guide):
    """Edge-aware smoothing of src [H, W, C] or [B, H, W, C] guided by
    guide [H, W] (shared) or [B, H, W] (one per image), in [0, 255].
    Returns src's shape, fp32. Each iteration is one row pass and one
    column pass (`smooth_pass`): on the card six launches of K2 and
    nothing else, for C = 2 and any B."""
    out = src.float().contiguous()
    guide = guide.float().contiguous()
    denom = 4.0 ** NUM_ITER - 1.0
    for t in range(1, NUM_ITER + 1):
        lam_t = 1.5 * LAMBDA * (4.0 ** (NUM_ITER - t)) / denom
        out = smooth_pass(out, guide, lam_t, SIGMA_COLOR, axis=1)
        out = smooth_pass(out, guide, lam_t, SIGMA_COLOR, axis=0)
    return out
