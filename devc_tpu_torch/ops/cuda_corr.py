"""Wrappers for the correspondence kernels and their autograd Function.

  * `corr_fwd`: K1 (`csrc/corr_fwd.cu`), replaces devc_tpu/ops/
    pallas_corr.py::_corr_fwd_kernel. Plain version:
    `correspondence.correspondence_warp_einsum` (and, emitting l,
    `correspondence.correspondence_fwd_plain`).
  * `corr_bwd_dq`, `corr_bwd_dkv`: K2b and K3 (`csrc/corr_bwd.cu`), replace
    pallas_corr.py::_corr_dq_kernel and ::_corr_dkv_kernel. `corr_bwd`
    runs both after forming D = rowsum(dout * out) with a torch op, as JAX
    does. Plain version: `correspondence.correspondence_bwd_plain`.
  * `CorrFunction`: K1 forward (emitting l) and the two backward kernels
    as one `torch.autograd.Function`, the counterpart of devc_tpu's
    custom VJP (`_corr_pallas_diff`). On CPU tensors it runs the plain
    versions of the same three functions.

The kernel wrappers take CUDA tensors only: each launches its kernel or
raises. Each counts its launches in `.launches`. `corr_fwd` refuses inputs
that require grad while grad mode is on: its outputs have no grad_fn, and
returning them would cut the gradient silently.
"""

from __future__ import annotations

import torch

from devc_tpu_torch.ops.correspondence import (
    correspondence_bwd_plain,
    correspondence_fwd_plain,
)
from devc_tpu_torch.utils.build import check, load_kernels

_TQ, _TK = 64, 128  # K1's query rows per block and keys per tile
_TB = 64  # the backward kernels' rows per tile, both sides
_BLOCKS_PER_SM = 3  # what fits an SM at the kernel's register use


def _key_splits(b: int, nq: int, nk: int, device) -> int:
    """Key ranges per query tile: enough blocks for about _BLOCKS_PER_SM
    on every SM (few query tiles at N = 5184), never an empty range."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_blocks = b * -(-nq // _TQ)
    return max(1, min(-(-nk // _TK), -(-_BLOCKS_PER_SM * sms // q_blocks)))


def _check_input(name, t, shape, fn="corr_fwd", device=None):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                         "aligned")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{fn}: inputs must be on one device")


def corr_fwd(theta, phi, values, temperature: float, emit_l: bool = False):
    """Fused correlation, online softmax and warp on the card.

    theta [B, Nq, C], phi [B, Nk, C], values [B, Nk, 3]: fp32, contiguous,
    on one CUDA device, C a multiple of 32. Returns out [B, Nq, 3], sim
    [B, Nq, 1] (the row max) and, with emit_l, the softmax denominator
    l [B, Nq, 1] relative to that max (else None).
    """
    if theta.dim() != 3 or phi.dim() != 3 or values.dim() != 3:
        raise ValueError("corr_fwd: theta, phi, values must be [B, N, C]")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (theta, phi, values)):
        raise RuntimeError(
            "corr_fwd: an input requires grad, but the kernel's outputs have "
            "no grad_fn; use correspondence_warp(..., differentiable=True) "
            "or CorrFunction")
    b, nq, c = theta.shape
    nk = phi.shape[1]
    if c % 32:
        raise ValueError(f"corr_fwd: channels must be a multiple of 32, got {c}")
    if nq == 0 or nk == 0:
        raise ValueError("corr_fwd: empty query or key set")
    _check_input("theta", theta, (b, nq, c))
    _check_input("phi", phi, (b, nk, c), device=theta.device)
    _check_input("values", values, (b, nk, 3), device=theta.device)

    lib = load_kernels()
    dev = theta.device
    out = torch.empty((b, nq, 3), dtype=torch.float32, device=dev)
    sim = torch.empty((b, nq, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, nq, 1), dtype=torch.float32, device=dev) if emit_l else None
    splits = _key_splits(b, nq, nk, dev)
    # per key range: the partial (m, l, acc[3]) of every row, merged after
    part = (torch.empty((splits, b, nq, 5), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    with torch.cuda.device(dev):
        code = lib.devc_corr_fwd(
            theta.data_ptr(), phi.data_ptr(), values.data_ptr(),
            out.data_ptr(), sim.data_ptr(),
            l.data_ptr() if emit_l else None,
            part.data_ptr() if part is not None else None,
            b, nq, nk, c, splits, float(1.0 / temperature),
            torch.cuda.current_stream().cuda_stream,
        )
    check(code, "corr_fwd")
    corr_fwd.launches += 1
    return out, sim, l


corr_fwd.launches = 0


def _reduction_splits(blocks: int, tiles: int, device) -> int:
    """Splits of the reduction axis for a backward kernel: one block fits
    an SM, so take the split count (at most 8) that needs the fewest waves
    per unit of work, the smaller on a tie."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    best, best_cost = 1, None
    for s in range(1, min(8, tiles) + 1):
        cost = -(-blocks * s // sms) / s
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _bwd_inputs(fn, theta, phi, values, m, l, dd, d_sim, d_out):
    """Check the backward kernels' inputs; returns (b, nq, nk, c)."""
    if theta.dim() != 3 or phi.dim() != 3:
        raise ValueError(f"{fn}: theta, phi must be [B, N, C]")
    b, nq, c = theta.shape
    nk = phi.shape[1]
    if c % 64 or c > 256:
        raise ValueError(f"{fn}: channels must be a multiple of 64 and at "
                         f"most 256, got {c}")
    if nq == 0 or nk == 0:
        raise ValueError(f"{fn}: empty query or key set")
    dev = theta.device
    for name, t, shape in (("theta", theta, (b, nq, c)), ("phi", phi, (b, nk, c)),
                           ("values", values, (b, nk, 3)),
                           ("m", m, (b, nq, 1)), ("l", l, (b, nq, 1)),
                           ("dd", dd, (b, nq, 1)), ("d_sim", d_sim, (b, nq, 1)),
                           ("d_out", d_out, (b, nq, 3))):
        _check_input(name, t, shape, fn, dev)
    return b, nq, nk, c


def corr_bwd_dq(theta, phi, values, m, l, dd, d_sim, d_out,
                temperature: float):
    """K2b: dtheta [B, Nq, C] = sum over keys of df * phi, df recomputed
    from K1's row max m and denominator l (see csrc/corr_bwd.cu). All
    inputs fp32, contiguous, on one CUDA device; m, l, dd (= rowsum(d_out
    * out)), d_sim are [B, Nq, 1]."""
    b, nq, nk, c = _bwd_inputs("corr_bwd_dq", theta, phi, values, m, l, dd,
                               d_sim, d_out)
    lib = load_kernels()
    dev = theta.device
    dtheta = torch.empty_like(theta)
    splits = _reduction_splits(b * -(-nq // _TB), -(-nk // _TB), dev)
    part = (torch.empty((splits, b, nq, c), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    with torch.cuda.device(dev):
        code = lib.devc_corr_bwd_dq(
            theta.data_ptr(), phi.data_ptr(), values.data_ptr(),
            m.data_ptr(), l.data_ptr(), dd.data_ptr(), d_sim.data_ptr(),
            d_out.data_ptr(), dtheta.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, nq, nk, c, splits, float(1.0 / temperature),
            torch.cuda.current_stream().cuda_stream)
    check(code, "corr_bwd_dq")
    corr_bwd_dq.launches += 1
    return dtheta


def corr_bwd_dkv(theta, phi, values, m, l, dd, d_sim, d_out,
                 temperature: float):
    """K3: dphi [B, Nk, C] = sum over queries of df^T theta and dvalues
    [B, Nk, 3] = attn^T d_out; inputs as corr_bwd_dq."""
    b, nq, nk, c = _bwd_inputs("corr_bwd_dkv", theta, phi, values, m, l, dd,
                               d_sim, d_out)
    lib = load_kernels()
    dev = theta.device
    dphi = torch.empty_like(phi)
    dvalues = torch.empty_like(values)
    splits = _reduction_splits(b * -(-nk // _TB), -(-nq // _TB), dev)
    part = (torch.empty((splits, b, nk, c + 3), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    with torch.cuda.device(dev):
        code = lib.devc_corr_bwd_dkv(
            theta.data_ptr(), phi.data_ptr(), values.data_ptr(),
            m.data_ptr(), l.data_ptr(), dd.data_ptr(), d_sim.data_ptr(),
            d_out.data_ptr(), dphi.data_ptr(), dvalues.data_ptr(),
            part.data_ptr() if part is not None else None,
            b, nq, nk, c, splits, float(1.0 / temperature),
            torch.cuda.current_stream().cuda_stream)
    check(code, "corr_bwd_dkv")
    corr_bwd_dkv.launches += 1
    return dphi, dvalues


corr_bwd_dq.launches = 0
corr_bwd_dkv.launches = 0


def corr_bwd(theta, phi, values, sim, l, out, d_out, d_sim,
             temperature: float):
    """Gradients (dtheta, dphi, dvalues) of K1's (out, sim) on the card:
    D = rowsum(d_out * out) as a torch op, then K2b and K3."""
    dd = (d_out * out).sum(dim=-1, keepdim=True)
    args = (theta, phi, values, sim, l, dd, d_sim, d_out, temperature)
    return (corr_bwd_dq(*args), *corr_bwd_dkv(*args))


class CorrFunction(torch.autograd.Function):
    """(out, sim) of the correspondence with the custom backward of
    devc_tpu's `_corr_pallas_diff`: residuals theta, phi, values, the row
    max m, the denominator l and out (all O(N C)); the backward recomputes
    attention tile by tile and routes d_sim to every exact tie of the row
    max. CUDA tensors run K1, K2b and K3; CPU tensors their plain
    versions. Call as CorrFunction.apply(theta, phi, values, temperature).
    """

    @staticmethod
    def forward(ctx, theta, phi, values, temperature: float):
        if theta.device.type == "cuda":
            out, sim, l = corr_fwd(theta, phi, values, temperature,
                                   emit_l=True)
        else:
            out, sim, l = correspondence_fwd_plain(theta, phi, values,
                                                   temperature)
        ctx.save_for_backward(theta, phi, values, sim, l, out)
        ctx.temperature = temperature
        return out, sim

    @staticmethod
    def backward(ctx, d_out, d_sim):
        theta, phi, values, sim, l, out = ctx.saved_tensors
        d_out, d_sim = d_out.contiguous(), d_sim.contiguous()
        bwd = corr_bwd if theta.device.type == "cuda" else \
            correspondence_bwd_plain
        dtheta, dphi, dvalues = bwd(theta, phi, values, sim, l, out, d_out,
                                    d_sim, ctx.temperature)
        return dtheta, dphi, dvalues, None
