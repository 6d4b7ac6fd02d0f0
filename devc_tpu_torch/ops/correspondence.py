"""Dense correspondence: correlation -> (row max, softmax) -> colour warp.

Mirrors devc_tpu/ops/correspondence.py. For N = (H/4)(W/4) positions, the
N x N cosine scores between the frame's embedding (theta) and the
exemplar's (phi) give a confidence map (the row max) and, through a
temperature softmax, warp the exemplar's Lab onto the frame.

  * `correspondence_warp_einsum` is the plain PyTorch version: it builds the
    whole score matrix. It is the CPU path and the reference the CUDA
    kernel is held against.
  * `devc_tpu_torch.ops.cuda_corr.corr_fwd` is the fused CUDA kernel, which
    never materialises the scores.
  * `correspondence_fwd_plain` / `correspondence_bwd_plain` are the plain
    versions of the kernel pair behind the gradient: K1 emitting the
    softmax denominator l, and the backward kernels K2b/K3
    (`cuda_corr.corr_bwd`), written out from devc_tpu's `_grad_tile`
    formulas on the whole score matrix.

`correspondence_warp` picks by the tensors' device, never by trying one and
falling back: CPU tensors take the plain version (autograd differentiates
it), CUDA tensors the kernel (or, with winner-take-all scaling, the plain
version, which alone has it). Under autograd on CUDA it goes through
`cuda_corr.CorrFunction`, K1 forward and K2b/K3 backward.

Inference uses T = 1e-10, which makes the softmax an argmax-average over
exactly tied maxima: both versions subtract the row max first, so
exp((s - m) / T) is exactly 1 at a tie and 0 elsewhere.
"""

from __future__ import annotations

import torch


def wta_scale(f, scale: float):
    """Winner-take-all: keep each row's max, scale everything else."""
    row_max = f.amax(dim=-1, keepdim=True)
    return torch.where(f == row_max, f, f * scale)


def correspondence_warp_einsum(theta, phi, values, temperature: float = 0.005,
                               wta_scale_weight: float = 1.0):
    """Plain version (materialises the [B, Nq, Nk] scores).

    theta [B, Nq, C], phi [B, Nk, C] (centered, L2-normalised), values
    [B, Nk, V]. Returns warped [B, Nq, V] and similarity [B, Nq, 1], the
    row max of the raw scores. Computes in fp32 (fp64 for fp64 inputs).
    """
    dt = torch.promote_types(theta.dtype, torch.float32)
    f = torch.bmm(theta.to(dt), phi.to(dt).transpose(1, 2))
    similarity = f.amax(dim=-1, keepdim=True)
    if wta_scale_weight != 1.0:
        f = wta_scale(f, wta_scale_weight)
    attn = torch.softmax((f - f.amax(dim=-1, keepdim=True)) / temperature,
                         dim=-1)
    return torch.bmm(attn, values.to(dt)), similarity


def correspondence_fwd_plain(theta, phi, values, temperature: float):
    """Plain version of K1 with the denominator: (out [B, Nq, 3], sim
    [B, Nq, 1], l [B, Nq, 1]), l = sum_k exp((s - m) / T) with m = sim."""
    f = torch.bmm(theta, phi.transpose(1, 2))
    sim = f.amax(dim=-1, keepdim=True)
    p = torch.exp((f - sim) / temperature)
    l = p.sum(dim=-1, keepdim=True)
    return torch.bmm(p, values) / l, sim, l


def correspondence_bwd_plain(theta, phi, values, sim, l, out, d_out, d_sim,
                             temperature: float):
    """Plain version of the backward kernels K2b and K3: (dtheta, dphi,
    dvalues) of (out, sim) from the forward's residuals, by
    devc_tpu/ops/pallas_corr.py::_grad_tile's formulas on the full score
    matrix (not through autograd):

        attn = exp((s - m) / T) / l,  D = rowsum(d_out * out)
        df   = attn * (d_out . v^T - D) / T + d_sim * 1[s == rowmax(s)]
        dtheta = df phi,  dphi = df^T theta,  dvalues = attn^T d_out

    Like the kernels, it sends d_sim to every key tied at the row max
    (autograd of `amax` would split it). The kernels test s == m against
    K1's saved max, whose bits they reproduce; this version tests against
    the row max of its own scores, which is the same key set whatever
    order the matrix product summed in.
    """
    inv_t = 1.0 / temperature
    s = torch.bmm(theta, phi.transpose(1, 2))
    attn = torch.exp((s - sim) * inv_t) / l
    dps = torch.bmm(d_out, values.transpose(1, 2))
    dd = (d_out * out).sum(dim=-1, keepdim=True)
    df = attn * (dps - dd) * inv_t
    df = df + torch.where(s == s.amax(dim=-1, keepdim=True), d_sim, 0.0)
    return (torch.bmm(df, phi), torch.bmm(df.transpose(1, 2), theta),
            torch.bmm(attn.transpose(1, 2), d_out))


def correspondence_warp(theta, phi, values, temperature: float = 0.005,
                        wta_scale_weight: float = 1.0,
                        differentiable: bool = False):
    """Dispatch on device: CUDA -> the fused kernel K1, CPU -> plain.

    On CUDA, when grad mode is on and an input requires grad, the call
    needs differentiable=True and goes through `CorrFunction` (K1, then
    K2b/K3 in the backward); without it the call raises rather than
    return outputs cut from the graph. CPU tensors take the plain version,
    which autograd differentiates either way.
    """
    if theta.device.type == "cuda" and wta_scale_weight == 1.0:
        from devc_tpu_torch.ops.cuda_corr import CorrFunction, corr_fwd

        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (theta, phi, values)):
            if not differentiable:
                raise RuntimeError(
                    "correspondence_warp: inputs require grad; pass "
                    "differentiable=True or run it under torch.no_grad()")
            return CorrFunction.apply(theta, phi, values, temperature)
        out, sim, _ = corr_fwd(theta, phi, values, temperature)
        return out, sim
    if theta.device.type in ("cuda", "cpu"):
        return correspondence_warp_einsum(theta, phi, values, temperature,
                                          wta_scale_weight)
    raise ValueError(f"no correspondence path for device {theta.device}")
