"""The dense correspondence, plain: a frozen copy of
devc_tpu_torch/ops/correspondence.py::correspondence_warp_einsum, which
builds the whole [B, Nq, Nk] score matrix. There is no kernel here: every
device runs this."""

from __future__ import annotations

import torch


def correspondence_warp(theta, phi, values, temperature: float = 0.005,
                        differentiable: bool = False):
    """theta [B, Nq, C], phi [B, Nk, C] (centered, L2-normalised), values
    [B, Nk, V] -> (warped [B, Nq, V], similarity [B, Nq, 1], the row max of
    the raw scores). Autograd differentiates it whatever `differentiable`
    says (the flag keeps the port's signature)."""
    del differentiable
    dt = torch.promote_types(theta.dtype, torch.float32)
    f = torch.bmm(theta.to(dt), phi.to(dt).transpose(1, 2))
    similarity = f.amax(dim=-1, keepdim=True)
    attn = torch.softmax((f - similarity) / temperature, dim=-1)
    return torch.bmm(attn, values.to(dt)).to(theta.dtype), similarity
