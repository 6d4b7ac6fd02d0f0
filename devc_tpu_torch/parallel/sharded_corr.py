"""The N x N correspondence split over the "model" ranks (mirrors
devc_tpu/parallel/sharded_corr.py).

At 864x1536 the correspondence has N = 20736 positions a side. Two ways
to split it over ranks, both exact:

  * `correspondence_warp_sharded` (rows): each rank takes its block of
    query rows against all the keys. The softmax runs over keys, so each
    block is complete: the rank runs `correspondence_warp` on it (K1 on
    the card, the plain version on the CPU) with no collective inside,
    and one all_gather returns the whole map, which the caller's reshape
    needs (devc_tpu leaves that gather to GSPMD).
  * `correspondence_warp_key_sharded` (keys): each rank takes its block of
    keys and values against all the queries, and runs K1 with the softmax
    denominator (`corr_fwd(emit_l=True)`; on the CPU
    `correspondence_fwd_plain`): its row max m_loc, denominator l_loc and
    normalised out_loc. The exact softmax over all keys follows, as
    devc_tpu combines it:

        m   = max over ranks of m_loc            (all_reduce MAX)
        c   = l_loc * exp((m_loc - m) / T)
        l   = sum over ranks of c                (all_reduce SUM)
        out = sum over ranks of out_loc * c / l  (the same all_reduce)
        sim = m

    the distributed form of K1's own online softmax over key tiles. The
    two sums travel as one tensor [B, Nq, V + 1]. The combine is
    elementwise code between collectives; in devc_tpu too it lies outside
    any Pallas kernel.

Both take the whole theta, phi and values on every rank of the axis (each
rank cuts its block) and return the whole (warped [B, Nq, V], similarity
[B, Nq, 1]) on every rank. The split axis (Nq or Nk) must divide by the
axis size. Inference only: nothing here is differentiable.
"""

from __future__ import annotations

import torch

from devc_tpu_torch.ops.correspondence import (
    correspondence_fwd_plain,
    correspondence_warp,
)
from devc_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
)


def _block(x, i: int, n: int):
    """Block i of n along axis 1, contiguous and 16-byte aligned (what K1
    takes)."""
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} positions do not divide over {n} "
                         "ranks")
    step = x.shape[1] // n
    blk = x[:, i * step:(i + 1) * step].contiguous()
    return blk if blk.data_ptr() % 16 == 0 else blk.clone()


def correspondence_warp_sharded(theta, phi, values, mesh: Mesh,
                                temperature: float = 0.005,
                                axis: str = "model"):
    """Query rows split over `axis`: theta [B, Nq, C], phi [B, Nk, C],
    values [B, Nk, V], whole on every rank. Returns the whole (warped
    [B, Nq, V], similarity [B, Nq, 1]) on every rank."""
    group = mesh.group(axis)
    n, i = axis_size(group), axis_index(group)
    warped, sim = correspondence_warp(_block(theta, i, n), phi, values,
                                      temperature)
    if group is None:
        return warped, sim
    # one gather for both outputs, in sim's dtype (fp32 for bf16 embeddings)
    both = torch.cat([warped.to(sim.dtype), sim], dim=-1)
    both = all_gather(both, group, dim=1)
    return both[..., :-1].to(warped.dtype), both[..., -1:]


def correspondence_warp_key_sharded(theta, phi, values, mesh: Mesh,
                                    temperature: float = 0.005,
                                    axis: str = "model"):
    """Keys split over `axis` (context parallel): theta [B, Nq, C], phi
    [B, Nk, C], values [B, Nk, V], whole on every rank. Returns the whole
    (warped [B, Nq, V], similarity [B, Nq, 1]) on every rank."""
    group = mesh.group(axis)
    n, i = axis_size(group), axis_index(group)
    phi_blk, values_blk = _block(phi, i, n), _block(values, i, n)
    if theta.device.type == "cuda":
        from devc_tpu_torch.ops.cuda_corr import corr_fwd

        out_loc, m_loc, l_loc = corr_fwd(theta, phi_blk, values_blk,
                                         temperature, emit_l=True)
    else:
        dt = torch.promote_types(theta.dtype, torch.float32)
        out_loc, m_loc, l_loc = correspondence_fwd_plain(
            theta.to(dt), phi_blk.to(dt), values_blk.to(dt), temperature)
    m = all_reduce(m_loc, "max", group)
    c = l_loc * torch.exp((m_loc - m) * (1.0 / temperature))
    sums = all_reduce(torch.cat([out_loc.to(c.dtype) * c, c], dim=-1),
                      "sum", group)
    out = sums[..., :-1] / sums[..., -1:]
    return out.to(theta.dtype), m
