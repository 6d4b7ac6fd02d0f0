"""The launch plan of K1's bf16 kernel (`ops/cuda_corr.py::bf16_plan`), on
the CPU: it covers every key tile once, keeps a block's shared memory on
the H100, picks the query tile's form as the kernel does, mirrors the
kernel's constants, and its key ranges, merged as the kernel merges them,
give devc_tpu's correspondence.

The kernel itself needs the card (tests/test_torch_kernels_cuda.py holds
it against this plan there); here the plan is a pure function of (b, nq,
nk, c, SM count).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu.ops.correspondence import correspondence_warp_einsum as j_einsum
from devc_tpu_torch.ops import cuda_corr
from devc_tpu_torch.ops.correspondence import correspondence_fwd_plain

H100_SMS = 132
SOURCE = os.path.join(os.path.dirname(cuda_corr.__file__), os.pardir, "csrc",
                      "corr_fwd_bf16.cu")
# the shapes K1 meets: one 432x768 or 864x1536 frame, the serving slots,
# several exemplars, ragged tails, tiny inputs, wide channels
SHAPES = [(1, 5184, 5184, 256), (1, 20736, 20736, 256), (4, 5184, 5184, 256),
          (3, 5184, 5184, 256), (1, 33, 65, 320), (2, 200, 312, 64),
          (1, 130, 4500, 512), (2, 300, 700, 1024), (1, 1, 1, 32),
          (16, 5184, 5184, 256), (1, 1000, 1000, 32)]


@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("b,nq,nk,c", SHAPES)
def test_plan_covers_every_key_tile_once(b, nq, nk, c, sms):
    plan = cuda_corr.bf16_plan(b, nq, nk, c, sms)
    tiles = -(-nk // cuda_corr.BF16_TK)
    assert plan.tiles == tiles
    ranges = plan.key_tile_ranges()
    assert len(ranges) == plan.splits <= min(8, tiles)
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    for (start, stop), (nxt, _) in zip(ranges, ranges[1:]):
        assert stop == nxt  # contiguous: no tile twice, none left out
    assert all(stop > start for start, stop in ranges)  # none empty
    # the kernel rounds the requested count the same way
    per_split = -(-tiles // plan.splits)
    assert per_split == plan.tiles_per_split
    assert -(-tiles // per_split) == plan.splits
    assert plan.grid == (-(-nq // cuda_corr.BF16_TQ), plan.splits, b)


@pytest.mark.parametrize("c", [32, 64, 96, 256, 288, 320, 352, 512, 1024,
                               2048])
def test_plan_shared_memory_and_form(c):
    """Every width fits one block's 232,448 bytes; the query tile stays
    resident exactly where that form fits (C <= 320), as the kernel's
    resident_form decides."""
    plan = cuda_corr.bf16_plan(1, 5184, 5184, c, H100_SMS)
    assert plan.smem_bytes <= 232448
    fits = cuda_corr.bf16_smem_bytes(True, c) <= cuda_corr.MAX_BLOCK_SMEM
    assert plan.resident == fits == (c <= 320)
    assert plan.smem_bytes == cuda_corr.bf16_smem_bytes(plan.resident, c)
    # the streamed form holds one query atom per stage, whatever C
    assert cuda_corr.bf16_smem_bytes(False, c) == \
        cuda_corr.bf16_smem_bytes(False, 64)


def test_plan_mirrors_the_kernel_constants():
    """The plan's tile sizes, ring depth, value row and shared-memory
    limit are the kernel's (read from its source)."""
    with open(SOURCE) as f:
        src = f.read()

    def const(name):
        found = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src)
        assert found, name
        return int(found.group(1))

    assert const("TQ") == cuda_corr.BF16_TQ
    assert const("TK") == cuda_corr.BF16_TK
    assert const("CK") == cuda_corr.BF16_CK
    assert const("STAGES") == cuda_corr.BF16_STAGES
    assert const("VW") == cuda_corr.BF16_VW
    assert const("ALIGN") == cuda_corr.BF16_ALIGN
    assert const("kMaxSmem") == cuda_corr.MAX_BLOCK_SMEM


def test_plan_fills_the_card_at_the_frame_sizes():
    """At N = 5184 the 21 query tiles are split so that the blocks fill
    the H100's SMs in one wave; at N = 20736 the blocks' waves leave
    little of the last one idle."""
    one = cuda_corr.bf16_plan(1, 5184, 5184, 256, H100_SMS)
    assert one.resident and one.splits == 6
    assert one.grid[0] * one.splits <= H100_SMS
    full = cuda_corr.bf16_plan(1, 20736, 20736, 256, H100_SMS)
    blocks = full.grid[0] * full.splits
    assert blocks >= H100_SMS
    assert blocks % H100_SMS >= 0.8 * H100_SMS or blocks % H100_SMS == 0


def _merged_by_plan(theta, phi, values, temperature, plan):
    """The kernel's arithmetic over the plan's key ranges, in float64: a
    partial (m, l, acc) per range, merged as corr_combine.cuh merges them
    (rescaled by exp((m_s - m) / T), summed in split order)."""
    tk = cuda_corr.BF16_TK
    parts = []
    for start, stop in plan.key_tile_ranges():
        keys = slice(start * tk, stop * tk)
        s = torch.bmm(theta, phi[:, keys].transpose(1, 2))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp((s - m) / temperature)
        parts.append((m, p.sum(-1, keepdim=True), torch.bmm(p, values[:, keys])))
    m = torch.stack([part[0] for part in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_s, l_s, acc_s in parts:
        w = torch.exp((m_s - m) / temperature)
        l, acc = l + w * l_s, acc + w * acc_s
    return acc / l, m, l


@pytest.mark.parametrize("temperature", [0.01, 1.0, 1e-10])
@pytest.mark.parametrize("b,nq,nk,c,sms", [(1, 300, 1100, 64, 4),
                                           (2, 130, 700, 32, 8),
                                           (1, 64, 2000, 96, 2)])
def test_split_merge_matches_devc_tpu(b, nq, nk, c, sms, temperature):
    """Splitting the keys by the plan and merging the partials gives the
    single-pass answer of devc_tpu's einsum path and of the port's plain
    version. Few SMs force several key ranges at these small shapes."""
    rng = np.random.RandomState(4)
    theta = rng.randn(b, nq, c)
    theta /= np.linalg.norm(theta, axis=-1, keepdims=True)
    phi = rng.randn(b, nk, c)
    phi /= np.linalg.norm(phi, axis=-1, keepdims=True)
    values = (rng.rand(b, nk, 3) - 0.5) * 200
    plan = cuda_corr.bf16_plan(b, nq, nk, c, sms)
    assert plan.splits > 1
    out, m, l = _merged_by_plan(*(torch.from_numpy(x) for x in
                                  (theta, phi, values)), temperature, plan)
    want_out, want_sim, want_l = correspondence_fwd_plain(
        *(torch.from_numpy(x) for x in (theta, phi, values)), temperature)
    np.testing.assert_allclose(m.numpy(), want_sim.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(l.numpy(), want_l.numpy(), rtol=1e-12)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=0,
                               atol=1e-9)
    # devc_tpu's einsum path in fp32 on the same inputs
    j_out, j_sim = j_einsum(*(jnp.asarray(x, jnp.float32) for x in
                              (theta, phi, values)), temperature=temperature)
    np.testing.assert_allclose(m.numpy(), np.asarray(j_sim), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-3)
