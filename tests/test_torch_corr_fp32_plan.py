"""K1's fp32 kernel and K3's score pass on the CPU: the fp32 score rule
they share (`csrc/corr_score.cuh`) emulated in PyTorch, and the fp32
kernel's launch plan (`ops/cuda_corr.py::fp32_plan`).

The rule forms every fp32 score on the TF32 tensor cores: each operand x
split into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with
ties away from zero (cvt.rna.tf32.f32); per 32-channel atom the lo.hi and
hi.lo products first, then hi.hi, summed into a fresh accumulator in
8-channel steps, and the atom's partial added to the score by an fp32
add. The emulation below (tests only) sums each 8-channel step exactly
and rounds it into an fp32 accumulator, a model of the tensor cores (which
truncate inside a step); it shows what the rule's arithmetic gives up
against float64 and that K1's plain path on such scores stays within its
tolerances of devc_tpu. The kernels themselves need the card
(tests/test_torch_kernels_cuda.py; chip_smoke.py holds the card's sim
against float64 to the bound stated here).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu.ops.correspondence import correspondence_warp_einsum as j_einsum
from devc_tpu.ops.pallas_corr import correspondence_warp_pallas
from devc_tpu_torch.ops import cuda_corr
from devc_tpu_torch.ops.correspondence import correspondence_fwd_plain

H100_SMS = 132
CSRC = os.path.join(os.path.dirname(cuda_corr.__file__), os.pardir, "csrc")
# |sim - float64 sim| on unit rows: what the rule's arithmetic may lose
# (the TF32 split keeps ~22 bits of each operand, lo.lo is dropped, and an
# fp32 rounding per 8-channel step and per atom); chip_smoke.py holds the
# card's K1 to it
SIM_FP64_BOUND = 1e-6


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 x: keep 10 mantissa bits, round to nearest,
    ties away from zero (add half an ulp to the magnitude, then cut)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def rule_scores(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The fp32 score rule on [B, Nq, C] x [B, Nk, C] (fp32, C % 32 == 0):
    per atom, a fresh fp32 accumulator takes the exact sum of each
    8-channel step of lo.hi and hi.lo, then of hi.hi; s += the atom's
    partial in fp32."""
    t_hi, t_lo = split(theta)
    p_hi, p_lo = split(phi)
    dot = lambda a, b, k: torch.bmm(a[..., k:k + 8].double(),
                                    b[..., k:k + 8].double().transpose(1, 2))
    s = torch.zeros(theta.shape[0], theta.shape[1], phi.shape[1],
                    dtype=torch.float32)
    for c0 in range(0, theta.shape[-1], 32):
        steps = [x for k in range(c0, c0 + 32, 8)
                 for x in ((t_lo, p_hi, k), (t_hi, p_lo, k))]
        steps += [(t_hi, p_hi, k) for k in range(c0, c0 + 32, 8)]
        p = torch.zeros_like(s)
        for a, b, k in steps:
            p = (p.double() + dot(a, b, k)).float()
        s = s + p
    return s


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the tf32 value after 1.0
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, -one],
                     dtype=torch.float32)
    want = [1.0, one, -one, 1.0, one, -one]
    assert tf32_rna(x).tolist() == want
    # hi + lo keeps about 22 bits of any x
    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.randn(10000).astype(np.float32))
    hi, lo = split(v)
    assert bool((tf32_rna(hi) == hi).all()) and bool((tf32_rna(lo) == lo).all())
    rel = ((hi.double() + lo.double() - v.double()).abs() / v.double().abs())
    assert rel.max().item() <= 2.0 ** -21


@pytest.mark.parametrize("c", [96, 256, 512])
def test_rule_scores_against_float64(c):
    """On unit rows the rule's scores lie within SIM_FP64_BOUND of the
    float64 scores, and so does the row max; fp32's own matrix product is
    no closer in the mean."""
    rng = np.random.RandomState(c)
    theta, phi = _unit(rng, 1, 96, c), _unit(rng, 1, 640, c)
    t, p = torch.from_numpy(theta), torch.from_numpy(phi)
    s = rule_scores(t, p)
    s64 = torch.bmm(t.double(), p.double().transpose(1, 2))
    err = (s.double() - s64).abs()
    assert err.max().item() <= SIM_FP64_BOUND
    sim_err = (s.amax(-1).double() - s64.amax(-1)).abs().max().item()
    assert sim_err <= SIM_FP64_BOUND
    fp32_err = (torch.bmm(t, p.transpose(1, 2)).double() - s64).abs()
    assert err.mean().item() <= 2 * fp32_err.mean().item()


def _warp_from_scores(s, values, temperature):
    """K1's plain path (correspondence_fwd_plain) on given scores."""
    sim = s.amax(dim=-1, keepdim=True)
    w = torch.exp((s - sim) / temperature)
    return torch.bmm(w, values) / w.sum(-1, keepdim=True), sim


@pytest.mark.parametrize("temperature", [0.01, 1e-10])
@pytest.mark.parametrize("b,nq,nk,c", [(1, 256, 256, 64), (1, 200, 312, 96),
                                       (2, 128, 72, 256)])
def test_rule_scores_through_k1_match_devc_tpu(b, nq, nk, c, temperature):
    """K1's plain path fed the rule's scores stays within K1's tolerances
    of devc_tpu's einsum path and its Pallas kernel (interpret mode):
    sim within 1e-5; out within 1e-3 at T = 0.01, and at T = 1e-10 (an
    exact argmax-average) at most 0.1% of rows differing."""
    rng = np.random.RandomState(7)
    theta, phi = _unit(rng, b, nq, c), _unit(rng, b, nk, c)
    values = (rng.rand(b, nk, 3).astype(np.float32) - 0.5) * 200
    t, p, v = (torch.from_numpy(x) for x in (theta, phi, values))
    out, sim = _warp_from_scores(rule_scores(t, p), v, temperature)
    # the same arithmetic on the fp32 matrix product is the plain version
    plain_out, plain_sim, _ = correspondence_fwd_plain(t, p, v, temperature)
    np.testing.assert_allclose(sim.numpy(), plain_sim.numpy(), atol=1e-5)
    ew, es = j_einsum(jnp.asarray(theta), jnp.asarray(phi),
                      jnp.asarray(values), temperature)
    pw, ps = correspondence_warp_pallas(
        jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(values),
        temperature, tq=128, tk=128, interpret=True)
    for want_w, want_s in ((ew, es), (pw, ps)):
        np.testing.assert_allclose(sim.numpy(), np.asarray(want_s),
                                   atol=1e-5)
        row_err = np.abs(out.numpy() - np.asarray(want_w)).max(-1)
        if temperature == 0.01:
            assert row_err.max() <= 1e-3
        else:
            assert (row_err > 1e-3).mean() <= 1e-3


def test_rule_keeps_exact_ties():
    """Two identical keys get identical scores, so at T = 1e-10 the row
    averages them exactly."""
    rng = np.random.RandomState(1)
    theta, phi = _unit(rng, 1, 4, 256), _unit(rng, 1, 200, 256)
    phi[0, 5] = phi[0, 150] = theta[0, 0]
    values = (rng.rand(1, 200, 3).astype(np.float32) - 0.5) * 200
    s = rule_scores(torch.from_numpy(theta), torch.from_numpy(phi))
    assert s[0, 0, 5] == s[0, 0, 150] == s[0, 0].max()
    out, _ = _warp_from_scores(s, torch.from_numpy(values), 1e-10)
    torch.testing.assert_close(out[0, 0], torch.from_numpy(
        (values[0, 5] + values[0, 150]) / 2))


# the shapes K1 meets: one 432x768 or 864x1536 frame, the serving slots,
# several exemplars, training, the shards, the demo's held-out frames,
# ragged tails, tiny inputs, wide channels
SHAPES = [(1, 5184, 5184, 256), (1, 20736, 20736, 256), (4, 5184, 5184, 256),
          (3, 5184, 5184, 256), (16, 5184, 5184, 256), (8, 5184, 5184, 256),
          (1, 2592, 5184, 256), (1, 5184, 2592, 256), (1, 1344, 1344, 256),
          (1, 33, 65, 320), (2, 200, 312, 64), (1, 130, 4500, 512),
          (2, 300, 700, 1024), (1, 1, 1, 32), (1, 1000, 1000, 32)]


@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("b,nq,nk,c", SHAPES)
def test_fp32_plan_covers_every_key_tile_once(b, nq, nk, c, sms):
    plan = cuda_corr.fp32_plan(b, nq, nk, c, sms)
    tiles = -(-nk // cuda_corr.FP32_TK)
    assert plan.tiles == tiles
    ranges = plan.key_tile_ranges()
    assert len(ranges) == plan.splits <= min(8, tiles)
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    for (start, stop), (nxt, _) in zip(ranges, ranges[1:]):
        assert stop == nxt  # contiguous: no tile twice, none left out
    assert all(stop > start for start, stop in ranges)  # none empty
    per_split = -(-tiles // plan.splits)  # as the kernel rounds the count
    assert per_split == plan.tiles_per_split
    assert -(-tiles // per_split) == plan.splits
    assert plan.grid == (-(-nq // cuda_corr.FP32_TQ), plan.splits, b)


@pytest.mark.parametrize("c", [32, 64, 96, 256, 320, 512, 1024, 2048])
def test_fp32_plan_fits_a_block_at_every_width(c):
    """The queries stream with the keys at every width: the same shared
    memory whatever C, within one block's 232,448 bytes (227 KB)."""
    plan = cuda_corr.fp32_plan(1, 5184, 5184, c, H100_SMS)
    assert not plan.resident
    assert plan.smem_bytes == cuda_corr.fp32_smem_bytes() <= 232448
    # a stage: query and key atoms of 32 fp32 channels, hi and lo
    assert cuda_corr.fp32_smem_bytes() == (
        1024 + 3 * (2 * (128 + 128) * 128 + 128 * 16) + 8 * 3)


def _constants(name):
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()

    def const(key):
        found = re.search(rf"constexpr (?:int|size_t) {key} = (\d+);", src)
        assert found, (name, key)
        return int(found.group(1))

    return src, const


def test_fp32_plan_mirrors_the_kernel_constants():
    """The plan's tiles, atom width, ring depth, value row, alignment and
    shared-memory limit are corr_fwd.cu's (read from its source)."""
    _, const = _constants("corr_fwd.cu")
    assert const("TQ") == cuda_corr.FP32_TQ
    assert const("TK") == cuda_corr.FP32_TK
    assert const("CK") == cuda_corr.FP32_CK
    assert const("STAGES") == cuda_corr.FP32_STAGES
    assert const("VW") == cuda_corr.BF16_VW
    assert const("ALIGN") == cuda_corr.BF16_ALIGN
    assert const("kMaxSmem") == cuda_corr.MAX_BLOCK_SMEM


def test_k1_and_k3_share_one_score_rule():
    """K1 and K3's score pass take their scores from corr_score.cuh's
    score_atom, on the same tile (two warpgroups of 64 query rows, 128
    keys, 32-channel atoms); no other fp32 score routine is left."""
    rule, const = _constants("corr_score.cuh")
    assert const("kScoreRows") == 64 and const("kScoreKeys") == 128
    assert const("kScoreAtom") == 32
    for name in ("corr_fwd.cu", "corr_bwd.cu"):
        src, const = _constants(name)
        assert '#include "corr_score.cuh"' in src
        assert src.count("score_atom(s, p,") == 1, name
        assert (const("TQ"), const("TK"), const("CK")) == (128, 128, 32)
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in rule
    assert not os.path.exists(os.path.join(CSRC, "corr_common.cuh"))


def test_fp32_plan_fills_the_card_at_the_frame_sizes():
    """At N = 5184 the 41 query tiles are split so that the blocks fill the
    H100's SMs in one wave; at N = 20736 most of the last wave is used."""
    one = cuda_corr.fp32_plan(1, 5184, 5184, 256, H100_SMS)
    assert one.grid[0] == 41 and one.splits == 3
    assert one.grid[0] * one.splits <= H100_SMS
    full = cuda_corr.fp32_plan(1, 20736, 20736, 256, H100_SMS)
    blocks = full.grid[0] * full.splits
    assert blocks >= H100_SMS
    assert blocks % H100_SMS >= 0.8 * H100_SMS or blocks % H100_SMS == 0


@pytest.mark.parametrize("temperature", [0.01, 1e-10])
@pytest.mark.parametrize("b,nq,nk,c,sms", [(1, 300, 1100, 64, 4),
                                           (2, 130, 700, 32, 8)])
def test_fp32_split_merge_matches_devc_tpu(b, nq, nk, c, sms, temperature):
    """The rule's scores split over the plan's key ranges and merged as
    corr_combine.cuh merges them (rescaled by exp((m_s - m) / T), summed in
    split order, fp32) give devc_tpu's einsum answer within K1's
    tolerances. Few SMs force several key ranges at these small shapes."""
    rng = np.random.RandomState(4)
    theta, phi = _unit(rng, b, nq, c), _unit(rng, b, nk, c)
    values = (rng.rand(b, nk, 3).astype(np.float32) - 0.5) * 200
    t, p, v = (torch.from_numpy(x) for x in (theta, phi, values))
    plan = cuda_corr.fp32_plan(b, nq, nk, c, sms)
    assert plan.splits > 1
    s = rule_scores(t, p)
    tk = cuda_corr.FP32_TK
    parts = []
    for start, stop in plan.key_tile_ranges():
        keys = slice(start * tk, stop * tk)
        m = s[..., keys].amax(-1, keepdim=True)
        w = torch.exp((s[..., keys] - m) / temperature)
        parts.append((m, w.sum(-1, keepdim=True), torch.bmm(w, v[:, keys])))
    m = torch.stack([x[0] for x in parts]).amax(0)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for m_s, l_s, acc_s in parts:
        w = torch.exp((m_s - m) / temperature)
        l, acc = l + w * l_s, acc + w * acc_s
    out = acc / l
    ew, es = j_einsum(jnp.asarray(theta), jnp.asarray(phi),
                      jnp.asarray(values), temperature=temperature)
    np.testing.assert_allclose(m.numpy(), np.asarray(es), atol=1e-5)
    row_err = np.abs(out.numpy() - np.asarray(ew)).max(-1)
    if temperature == 0.01:
        assert row_err.max() <= 1e-3
    else:
        assert (row_err > 1e-3).mean() <= 1e-3
