"""The split convolution's CPU side (devc_tpu_torch/ops/conv_split.py and
ops/layers.py::Conv2d): the TF32 rounding against a numpy model, the
split's exactness, the three products' bound, the weight layout the
kernel reads, the weight cache, the rule and the depth-split plan. The
kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from devc_tpu_torch.ops import conv_split
from devc_tpu_torch.ops.layers import Conv2d


def _tf32_model(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 from the numbers, not the bits: round |x| to 11
    significant bits (10 stored), halves away from zero, on TF32's grid
    (fp32's exponent range, subnormals included), in float64; overflow
    to inf; a NaN quiet with its payload's low 13 bits cleared."""
    x = x.astype(np.float32)
    out = np.empty_like(x)
    for i, v in enumerate(x.ravel()):
        if np.isnan(v):
            bits = (int(v.view(np.uint32)) | 0x00400000) & 0xFFFFE000
            out.ravel()[i] = np.uint32(bits).view(np.float32)
        elif np.isinf(v) or v == 0:
            out.ravel()[i] = v
        else:
            m, e = np.frexp(abs(float(v)))  # |v| = m 2^e, m in [0.5, 1)
            quantum = 2.0 ** (max(int(e), -125) - 11)
            r = np.floor(abs(float(v)) / quantum + 0.5) * quantum
            with np.errstate(over="ignore"):
                out.ravel()[i] = np.float32(np.copysign(r, float(v)))
    return out


def _edge_values() -> np.ndarray:
    bits = np.array([
        0x3F801000, 0xBF801000,  # exact ties above 1 and -1: away
        0x3F803000, 0xBF803000,  # ties between odd neighbours
        0x3F800FFF, 0x3F801001,  # just below / above a tie
        0x00001000, 0x80003000, 0x00000001, 0x007FFFFF,  # subnormals
        0x00800000, 0x7F7FFFFF, 0xFF7FF000,  # smallest normal; overflow
        0x7F800000, 0xFF800000, 0x7FC00000, 0x7FFFFFFF, 0xFFC00000,
        0x00000000, 0x80000000,
    ], dtype=np.uint32)
    return bits.view(np.float32)


def test_tf32_rna_matches_numpy_model():
    rng = np.random.RandomState(0)
    rand = (rng.randn(4000) * 10.0 ** rng.randint(-40, 38, 4000)).astype(
        np.float32)
    x = np.concatenate([_edge_values(), rand])
    got = conv_split.tf32_rna(torch.from_numpy(x)).numpy()
    want = _tf32_model(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), [
        (hex(int(a)), hex(int(g)), hex(int(w)))
        for a, g, w in zip(x.view(np.uint32), got.view(np.uint32),
                           want.view(np.uint32)) if g != w][:5]


def test_split_halves_are_tf32_and_reconstruct():
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(20000) * 10.0 ** rng.randint(
        -30, 30, 20000)).astype(np.float32))
    hi, lo = conv_split.split_halves(x)
    for half in (hi, lo):
        assert bool(((half.view(torch.int32) & 0x1FFF) == 0).all())
        assert torch.equal(conv_split.tf32_rna(half), half)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -22 * x.double().abs()).all())
    # +-inf: hi is x, lo the card's canonical NaN rounded
    hi, lo = conv_split.split_halves(torch.tensor([float("inf"),
                                                   -float("inf")]))
    assert hi.tolist() == [float("inf"), -float("inf")]
    assert lo.view(torch.int32).tolist() == [0x7FFFE000, 0x7FFFE000]


# 3x3 (dilation 1 and 2), 3x3 stride 2, 1x1
@pytest.mark.parametrize("k,stride,pad,dil", [(3, 1, 1, 1), (3, 1, 2, 2),
                                              (3, 2, 0, 1), (1, 1, 0, 1)])
def test_three_products_within_bound(k, stride, pad, dil):
    """x_lo w_hi + x_hi w_lo + x_hi w_hi, in float64, lies within
    2^-21 sum |x||w| of the exact convolution: the dropped lo.lo and the
    halves' own rounding."""
    gen = torch.Generator().manual_seed(k * 10 + stride + dil)
    x = torch.randn(2, 64, 13, 11, generator=gen) * 3
    w = torch.randn(40, 64, k, k, generator=gen) * 0.1
    xh, xl = (t.double() for t in conv_split.split_halves(x))
    wh, wl = (t.double() for t in conv_split.split_halves(w))
    args = (None, stride, pad, dil)
    split = (F.conv2d(xl, wh, *args) + F.conv2d(xh, wl, *args)
             + F.conv2d(xh, wh, *args))
    exact = F.conv2d(x.double(), w.double(), *args)
    scale = F.conv2d(x.double().abs(), w.double().abs(), *args)
    assert bool(((split - exact).abs() <= 2.0 ** -21 * scale).all())


def test_split_conv2d_on_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 9, 7, generator=gen)
    w = torch.randn(24, 32, 3, 3, generator=gen) * 0.1
    b = torch.randn(24, generator=gen)
    got = conv_split.split_conv2d(x, conv_split.weight_split(w), b, 2, 1, 1,
                                  3, w)
    want = conv_split.split_conv2d_plain(x, w, b, 2, 1, 1)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, F.conv2d(x, w, b, 2, 1, 1), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError):  # input channels not whole atoms
        conv_split.split_conv2d(x[:, :30], conv_split.weight_split(w[:, :30]),
                                b, 1, 1, 1, 3, w[:, :30])


def test_weight_split_layout():
    """[k * k, C_out, 2 C_in]: tap r * k + s, output channel o, the input
    channels' hi then their lo."""
    w = torch.randn(5, 64, 3, 3)
    got = conv_split.weight_split(w)
    assert got.shape == (9, 5, 128) and got.is_contiguous()
    hi, lo = conv_split.split_halves(w)
    for r in range(3):
        for s in range(3):
            assert torch.equal(got[3 * r + s, :, :64], hi[:, :, r, s])
            assert torch.equal(got[3 * r + s, :, 64:], lo[:, :, r, s])


def test_weight_cache_rebuilds_after_an_update():
    conv = Conv2d(32, 16, 3, padding=1)
    first = conv._split_weight(conv.weight)
    assert conv._split_weight(conv.weight) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)  # in place: a new version
    second = conv._split_weight(conv.weight)
    assert second is not first
    assert torch.equal(second, conv_split.weight_split(conv.weight.detach()))
    sd = {k: v * 3.0 for k, v in conv.state_dict().items()}
    conv.load_state_dict(sd)
    third = conv._split_weight(conv.weight)
    assert torch.equal(third, conv_split.weight_split(conv.weight.detach()))


def test_rule_engages_only_for_fp32_inference_tf32_off_groups_1():
    ok = dict(dtype=torch.float32, on_cuda=True, inference=True, groups=1,
              cudnn_tf32=False, c_in=64, c_out=128, kernel=(3, 3),
              hw=(54, 96))
    assert conv_split.engages(**ok)
    for key, value in (("dtype", torch.bfloat16), ("dtype", torch.float64),
                       ("on_cuda", False), ("inference", False),
                       ("groups", 64), ("cudnn_tf32", True), ("c_in", 7),
                       ("c_in", 3), ("c_in", 48), ("c_out", 2)):
        assert not conv_split.engages(**{**ok, key: value}), key


def test_conv2d_on_cpu_takes_the_plain_call():
    """On the CPU the rule never engages: cuDNN's flags stay as they were,
    the plain call's bits come out, and it is counted."""
    conv = Conv2d(64, 32, 3, padding=1).requires_grad_(False)
    x = torch.randn(2, 64, 6, 5)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    calls = (Conv2d.split_calls, Conv2d.plain_calls)
    with torch.inference_mode():
        assert not conv._engages(x)
        got = conv(x)
    assert (Conv2d.split_calls, Conv2d.plain_calls) == (calls[0],
                                                        calls[1] + 1)
    assert torch.equal(got, F.conv2d(x, conv.weight, conv.bias, 1, 1))
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags


@pytest.mark.parametrize("n_pix,cout,atoms,want", [
    (82944, 128, 36, 1),   # 216x384: 648 tiles fill the card
    (1296, 512, 144, 3),   # 27x48 at 512 channels: 44 tiles
    (312, 512, 144, 8),    # 13x24: 12 tiles
    (5184, 256, 8, 1),     # a 1x1 at 54x96: too few atoms to split
])
def test_plan_splits(n_pix, cout, atoms, want):
    got = conv_split.plan_splits(n_pix, cout, atoms, 132)
    assert got == want
    per = -(-atoms // got)
    assert 1 <= got <= conv_split.MAX_SPLITS and (got - 1) * per < atoms
