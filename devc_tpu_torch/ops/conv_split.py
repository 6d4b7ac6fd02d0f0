"""The fp32-accurate split convolution: an fp32 convolution on the TF32
tensor cores as three TF32 products per 32-channel atom, by the fp32
score rule of csrc/corr_score.cuh. `layers.Conv2d` runs it where
`engages` says so.

x = x_hi + x_lo and w = w_hi + w_lo, with hi = tf32(v) and lo =
tf32(v - hi), each rounded to nearest with ties away from zero. The
kernel (`csrc/conv_split.cu`) sums x_lo w_hi + x_hi w_lo, then x_hi w_hi,
per atom of 32 input channels of one tap in a fresh tensor-core
accumulator, and adds each atom's partial to the output with an fp32
add. Each product of two TF32 values is exact in fp32, the dropped
terms (lo.lo and the halves' own rounding) are below 2^-21 of |x||w|, and
the short accumulations keep the tensor cores' truncation small: on the
H100 the result lies 2-8x nearer a float64 convolution than cuDNN's fp32
one, at every network shape but the two where cuDNN takes FFT.
(One cuDNN TF32 convolution of the operands stacked on the channels would
sum all 3 C k^2 products in one accumulator: 2-6x fp32's distance a
layer, and the warp's argmax flips far more often; PERF.md.) The input
is split inside the kernel as it is loaded; the weight is split once
(`weight_split`) and kept by `layers.Conv2d`.

  * `split_conv2d`: the kernel; counts the kernels it launches in
    `split_conv2d.launches`: one, and a second that sums the parts where
    `plan_splits` splits the depth because the tiles do not fill the card
    (`launch_plan` says which). A batch is one call, each sample computed
    alike (its bits do not depend on the batch). Plain version:
    `split_conv2d_plain` (the three products in float64, rounded to fp32;
    CPU tensors take it).
  * `weight_split`: the weight as the kernel reads it, plain PyTorch.
  * `engages` and `shape_rule`: the rule, pure functions of what a call
    can observe.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from devc_tpu_torch.utils.build import check, load_kernels

_NAN = 0x7FFFFFFF  # the canonical NaN of the card's fp32 arithmetic

ATOM = 32  # input channels an atom: the kernel takes C_in % 32 == 0
# Convolutions with fewer output channels leave most of the kernel's
# 128-channel tile empty (ColorVidNet's conv10_ab has 2); from
# `chip_conv_probe.py --split` at 432x768 on the H100.
MIN_OUT_CHANNELS = 16


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on fp32 x, bit for bit: keep 10 mantissa bits,
    rounded to nearest with ties away from zero (a carry into the
    exponent is the right result, up to inf); a NaN keeps its sign and
    its payload's top 10 bits, quiet."""
    bits = x.view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    nan = (bits | 0x00400000) & ~0x1FFF
    return torch.where(torch.isnan(x), nan, rounded).view(torch.float32)


def split_halves(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 x as the card forms them: hi = tf32(x), lo =
    tf32(x - hi); x - hi is exact in fp32, and a NaN it gives is the
    card's canonical one."""
    hi = tf32_rna(x)
    d = x - hi
    d = torch.where(torch.isnan(d), torch.full_like(d.view(torch.int32), _NAN)
                    .view(torch.float32), d)
    return hi, tf32_rna(d)


def weight_split(w: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, k, k] fp32 -> [k * k, C_out, 2 C_in]: for each tap and
    output channel, the input channels' TF32 hi, then their lo (the
    layout the kernel's TMA reads)."""
    cout, cin, kh, kw = w.shape
    taps = w.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin)
    hi, lo = split_halves(taps)
    return torch.cat([hi, lo], dim=2).contiguous()


def out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def split_conv2d_plain(x, w, bias, stride: int, pad: int, dil: int):
    """The kernel's arithmetic without its order: x_lo w_hi + x_hi w_lo +
    x_hi w_hi summed in float64 and rounded to fp32, then + bias in fp32.
    x [N, C, H, W], w [C_out, C, k, k], fp32."""
    xh, xl = (t.double() for t in split_halves(x))
    wh, wl = (t.double() for t in split_halves(w))
    args = (None, stride, pad, dil)
    y = (F.conv2d(xl, wh, *args) + F.conv2d(xh, wl, *args)
         + F.conv2d(xh, wh, *args)).float()
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


TILE = 128  # output pixels and output channels a block of the kernel
MAX_SPLITS = 8
BLOCK_COST = 4  # a block's fixed cost (ring fill, epilogue), in atoms


@functools.lru_cache(maxsize=None)
def plan_splits(n_pix: int, cout: int, atoms: int, sms: int) -> int:
    """How many blocks share one tile's depth (`atoms` atoms of 32 input
    channels): the count, at most 8, whose waves of one sample's tiles
    over `sms` SMs (one block each) take the least time, counted in atoms
    of a block plus its fixed cost; the smaller on a tie. A pure function
    of one sample's shape, so that a sample's bits do not depend on the
    batch."""
    blocks = -(-n_pix // TILE) * -(-cout // TILE)
    best, best_cost = 1, None
    for k in range(1, min(MAX_SPLITS, atoms) + 1):
        per = -(-atoms // k)
        k_used = -(-atoms // per)
        cost = -(-blocks * k_used // sms) * (per + BLOCK_COST)
        if best_cost is None or cost < best_cost:
            best, best_cost = k_used, cost
    return best


@functools.lru_cache(maxsize=None)
def launch_plan(c: int, h: int, w: int, cout: int, k: int, stride: int,
                pad: int, dil: int, device: torch.device):
    """(output H, W, splits) of a call on a [N, c, h, w] input on the
    card `device`, made once per shape; splits > 1 adds the summing
    launch."""
    oh, ow = (out_size(s, k, stride, pad, dil) for s in (h, w))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return oh, ow, plan_splits(oh * ow, cout, k * k * c // ATOM, sms)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point (the library is built on first use)."""
    return load_kernels().devc_conv_split


def split_conv2d(x, w_split, bias, stride: int, pad: int, dil: int,
                 k: int, w=None):
    """conv2d(x, w) + bias in fp32 accuracy on the TF32 tensor cores. x
    [N, C, H, W] fp32 (C % 32 == 0), w_split = `weight_split(w)`, bias
    [C_out] or None; a square k x k kernel, the same stride, zero padding
    and dilation on both axes. A CUDA tensor launches the kernel (and,
    where `plan_splits` splits the depth, the sum of the partials) or
    raises; a CPU one takes the plain version (which needs w)."""
    n, c, h, wd = x.shape
    taps, cout, c2 = w_split.shape
    if (x.dtype != torch.float32 or c % ATOM or taps != k * k
            or c2 != 2 * c or w_split.dtype != torch.float32):
        raise ValueError("split_conv2d: x must be [N, C, H, W] fp32 with C "
                         f"a multiple of {ATOM} and w_split weight_split(w) "
                         f"of a [C_out, C, {k}, {k}] weight")
    if x.device.type != "cuda":
        return split_conv2d_plain(x, w, bias, stride, pad, dil)
    if bias is not None and (bias.shape != (cout,)
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError("split_conv2d: bias must be [C_out] fp32, "
                         "contiguous")
    x = x.contiguous()
    oh, ow, splits = launch_plan(c, h, wd, cout, k, stride, pad, dil,
                                 x.device)
    out = torch.empty((n, cout, oh, ow), dtype=torch.float32,
                      device=x.device)
    part = (torch.empty((n, splits, cout, oh * ow), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    args = (x.data_ptr(), w_split.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), n, c, h, wd, cout, oh,
            ow, k, stride, pad, dil, splits)
    if x.device.index == torch.cuda.current_device():
        code = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            code = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    check(code, "split_conv2d")
    split_conv2d.launches += 1 + (splits > 1)
    return out


split_conv2d.launches = 0


def shape_rule(c_in: int, c_out: int, kernel, hw) -> bool:
    """Whether the kernel takes a convolution of c_in -> c_out channels,
    kernel (kh, kw), on an input of hw = (H, W), and runs it faster than
    cuDNN's fp32 one (`chip_conv_probe.py --split`): whole atoms of input
    channels, enough output channels to fill part of a tile."""
    return c_in % ATOM == 0 and c_out >= MIN_OUT_CHANNELS


def engages(dtype, on_cuda: bool, inference: bool, groups: int,
            cudnn_tf32: bool, c_in: int, c_out: int, kernel, hw) -> bool:
    """The split path's rule: an fp32 input on the card under inference
    mode, an ungrouped convolution, TF32 off in cuDNN (the caller asked
    for fp32; with TF32 allowed cuDNN runs TF32 already), and a shape the
    kernel takes and gains on (`shape_rule`)."""
    return (dtype == torch.float32 and on_cuda and inference and groups == 1
            and not cudnn_tf32 and shape_rule(c_in, c_out, kernel, hw))
