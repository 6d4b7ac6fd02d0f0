"""Wrappers for the correspondence kernels and their autograd Function.

  * `corr_fwd`: K1, replaces devc_tpu/ops/pallas_corr.py::_corr_fwd_kernel:
    fp32 embeddings run `csrc/corr_fwd.cu` (fp32 FMA scores in the order
    the backward reproduces), bf16 embeddings (the --bf16 mode; out in
    bf16) `csrc/corr_fwd_bf16.cu` (scores on the bf16 tensor cores with
    fp32 accumulation, launched as `bf16_plan` lays it out). Plain version:
    `correspondence.correspondence_warp_einsum` (and, emitting l,
    `correspondence.correspondence_fwd_plain`).
  * `corr_bwd_dkv`, `corr_bwd_dq`: K3 and K2b (`csrc/corr_bwd.cu`), replace
    pallas_corr.py::_corr_dkv_kernel and ::_corr_dq_kernel. K3 is the
    backward's one score pass (dphi, dvalues, and df into a scratch
    array); K2b forms dtheta from that df. `corr_bwd` forms D =
    rowsum(dout * out) with a torch op, as JAX does, and runs both per
    batch chunk of bounded scratch (`plan_batch_chunks`). Plain version:
    `correspondence.correspondence_bwd_plain`.
  * `CorrFunction`: K1 forward (emitting l) and the two backward kernels
    as one `torch.autograd.Function`, the counterpart of devc_tpu's
    custom VJP (`_corr_pallas_diff`). On CPU tensors it runs the plain
    versions of the same three functions.

The kernel wrappers take CUDA tensors only: each launches its kernel or
raises. Each counts its launches in `.launches` (`corr_fwd` its bf16
launches in `.bf16_launches` as well). `corr_fwd` refuses inputs
that require grad while grad mode is on: its outputs have no grad_fn, and
returning them would cut the gradient silently. The backward, and so
`CorrFunction`, takes fp32 only, as devc_tpu's differentiable path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from devc_tpu_torch.ops.correspondence import (
    correspondence_bwd_plain,
    correspondence_fwd_plain,
)
from devc_tpu_torch.utils.build import check, load_kernels

_TQ, _TK = 128, 128  # the fp32 K1's query rows per block, keys per tile
_TB = 128  # the backward's tile, both sides; the df scratch is padded to it
SCRATCH_BUDGET = 2 << 30  # bytes of df scratch the backward may hold at once
_MAX_SPLITS = 8  # K1 reloads its query tile once per key range

# K1's bf16 kernel (csrc/corr_fwd_bf16.cu), mirrored so that its launch
# plan is a pure function the CPU tests reach: 256 query rows (four
# warpgroups) and 128 keys a tile; shared tiles of [rows][64 channels]
# bf16 ("atoms" of 128-byte rows, 1024-byte aligned), a 3-stage ring of
# key atoms with a key tile's values (fp32, 16-byte rows) and an 8-byte
# mbarrier per stage, and one mbarrier for the query tile. The kernel keeps
# the query tile resident whenever that form fits a block's shared memory,
# and runs one block an SM (more than half an SM's shared memory at every
# width).
BF16_TQ, BF16_TK, BF16_CK, BF16_STAGES = 256, 128, 64, 3
BF16_ALIGN, BF16_VW = 1024, 4
MAX_BLOCK_SMEM = 232448  # dynamic shared memory of one block (H100)


def _plan_splits(q_blocks: int, tiles: int, slots: int) -> int:
    """Key ranges per query tile: the count (at most _MAX_SPLITS) whose
    waves of blocks over `slots` places on the card take the fewest key
    tiles per place, the smaller on a tie (few query tiles at N = 5184
    leave most SMs idle without a split)."""
    best, best_cost = 1, None
    for s in range(1, min(_MAX_SPLITS, tiles) + 1):
        per_split = -(-tiles // s)
        splits = -(-tiles // per_split)  # as the kernel rounds them
        cost = -(-q_blocks * splits // slots) * per_split
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _key_splits(b: int, nq: int, nk: int, device) -> int:
    """Key ranges per query tile for the fp32 K1, which runs one block per
    SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _plan_splits(b * -(-nq // _TQ), -(-nk // _TK), sms)


def bf16_smem_bytes(resident: bool, c: int) -> int:
    """The bf16 kernel's dynamic shared memory for c channels (its
    smem_bytes): alignment slack, the query tile (all its atoms when
    resident, else one per stage), the key ring and the values ring."""
    q_atoms = -(-c // BF16_CK) if resident else BF16_STAGES
    q_atom, k_atom = BF16_TQ * 2 * BF16_CK, BF16_TK * 2 * BF16_CK
    v_tile = BF16_TK * BF16_VW * 4
    return (BF16_ALIGN + q_atom * q_atoms
            + BF16_STAGES * (k_atom + v_tile) + 8 * (BF16_STAGES + 1))


@dataclass(frozen=True)
class Bf16Plan:
    """How `corr_fwd` launches the bf16 kernel: grid (query tiles, splits,
    batch) of 512-thread blocks, one an SM; split y takes key tiles [y
    tiles_per_split, (y + 1) tiles_per_split) of the `tiles` tiles."""

    resident: bool
    smem_bytes: int
    splits: int
    tiles_per_split: int
    tiles: int
    grid: tuple

    def key_tile_ranges(self) -> list[tuple[int, int]]:
        return [(y * self.tiles_per_split,
                 min(self.tiles, (y + 1) * self.tiles_per_split))
                for y in range(self.splits)]


def bf16_plan(b: int, nq: int, nk: int, c: int, sms: int) -> Bf16Plan:
    """The bf16 kernel's launch for [b, nq, c] queries against [b, nk, c]
    keys on a card of `sms` SMs: its form and shared memory, and the split
    of the keys that fills the card (the kernel rounds the requested count
    the same way, so that no split is empty)."""
    resident = bf16_smem_bytes(True, c) <= MAX_BLOCK_SMEM
    q_tiles, tiles = -(-nq // BF16_TQ), -(-nk // BF16_TK)
    want = _plan_splits(b * q_tiles, tiles, sms)
    per_split = -(-tiles // want)
    splits = -(-tiles // per_split)
    return Bf16Plan(resident, bf16_smem_bytes(resident, c), splits,
                    per_split, tiles, (q_tiles, splits, b))


def bf16_kernel_form(c: int) -> tuple[bool, int]:
    """The bf16 kernel's own choice for c channels, asked of the built
    library: (query tile resident, dynamic shared memory bytes). The
    plan's must agree."""
    resident = ctypes.c_int(0)
    smem = load_kernels().devc_corr_fwd_bf16_form(c, ctypes.byref(resident))
    return bool(resident.value), smem


def _check_input(name, t, shape, fn="corr_fwd", device=None,
                 dtype=torch.float32):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {str(dtype)[6:]}, got "
                        f"{t.dtype}")
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

    theta [B, Nq, C], phi [B, Nk, C], values [B, Nk, 3]: all fp32 or all
    bf16, contiguous, on one CUDA device, C a multiple of 32. Returns out
    [B, Nq, 3] in the inputs' dtype, sim [B, Nq, 1] (the row max) and,
    with emit_l, the softmax denominator l [B, Nq, 1] relative to that max
    (else None), both fp32: the Pallas kernel's output dtypes. bf16 inputs
    run the bf16 kernel (scores on the tensor cores: within the fp32
    kernel's tolerances of the plain version, not bit-equal to the fp32
    kernel on the upcast inputs), with the values upcast to fp32 here
    (exact) in rows padded to 16 bytes (a 6-byte bf16 row does not suit
    the kernel's TMA copies).
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
    dtype = theta.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr_fwd: theta must be float32 or bfloat16, got "
                        f"{dtype}")
    _check_input("theta", theta, (b, nq, c), dtype=dtype)
    _check_input("phi", phi, (b, nk, c), device=theta.device, dtype=dtype)
    _check_input("values", values, (b, nk, 3), device=theta.device,
                 dtype=dtype)

    lib = load_kernels()
    dev = theta.device
    bf16 = dtype == torch.bfloat16
    if bf16:
        # fp32 rows of 16 bytes for the kernel's TMA boxes: one copy; the
        # fourth column is never read
        padded_values = torch.empty((b, nk, 4), dtype=torch.float32,
                                    device=values.device)
        padded_values[..., :3] = values
        values = padded_values
    out = torch.empty((b, nq, 3), dtype=dtype, device=dev)
    sim = torch.empty((b, nq, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, nq, 1), dtype=torch.float32, device=dev) if emit_l else None
    splits = (bf16_plan(b, nq, nk, c, _sms(dev)).splits if bf16
              else _key_splits(b, nq, nk, dev))
    # per key range: the partial (m, l, acc[3]) of every row, merged after
    part = (torch.empty((splits, b, nq, 5), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    entry = lib.devc_corr_fwd_bf16 if bf16 else lib.devc_corr_fwd
    with torch.cuda.device(dev):
        code = entry(
            theta.data_ptr(), phi.data_ptr(), values.data_ptr(),
            out.data_ptr(), sim.data_ptr(),
            l.data_ptr() if emit_l else None,
            part.data_ptr() if part is not None else None,
            b, nq, nk, c, splits, float(1.0 / temperature),
            torch.cuda.current_stream().cuda_stream,
        )
    check(code, "corr_fwd")
    corr_fwd.launches += 1
    corr_fwd.bf16_launches += bf16
    return out, sim, l


corr_fwd.launches = 0
corr_fwd.bf16_launches = 0


def _splits(blocks: int, units: int, slots: int) -> int:
    """Splits of a reduction axis of `units` tiles over blocks that fill
    `slots` places on the card at once: the count (at most 8) that needs
    the fewest waves per unit of work, the smaller on a tie."""
    best, best_cost = 1, None
    for s in range(1, min(8, units) + 1):
        cost = -(-blocks * s // slots) / s
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def padded(n: int) -> int:
    """Rows or columns of the df scratch for n queries or keys: n rounded
    up to the backward's 128-row tiles."""
    return -(-n // _TB) * _TB


def df_scratch_bytes(nq: int, nk: int) -> int:
    """Bytes of one sample's df scratch ([Nq', Nk'] fp32)."""
    return 4 * padded(nq) * padded(nk)


def plan_batch_chunks(b: int, nq: int, nk: int,
                      budget: int = SCRATCH_BUDGET) -> list[tuple[int, int]]:
    """Batch ranges [start, stop) that the backward runs one after the
    other, each with a df scratch of at most `budget` bytes: equal chunks
    of as many samples as fit, the last one shorter. Raises if one sample
    does not fit."""
    per_sample = df_scratch_bytes(nq, nk)
    if per_sample > budget:
        raise ValueError(
            f"corr_bwd: one sample's df scratch ({per_sample} bytes for "
            f"Nq = {nq}, Nk = {nk}) exceeds the budget of {budget} bytes")
    step = min(b, budget // per_sample)
    return [(i, min(b, i + step)) for i in range(0, b, step)]


def _bwd_inputs(fn, theta, phi, values, m, l, dd, d_sim, d_out):
    """Check the backward's inputs; returns (b, nq, nk, c)."""
    if theta.dim() != 3 or phi.dim() != 3:
        raise ValueError(f"{fn}: theta, phi must be [B, N, C]")
    b, nq, c = theta.shape
    nk = phi.shape[1]
    if c % 32 or c == 0:
        raise ValueError(f"{fn}: channels must be a multiple of 32, got {c}")
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


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_dkv(lib, theta, phi, values, m, l, dd, d_sim, d_out, df, dphi,
                dvalues, inv_t: float, batch: int):
    """K3 on one batch chunk (inputs checked by the caller): the score
    pass (df into `df`, dvalues) and dphi = df^T theta. The reductions'
    splits, and so the bits, depend on `batch` (the whole backward's),
    not on the chunk."""
    b, nq, c = theta.shape
    nk = phi.shape[1]
    dev = theta.device
    sms = _sms(dev)
    key_tiles, query_tiles = padded(nk) // _TB, padded(nq) // _TB
    # the score pass runs one block per SM, the product two
    splits = _splits(batch * key_tiles, query_tiles, sms)
    psplits = _splits(batch * key_tiles * -(-c // _TB), query_tiles, 2 * sms)
    rows = torch.empty((b, padded(nq), 8), dtype=torch.float32, device=dev)
    part_v = (torch.empty((splits, b, nk, 3), dtype=torch.float32, device=dev)
              if splits > 1 else None)
    part_p = (torch.empty((psplits, b, nk, c), dtype=torch.float32,
                          device=dev) if psplits > 1 else None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        code = lib.devc_corr_bwd_dkv(
            theta.data_ptr(), phi.data_ptr(), values.data_ptr(),
            m.data_ptr(), l.data_ptr(), dd.data_ptr(), d_sim.data_ptr(),
            d_out.data_ptr(), rows.data_ptr(), df.data_ptr(),
            dphi.data_ptr(), dvalues.data_ptr(), ptr(part_v), ptr(part_p),
            b, nq, nk, c, splits, psplits, inv_t,
            torch.cuda.current_stream().cuda_stream)
    check(code, "corr_bwd_dkv")


def _launch_dq(lib, df, phi, dtheta, batch: int):
    """K2b on one batch chunk: dtheta = df phi; splits as _launch_dkv."""
    b, nq, c = dtheta.shape
    nk = phi.shape[1]
    dev = phi.device
    splits = _splits(batch * padded(nq) // _TB * -(-c // _TB),
                     padded(nk) // _TB, 2 * _sms(dev))
    part = (torch.empty((splits, b, nq, c), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    with torch.cuda.device(dev):
        code = lib.devc_corr_bwd_dq(
            df.data_ptr(), phi.data_ptr(), dtheta.data_ptr(),
            part.data_ptr() if part is not None else None, b, nq, nk, c,
            splits, torch.cuda.current_stream().cuda_stream)
    check(code, "corr_bwd_dq")


def _check_df(fn, df, b, nq, nk, device):
    _check_input("df", df, (b, padded(nq), padded(nk)), fn, device)


def corr_bwd_dkv(theta, phi, values, m, l, dd, d_sim, d_out,
                 temperature: float, df):
    """K3, the backward's one score pass: dphi [B, Nk, C] = df^T theta and
    dvalues [B, Nk, 3] = attn^T d_out, with df and attn formed from the
    recomputed scores, K1's row max m and denominator l (see
    csrc/corr_bwd.cu). Writes df into `df`, fp32 [B, padded(Nq),
    padded(Nk)] (zero outside the valid rows and keys), for corr_bwd_dq.
    All inputs fp32, contiguous, on one CUDA device, C a multiple of 32;
    m, l, dd (= rowsum(d_out * out)), d_sim are [B, Nq, 1]."""
    b, nq, nk, c = _bwd_inputs("corr_bwd_dkv", theta, phi, values, m, l, dd,
                               d_sim, d_out)
    _check_df("corr_bwd_dkv", df, b, nq, nk, theta.device)
    dphi = torch.empty_like(phi)
    dvalues = torch.empty_like(values)
    _launch_dkv(load_kernels(), theta, phi, values, m, l, dd, d_sim, d_out,
                df, dphi, dvalues, float(1.0 / temperature), b)
    corr_bwd_dkv.launches += 1
    return dphi, dvalues


def corr_bwd_dq(df, phi, nq: int):
    """K2b: dtheta [B, nq, C] = df phi, from the df that corr_bwd_dkv wrote
    ([B, padded(nq), padded(Nk)]) and phi [B, Nk, C]; on the tensor
    cores, no score recomputed."""
    if not isinstance(phi, torch.Tensor) or phi.dim() != 3:
        raise ValueError("corr_bwd_dq: phi must be a [B, N, C] tensor")
    b, nk, c = phi.shape
    if c % 32 or c == 0:
        raise ValueError(f"corr_bwd_dq: channels must be a multiple of 32, "
                         f"got {c}")
    _check_input("phi", phi, (b, nk, c), "corr_bwd_dq")
    _check_df("corr_bwd_dq", df, b, nq, nk, phi.device)
    dtheta = torch.empty((b, nq, c), dtype=torch.float32, device=phi.device)
    _launch_dq(load_kernels(), df, phi, dtheta, b)
    corr_bwd_dq.launches += 1
    return dtheta


corr_bwd_dq.launches = 0
corr_bwd_dkv.launches = 0


def corr_bwd(theta, phi, values, sim, l, out, d_out, d_sim,
             temperature: float, scratch_budget: int = SCRATCH_BUDGET):
    """Gradients (dtheta, dphi, dvalues) of K1's (out, sim) on the card:
    D = rowsum(d_out * out) as a torch op, then per batch chunk
    (`plan_batch_chunks`) K3's score pass and dphi, and K2b's dtheta from
    the same df scratch. One call counts one launch of each kernel,
    whatever the number of chunks, and gives the same bits whatever the
    budget."""
    dd = (d_out * out).sum(dim=-1, keepdim=True)
    b, nq, nk, c = _bwd_inputs("corr_bwd", theta, phi, values, sim, l, dd,
                               d_sim, d_out)
    chunks = plan_batch_chunks(b, nq, nk, scratch_budget)
    lib = load_kernels()
    dev = theta.device
    df = torch.empty((chunks[0][1], padded(nq), padded(nk)),
                     dtype=torch.float32, device=dev)
    dtheta = torch.empty_like(theta)
    dphi = torch.empty_like(phi)
    dvalues = torch.empty_like(values)
    inv_t = float(1.0 / temperature)
    for b0, b1 in chunks:
        part = slice(b0, b1)
        _launch_dkv(lib, theta[part], phi[part], values[part], sim[part],
                    l[part], dd[part], d_sim[part], d_out[part],
                    df[:b1 - b0], dphi[part], dvalues[part], inv_t, b)
        _launch_dq(lib, df[:b1 - b0], phi[part], dtheta[part], b)
    corr_bwd_dkv.launches += 1
    corr_bwd_dq.launches += 1
    return dtheta, dphi, dvalues


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
        if any(t.dtype == torch.bfloat16 for t in (theta, phi, values)):
            raise TypeError("CorrFunction: the differentiable correspondence "
                            "is fp32 only (as devc_tpu's); bf16 runs under "
                            "inference")
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
