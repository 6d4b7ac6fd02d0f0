"""Wrappers for the correspondence kernels and their autograd Function.

  * `corr_fwd`: K1, replaces devc_tpu/ops/pallas_corr.py::_corr_fwd_kernel:
    fp32 embeddings run `csrc/corr_fwd.cu` (scores on the tensor cores by
    the fp32 score rule of `csrc/corr_score.cuh`, 3xTF32, which K3
    reproduces bit for bit; launched as `fp32_plan` lays it out), bf16
    embeddings (the --bf16 mode; out in bf16) `csrc/corr_fwd_bf16.cu`
    (scores on the bf16 tensor cores with fp32 accumulation, launched as
    `bf16_plan` lays it out). Plain version:
    `correspondence.correspondence_warp_einsum` (and, emitting l,
    `correspondence.correspondence_fwd_plain`).
  * `corr_bwd_dkv`, `corr_bwd_dq`: K3 and K2b (`csrc/corr_bwd.cu`), replace
    pallas_corr.py::_corr_dkv_kernel and ::_corr_dq_kernel. K3 is the
    backward's one score pass (dphi, dvalues, and df into a scratch
    array, by K1's score rule; `corr_bwd_dkv_part` launches either half
    alone, for timing); K2b forms dtheta from that df. `corr_bwd` forms
    D = rowsum(dout * out) with a torch op, as JAX does, and runs both per
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

_TB = 128  # the backward's tile, both sides; the df scratch is padded to it
SCRATCH_BUDGET = 2 << 30  # bytes of df scratch the backward may hold at once
_MAX_SPLITS = 8  # K1 reloads its query tile once per key range

# K1's two kernels, mirrored so that their launch plans are pure functions
# the CPU tests reach. Both tile the queries by warpgroups of 64 rows and
# the keys by 128, and keep shared tiles of 128-byte rows in the 128-byte
# swizzle ("atoms", 1024-byte aligned), filled by TMA through a ring of
# stages with an 8-byte mbarrier each; a key tile's values ride with its
# last atom (fp32, 16-byte rows). One block an SM.
#   * fp32 (csrc/corr_fwd.cu): 128 query rows (two warpgroups) a block;
#     atoms of 32 fp32 channels; a 3-stage ring, each stage one atom of
#     the queries and one of the keys, each in TF32 hi and lo. The queries
#     stream with the keys at every width (resident, hi and lo would not
#     fit), so the shared memory is the same at every C.
#   * bf16 (csrc/corr_fwd_bf16.cu): 256 query rows (four warpgroups) a
#     block; atoms of 64 bf16 channels; a 3-stage ring of key atoms and one
#     mbarrier for the query tile, which stays resident whenever that form
#     fits a block's shared memory.
FP32_TQ, FP32_TK, FP32_CK, FP32_STAGES = 128, 128, 32, 3
BF16_TQ, BF16_TK, BF16_CK, BF16_STAGES = 256, 128, 64, 3
BF16_ALIGN, BF16_VW = 1024, 4  # both kernels' atom alignment and value row
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


def fp32_smem_bytes() -> int:
    """The fp32 kernel's dynamic shared memory (its smem_bytes):
    alignment slack, the ring of stages (query and key atoms, hi and lo),
    the values ring and an mbarrier per stage."""
    stage = 2 * (FP32_TQ + FP32_TK) * 4 * FP32_CK
    v_tile = FP32_TK * BF16_VW * 4
    return BF16_ALIGN + FP32_STAGES * (stage + v_tile) + 8 * FP32_STAGES


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
class K1Plan:
    """How `corr_fwd` launches one of K1's kernels: grid (query tiles,
    splits, batch), one block an SM; split y takes key tiles [y
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


def _k1_plan(b, nq, nk, sms, tq, tk, resident, smem) -> K1Plan:
    """The split of the keys that fills the card (the kernel rounds the
    requested count the same way, so that no split is empty)."""
    q_tiles, tiles = -(-nq // tq), -(-nk // tk)
    want = _plan_splits(b * q_tiles, tiles, sms)
    per_split = -(-tiles // want)
    splits = -(-tiles // per_split)
    return K1Plan(resident, smem, splits, per_split, tiles,
                  (q_tiles, splits, b))


def fp32_plan(b: int, nq: int, nk: int, c: int, sms: int) -> K1Plan:
    """The fp32 kernel's launch for [b, nq, c] queries against [b, nk, c]
    keys on a card of `sms` SMs: its shared memory (the queries always
    stream, `resident` is False) and the split of the keys."""
    return _k1_plan(b, nq, nk, sms, FP32_TQ, FP32_TK, False,
                    fp32_smem_bytes())


def bf16_plan(b: int, nq: int, nk: int, c: int, sms: int) -> K1Plan:
    """The bf16 kernel's launch for [b, nq, c] queries against [b, nk, c]
    keys on a card of `sms` SMs: its form and shared memory, and the split
    of the keys."""
    resident = bf16_smem_bytes(True, c) <= MAX_BLOCK_SMEM
    return _k1_plan(b, nq, nk, sms, BF16_TQ, BF16_TK, resident,
                    bf16_smem_bytes(resident, c))


def fp32_kernel_smem() -> int:
    """The fp32 kernel's dynamic shared memory, asked of the built library;
    fp32_plan's must agree."""
    return load_kernels().devc_corr_fwd_smem()


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
    (else None), both fp32: the Pallas kernel's output dtypes. fp32 inputs
    run the fp32 kernel (3xTF32 scores, whose bits K3 reproduces), with a
    scratch of B (Nq + Nk) 2C floats for the TF32 halves of theta and phi;
    bf16 inputs the bf16 kernel (scores on the tensor cores: within the
    fp32 kernel's tolerances of the plain version, not bit-equal to the
    fp32 kernel on the upcast inputs). Either kernel takes the values in
    fp32 rows padded to 16 bytes for its TMA copies (bf16 upcast here,
    exact; a 6-byte bf16 row does not suit them).
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
    # fp32 rows of 16 bytes for the kernel's TMA boxes: one copy; the
    # fourth column is never read
    padded_values = torch.empty((b, nk, 4), dtype=torch.float32,
                                device=values.device)
    padded_values[..., :3] = values
    out = torch.empty((b, nq, 3), dtype=dtype, device=dev)
    sim = torch.empty((b, nq, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, nq, 1), dtype=torch.float32, device=dev) if emit_l else None
    plan = (bf16_plan if bf16 else fp32_plan)(b, nq, nk, c, _sms(dev))
    # per key range: the partial (m, l, acc[3]) of every row, merged after
    part = (torch.empty((plan.splits, b, nq, 5), dtype=torch.float32,
                        device=dev) if plan.splits > 1 else None)
    args = [theta.data_ptr(), phi.data_ptr(), padded_values.data_ptr(),
            out.data_ptr(), sim.data_ptr(), l.data_ptr() if emit_l else None,
            part.data_ptr() if part is not None else None]
    if not bf16:
        # the TF32 halves of theta and phi (csrc/corr_score.cuh)
        split = torch.empty((b * (nq + nk) * 2 * c,), dtype=torch.float32,
                            device=dev)
        args.append(split.data_ptr())
    entry = lib.devc_corr_fwd_bf16 if bf16 else lib.devc_corr_fwd
    with torch.cuda.device(dev):
        code = entry(*args, b, nq, nk, c, plan.splits,
                     float(1.0 / temperature),
                     torch.cuda.current_stream().cuda_stream)
    check(code, "corr_fwd")
    corr_fwd.launches += 1
    corr_fwd.bf16_launches += bf16
    return out, sim, l


corr_fwd.launches = 0
corr_fwd.bf16_launches = 0


def split_tf32(x):
    """The fp32 score rule's pre-pass alone (csrc/corr_score.cuh), launched
    and not counted: x [..., C] fp32 on the card, C % 4 == 0, to
    [..., 2C] = (hi | lo), hi = tf32(x) and lo = tf32(x - hi), each rounded
    to nearest, ties away. K1 fp32 and K3 run it themselves on theta and
    phi; this is for timing it apart and checking its bits."""
    if not isinstance(x, torch.Tensor) or x.dim() < 1 or x.shape[-1] % 4 \
            or x.shape[-1] == 0:
        raise ValueError("split_tf32: x must be [..., C], C a multiple of 4")
    _check_input("x", x, tuple(x.shape), "split_tf32")
    out = torch.empty((*x.shape[:-1], 2 * x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        code = load_kernels().devc_split_tf32(
            x.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1],
            x.shape[-1], torch.cuda.current_stream().cuda_stream)
    check(code, "split_tf32")
    return out


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
                dvalues, inv_t: float, batch: int, parts=("scores", "product")):
    """K3 on one batch chunk (inputs checked by the caller): the score
    pass (df into `df`, dvalues) and dphi = df^T theta; `parts` picks
    either alone (the product reads the df already in `df`). The
    reductions' splits, and so the bits, depend on `batch` (the whole
    backward's), not on the chunk."""
    b, nq, c = theta.shape
    nk = phi.shape[1]
    dev = theta.device
    sms = _sms(dev)
    key_tiles, query_tiles = padded(nk) // _TB, padded(nq) // _TB
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None
    if "scores" in parts:
        # the score pass runs one block per SM
        splits = _splits(batch * key_tiles, query_tiles, sms)
        rows = torch.empty((b, padded(nq), 8), dtype=torch.float32,
                           device=dev)
        # the TF32 halves of theta and phi (csrc/corr_score.cuh)
        split = torch.empty((b * (nq + nk) * 2 * c,), dtype=torch.float32,
                            device=dev)
        part_v = (torch.empty((splits, b, nk, 3), dtype=torch.float32,
                              device=dev) if splits > 1 else None)
        with torch.cuda.device(dev):
            code = lib.devc_corr_bwd_dkv(
                theta.data_ptr(), phi.data_ptr(), values.data_ptr(),
                m.data_ptr(), l.data_ptr(), dd.data_ptr(), d_sim.data_ptr(),
                d_out.data_ptr(), split.data_ptr(), rows.data_ptr(),
                df.data_ptr(), dvalues.data_ptr(), ptr(part_v), b, nq, nk, c,
                splits, inv_t, stream)
        check(code, "corr_bwd_dkv")
    if "product" in parts:
        # the product runs two blocks per SM
        psplits = _splits(batch * key_tiles * -(-c // _TB), query_tiles,
                          2 * sms)
        part_p = (torch.empty((psplits, b, nk, c), dtype=torch.float32,
                              device=dev) if psplits > 1 else None)
        with torch.cuda.device(dev):
            code = lib.devc_corr_bwd_dphi(
                df.data_ptr(), theta.data_ptr(), dphi.data_ptr(),
                ptr(part_p), b, nq, nk, c, psplits, stream)
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


def corr_bwd_dkv_part(part: str, theta, phi, values, m, l, dd, d_sim,
                      d_out, temperature: float, df, dphi, dvalues):
    """One half of K3, launched alone and not counted: "scores" (the score
    pass: df into `df`, dvalues into `dvalues`) or "product" (dphi = df^T
    theta into `dphi`, from the df already in `df`). For timing the two
    apart; `corr_bwd_dkv` runs both. Arguments as corr_bwd_dkv's, plus
    the outputs."""
    if part not in ("scores", "product"):
        raise ValueError(f"corr_bwd_dkv_part: part must be 'scores' or "
                         f"'product', got {part!r}")
    b, nq, nk, c = _bwd_inputs("corr_bwd_dkv", theta, phi, values, m, l, dd,
                               d_sim, d_out)
    _check_df("corr_bwd_dkv", df, b, nq, nk, theta.device)
    _check_input("dphi", dphi, (b, nk, c), "corr_bwd_dkv", theta.device)
    _check_input("dvalues", dvalues, (b, nk, 3), "corr_bwd_dkv",
                 theta.device)
    _launch_dkv(load_kernels(), theta, phi, values, m, l, dd, d_sim, d_out,
                df, dphi, dvalues, float(1.0 / temperature), b, parts=(part,))


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
