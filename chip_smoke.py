#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (devc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure prints its traceback and
exits non-zero, and only a run where every phase passed prints the final
line {"ok": true, "device": {...}}:

  1. env       torch / CUDA versions and the card (nvidia-smi name, power
               limit). No GPU: exit 1.
  2. build     the CUDA kernels from devc_tpu_torch/csrc/ (one nvcc per
               source, all at once, sm_90a).
  3. kernels   K1 (fused correspondence) at N = 5184 and 20736 (B = 1,
               inference) and at the training shape (B = 16, N = 5184),
               and K2's two entries (the fused smoother pass at the four
               frame-pass shapes; the general tridiagonal solve at four
               [B, L] shapes) vs their plain PyTorch versions on the card:
               errors and median CUDA-event times of both, and of one
               PyTorch call computing K1's out (SDPA) as a yardstick.
  4. bwd       K2b / K3 (the correspondence backward: K3 the one score
               pass with dphi, K2b dtheta from its df scratch) vs their
               plain version at the training shape (B = 16, N = 5184,
               C = 256, T = 0.01), at B = 1, at C = 96 and 512 (ragged N)
               and at B = 1, N = 20736: errors, a second call bit-equal, a
               chunked run (4 chunks) bit-equal to one chunk, the df
               scratch bytes; at N = 5184 ms of each kernel, of the pair
               and of the plain backward, with each one's bound and the
               pair's; and the sim-gradient routing check (d_out = 0,
               d_sim = 1: dtheta of every row is phi at the row's argmax).
  5. parity    one frame at a small size, teacher-forced, on the card
               (kernels) vs on the CPU (plain versions).
  6. main      colorize_frames on 8 textured 432x768 frames with seeded
               random weights at full model width, fp32, T = 1e-10, WLS on:
               outputs checked, kernel launch counts checked (K1 once and
               K2's smoother pass six times per frame), per-frame ms from
               CUDA events.
  7. layers    one frame's stages timed one by one with CUDA events.
  8. cli       python -m devc_tpu_torch.cli.colorize on the frames written
               as PNGs, when Pillow is installed (else says it skipped).
  9. train_parity  one GAN training step at 64x128, batch 2, on the card
               (kernels) against the same step on the CPU in fp32 and in
               float64 (plain versions), same weights and batch.
 10. train     the training main path: train_step_u8 at batch 16, 216x384,
               full width, TrainConfig defaults (T = 0.01, luminance noise
               2.0, remat), 1 warm-up + 4 timed steps: ms per step, peak
               memory, every loss, weights moved, kernel launch counts
               (per step K1 4 times: twice per frame, the forward and its
               recomputation under remat; K2b and K3 once per frame), and a
               checkpoint save / restore that must be bit-equal; then one
               more step under torch.profiler: device time by kernel
               group and the busy share (`train_profile`).

Then the kernel summary line, the nvidia-smi line, and the final line.
Frames, batches and weights are made from --seed with numpy; nothing is
downloaded.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

H, W = 432, 768  # the reference's default --image_size; net 216 x 384
N_FRAMES = 8
# K1 at the correspondence sizes of the two reference resolutions
# (432x768 -> N = 54*96 = 5184; 864x1536 -> N = 108*192 = 20736)
K1_SIZES = (5184, 20736)
# K1 at the training shape: batch 16 of 216x384 (N = 5184), T = 0.01
K1_TRAIN = (16, 5184)
# K2's smoother pass: (H, W, axis) of the row (1) and column (0) passes of
# a frame at both resolutions
K2_PASSES = ((432, 768, 1), (432, 768, 0), (864, 1536, 1), (864, 1536, 0))
# K2's general solve at the (L, B) those passes solved as [B, L] systems
# before the fusion (one system per row or column and channel)
K2_SHAPES = ((768, 864), (432, 1536), (1536, 1728), (864, 3072))
# the smoother's first, largest lambda (lambda_1 = 1.5 * 500 * 16 / 63)
FGS_LAM = 1.5 * 500.0 * 16.0 / 63.0
# training: cli/train.py's defaults, --batch_size 16 --image_size 216 384
TRAIN_B, TRAIN_HW = 16, (216, 384)
TRAIN_N = (TRAIN_HW[0] // 4) * (TRAIN_HW[1] // 4)  # 5184 positions
# The H100 SXM's published peaks (fp32 outside the tensor cores, TF32 on
# them; HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, tensor cores
PEAK_BYTES_PER_S = 3.35e12


def bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations at
    the fp32 peak and the bytes at the memory rate."""
    ops_ms, bytes_ms = flop / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def textured_frames(seed: int, n: int, hw):
    """Smooth random colour fields plus noise, uint8 [H, W, 3]: no flat
    regions, so exact score ties in the correspondence stay rare."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = field * 200 + 20 + rng.randn(h, w, 3) * 12
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def cuda_ms(fn, reps: int = 10, warmup: int = 2, queued: bool = False) -> float:
    """Median milliseconds of fn() over reps, each bracketed by CUDA
    events on the current stream. With queued, the card first spins for
    about a millisecond (torch.cuda._sleep), so the host has enqueued fn's
    launches before the start event runs: the events then time the
    device's work alone, not the host's launch cost (which dominates a
    call of a few microseconds on the card)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)  # clock cycles
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _k1_inputs(rng, b, n, dev):
    """Unit-norm theta, phi [b, n, 256] and a network-Lab payload (L in
    [-50, 50], ab in [-100, 100]) on the card."""
    import numpy as np
    import torch

    theta, phi = unit_rows(rng, b, n, 256), unit_rows(rng, b, n, 256)
    values = (rng.rand(b, n, 3).astype(np.float32) - 0.5) * \
        np.array([100, 200, 200], np.float32)
    return [torch.from_numpy(x).to(dev) for x in (theta, phi, values)]


def _k1_cases(rng, dev):
    """K1 against its plain version at each shape; returns one summary per
    shape (ms, plain and library ms, bound, launches of its own test)."""
    import torch

    from devc_tpu_torch.ops.correspondence import correspondence_warp_einsum
    from devc_tpu_torch.ops.cuda_corr import corr_fwd

    shapes = [(1, n, (0.01, 1e-10)) for n in K1_SIZES] + [
        (K1_TRAIN[0], K1_TRAIN[1], (0.01,))]
    rows = []
    for b, n, temps in shapes:
        theta, phi, values = _k1_inputs(rng, b, n, dev)
        flop = 2 * b * n * n * 259
        # theta, phi, values read once; out, sim, l written once
        nbytes = 4 * b * n * (2 * 256 + 3 + 5)
        row = {"b": b, "n": n, "c": 256, "max_abs_err": 0.0}
        for temperature in temps:
            out, sim, l = corr_fwd(theta, phi, values, temperature,
                                   emit_l=True)
            want_out, want_sim = correspondence_warp_einsum(
                theta, phi, values, temperature)
            torch.cuda.synchronize()
            sim_err = (sim - want_sim).abs().max().item()
            row_err = (out - want_out).abs().amax(dim=-1)
            out_err = row_err.max().item()
            case = {"kernel": "corr_fwd", "b": b, "n": n, "c": 256,
                    "temperature": temperature, "sim_max_abs_err": sim_err,
                    "out_max_abs_err": out_err,
                    "l_min": l.min().item()}
            # sim: a max of fp32 dot products summed in another order
            assert sim_err <= 1e-5, case
            assert l.min().item() >= 1.0, case  # the max contributes 1
            if temperature == 0.01:
                # exp((s - m) / T) turns a score round-off d (~1e-7) into a
                # relative weight change d / T ~ 1e-5, which moves a
                # weighted mean of values spanning 200 by ~1e-3 at most:
                # the bound devc_tpu's tests hold its Pallas kernel to
                # against the einsum path (tests/test_pallas_corr.py)
                assert out_err <= 1e-3, case
                row["max_abs_err"] = max(row["max_abs_err"], out_err, sim_err)
            else:
                # T = 1e-10 is an exact argmax-average; a row whose two
                # best scores differ by less than the summation-order
                # round-off may pick another key (near-tie flip), so up to
                # 0.1% of rows may differ and all others must be equal
                flipped = (row_err > 1e-4).float().mean().item()
                case["rows_differing"] = flipped
                assert flipped <= 1e-3, case
                row["max_abs_err"] = max(row["max_abs_err"], sim_err)
            del out, sim, l, want_out, want_sim
            # timed at the path's temperature: 1e-10 for inference, 0.01
            # for training
            if temperature == temps[-1]:
                case["ms"] = cuda_ms(lambda: corr_fwd(
                    theta, phi, values, temperature), queued=True)
                case["plain_ms"] = cuda_ms(lambda: correspondence_warp_einsum(
                    theta, phi, values, temperature), queued=True)
                case["library_ms"], case["library_call"] = sdpa_ms(
                    theta, phi, values, temperature)
                case["gflop_per_s"] = flop / case["ms"] / 1e6
                case.update(bound(flop, nbytes))
                row.update({k: case[k] for k in (
                    "temperature", "ms", "plain_ms", "library_ms",
                    "library_call", "gflop_per_s", "bound_ms", "bound_by")})
            emit("kernels", **case)
            torch.cuda.empty_cache()
        rows.append(row)
        del theta, phi, values
        torch.cuda.empty_cache()
    return rows


def _k2_cases(rng, dev):
    """K2's smoother pass and general solve against their plain versions;
    returns (pass summaries, solve summaries)."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import fgs

    passes = []
    for h, w, axis in K2_PASSES:
        src = ((rng.rand(h, w, 2) - 0.5) * 200).astype(np.float32)  # ab
        guide = np.floor(rng.rand(h, w) * 256).astype(np.float32)  # uint8
        guide[:, w // 2:] = np.floor(guide[:, w // 2:] / 8)  # an edge
        src, guide = (torch.from_numpy(x).to(dev) for x in (src, guide))
        x = fgs.smooth_pass(src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis)
        want = fgs.smooth_pass_plain(src, guide, FGS_LAM, fgs.SIGMA_COLOR,
                                     axis)
        torch.cuda.synchronize()
        err = (x - want).abs()
        scale = want.abs().max().item()
        case = {"kernel": "smooth_pass", "h": h, "w": w, "axis": axis,
                "max_abs_err": err.max().item(),
                "max_rel_err": err.max().item() / scale}
        # rtol 1e-4; the atol of 1e-5 of the largest |x| covers entries
        # that cross zero, where a relative bound means nothing
        assert bool((err <= 1e-4 * want.abs() + 1e-5 * scale).all()), case
        case["ms"] = cuda_ms(lambda: fgs.smooth_pass(
            src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis), queued=True)
        case["plain_ms"] = cuda_ms(lambda: fgs.smooth_pass_plain(
            src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis), queued=True)
        # the same launch timed with the host's cost in it
        case["host_incl_ms"] = cuda_ms(lambda: fgs.smooth_pass(
            src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis))
        # src and guide read once, the result written once (20 B a pixel);
        # per pixel two weights (exp), three coefficients and the solve of
        # two right-hand sides: about 30 FLOP
        case.update(bound(30 * h * w, 20 * h * w))
        case["gb_per_s"] = 20 * h * w / case["ms"] / 1e6
        emit("kernels", **case)
        passes.append(case)

    solves = []
    for length, n_sys in K2_SHAPES:
        guide = np.floor(rng.rand(n_sys, length) * 256)
        guide[:, length // 2:] //= 8  # an edge in every system
        wgt = np.exp(-np.abs(np.diff(guide, axis=1)) / 4.0)
        zeros = np.zeros((n_sys, 1))
        w_left = np.concatenate([zeros, wgt], axis=1)
        w_right = np.concatenate([wgt, zeros], axis=1)
        a, b = -FGS_LAM * w_left, 1.0 + FGS_LAM * (w_left + w_right)
        c = -FGS_LAM * w_right
        d = (rng.rand(n_sys, length) - 0.5) * 200  # ab-like right-hand sides
        a, b, c, d = (torch.from_numpy(x.astype(np.float32)).to(dev)
                      for x in (a, b, c, d))
        x = fgs.tridiag_pcr(a, b, c, d)
        case = {"kernel": "tridiag_pcr", "L": length, "B": n_sys,
                "max_abs_err": 0.0}
        for name, plain in (("pcr", fgs._tridiag_pcr),
                            ("thomas", fgs._tridiag_thomas)):
            want = plain(a, b, c, d)
            torch.cuda.synchronize()
            err = (x - want).abs()
            scale = want.abs().max().item()
            case[f"vs_{name}_max_abs_err"] = err.max().item()
            case[f"vs_{name}_max_rel_err"] = err.max().item() / scale
            assert bool((err <= 1e-4 * want.abs() + 1e-5 * scale).all()), case
            case["max_abs_err"] = max(case["max_abs_err"], err.max().item())
        case["ms"] = cuda_ms(lambda: fgs.tridiag_pcr(a, b, c, d), queued=True)
        case["plain_ms"] = cuda_ms(lambda: fgs._tridiag_pcr(a, b, c, d),
                                   queued=True)
        case["gb_per_s"] = 20 * length * n_sys / case["ms"] / 1e6
        # a, b, c, d read and x written once; Thomas's 8 FLOP per unknown
        case.update(bound(8 * length * n_sys, 20 * length * n_sys))
        emit("kernels", **case)
        solves.append(case)
    return passes, solves


def phase_kernels(seed: int):
    """K1 and K2 vs their plain versions on the card. Returns the
    per-kernel summaries (without launch counts): K1's at the inference
    shape with every shape under `by_shape`, and K2's with its two
    entries."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    k1_rows = _k1_cases(rng, dev)
    k1 = dict(k1_rows[0], max_abs_err=max(r["max_abs_err"] for r in k1_rows),
              by_shape=k1_rows)
    passes, solves = _k2_cases(rng, dev)
    none = ("none: PyTorch has no batched tridiagonal solve (a banded or "
            "dense solve would be another algorithm on O(L^2) data)")
    pick = lambda c: {k: c[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")}
    smooth = {"name": "smooth_pass", "max_abs_err": max(
        c["max_abs_err"] for c in passes), **pick(passes[0]),
        "shape": "432x768 row pass", "library_ms": None, "library_call": none,
        "by_shape": [{"h": c["h"], "w": c["w"], "axis": c["axis"], **pick(c)}
                     for c in passes]}
    solve = {"name": "tridiag_pcr", "max_abs_err": max(
        c["max_abs_err"] for c in solves), **pick(solves[0]),
        "shape": "(L, B) = (768, 864)", "library_ms": None,
        "library_call": none,
        "by_shape": [{"L": c["L"], "B": c["B"], **pick(c)} for c in solves]}
    k2 = {k: v for k, v in smooth.items() if k != "name"}
    k2["entries"] = [smooth, solve]
    return k1, k2


def sdpa_ms(theta, phi, values, temperature):
    """Time of one PyTorch call computing K1's out: SDPA with scale 1/T,
    on the first backend that takes fp32 at these head sizes (tried in
    this order). Returns (ms, "backend name")."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (t[:, None] for t in (theta, phi, values))  # one head
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        call = lambda: F.scaled_dot_product_attention(q, k, v,
                                                      scale=1.0 / temperature)
        with sdpa_kernel([backend]):
            try:  # a backend that refuses these inputs raises at once
                call()
            except RuntimeError:
                continue
            return (cuda_ms(call, queued=True),
                    f"F.scaled_dot_product_attention ({backend.name})")
    raise RuntimeError("no SDPA backend ran")


def unit_rows(rng, *shape):
    import numpy as np

    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def bwd_bounds(b: int, nq: int, nk: int, c: int) -> dict:
    """Least times of the correspondence backward on the card, for the pair
    (the function: theta, phi, values, m, l, D, d_sim, d_out in; dtheta,
    dphi, dvalues out) and for each kernel as its wrapper computes it:

      ops:   the score pass, 2 B Nq Nk C FLOP, must be fp32 FMAs in K1's
             order (PEAK_FP32_FLOPS); the products need no order and run
             at the TF32 tensor-core rate (PEAK_TF32_FLOPS): dtheta and
             dphi 2 B Nq Nk C each, dvalues 2 B Nq Nk 3. The pair's ops
             bound is max(score pass, all products); K3's max(score pass,
             dphi + dvalues); K2b's the dtheta product.
      bytes: each input read once, each output written once, at
             PEAK_BYTES_PER_S. K3's outputs include the df scratch
             [B, Nq', Nk'] and K2b's inputs include it; the pair's do not.

    The earlier bound of 6.6 ms per kernel (both products and a score pass
    each at the fp32 rate) is retired: the design forms the scores once and
    the products are no longer bound to the fp32 pipe."""
    from devc_tpu_torch.ops.cuda_corr import df_scratch_bytes

    pairs = b * nq * nk
    score_ms = 2 * pairs * c / PEAK_FP32_FLOPS * 1e3
    product_ms = lambda width: 2 * pairs * width / PEAK_TF32_FLOPS * 1e3
    byte_ms = lambda n: n / PEAK_BYTES_PER_S * 1e3
    df_bytes = b * df_scratch_bytes(nq, nk)
    rows_in = 4 * b * nq * (1 + 1 + 1 + 1 + 3)  # m, l, D, d_sim, d_out
    theta_b, phi_b = 4 * b * nq * c, 4 * b * nk * c
    values_b = 4 * b * nk * 3

    def pick(ops_ms, nbytes):
        return {"bound_ms": max(ops_ms, byte_ms(nbytes)),
                "bound_by": "operations" if ops_ms >= byte_ms(nbytes)
                else "bytes"}

    return {
        "pair": pick(max(score_ms, product_ms(2 * c + 3)),
                     2 * theta_b + 2 * phi_b + 2 * values_b + rows_in),
        "corr_bwd_dkv": pick(max(score_ms, product_ms(c + 3)),
                             theta_b + 2 * phi_b + 2 * values_b + rows_in
                             + df_bytes),
        "corr_bwd_dq": pick(product_ms(c), df_bytes + phi_b + theta_b),
        "df_scratch_bytes": df_bytes,
    }


# the backward's cases: (B, N, C); the first two are timed and get the
# routing check; C = 96 and 512 at ragged N; one sample at 864x1536
BWD_CASES = ((TRAIN_B, TRAIN_N, 256), (1, TRAIN_N, 256), (2, 4500, 96),
             (1, 520, 512), (1, 20736, 256))


def phase_bwd(seed: int):
    """K2b and K3 vs their plain version on the card, two calls bit-equal,
    a chunked run bit-equal to one chunk, and the sim-gradient routing
    check. Returns the per-kernel summaries (without launches)."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import cuda_corr
    from devc_tpu_torch.ops.correspondence import correspondence_bwd_plain

    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + 7)
    temperature = 0.01
    summary = {"corr_bwd_dq": {"max_abs_err": 0.0},
               "corr_bwd_dkv": {"max_abs_err": 0.0}}
    for b, n, c in BWD_CASES:
        theta, phi = unit_rows(rng, b, n, c), unit_rows(rng, b, n, c)
        values = (rng.rand(b, n, 3).astype(np.float32) - 0.5) * 100
        d_out = rng.randn(b, n, 3).astype(np.float32)
        d_sim = rng.randn(b, n, 1).astype(np.float32)
        theta, phi, values, d_out, d_sim = (
            torch.from_numpy(x).to(dev) for x in (theta, phi, values, d_out, d_sim))
        out, sim, l = cuda_corr.corr_fwd(theta, phi, values, temperature,
                                         emit_l=True)
        args = (theta, phi, values, sim, l, out, d_out, d_sim, temperature)
        got = cuda_corr.corr_bwd(*args)
        again = cuda_corr.corr_bwd(*args)
        want = correspondence_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w, g2 in zip(("dtheta", "dphi", "dvalues"), got, want,
                                  again):
            errs[name] = (g - w).abs().max().item()
            # devc_tpu's bound for its Pallas VJP vs einsum autodiff
            # (tests/test_pallas_grad.py)
            ok = bool(((g - w).abs() <= 5e-3 + 1e-3 * w.abs()).all())
            assert ok, (b, n, c, name, errs[name])
            assert torch.equal(g, g2), (b, n, c, name, "second call differs")
        bounds = bwd_bounds(b, n, n, c)
        case = {"check": "vs_plain", "b": b, "n": n, "c": c,
                "temperature": temperature, "max_abs_err": errs,
                "second_call": "bit-equal",
                "df_scratch_bytes": bounds["df_scratch_bytes"],
                "chunks": len(cuda_corr.plan_batch_chunks(b, n, n))}
        if b == TRAIN_B:
            # four chunks of four samples: the same bits as one chunk
            budget = 4 * cuda_corr.df_scratch_bytes(n, n)
            chunked = cuda_corr.corr_bwd(*args, scratch_budget=budget)
            assert all(torch.equal(x, y) for x, y in zip(chunked, got))
            case["chunked_4x4"] = "bit-equal"
            del chunked
        emit("bwd", **case)
        for kernel, outs in (("corr_bwd_dq", ("dtheta",)),
                             ("corr_bwd_dkv", ("dphi", "dvalues"))):
            s = summary[kernel]
            s["max_abs_err"] = max([s["max_abs_err"]] + [errs[o] for o in outs])
        del got, again, want

        if n == TRAIN_N and c == 256:
            _bwd_times(summary, cuda_corr, args, bounds, b, n, c)
            _bwd_routing(cuda_corr, args, b, n, c)
        del theta, phi, values, d_out, d_sim, out, sim, l, args
        torch.cuda.empty_cache()
    return summary


def _bwd_times(summary, cuda_corr, args, bounds, b, n, c):
    """Each kernel alone, the pair (corr_bwd, D included) and the plain
    backward, timed with the card queued ahead of the host."""
    import torch

    from devc_tpu_torch.ops.correspondence import correspondence_bwd_plain

    theta, phi, values, sim, l, out, d_out, d_sim, temperature = args
    dd = (d_out * out).sum(dim=-1, keepdim=True)
    df = torch.empty((b, cuda_corr.padded(n), cuda_corr.padded(n)),
                     dtype=torch.float32, device=theta.device)
    kargs = (theta, phi, values, sim, l, dd, d_sim, d_out, temperature, df)
    ms = {"corr_bwd_dkv": cuda_ms(lambda: cuda_corr.corr_bwd_dkv(*kargs),
                                  queued=True),
          "corr_bwd_dq": cuda_ms(lambda: cuda_corr.corr_bwd_dq(df, phi, n),
                                 queued=True)}
    pair_ms = cuda_ms(lambda: cuda_corr.corr_bwd(*args), queued=True)
    plain_ms = cuda_ms(lambda: correspondence_bwd_plain(*args), queued=True)
    pair = bounds["pair"]
    # the products alone: the kernels' dtheta and dphi (3xTF32 on the
    # tensor cores) against fp64 products of their own df, beside cuBLAS's
    # fp32 product of the same df (TF32 off) as the yardstick
    dphi, _ = cuda_corr.corr_bwd_dkv(*kargs)
    dtheta = cuda_corr.corr_bwd_dq(df, phi, n)
    prod_err = {"dtheta": 0.0, "dphi": 0.0, "cublas_fp32_dtheta": 0.0}
    for i in range(b):
        d64 = df[i, :n, :n].double()
        want = d64 @ phi[i].double()
        cublas = df[i, :n, :n] @ phi[i]
        for key, got in (("dtheta", dtheta[i]), ("cublas_fp32_dtheta", cublas)):
            prod_err[key] = max(prod_err[key],
                                (got.double() - want).abs().max().item())
        want = d64.t() @ theta[i].double()
        prod_err["dphi"] = max(prod_err["dphi"],
                               (dphi[i].double() - want).abs().max().item())
        del d64, want, cublas
    emit("bwd", check="products_vs_fp64_on_own_df", b=b, n=n, c=c,
         max_abs_err=prod_err)
    del dphi, dtheta
    for kernel in ("corr_bwd_dkv", "corr_bwd_dq"):
        own = bounds[kernel]
        case = {"kernel": kernel, "b": b, "n": n, "c": c,
                "temperature": temperature, "ms": ms[kernel],
                "share_of_own_bound": own["bound_ms"] / ms[kernel], **own,
                "pair_ms": pair_ms, "pair_bound_ms": pair["bound_ms"],
                "pair_bound_by": pair["bound_by"],
                "pair_share_of_bound": pair["bound_ms"] / pair_ms,
                "plain_ms_both_outputs": plain_ms,
                "df_scratch_bytes": bounds["df_scratch_bytes"]}
        emit("bwd", **case)
        if b == TRAIN_B:
            summary[kernel].update(
                ms=ms[kernel], plain_ms=plain_ms,
                plain_call="correspondence_bwd_plain: dtheta, dphi and "
                "dvalues together", library_ms=None,
                library_call="none: no single PyTorch call computes the "
                "correspondence backward (the sim-gradient term has no "
                "library counterpart)", **own, pair_ms=pair_ms,
                pair_bound_ms=pair["bound_ms"],
                df_scratch_bytes=bounds["df_scratch_bytes"])
    del df


def _bwd_routing(cuda_corr, args, b, n, c):
    """d_out = 0, d_sim = 1 leaves df = 1[s == m]; every row's dtheta must
    be phi at its argmax. The argmax is taken from fp64 scores; where their
    top two are within 1e-5 the fp32 max may be either, and the row may
    match either."""
    import torch

    theta, phi, values, sim, l, out, d_out, d_sim, temperature = args
    dtheta, _, _ = cuda_corr.corr_bwd(theta, phi, values, sim, l, out,
                                      torch.zeros_like(d_out),
                                      torch.ones_like(d_sim), temperature)
    s64 = torch.bmm(theta.double(), phi.double().transpose(1, 2))
    top = s64.topk(2, dim=-1)
    del s64
    pick = lambda j: torch.gather(
        phi, 1, top.indices[..., j:j + 1].expand(-1, -1, c))
    err1 = (dtheta - pick(0)).abs().amax(dim=-1)
    err2 = (dtheta - pick(1)).abs().amax(dim=-1)
    near_tie = (top.values[..., 0] - top.values[..., 1]) < 1e-5
    ok = (err1 <= 1e-6) | (near_tie & (err2 <= 1e-6))
    case = {"check": "dsim_routing", "b": b, "n": n,
            "rows": b * n, "rows_ok": int(ok.sum().item()),
            "near_tie_rows": int(near_tie.sum().item()),
            "max_err_at_argmax": err1.max().item()}
    emit("bwd", **case)
    assert bool(ok.all()), case


def phase_parity(models_cpu, models_gpu, seed: int):
    """One 64x128 frame, teacher-forced: the same frame, carry and
    exemplar state through the card (kernels) and the CPU (plain)."""
    import numpy as np
    import torch

    from devc_tpu_torch.pipeline import frame as pframe
    from devc_tpu_torch.pipeline import video

    hw = (64, 128)
    ref, rgb = textured_frames(seed + 1, 2, hw)
    _, state = video._device_ref_features(models_cpu, torch.from_numpy(ref))
    _, lab_small = video._preprocess_device(torch.from_numpy(rgb))
    last = torch.zeros_like(lab_small)
    for temperature in (0.01, 1e-10):
        got = {}
        for models in (models_cpu, models_gpu):
            dev = models.device
            with torch.inference_mode():
                ab, _, sim = pframe.frame_colorization(
                    models, lab_small.to(dev), last.to(dev),
                    {k: state[k].to(dev) for k in ("phi", "values")},
                    temperature)
            got[dev.type] = (ab.cpu(), sim.cpu())
        ab_err = (got["cuda"][0] - got["cpu"][0]).abs().max().item()
        sim_err = (got["cuda"][1] - got["cpu"][1]).abs().max().item()
        case = {"hw": hw, "temperature": temperature,
                "pred_ab_max_abs_err": ab_err, "sim_max_abs_err": sim_err}
        emit("parity", **case)
        # the bounds devc_tpu's golden and driver-parity tests use
        assert sim_err <= 1e-3 and ab_err < 0.5, case
        assert bool(np.isfinite(got["cuda"][0].numpy()).all()), case


def phase_main(models, seed: int, card: str):
    import numpy as np
    import torch

    from devc_tpu_torch.ops import cuda_corr, fgs
    from devc_tpu_torch.pipeline.video import colorize_frames

    ref, *frames = textured_frames(seed, N_FRAMES + 1, (H, W))
    events, outs = [], []

    def on_frame(idx, rgb):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        outs.append(rgb)

    torch.cuda.reset_peak_memory_stats()
    cuda_corr.corr_fwd.launches = 0
    fgs.smooth_pass.launches = 0
    fgs.tridiag_pcr.launches = 0
    t0 = time.perf_counter()
    n = colorize_frames(models, frames, ref, temperature=1e-10, wls=True,
                        on_frame=on_frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"corr_fwd": cuda_corr.corr_fwd.launches,
                "smooth_pass": fgs.smooth_pass.launches,
                "tridiag_pcr": fgs.tridiag_pcr.launches}

    assert n == N_FRAMES and len(outs) == N_FRAMES, n
    for rgb in outs:
        assert rgb.dtype == np.uint8 and rgb.shape == (H, W, 3), rgb.shape
    chroma = max(int(np.abs(o[..., 0].astype(int) - o[..., 1]).max())
                 for o in outs)
    assert chroma > 3, "outputs are gray: no chroma was added"
    # K1 once and K2's smoother pass six times per frame; the general
    # solve is not on the path
    assert launches == {"corr_fwd": N_FRAMES, "smooth_pass": 6 * N_FRAMES,
                        "tridiag_pcr": 0}, launches
    # frame-to-frame intervals on the stream, first frame excluded
    per_frame = [events[i - 1].elapsed_time(events[i])
                 for i in range(1, len(events))]
    emit("main", frames=n, image_size=[H, W], temperature=1e-10, wls=True,
         launches=launches, max_r_minus_g=chroma,
         per_frame_ms=per_frame,
         mean_frame_ms=statistics.mean(per_frame),
         median_frame_ms=statistics.median(per_frame),
         frames_per_s=1000.0 / statistics.mean(per_frame),
         wall_s_incl_exemplar=wall,
         peak_mem_mib=torch.cuda.max_memory_allocated() / 2**20,
         card=card)
    return launches, outs, ref, frames


def phase_layers(models, ref, rgb, card: str):
    """One frame's stages timed apart (CUDA events, median of 5)."""
    import torch

    from devc_tpu_torch import colorspace as cs
    from devc_tpu_torch.models.colorvidnet import colorvidnet_apply
    from devc_tpu_torch.models.vgg19 import vgg19_extract
    from devc_tpu_torch.models.warpnet import embed_queries, warp_with_keys
    from devc_tpu_torch.ops.fgs import fast_global_smoother
    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import FEATURE_TAPS

    dev = models.device
    rgb_t = torch.from_numpy(rgb).to(dev)
    _, state = video._device_ref_features(models, torch.from_numpy(ref).to(dev))
    times, device_ms = {}, {}
    with torch.inference_mode():
        lab_large, lab_small = video._preprocess_device(rgb_t)
        a_l = lab_small[..., 0:1]
        hw = (a_l.shape[1], a_l.shape[2])
        feats = vgg19_extract(models.vgg, cs.gray_to_rgb(a_l), FEATURE_TAPS)
        a_n = [cs.feature_normalize(f) for f in feats[1:]]
        theta = embed_queries(models.warpnet, a_n)
        warped, sim = warp_with_keys(theta, state["phi"], state["values"], hw,
                                     1e-10)
        x = torch.cat([a_l, warped[..., 1:3], sim, torch.zeros_like(lab_small)],
                      dim=-1)
        ab = colorvidnet_apply(models.colorvid, x)
        ab_up = video._resize_nhwc(ab, (H, W)) * 1.25
        guide = torch.clamp(torch.floor(
            cs.uncenter_l(lab_large[0, ..., 0]) * 255.0 / 100.0), 0.0, 255.0)

        times["preprocess"] = cuda_ms(lambda: video._preprocess_device(rgb_t), 5)
        times["vgg19"] = cuda_ms(lambda: vgg19_extract(
            models.vgg, cs.gray_to_rgb(a_l), FEATURE_TAPS), 5)
        times["embed_queries"] = cuda_ms(lambda: embed_queries(
            models.warpnet, [cs.feature_normalize(f) for f in feats[1:]]), 5)
        times["correspondence_k1"] = cuda_ms(lambda: warp_with_keys(
            theta, state["phi"], state["values"], hw, 1e-10), 5)
        times["colorvidnet"] = cuda_ms(
            lambda: colorvidnet_apply(models.colorvid, x), 5)
        times["upsample_chroma"] = cuda_ms(
            lambda: video._resize_nhwc(ab, (H, W)) * 1.25, 5)
        times["fgs_k2"] = cuda_ms(
            lambda: fast_global_smoother(ab_up[0], guide), 5)
        # the six launches' device time, the host's launch cost left out
        device_ms["fgs_k2"] = cuda_ms(
            lambda: fast_global_smoother(ab_up[0], guide), 5, queued=True)
        times["lab_to_rgb_u8"] = cuda_ms(lambda: torch.floor(torch.clamp(
            cs.lab_centered_to_rgb(torch.cat([lab_large[..., 0:1], ab_up],
                                             dim=-1)), 0, 1) * 255).to(
            torch.uint8), 5)
    last = torch.zeros_like(lab_small)
    times["frame_step"] = cuda_ms(lambda: video.frame_step(
        models, rgb_t, last, state), 5)
    emit("layers", ms=times, sum_of_stages_ms=sum(
        v for k, v in times.items() if k != "frame_step"),
        device_only_ms=device_ms, card=card)


def phase_cli(frames, ref, seed: int, main_outs):
    """The CLI on the frames written as PNGs, when Pillow is installed."""
    try:
        from PIL import Image
    except ImportError:
        emit("cli", ran="skipped: Pillow is not installed")
        return
    import numpy as np

    tmp = tempfile.mkdtemp(prefix="devc_chip_smoke_")
    try:
        clip = os.path.join(tmp, "clip")
        os.makedirs(clip)
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(clip, f"{i:05d}.png"))
        ref_path = os.path.join(tmp, "ref.png")
        Image.fromarray(ref).save(ref_path)
        png_write_ms = (time.perf_counter() - t0) / (len(frames) + 1) * 1e3
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "devc_tpu_torch.cli.colorize",
               "--clip_path", clip, "--ref_path", ref_path,
               "--output_path", out, "--image_size", str(H), str(W),
               "--random_init", "--seed", str(seed), "--no_video",
               "--device", "cuda"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"CLI failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        out_dir = os.path.join(out, "clip_ref")
        names = sorted(os.listdir(out_dir))
        assert names == [f"{i:05d}.jpg" for i in range(len(frames))], names
        psnrs = []
        for name, want in zip(names, main_outs):
            got = np.asarray(Image.open(os.path.join(out_dir, name)))
            assert got.shape == (H, W, 3), got.shape
            mse = np.mean((got.astype(np.float64) - want) ** 2)
            psnrs.append(99.0 if mse == 0 else 10 * np.log10(255**2 / mse))
        # same weights and frames as the main phase; JPEG q95 costs a few dB
        assert min(psnrs) > 30.0, psnrs
        emit("cli", ran="python -m devc_tpu_torch.cli.colorize",
             frames=len(names), wall_s=cli_s, psnr_vs_main=psnrs,
             png_write_ms_per_frame=png_write_ms,
             stdout=res.stdout.strip().splitlines()[-1:])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def synthetic_batch_u8(seed: int, b: int, hw):
    """A uint8 loader batch (devc_tpu's train_step_u8 contract) from
    numpy: smooth textured frames, a smooth flow of a few pixels, a random
    occlusion mask, brightness jitter and mixed placeholder /
    self-reference flags."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = hw

    def frames():
        coarse = rng.rand(b, h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((1, 8, 8, 1)))[:, :h, :w]
        img = field * 200 + 20 + rng.randn(b, h, w, 3) * 12
        return np.clip(img, 0, 255).astype(np.uint8)

    coarse_flow = rng.randn(b, h // 16 + 1, w // 16 + 1, 2) * 3
    flow = np.kron(coarse_flow, np.ones((1, 16, 16, 1)))[:, :h, :w]
    return {
        "last_rgb": frames(), "current_rgb": frames(), "ref_rgb": frames(),
        "flow_forward": flow.astype(np.float16),
        "flow_backward": np.zeros((b, h, w, 2), np.float16),
        "mask": (rng.rand(b, h, w, 1) > 0.2).astype(np.uint8),
        "jitter": rng.uniform(-5, 5, (b, 1)).astype(np.float32),
        "placeholder_flag": (np.arange(b) % 2 == 0)[:, None].astype(np.float32),
        "self_ref_flag": (np.arange(b) % 2 == 0)[:, None].astype(np.float32),
    }


def train_weights(seed: int, damp_recurrence: float = 1.0):
    """Seeded numpy weights: (vgg, params_g, params_d, sn_state)."""
    import numpy as np

    from devc_tpu_torch.utils.init import (
        host_discriminator_init,
        host_pipeline_params,
    )

    p = host_pipeline_params(seed)
    p["colorvid"]["conv1_1a"]["w"][:, :, 4:7, :] *= damp_recurrence
    params_d, sn = host_discriminator_init(seed + 3)
    params_d["gamma"] = np.full((1,), 0.3, np.float32)  # attention counts
    return p["vgg"], {"warpnet": p["warpnet"], "colorvid": p["colorvid"]}, \
        params_d, sn


class GradRecorder:
    """An optimizer whose state is the last gradient and whose update is
    zero, to read a step's gradients."""

    def init(self, groups):
        return None

    def update(self, grads, state):
        import torch

        return {k: [torch.zeros_like(g) for g in v]
                for k, v in grads.items()}, grads


def _grad_step(weights, batch_u8, cfg, device, dtype):
    """One train_step with gradient-recording optimizers on `device` in
    `dtype`: (metrics as floats, {network: [float64 CPU gradients]},
    kernel launches [K1, K2b, K3])."""
    import torch

    from devc_tpu_torch.ops import cuda_corr
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.utils.convert import frozen_vgg, train_state_from_numpy

    vgg_np, params_g, params_d, sn = weights
    state = train_state_from_numpy(params_g, params_d, sn, GradRecorder(),
                                   GradRecorder(), device=device)
    state.params_g.to(dtype)
    state.params_d.to(dtype)
    state.sn_state = {k: {n: t.to(dtype) for n, t in uv.items()}
                      for k, uv in state.sn_state.items()}
    batch = loop.preprocess_batch_u8({k: torch.from_numpy(v).to(device)
                                      for k, v in batch_u8.items()})
    counts = lambda: [cuda_corr.corr_fwd.launches,
                      cuda_corr.corr_bwd_dq.launches,
                      cuda_corr.corr_bwd_dkv.launches]
    before = counts()
    new, metrics = loop.train_step(
        state, {k: v.to(dtype) for k, v in batch.items()}, GradRecorder(),
        GradRecorder(), frozen_vgg(vgg_np, device).to(dtype), cfg)
    grads = {g: [t.double().cpu() for t in ts]
             for g, ts in new.opt_state_g.items()}
    grads["critic"] = [t.double().cpu() for t in new.opt_state_d[""]]
    return ({k: v.item() for k, v in metrics.items()}, grads,
            [a - b for a, b in zip(counts(), before)])


def _rel_l2(a, b):
    num = sum(float((x - y).square().sum()) for x, y in zip(a, b))
    return (num / sum(float(y.square().sum()) for y in b)) ** 0.5


def phase_train_parity(seed: int):
    """One training step at 64x128, batch 2, luminance noise 0, on the card
    (K1, K2b, K3) against the CPU (plain versions) in fp32 and in float64,
    same weights and batch.

    At random weights this step is chaotic in fp32: with T = 0.01 and the
    full two-frame recurrence (ColorVidNet amplifies an input change many
    times, and the second frame takes the first's prediction), the CPU's
    own fp32 gradients lie far from its float64 ones; the phase measures
    that first (`chaos_at_defaults`, CPU only). So the comparison runs at
    T = 1 with the recurrent input damped (conv1_1a's previous-Lab weights
    x 1e-3). Losses: the card's against the CPU's fp32 at rtol 1e-3.
    Gradients, per network (WarpNet, ColorVidNet, critic): the card's
    distance from the float64 step (relative L2) at most 3x the CPU fp32
    step's own, plus 1e-3."""
    import torch

    from devc_tpu_torch.train import loop

    batch_u8 = synthetic_batch_u8(seed + 11, 2, (64, 128))
    chaos = {}
    default_cfg = loop.TrainConfig(luminance_noise=0.0)
    weights = train_weights(seed)
    g32 = _grad_step(weights, batch_u8, default_cfg, "cpu", torch.float32)[1]
    g64 = _grad_step(weights, batch_u8, default_cfg, "cpu", torch.float64)[1]
    for net in g64:
        chaos[net] = _rel_l2(g32[net], g64[net])

    weights = train_weights(seed, damp_recurrence=1e-3)
    cfg = loop.TrainConfig(luminance_noise=0.0, temperature=1.0)
    runs = {name: _grad_step(weights, batch_u8, cfg, device, dtype)
            for name, device, dtype in (("cuda", "cuda", torch.float32),
                                        ("cpu32", "cpu", torch.float32),
                                        ("cpu64", "cpu", torch.float64))}
    launches = runs["cuda"][2]
    exact = runs["cpu64"][1]
    case = {"hw": [64, 128], "batch": 2, "temperature": 1.0,
            "chaos_at_defaults_cpu32_grad_rel_l2_vs_fp64": chaos,
            "launches_corr_fwd_dq_dkv": launches,
            "loss_rel_err_vs_cpu32": {}, "grad_rel_l2_vs_fp64": {},
            "grad_max_abs_err_over_max_vs_fp64": {}}
    for k, v in runs["cpu32"][0].items():
        case["loss_rel_err_vs_cpu32"][k] = abs(runs["cuda"][0][k] - v) / max(
            abs(v), 1e-12)
    for net in exact:
        card = _rel_l2(runs["cuda"][1][net], exact[net])
        cpu = _rel_l2(runs["cpu32"][1][net], exact[net])
        case["grad_rel_l2_vs_fp64"][net] = {"cuda": card, "cpu32": cpu}
        # the largest error in the network over its largest gradient
        case["grad_max_abs_err_over_max_vs_fp64"][net] = max(
            float((x - y).abs().max()) for x, y in zip(
                runs["cuda"][1][net], exact[net])) / max(
            float(y.abs().max()) for y in exact[net])
    emit("train_parity", **case)
    # remat: K1 in each frame's forward and again in its recomputation;
    # K2b and K3 once per frame
    assert launches == [4, 2, 2], launches
    for k, v in runs["cpu32"][0].items():
        assert abs(runs["cuda"][0][k] - v) <= 1e-3 * abs(v) + 1e-6, (k, case)
    for net, errs in case["grad_rel_l2_vs_fp64"].items():
        assert errs["cuda"] <= 3 * errs["cpu32"] + 1e-3, (net, case)


# kernel name fragments -> the training step's layers, first match wins
KERNEL_GROUPS = (
    ("K1 corr_fwd", ("corr_fwd_kernel", "corr_combine_kernel")),
    ("K2b corr_bwd_dq", ("corr_dq_product_kernel",)),
    ("K3 corr_bwd_dkv", ("corr_dkv_scores_kernel", "corr_dkv_rows_kernel",
                         "corr_dkv_product_kernel")),
    ("K2b/K3 split merge", ("sum_splits_kernel",)),
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "xmma",
                              "cudnn", "winograd", "implicit")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass")),
)


def profile_train_step(step, state, batch, gen, step_ms: float):
    """One training step under torch.profiler: device time by group of
    kernels, and the busy share against the untraced step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    groups, launches = {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        launches += 1
        name = evt.name.lower()
        group = next((g for g, frags in KERNEL_GROUPS
                      if any(f.lower() in name for f in frags)),
                     "elementwise, reductions, copies")
        groups[group] = groups.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
    kernel_ms = sum(groups.values())
    emit("train_profile", kernel_ms_by_group=dict(
        sorted(groups.items(), key=lambda kv: -kv[1])),
        kernel_ms=kernel_ms, kernel_launches=launches,
        untraced_step_ms=step_ms,
        busy_share=kernel_ms / step_ms if kernel_ms else "not measured")
    return state


def phase_train(seed: int, card: str):
    """The training main path at full width: train_step_u8 at batch 16,
    216x384, TrainConfig defaults. Returns the kernel launch counts."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import cuda_corr
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train.checkpoint import CheckpointManager
    from devc_tpu_torch.train.state import make_optimizers
    from devc_tpu_torch.utils.convert import frozen_vgg, train_state_from_numpy

    vgg_np, params_g, params_d, sn = train_weights(seed)
    tx_g, tx_d = make_optimizers()
    state = train_state_from_numpy(params_g, params_d, sn, tx_g, tx_d,
                                   device="cuda")
    start = {n: t.detach().clone() for n, t in
             list(state.params_g.named_parameters(prefix="g"))
             + list(state.params_d.named_parameters(prefix="d"))}
    step = loop.make_train_step(tx_g, tx_d, frozen_vgg(vgg_np, "cuda"),
                                loop.TrainConfig(), device_preprocess=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             synthetic_batch_u8(seed + 5, TRAIN_B, TRAIN_HW).items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_corr.corr_fwd.launches = 0
    cuda_corr.corr_bwd_dq.launches = 0
    cuda_corr.corr_bwd_dkv.launches = 0
    n_steps, losses, step_ms = 5, [], []
    for i in range(n_steps):  # step 0 is the warm-up
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state, metrics = step(state, batch, gen)
        t1.record()
        t1.synchronize()
        step_ms.append(t0.elapsed_time(t1))
        losses.append({k: v.item() for k, v in metrics.items()})
    launches = {"corr_fwd": cuda_corr.corr_fwd.launches,
                "corr_bwd_dq": cuda_corr.corr_bwd_dq.launches,
                "corr_bwd_dkv": cuda_corr.corr_bwd_dkv.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    # a sixth step, traced; its launches are not the main path's count
    state = profile_train_step(step, state, batch, gen,
                               statistics.median(step_ms[1:]))

    moved = {"params_g": 0.0, "params_d": 0.0}
    for n, t in (list(state.params_g.named_parameters(prefix="g"))
                 + list(state.params_d.named_parameters(prefix="d"))):
        key = "params_g" if n.startswith("g.") else "params_d"
        moved[key] = max(moved[key], (t.detach() - start[n]).abs().max().item())
    for i, m in enumerate(losses):
        assert all(np.isfinite(v) for v in m.values()), (i, m)
    assert moved["params_g"] > 0 and moved["params_d"] > 0, moved
    # per step: 2 frames x (K1 forward + K1 recomputed under remat) and
    # one K2b and one K3 per frame in the backward
    want = {"corr_fwd": 4 * n_steps, "corr_bwd_dq": 2 * n_steps,
            "corr_bwd_dkv": 2 * n_steps}
    assert launches == want, (launches, want)

    tmp = tempfile.mkdtemp(prefix="devc_chip_ckpt_")
    try:
        mgr = CheckpointManager(tmp, max_to_keep=2)
        assert mgr.save(state.step, state, force=True)
        fresh = train_state_from_numpy(params_g, params_d, sn, tx_g, tx_d,
                                       device="cuda")
        restored = mgr.restore(fresh)
        same = (restored.step == state.step and all(
            torch.equal(a, b) for a, b in zip(
                list(state.params_g.state_dict().values())
                + list(state.params_d.state_dict().values()),
                list(restored.params_g.state_dict().values())
                + list(restored.params_d.state_dict().values()))))
        same &= all(torch.equal(uv[k], restored.sn_state[n][k])
                    for n, uv in state.sn_state.items() for k in uv)
        for a, b in ((state.opt_state_g, restored.opt_state_g),
                     (state.opt_state_d, restored.opt_state_d)):
            same &= a.count == b.count and all(
                (x is None and y is None) or torch.equal(x, y)
                for x, y in zip(a[1:], b[1:]))
        ckpt_mib = sum(os.path.getsize(os.path.join(tmp, f))
                       for f in os.listdir(tmp)) / 2**20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert same, "checkpoint round trip is not bit-equal"

    timed = step_ms[1:]
    emit("train", batch=TRAIN_B, image_size=list(TRAIN_HW), n=TRAIN_N,
         steps=n_steps, warmup_steps=1, step_ms=step_ms,
         median_step_ms=statistics.median(timed),
         samples_per_s=TRAIN_B * 1000.0 / statistics.median(timed),
         peak_mem_mib=peak, losses_last=losses[-1], losses_first=losses[0],
         moved_max_abs=moved, launches=launches,
         checkpoint_round_trip="bit-equal", checkpoint_mib=ckpt_mib,
         card=card)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], card=card,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.pipeline.video import use_full_fp32
    from devc_tpu_torch.utils import build
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    use_full_fp32()
    build.load_kernels()
    ptxas = [ln.strip() for ln in build.build_info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=build.build_info["seconds"],
         library=os.path.relpath(build.build_info["path"]), ptxas=ptxas)

    k1, k2 = phase_kernels(args.seed)
    bwd = phase_bwd(args.seed)

    sds = state_dicts_from_numpy(host_pipeline_params(args.seed))
    models = PipelineModels.from_state_dicts(sds, "cuda")
    phase_parity(PipelineModels.from_state_dicts(sds, "cpu"), models,
                 args.seed)
    launches, outs, ref, frames = phase_main(models, args.seed, card)
    phase_layers(models, ref, frames[0], card)
    phase_cli(frames, ref, args.seed, outs)
    del models
    torch.cuda.empty_cache()
    phase_train_parity(args.seed)
    train = phase_train(args.seed, card)

    # launches: each driven path's count, read right after that path ran
    # with the counts at 0 (inference main path, training main path)
    by_path = lambda name: {"main": launches.get(name, 0),
                            "train": train.get(name, 0)}
    for entry in k2["entries"]:  # K2's two entries, each with its counts
        entry["launches_by_path"] = by_path(entry["name"])
        entry["launches"] = sum(entry["launches_by_path"].values())
    rows = [("corr_fwd", "corr_fwd.cu", "devc_tpu/ops/pallas_corr.py:80", k1),
            ("smooth_pass", "tridiag_pcr.cu", "devc_tpu/ops/fgs.py:68", k2),
            ("corr_bwd_dq", "corr_bwd.cu", "devc_tpu/ops/pallas_corr.py:218",
             bwd["corr_bwd_dq"]),
            ("corr_bwd_dkv", "corr_bwd.cu", "devc_tpu/ops/pallas_corr.py:246",
             bwd["corr_bwd_dkv"])]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"devc_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": sum(by_path(name).values()),
         "launches_by_path": by_path(name), **fields}
        for name, src, replaces, fields in rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
