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
  9. serve     the serving path: K2's batched pass (B = 4 guides, B = 3
               one shared guide, 432x768, both axes) and K1 at B = 4 and
               3 (N = 5184, T = 1e-10) vs their plain versions, with ms,
               bounds and SDPA; ClipBatchScheduler at 432x768 (4 slots,
               6 jobs of 5-9 PNG frames, one with a corrupt exemplar that
               fails alone): frame counts, each job's frame 0 within +-1
               of the clip alone, one K1 and six K2 launches per batched
               step, ms per step, frames/s, peak memory; a device_resize
               run with one job at 540x960; colorize_video_multi with
               R = 3 (launches, frame 0 within +-1 of serial runs); scan
               mode (chunk 4) bit-equal to stream, per-frame ms of both;
               the server's request handlers in process, each request
               twice, with device memory before and after each (a repeat
               must leave nothing behind), and the device-resized input's
               difference to the host CenterPad; python -m
               devc_tpu_torch.cli.serve as a subprocess (ready, ping, a
               job, a batch, shutdown, exit 0); a video file when cv2
               imports.
 10. train_parity  one GAN training step at 64x128, batch 2, on the card
               (kernels) against the same step on the CPU in fp32 and in
               float64 (plain versions), same weights and batch.
 11. train     the training main path: train_step_u8 at batch 16, 216x384,
               full width, TrainConfig defaults (T = 0.01, luminance noise
               2.0, remat), 1 warm-up + 4 timed steps: ms per step, peak
               memory, every loss, weights moved, kernel launch counts
               (per step K1 4 times: twice per frame, the forward and its
               recomputation under remat; K2b and K3 once per frame), and a
               checkpoint save / restore that must be bit-equal; then one
               more step under torch.profiler: device time by kernel
               group, the busy share and any FFT / complex-GEMM cuDNN
               kernels (`train_profile`).
 12. cli_train the trainer's entry point in process, on an ImageNet-style
               and a video-pairs dataset written to a temporary directory:
               python -m devc_tpu_torch.cli.train for 30 steps at batch
               16, 216x384, its defaults (8 loader threads, float
               batches): ms a step, the share of wall time waiting on the
               loader, peak memory, launches (K1 120, K2b 60, K3 60),
               every loss finite and the last 8 steps' mean total_loss
               below the first 8's; 2 steps with --device_preprocess;
               --resume (restored state bit-equal to the step-30 file,
               steps 31-32) and its refusal of another VGG; cli.export;
               cli.colorize --train_ckpt on the 8 frames at 432x768 (K1 8,
               smooth_pass 48, chroma).

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

    from devc_tpu_torch.pipeline.video import colorize_frames

    ref, *frames = textured_frames(seed, N_FRAMES + 1, (H, W))
    events, outs = [], []

    def on_frame(idx, rgb):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        outs.append(rgb)

    torch.cuda.reset_peak_memory_stats()
    _counts_zero()
    t0 = time.perf_counter()
    n = colorize_frames(models, frames, ref, temperature=1e-10, wls=True,
                        on_frame=on_frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()

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


# the serving path: K2 over a batch of 432x768 images, (B, shared guide):
# 4 clip slots with a guide each, 3 exemplars against one frame's guide
K2_BATCHED = ((4, False), (3, True))
# K1 on the serving path at N = 5184: (B, theta shared): 4 clip slots; 3
# exemplars against one frame's embedding (broadcast, then contiguous)
K1_SERVE = ((4, False), (3, True))
SERVE_SLOTS = 4
SERVE_JOB_FRAMES = (5, 9, 6, 8, 7, 5)  # one clip per job
SERVE_BAD_JOB = 3  # this job's exemplar is corrupt: it fails alone
RESIZE_SRC = (540, 960)  # the second run's odd job: 1.25x the target


def _serve_kernels(rng, dev):
    """K2's batched pass and K1 at the serving path's batches against
    their plain versions; returns (K2 rows, K1 rows)."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import fgs
    from devc_tpu_torch.ops.correspondence import correspondence_warp_einsum
    from devc_tpu_torch.ops.cuda_corr import corr_fwd

    k2 = []
    for b, shared in K2_BATCHED:
        for axis in (1, 0):
            src = torch.from_numpy(
                ((rng.rand(b, H, W, 2) - 0.5) * 200).astype(np.float32)).to(dev)
            guide = np.floor(rng.rand(1 if shared else b, H, W) * 256)
            guide[..., W // 2:] = np.floor(guide[..., W // 2:] / 8)
            guide = torch.from_numpy(guide.astype(np.float32)).to(dev)
            guide = guide[0] if shared else guide
            call = lambda: fgs.smooth_pass(src, guide, FGS_LAM,
                                           fgs.SIGMA_COLOR, axis)
            x = call()
            want = fgs.smooth_pass_plain(src, guide, FGS_LAM, fgs.SIGMA_COLOR,
                                         axis)
            alone = [fgs.smooth_pass(src[i], guide if shared else guide[i],
                                     FGS_LAM, fgs.SIGMA_COLOR, axis)
                     for i in range(b)]
            torch.cuda.synchronize()
            err = (x - want).abs()
            scale = want.abs().max().item()
            case = {"check": "k2_batched", "kernel": "smooth_pass", "b": b,
                    "guide": "shared" if shared else "per image", "h": H,
                    "w": W, "axis": axis, "max_abs_err": err.max().item(),
                    "max_rel_err": err.max().item() / scale,
                    "each_image_vs_its_own_launch": "bit-equal"}
            assert bool((err <= 1e-4 * want.abs() + 1e-5 * scale).all()), case
            assert all(torch.equal(x[i], a) for i, a in enumerate(alone)), \
                "a batched image differs from its own launch"
            case["ms"] = cuda_ms(call, queued=True)
            case["plain_ms"] = cuda_ms(lambda: fgs.smooth_pass_plain(
                src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis), queued=True)
            case["one_image_ms"] = cuda_ms(lambda: fgs.smooth_pass(
                src[0], guide if shared else guide[0], FGS_LAM,
                fgs.SIGMA_COLOR, axis), queued=True)
            # src read and the result written once (16 B a pixel), the
            # guide read once: per image, or once for the batch
            nbytes = 16 * b * H * W + 4 * H * W * (1 if shared else b)
            case.update(bound(30 * b * H * W, nbytes))
            emit("serve", **case)
            k2.append(case)
    k1 = []
    n = K1_SIZES[0]
    for b, shared in K1_SERVE:
        theta, phi, values = _k1_inputs(rng, b, n, dev)
        if shared:
            theta = theta[:1].expand(b, n, 256).contiguous()
        out, sim, _ = corr_fwd(theta, phi, values, 1e-10)
        want_out, want_sim = correspondence_warp_einsum(theta, phi, values,
                                                        1e-10)
        torch.cuda.synchronize()
        sim_err = (sim - want_sim).abs().max().item()
        differing = int(((out - want_out).abs().amax(dim=-1) > 1e-4).sum())
        case = {"check": "k1_batched", "kernel": "corr_fwd", "b": b, "n": n,
                "c": 256, "temperature": 1e-10,
                "theta": "one frame's, repeated" if shared else "per slot",
                "sim_max_abs_err": sim_err, "rows_differing": differing,
                "max_abs_err": sim_err}
        assert sim_err <= 1e-5 and differing == 0, case
        case["ms"] = cuda_ms(lambda: corr_fwd(theta, phi, values, 1e-10),
                             queued=True)
        case["plain_ms"] = cuda_ms(lambda: correspondence_warp_einsum(
            theta, phi, values, 1e-10), queued=True)
        case["library_ms"], case["library_call"] = sdpa_ms(
            theta, phi, values, 1e-10)
        flop = 2 * b * n * n * 259
        case.update(bound(flop, 4 * b * n * (2 * 256 + 3 + 5)))
        case["gflop_per_s"] = flop / case["ms"] / 1e6
        emit("serve", **case)
        k1.append(case)
        del theta, phi, values, out, sim, want_out, want_sim
        torch.cuda.empty_cache()
    return k2, k1


def _counts_zero():
    from devc_tpu_torch.ops import cuda_corr, fgs

    cuda_corr.corr_fwd.launches = 0
    fgs.smooth_pass.launches = 0
    fgs.tridiag_pcr.launches = 0


def _counts():
    from devc_tpu_torch.ops import cuda_corr, fgs

    return {"corr_fwd": cuda_corr.corr_fwd.launches,
            "smooth_pass": fgs.smooth_pass.launches,
            "tridiag_pcr": fgs.tridiag_pcr.launches}


def _alone_frame0(models, frames, ref):
    """Frame 0 of colorize_frames on (frames, ref) alone."""
    from devc_tpu_torch.pipeline.video import colorize_frames

    got = []
    colorize_frames(models, frames[:1], ref, lambda i, a: got.append(a))
    return got[0]


def _diff(a, b) -> dict:
    import numpy as np

    d = np.abs(a.astype(int) - b.astype(int))
    return {"max": int(d.max()), "share": float((d > 0).mean())}


def _save_clip(path, frames):
    from PIL import Image

    os.makedirs(path)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(path, f"{i:05d}.png"))


def _serve_scheduler(models, tmp, seed, card):
    """ClipBatchScheduler at 432x768: the serving path's main run (the
    kernels' `serve` launches), then a device_resize run with a job at
    another source size. Returns (the jobs, the main run's launch
    counts)."""
    import numpy as np
    import torch
    from PIL import Image

    from devc_tpu_torch.parallel.inference import batched_frame_step
    from devc_tpu_torch.pipeline.scheduler import ClipBatchScheduler
    from devc_tpu_torch.pipeline.video import (
        _device_ref_features_multi,
        frame_step,
    )

    jobs = []
    for j, n in enumerate(SERVE_JOB_FRAMES):
        ref, *frames = textured_frames(seed + 100 + j, n + 1, (H, W))
        clip = os.path.join(tmp, f"job{j}")
        _save_clip(clip, frames)
        ref_path = os.path.join(tmp, f"job{j}_ref.png")
        if j == SERVE_BAD_JOB:
            with open(ref_path, "wb") as f:
                f.write(b"not an image")
        else:
            Image.fromarray(ref).save(ref_path)
        jobs.append(dict(clip=clip, ref_path=ref_path, ref=ref,
                         frames=frames, out=os.path.join(tmp, f"out{j}")))

    def run(sched, picked, tag):
        for j in picked:
            sched.submit(jobs[j]["clip"], jobs[j]["ref_path"],
                         jobs[j]["out"] + tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = allocated_mib()
        _counts_zero()
        t0 = time.perf_counter()
        results = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        SERVE_MEMORY.append({"run": "scheduler" + tag, "before_mib": before,
                             "after_mib": allocated_mib()})
        return results, counts, wall

    sched = ClipBatchScheduler(models, image_size=(H, W), slots=SERVE_SLOTS,
                               out_ext="png")
    results, launches, wall = run(sched, range(len(jobs)), "")
    serve_launches = dict(launches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps = sched.steps
    frame0 = {}
    for j, (job, r) in enumerate(zip(jobs, results)):
        if j == SERVE_BAD_JOB:
            assert "error" in r, r
            continue
        assert r.get("frames") == len(job["frames"]), (j, r)
        got = np.asarray(Image.open(r["outputs"][0]))
        job["alone0"] = _alone_frame0(models, job["frames"], job["ref"])
        frame0[j] = _diff(got, job["alone0"])
    good_frames = sum(len(j["frames"]) for i, j in enumerate(jobs)
                      if i != SERVE_BAD_JOB)
    # the batched step alone, at B = slots, on device-resident inputs, and
    # the one-frame step beside it (host launch cost included in both)
    dev = models.device
    refs = np.stack([jobs[j]["ref"] for j in (0, 1, 2, 4)])
    batch = torch.from_numpy(np.stack([jobs[j]["frames"][0]
                                       for j in (0, 1, 2, 4)])).to(dev)
    _, state = _device_ref_features_multi(models, torch.from_numpy(refs).to(dev))
    last = torch.zeros((SERVE_SLOTS, H // 2, W // 2, 3), device=dev)
    step_ms = cuda_ms(lambda: batched_frame_step(models, batch, last, state),
                      reps=5)
    one = {k: v[:1] for k, v in state.items()}
    frame_ms = cuda_ms(lambda: frame_step(models, batch[0], last[:1], one),
                       reps=5)
    case = {"check": "scheduler", "slots": SERVE_SLOTS, "image_size": [H, W],
            "jobs": len(jobs), "job_frames": list(SERVE_JOB_FRAMES),
            "failed_job": {SERVE_BAD_JOB: results[SERVE_BAD_JOB]},
            "frames": good_frames, "steps": steps, "launches": launches,
            "frame0_vs_alone": frame0, "wall_s": wall,
            "wall_ms_per_step": wall * 1e3 / steps,
            "wall_frames_per_s": good_frames / wall,
            "step_ms_b4": step_ms, "step_frames_per_s": 1e3 * SERVE_SLOTS
            / step_ms, "frame_step_ms_b1": frame_ms, "peak_mem_mib": peak,
            "card": card}
    emit("serve", **case)
    # one K1 launch and six K2 launches per batched step
    assert launches == {"corr_fwd": steps, "smooth_pass": 6 * steps,
                        "tridiag_pcr": 0}, (launches, steps)
    assert all(d["max"] <= 1 for d in frame0.values()), frame0

    # the same good jobs written as JPEG (the server's default): how much
    # of the wall time above is PNG encoding
    good = [j for j in range(len(jobs)) if j != SERVE_BAD_JOB]
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=SERVE_SLOTS)
    results, jpg_launches, jpg_wall = run(sched, good, "_jpg")
    assert [r["frames"] for r in results] == [len(jobs[j]["frames"])
                                              for j in good], results
    emit("serve", check="scheduler_jpeg", jobs=len(good), frames=good_frames,
         steps=sched.steps, launches=jpg_launches, wall_s=jpg_wall,
         wall_ms_per_step=jpg_wall * 1e3 / sched.steps,
         wall_frames_per_s=good_frames / jpg_wall, card=card)

    # device_resize: two jobs at 432x768 and one at RESIZE_SRC, raw frames
    # zero-padded to the largest, the CenterPad in the step
    from devc_tpu_torch.data.transforms import centerpad_np
    from devc_tpu_torch.ops.device_resize import (
        centerpad_plan_padded,
        device_centerpad,
    )

    ref, *big = textured_frames(seed + 200, 6, RESIZE_SRC)
    jobs.append(dict(clip=os.path.join(tmp, "big"),
                     ref_path=os.path.join(tmp, "big_ref.png"),
                     ref=centerpad_np(ref, (H, W)), frames=big,
                     out=os.path.join(tmp, "outbig")))
    _save_clip(jobs[-1]["clip"], big)
    Image.fromarray(ref).save(jobs[-1]["ref_path"])
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=SERVE_SLOTS,
                               out_ext="png", device_resize=True)
    picked = (0, 1, len(jobs) - 1)
    results, launches, wall = run(sched, picked, "_dr")
    frame0 = {}
    for j, r in zip(picked, results):
        assert r.get("frames") == len(jobs[j]["frames"]), (j, r)
        got = np.asarray(Image.open(r["outputs"][0]))
        assert got.shape == (H, W, 3), got.shape
        if j == len(jobs) - 1:  # resized: against the host CenterPad's run
            host_in = centerpad_np(big[0], (H, W))
            want = _alone_frame0(models, [host_in], jobs[j]["ref"])
            mse = np.mean((got.astype(float) - want) ** 2)
            frame0[j] = dict(_diff(got, want), psnr=99.0 if mse == 0 else
                             10 * np.log10(255.0 ** 2 / mse))
            # what the network saw: the device-resized frame (the step's
            # own plan, padded to the batch's largest source) against the
            # host CenterPad; and frame 0 run alone on that device input
            a_h, a_w = (torch.from_numpy(a).to(models.device)
                        for a in centerpad_plan_padded(RESIZE_SRC, (H, W),
                                                       RESIZE_SRC))
            dev_in = device_centerpad(torch.from_numpy(big[0]).to(
                models.device), a_h, a_w).cpu().numpy()
            frame0[j]["resized_input_vs_host"] = _diff(dev_in, host_in)
            frame0[j]["vs_alone_on_device_resized_input"] = _diff(
                got, _alone_frame0(models, [dev_in], jobs[j]["ref"]))
        else:  # identity plans: as the host path
            frame0[j] = _diff(got, jobs[j]["alone0"])
    case = {"check": "scheduler_device_resize", "slots": SERVE_SLOTS,
            "sources": [[H, W], [H, W], list(RESIZE_SRC)],
            "frames": [r["frames"] for r in results], "steps": sched.steps,
            "launches": launches, "frame0_vs_host_path": frame0,
            "wall_s": wall, "card": card}
    emit("serve", **case)
    assert launches == {"corr_fwd": sched.steps,
                        "smooth_pass": 6 * sched.steps,
                        "tridiag_pcr": 0}, launches
    assert all(frame0[j]["max"] <= 1 for j in picked[:2]), frame0
    assert frame0[picked[2]]["psnr"] > 30.0, frame0
    return jobs, serve_launches


def _serve_multi_and_scan(models, tmp, jobs, frames, ref, main_outs, card):
    """Several exemplars (R = 3) and scan mode on the main 8 frames."""
    import numpy as np
    import torch
    from PIL import Image

    from devc_tpu_torch.pipeline import graph, video

    clip = os.path.join(tmp, "main")
    _save_clip(clip, frames)
    ref_paths = []
    for i, r in enumerate([ref] + [jobs[j]["ref"] for j in (0, 1)]):
        ref_paths.append(os.path.join(tmp, f"mref{i}.png"))
        Image.fromarray(r).save(ref_paths[-1])
    refs = [ref] + [jobs[j]["ref"] for j in (0, 1)]
    r_count = len(refs)

    _counts_zero()
    written = video.colorize_video_multi(
        models, clip, ref_paths, [os.path.join(tmp, f"multi{i}")
                                  for i in range(r_count)],
        image_size=(H, W), write_video=False, out_ext="png")
    torch.cuda.synchronize()
    multi_launches = _counts()
    assert [len(w) for w in written] == [len(frames)] * r_count, written
    frame0 = {i: _diff(np.asarray(Image.open(w[0])),
                       main_outs[0] if i == 0 else
                       _alone_frame0(models, frames, refs[i]))
              for i, w in enumerate(written)}

    # scan mode through the entry point, against the main phase's stream
    # outputs; the graph's launches are counted per replay
    runners = []

    class Recorded(graph.CapturedStep):
        def __init__(self, *args):
            super().__init__(*args)
            runners.append(self)

    video.CapturedStep = Recorded
    try:
        _counts_zero()
        scan = video.colorize_video(models, clip, ref_paths[0],
                                    os.path.join(tmp, "scan"),
                                    image_size=(H, W), write_video=False,
                                    mode="scan", chunk=4, out_ext="png")
        torch.cuda.synchronize()
        scan_counted = _counts()
    finally:
        video.CapturedStep = graph.CapturedStep
    scan_equal = [bool(np.array_equal(np.asarray(Image.open(p)), o))
                  for p, o in zip(scan, main_outs)]
    (runner,) = runners

    # per-frame ms of the device loop (host launch cost included, no
    # transfers): eager steps against graph replays, one frame and R = 3
    dev = models.device
    frames_dev = torch.from_numpy(np.stack(frames)).to(dev)
    ms = {}
    for name, r_refs in (("one_exemplar", refs[:1]), ("three_exemplars",
                                                      refs)):
        _, state = video._device_ref_features_multi(
            models, torch.from_numpy(np.stack(r_refs)).to(dev))
        carry = torch.zeros((len(r_refs), H // 2, W // 2, 3), device=dev)
        if len(r_refs) == 1:
            step = lambda f, c: video.frame_step(models, f, c, state)
        else:
            step = lambda f, c: video.frame_step_multi(models, f, c, state)

        def eager():
            c = carry
            for f in frames_dev:
                _, c = step(f, c)

        replay = graph.CapturedStep(step, (H, W, 3), carry)
        ms[name] = {
            "stream_ms_per_frame": cuda_ms(eager, reps=3, warmup=1)
            / len(frames),
            "scan_ms_per_frame": cuda_ms(lambda: replay.run(frames_dev),
                                         reps=3, warmup=1) / len(frames)}
        del replay
    case = {"check": "multi_and_scan", "frames": len(frames),
            "exemplars": r_count, "multi_launches": multi_launches,
            "multi_frame0_vs_serial": frame0,
            "scan_chunk": 4, "scan_vs_stream": "bit-equal"
            if all(scan_equal) else scan_equal,
            "scan_wrapper_counts": scan_counted,
            "scan_launches_per_replay": runner.kernel_launches,
            "scan_replays": runner.replays,
            "scan_kernel_launches": {k: v * runner.replays for k, v in
                                     runner.kernel_launches.items()},
            "note": "graph replays run no Python: the wrappers count the "
                    "warm-up step and the capture; the kernels launched by "
                    "the replays are replays x launches per replay",
            "ms": ms, "card": card}
    emit("serve", **case)
    assert multi_launches == {"corr_fwd": len(frames),
                              "smooth_pass": 6 * len(frames),
                              "tridiag_pcr": 0}, multi_launches
    assert all(d["max"] <= 1 for d in frame0.values()), frame0
    assert all(scan_equal) and len(scan) == len(frames), scan_equal
    assert runner.replays == len(frames)
    assert runner.kernel_launches == {"corr_fwd": 1, "smooth_pass": 6,
                                      "tridiag_pcr": 0}
    return clip, ref_paths[0]


def _serve_server(clip, ref_path, tmp, seed):
    """python -m devc_tpu_torch.cli.serve on the card, as a subprocess:
    ready line, ping, one job, one batch, shutdown, exit 0."""
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "devc_tpu_torch.cli.serve", "--random_init",
         "--seed", str(seed), "--image_size", str(H), str(W)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    lines = []

    def ask(req):
        if req is not None:
            proc.stdin.write(json.dumps(req) + "\n")
            proc.stdin.flush()
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the server exited: {proc.stderr.read()}")
        lines.append(json.loads(line))
        return lines[-1]

    t0 = time.perf_counter()
    try:
        ready = ask(None)
        assert ready.get("ready") is True, ready
        assert ask({"cmd": "ping"}) == {"ok": True, "pong": True}
        job = ask({"clip_path": clip, "ref_path": ref_path,
                   "output_path": os.path.join(tmp, "srv_job"),
                   "mode": "scan", "chunk": 4})
        assert job["ok"] is True and job["frames"] == N_FRAMES, job
        batch = ask({"cmd": "batch", "slots": 2, "jobs": [
            {"clip_path": clip, "ref_path": ref_path,
             "output_path": os.path.join(tmp, f"srv_b{i}")}
            for i in range(2)]})
        assert batch["ok"] is True, batch
        assert [r["frames"] for r in batch["results"]] == [N_FRAMES] * 2
        assert ask({"cmd": "shutdown"}) == {"ok": True, "bye": True}
        code = proc.wait(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert code == 0, code
    emit("serve", check="server", ran="python -m devc_tpu_torch.cli.serve",
         exit_code=code, wall_s=time.perf_counter() - t0,
         responses=[{k: v for k, v in r.items() if k != "results"}
                    for r in lines])


def allocated_mib() -> float:
    import torch

    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 2**20


SERVE_MEMORY: list = []  # allocated MiB around each scheduler run / request


def _serve_requests_memory(models, clip, ref_path, tmp):
    """cli.serve's request handlers in this process, each request twice
    (a scan job, a stream job, a 2-slot batch): device memory allocated
    before and after each, to see whether a request leaves anything
    behind."""
    from devc_tpu_torch.cli import serve

    reqs = [("job_scan", serve._job, {"mode": "scan", "chunk": 4}),
            ("job_stream", serve._job, {}),
            ("batch", serve._batch, {"slots": 2, "jobs": [
                {"clip_path": clip, "ref_path": ref_path,
                 "output_path": os.path.join(tmp, f"mem_b{i}")}
                for i in range(2)]})]
    for rep in range(2):
        for name, fn, extra in reqs:
            job = {"clip_path": clip, "ref_path": ref_path,
                   "output_path": os.path.join(tmp, f"mem_{name}{rep}"),
                   **extra}
            before = allocated_mib()
            resp = fn(models, job, (H, W), 1e-10)
            assert resp["ok"] is True, resp
            SERVE_MEMORY.append({"run": f"request_{name}_{rep}",
                                 "before_mib": before,
                                 "after_mib": allocated_mib()})
    # a request repeated leaves nothing behind (each scan-mode request
    # once kept a new stream's 32 MiB cuBLAS workspace)
    grown = [r for r in SERVE_MEMORY[-len(reqs):]
             if r["after_mib"] != r["before_mib"]]
    assert not grown, grown


def _serve_video(models, frames, ref, tmp):
    """A video file as the clip, when cv2 imports."""
    try:
        import cv2
    except ImportError:
        emit("serve", check="video_file", ran="skipped: no cv2")
        return
    import numpy as np
    from PIL import Image

    from devc_tpu_torch.pipeline import video

    path = os.path.join(tmp, "clip.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24, (W, H))
    if not wr.isOpened():
        raise RuntimeError("cv2 cannot write an MJPG .avi here")
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()
    ref_path = os.path.join(tmp, "vref.png")
    Image.fromarray(ref).save(ref_path)
    written = video.colorize_video(models, path, ref_path,
                                   os.path.join(tmp, "vid"), image_size=(H, W),
                                   write_video=False, out_ext="png")
    decoded = list(video._video_frames_rgb(path))
    want = []
    video.colorize_frames(models, decoded, ref, lambda i, a: want.append(a))
    same = [bool(np.array_equal(np.asarray(Image.open(p)), w))
            for p, w in zip(written, want)]
    emit("serve", check="video_file", ran="colorize_video on an MJPG .avi",
         frames=len(written), equal_to_colorize_frames_on_decoded=all(same),
         psnr_frame0_vs_source_frames=float(10 * np.log10(255.0 ** 2 / max(
             np.mean((decoded[0].astype(float) - frames[0]) ** 2), 1e-12))))
    assert len(written) == len(frames) and all(same), same


def phase_serve(models, frames, ref, main_outs, seed: int, card: str):
    """The serving path on the card: K2's batched pass and K1 at the
    serving batches against their plain versions; ClipBatchScheduler (4
    slots, 6 jobs, one failing) and its device_resize run; several
    exemplars and scan mode; the server as a subprocess; a video file.
    Returns (K2 rows, K1 rows, the scheduler run's launch counts)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed + 31)
    start_mib = allocated_mib()
    k2, k1 = _serve_kernels(rng, models.device)
    tmp = tempfile.mkdtemp(prefix="devc_chip_serve_")
    try:
        jobs, launches = _serve_scheduler(models, tmp, seed, card)
        clip, ref_path = _serve_multi_and_scan(models, tmp, jobs, frames, ref,
                                               main_outs, card)
        _serve_requests_memory(models, clip, ref_path, tmp)
        _serve_server(clip, ref_path, tmp, seed)
        _serve_video(models, frames, ref, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("serve", check="memory", allocated_mib_at_start=start_mib,
         allocated_mib_at_end=allocated_mib(), runs=SERVE_MEMORY)
    return k2, k1, launches


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
    groups, launches, fft = {}, 0, {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        launches += 1
        name = evt.name.lower()
        if "fft" in name or "cf32" in name:
            row = fft.setdefault(evt.name[:160], {"launches": 0, "ms": 0.0})
            row["launches"] += 1
            row["ms"] += evt.time_range.elapsed_us() / 1e3
        group = next((g for g, frags in KERNEL_GROUPS
                      if any(f.lower() in name for f in frags)),
                     "elementwise, reductions, copies")
        groups[group] = groups.get(group, 0.0) + evt.time_range.elapsed_us() / 1e3
    kernel_ms = sum(groups.values())
    emit("train_profile", kernel_ms_by_group=dict(
        sorted(groups.items(), key=lambda kv: -kv[1])),
        kernel_ms=kernel_ms, kernel_launches=launches,
        untraced_step_ms=step_ms,
        busy_share=kernel_ms / step_ms if kernel_ms else "not measured",
        fft_or_cf32_kernels=fft)
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


# cli_train: the trainer's entry point at its defaults (batch 16, 216x384)
# on synthetic datasets written to disk
CLI_TRAIN_STEPS, CLI_TRAIN_CKPT_STEP = 30, 15
CLI_TRAIN_STILLS = 64  # ImageNet-style stills, 4 classes of 16
CLI_TRAIN_VIDEO_HW = (240, 416)  # video-pair frames, center-cropped


def write_imagenet_root(root: str, seed: int) -> None:
    """ImageNet-pairs layout (ImageNetPairsDataset): class folders of
    textured stills of 240-320 x 400-560 in input/, consecutive stills
    paired in pairs.txt with a positive score."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    per_class = CLI_TRAIN_STILLS // 4
    for c in range(4):
        d = os.path.join(root, f"class{c}", "input")
        os.makedirs(d)
        for i in range(per_class):
            hw = (int(rng.randint(240, 321)), int(rng.randint(400, 561)))
            (img,) = textured_frames(int(rng.randint(1 << 30)), 1, hw)
            Image.fromarray(img).save(os.path.join(d, f"img{i}.JPEG"),
                                      quality=95)
        with open(os.path.join(root, f"class{c}", "pairs.txt"), "w") as f:
            for i in range(per_class - 1):
                f.write(f"img{i}.JPEG img{i + 1}.JPEG 1.0\n")


def write_video_root(root: str, seed: int) -> None:
    """Video-pairs layout (VideoPairsDataset, the reference's
    lib/videoloader.py): per clip input_pad/ frames, reference/ and
    reference_gt/ exemplars, flow/ .flo files of a known translation per
    pair (frame b is frame a moved by (dx, dy)), mask/ occlusion masks
    (0 where the translation brings in new content), and
    pairs_output_new.txt."""
    import numpy as np
    from PIL import Image

    from devc_tpu_torch.data.flow import write_flo

    rng = np.random.RandomState(seed)
    h, w = CLI_TRAIN_VIDEO_HW
    for c in range(2):
        clip = os.path.join(root, f"clip{c}")
        for sub in ("input_pad", "reference", "reference_gt", "flow", "mask"):
            os.makedirs(os.path.join(clip, sub))
        (base,) = textured_frames(seed + 10 + c, 1, (h + 40, w + 40))
        shifts = [(0, 0), (3, 2), (6, 5), (8, 9)]
        for i, (dx, dy) in enumerate(shifts):
            frame = base[20 - dy:20 - dy + h, 20 - dx:20 - dx + w]
            Image.fromarray(frame).save(
                os.path.join(clip, "input_pad", f"f{i}.jpg"), quality=95)
        refs = textured_frames(seed + 20 + c, 8, (h, w))
        for i in range(5):
            Image.fromarray(refs[i]).save(
                os.path.join(clip, "reference", f"r{i}.JPEG"), quality=95)
        for i in range(3):
            Image.fromarray(refs[5 + i]).save(
                os.path.join(clip, "reference_gt", f"g{i}.jpg"), quality=95)
        lines = []
        for i in range(len(shifts) - 1):
            dx = shifts[i + 1][0] - shifts[i][0]
            dy = shifts[i + 1][1] - shifts[i][1]
            fwd = np.empty((h, w, 2), np.float32)
            fwd[..., 0], fwd[..., 1] = dx, dy
            write_flo(os.path.join(clip, "flow", f"f{i}_forward.flo"), fwd)
            write_flo(os.path.join(clip, "flow", f"f{i}_backward.flo"), -fwd)
            mask = np.full((h, w), 255, np.uint8)
            mask[:dy], mask[:, :dx] = 0, 0
            Image.fromarray(mask).save(
                os.path.join(clip, "mask", f"f{i}_mask.pgm"))
            lines.append(f"f{i}.jpg f{i + 1}.jpg rv.jpg rv1.jpg r0.J r1.J "
                         "r2.J r3.J r4.J g0.j g1.j g2.j")
        with open(os.path.join(clip, "pairs_output_new.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def _train_counts_zero():
    from devc_tpu_torch.ops import cuda_corr

    for fn in (cuda_corr.corr_fwd, cuda_corr.corr_bwd_dq,
               cuda_corr.corr_bwd_dkv):
        fn.launches = 0


def _train_counts():
    from devc_tpu_torch.ops import cuda_corr

    return {"corr_fwd": cuda_corr.corr_fwd.launches,
            "corr_bwd_dq": cuda_corr.corr_bwd_dq.launches,
            "corr_bwd_dkv": cuda_corr.corr_bwd_dkv.launches}


def _state_blob_equal(a: dict, b: dict) -> bool:
    """Two checkpoint blobs (nested dicts of tensors and numbers) equal
    bit for bit."""
    import torch

    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_state_blob_equal(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
    return a == b


def phase_cli_train(frames, ref, seed: int, card: str):
    """python -m devc_tpu_torch.cli.train's main path, in this process, on
    both training datasets written to disk: 30 steps at the trainer's
    defaults (batch 16, 216x384, float batches, --workers 8), then a
    2-step --device_preprocess run, --resume (bit-equal restore of step
    30, steps 31-32) and its VGG-mismatch refusal, cli.export and
    cli.colorize --train_ckpt on 8 frames at 432x768. Returns the launch
    counts of the training run and of the colorize run."""
    import numpy as np
    import torch
    from PIL import Image

    from devc_tpu_torch.cli import colorize as cli_colorize
    from devc_tpu_torch.cli import export as cli_export
    from devc_tpu_torch.cli import train as cli_train
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.pipeline.video import colorize_frames
    from devc_tpu_torch.train import checkpoint

    tmp = tempfile.mkdtemp(prefix="devc_chip_cli_train_")
    try:
        imagenet, video = (os.path.join(tmp, d) for d in ("imagenet", "video"))
        t0 = time.perf_counter()
        write_imagenet_root(imagenet, seed + 40)
        write_video_root(video, seed + 41)
        data_s = time.perf_counter() - t0
        ckpt, runs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "runs")
        common = ["--data_root", video, "--data_root_imagenet", imagenet,
                  "--vgg_ckpt", "/nonexistent/vgg19_conv.pth",
                  "--seed", str(seed)]

        def train(ckpt_dir, log_dir, *extra):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _train_counts_zero()
            summary = cli_train.main(common + [
                "--checkpoint_dir", ckpt_dir, "--log_dir", log_dir,
                "--print_step", "1", *extra])
            torch.cuda.synchronize()
            return (summary, _train_counts(),
                    torch.cuda.max_memory_allocated() / 2**20)

        summary, launches, peak = train(
            ckpt, runs, "--max_steps", str(CLI_TRAIN_STEPS),
            "--checkpoint_step", str(CLI_TRAIN_CKPT_STEP),
            "--tb_log_step", str(CLI_TRAIN_CKPT_STEP))
        metrics = [json.loads(line) for line in
                   open(os.path.join(runs, "metrics.jsonl"))]
        total = [m["total_loss"] for m in metrics]
        first8, last8 = statistics.mean(total[:8]), statistics.mean(total[-8:])
        step_ms = [s * 1e3 for s in summary["step_s"]]
        case = {
            "check": "train", "batch": TRAIN_B, "image_size": list(TRAIN_HW),
            "steps": summary["steps"], "workers": 8,
            "data_write_s": data_s, "step_ms": step_ms,
            "median_step_ms_after_first": statistics.median(step_ms[1:]),
            "step_timer_ema_ms": summary["step_ms_ema"],
            "loader_wait_ms": [s * 1e3 for s in summary["loader_wait_s"]],
            "loader_wait_share": summary["loader_wait_share"],
            "wall_s": summary["wall_s"], "peak_mem_mib": peak,
            "launches": launches, "total_loss": total,
            "total_loss_first8_mean": first8, "total_loss_last8_mean": last8,
            "losses_last": metrics[-1], "checkpoints": sorted(
                os.listdir(ckpt)), "card": card}
        emit("cli_train", **case)
        assert summary["steps"] == CLI_TRAIN_STEPS, summary["steps"]
        assert [m["step"] for m in metrics] == list(
            range(1, CLI_TRAIN_STEPS + 1))
        for m in metrics:
            assert all(np.isfinite(v) for v in m.values()), m
        n = CLI_TRAIN_STEPS
        assert launches == {"corr_fwd": 4 * n, "corr_bwd_dq": 2 * n,
                            "corr_bwd_dkv": 2 * n}, launches
        assert last8 < first8, (first8, last8)
        assert checkpoint.load_run_metadata(ckpt) == {
            "vgg_source": "random:seed1"}

        # the uint8 contract: Lab, jitter and placeholder on the card
        dp, dp_launches, dp_peak = train(
            os.path.join(tmp, "ckpt_dp"), os.path.join(tmp, "runs_dp"),
            "--max_steps", "2", "--device_preprocess")
        dp_metrics = [json.loads(line) for line in
                      open(os.path.join(tmp, "runs_dp", "metrics.jsonl"))]
        for m in dp_metrics:
            assert all(np.isfinite(v) for v in m.values()), m
        assert dp_launches == {"corr_fwd": 8, "corr_bwd_dq": 4,
                               "corr_bwd_dkv": 4}, dp_launches

        # --resume: the restored state is the step-30 file, bit for bit
        saved, _ = checkpoint.load_train_state_dict(ckpt, CLI_TRAIN_STEPS)
        restored = {}
        real_restore = checkpoint.CheckpointManager.restore

        def recording_restore(self, state_like, step=None):
            state = real_restore(self, state_like, step)
            restored["blob"] = {
                "step": state.step,
                "params_g": {net: state.params_g[net].state_dict()
                             for net in ("warpnet", "colorvid")},
                "params_d": state.params_d.state_dict(),
                "sn_state": state.sn_state,
                "opt_state_g": state.opt_state_g._asdict(),
                "opt_state_d": state.opt_state_d._asdict()}
            restored["blob"] = _clone_to_cpu(restored["blob"])
            return state

        checkpoint.CheckpointManager.restore = recording_restore
        try:
            res, res_launches, _ = train(ckpt, runs, "--resume",
                                         "--max_steps", "2",
                                         "--checkpoint_step",
                                         str(CLI_TRAIN_CKPT_STEP))
        finally:
            checkpoint.CheckpointManager.restore = real_restore
        bit_equal = _state_blob_equal(restored["blob"], saved)
        resumed_steps = [json.loads(line)["step"] for line in
                         open(os.path.join(runs, "metrics.jsonl"))][n:]
        after = sorted(os.listdir(ckpt))

        # a torch VGG file where the run trained against the seed-1 draw
        exported = os.path.join(tmp, "exported")
        t0 = time.perf_counter()
        cli_export.main(["--train_ckpt", ckpt, "--out", exported,
                         "--discriminator", "--vgg"])
        export_s = time.perf_counter() - t0
        refusal = None
        try:
            cli_train.main(common[:-4] + [
                "--vgg_ckpt", os.path.join(exported, "vgg19_conv.pth"),
                "--seed", str(seed), "--checkpoint_dir", ckpt,
                "--log_dir", os.path.join(tmp, "runs_refused"), "--resume",
                "--max_steps", "1"])
        except SystemExit as e:
            refusal = str(e)
        emit("cli_train", check="resume", restored_step=saved["step"],
             restore_bit_equal=bit_equal, first_step=res["first_step"],
             last_step=res["last_step"], metric_steps=resumed_steps,
             launches=res_launches, checkpoints=after,
             device_preprocess={"steps": dp["steps"], "launches": dp_launches,
                                "peak_mem_mib": dp_peak,
                                "step_ms": [s * 1e3 for s in dp["step_s"]],
                                "total_loss": [m["total_loss"]
                                               for m in dp_metrics]},
             export_s=export_s, exported=sorted(os.listdir(exported)),
             vgg_mismatch_refusal=refusal, card=card)
        assert bit_equal, "the restored state differs from the step-30 file"
        assert (res["first_step"], res["last_step"]) == (n + 1, n + 2), res
        assert resumed_steps == [n + 1, n + 2], resumed_steps
        assert f"step_{n + 2:09d}.pt" in after, after
        assert res_launches == {"corr_fwd": 8, "corr_bwd_dq": 4,
                                "corr_bwd_dkv": 4}, res_launches
        assert refusal is not None and "vgg_source" in refusal, refusal

        # the exported files load strictly; cli.colorize --train_ckpt on
        # the card with the seed-1 VGG the run recorded
        models = PipelineModels.from_state_dicts({
            name: torch.load(os.path.join(exported, f), weights_only=True)
            for name, f in (("vgg", "vgg19_conv.pth"),
                            ("warpnet", f"nonlocal_net_iter_{n + 2}.pth"),
                            ("colorvid", f"colornet_iter_{n + 2}.pth"))},
            "cuda")
        clip = os.path.join(tmp, "clip")
        _save_clip(clip, frames)
        ref_path = os.path.join(tmp, "ref.png")
        Image.fromarray(ref).save(ref_path)
        out = os.path.join(tmp, "colorized")
        _counts_zero()
        t0 = time.perf_counter()
        cli_colorize.main([
            "--clip_path", clip, "--ref_path", ref_path, "--output_path", out,
            "--train_ckpt", ckpt, "--vgg_ckpt", "/nonexistent/vgg19_conv.pth",
            "--image_size", str(H), str(W), "--no_video", "--device", "cuda"])
        torch.cuda.synchronize()
        colorize_s = time.perf_counter() - t0
        col_launches = _counts()
        out_dir = os.path.join(out, "clip_ref")
        outs = [np.asarray(Image.open(os.path.join(out_dir, f)))
                for f in sorted(os.listdir(out_dir))]
        chroma = max(int(np.abs(o[..., 0].astype(int) - o[..., 1]).max())
                     for o in outs)
        want0 = []
        colorize_frames(models, frames[:1], ref, lambda i, a: want0.append(a))
        # the CLI writes JPEG (q95): frame 0 against the exported weights'
        # own frame 0, by PSNR
        mse = np.mean((outs[0].astype(float) - want0[0]) ** 2)
        psnr = 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))
        emit("cli_train", check="colorize_train_ckpt", frames=len(outs),
             image_size=[H, W], launches=col_launches, max_r_minus_g=chroma,
             frame0_psnr_vs_exported_weights=psnr, wall_s=colorize_s,
             card=card)
        assert len(outs) == len(frames), len(outs)
        assert chroma > 3, "outputs are gray: no chroma was added"
        assert col_launches == {"corr_fwd": len(frames),
                                "smooth_pass": 6 * len(frames),
                                "tridiag_pcr": 0}, col_launches
        assert psnr > 30.0, psnr
        del models
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, col_launches


def _clone_to_cpu(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _clone_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


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
    k2_serve, k1_serve, serve = phase_serve(models, frames, ref, outs,
                                            args.seed, card)
    del models
    torch.cuda.empty_cache()
    # what stays allocated with every model gone: cuBLAS keeps a workspace
    # per (handle, stream) it has run on; clearing them shows their share
    residue = allocated_mib()
    torch._C._cuda_clearCublasWorkspaces()
    emit("serve", check="memory_after_models_freed", allocated_mib=residue,
         allocated_mib_without_cublas_workspaces=allocated_mib())
    phase_train_parity(args.seed)
    train = phase_train(args.seed, card)
    cli_train, cli_colorize = phase_cli_train(frames, ref, args.seed, card)

    # the serving path's shapes beside each kernel's own
    pick = ("b", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    k1["by_shape"] += [dict({k: c[k] for k in pick}, n=c["n"],
                            temperature=1e-10, theta=c["theta"],
                            library_ms=c["library_ms"], path="serve")
                       for c in k1_serve]
    k1["max_abs_err"] = max([k1["max_abs_err"]]
                            + [c["max_abs_err"] for c in k1_serve])
    smooth = k2["entries"][0]
    smooth["by_shape"] += [dict({k: c[k] for k in pick}, h=c["h"], w=c["w"],
                                axis=c["axis"], guide=c["guide"],
                                path="serve") for c in k2_serve]
    smooth["max_abs_err"] = k2["max_abs_err"] = max(
        [smooth["max_abs_err"]] + [c["max_abs_err"] for c in k2_serve])
    # launches: each driven path's count, read right after that path ran
    # with the counts at 0 (inference main path, the batched serving
    # scheduler, the training step, cli.train's 30 steps, cli.colorize
    # --train_ckpt on its checkpoint)
    by_path = lambda name: {"main": launches.get(name, 0),
                            "serve": serve.get(name, 0),
                            "train": train.get(name, 0),
                            "cli_train": cli_train.get(name, 0),
                            "cli_train_colorize": cli_colorize.get(name, 0)}
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
