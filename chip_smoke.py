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
               [B, L] shapes) vs their plain PyTorch versions on the card
               (K1 by `_k1_case`, as every phase checks it: sim also
               against float64, out at T = 0.01 against the plain version
               in float64 and no farther from it than the fp32 plain
               version): errors and median CUDA-event times of both, and
               of one PyTorch call computing K1's out (SDPA on the fp32
               inputs, the values zero-padded to 16-byte rows for the
               fused backends: `sdpa_ms`) as a yardstick; bounds from
               `bound` / `k1_bound` (fp32-accurate products at three TF32
               passes).
  4. bwd       K2b / K3 (the correspondence backward: K3 the one score
               pass with dphi, K2b dtheta from its df scratch) vs the
               plain version in float64 (`bwd_float64`), and no farther
               from it than the fp32 plain version, at the training shape
               (B = 16, N = 5184, C = 256, T = 0.01), at B = 1, at C = 96 and
               512 (ragged N) and at B = 1, N = 20736: errors, a second
               call bit-equal, a chunked run (4 chunks) bit-equal to one
               chunk, the df scratch bytes; K1's sim bit-equal to the
               row max K3 finds (B = 16, C = 96, 512); at N = 5184 ms of
               each kernel, of K3's score pass and product apart, of the
               score rule's TF32 split of theta and phi alone, of the
               pair and of the plain backward, with each one's bound
               (`bwd_bounds`) and the pair's; and the sim-gradient
               routing check (d_out = 0, d_sim = 1: dtheta of every row
               is phi at the row's argmax).
  5. parity    one frame at a small size, teacher-forced, on the card
               (kernels) vs on the CPU (plain versions).
  6. conv_split  the split convolution (ops/conv_split.py) at the main
               path's shapes: one exemplar preparation and one frame step
               at 432x768 recorded (57 split calls a frame, 28 a
               preparation; the kernel launches the card's launch plans
               give, which every later launch check reads; the same at
               224x384 for the convergence phase), then every distinct
               shape on its recorded inputs against the plain version
               (`split_conv2d_plain`) and float64, within 2^-17 of
               max |x|*|w| and no farther from float64 than cuDNN's fp32
               call (2^-23 at the two shapes where that call is an FFT):
               ms, plain ms, cuDNN fp32 ms and the bound (three TF32
               passes a product, 165 TFLOP/s of fp32-accurate work).
  7. main      colorize_frames on 8 textured 432x768 frames with seeded
               random weights at full model width, fp32, T = 1e-10, WLS on:
               outputs checked, kernel launch counts checked (K1 once,
               K2's smoother pass six times and the split convolution's
               frame launches per frame, and its launches of one
               exemplar preparation), per-frame ms from CUDA events.
  8. layers    one frame's stages timed one by one with CUDA events.
  9. cli       python -m devc_tpu_torch.cli.colorize on the frames written
               as PNGs, when Pillow is installed (else says it skipped).
 10. bf16      the bf16 mode (cli.colorize --bf16): K1's bf16 kernel
               (scores on the tensor cores) at B = 1, N = 5184 and 20736
               against its plain version at T = 0.01, 1 and 1e-10, a
               second call bit-equal, an exact tie averaged exactly, with
               ms, the bf16 bound and SDPA on the bf16 inputs;
               frame_step in bf16 on the card against the CPU's bf16 path
               (64x128, teacher-forced); the main path in bf16 on the 8
               frames (launches: K1's bf16 kernel 8, K2 48), scan
               bit-equal to stream; ms a frame of fp32 and bf16 at
               432x768 (stream, scan) and 864x1536 (stream); the stages
               in bf16; cli.colorize with and without --bf16 and
               cli.evaluate on the card over both outputs; bf16 against
               fp32 frames (PSNR, largest uint8 difference, share of
               pixels moved), teacher-forced and free-running, on the
               random weights (and, in phase cli_train, on its checkpoint).
 11. serve     the serving path: K2's batched pass (B = 4 guides, B = 3
               one shared guide, 432x768, both axes) and K1 at B = 4 and
               3 (N = 5184, T = 1e-10) vs their plain versions, with ms,
               bounds and SDPA; ClipBatchScheduler at 432x768 (4 slots,
               6 jobs of 5-9 PNG frames, one with a corrupt exemplar that
               fails alone): frame counts, each job's frame 0 within +-1
               of the clip alone, one K1, six K2 launches and a frame's
               split convolutions per batched step, ms per step,
               frames/s, peak memory; a device_resize run with one job
               at 540x960; colorize_video_multi with
               R = 3 (launches, frame 0 within +-1 of serial runs); scan
               mode (chunk 4) bit-equal to stream, per-frame ms of both;
               the server's request handlers in process, each request
               twice, with device memory before and after each (a repeat
               must leave nothing behind), and the device-resized input's
               difference to the host CenterPad; python -m
               devc_tpu_torch.cli.serve as a subprocess (ready, ping, a
               job, a batch, shutdown, exit 0); a video file when cv2
               imports.
 12. train_parity  one GAN training step at 64x128, batch 2, on the card
               (kernels) against the same step on the CPU in fp32 and in
               float64 (plain versions), same weights and batch.
 13. train     the training main path: train_step_u8 at batch 16, 216x384,
               full width, TrainConfig defaults (T = 0.01, luminance noise
               2.0, remat), 1 warm-up + 4 timed steps: ms per step, peak
               memory, every loss, weights moved, kernel launch counts
               (per step K1 4 times: twice per frame, the forward and its
               recomputation under remat; K2b and K3 once per frame), and a
               checkpoint save / restore that must be bit-equal.
 14. cli_train the trainer's entry point in process, on an ImageNet-style
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
               smooth_pass 48, chroma); the bf16 mode's quality on the
               exported checkpoint (as in phase bf16).
 15. convergence  python -m devc_tpu_torch.examples.convergence_demo in
               process on a generated scene tree (12 scenes of 3-4 stills,
               a palette each; `write_scene_tree`): 40 steps at batch 8,
               216x384, --holdout 2, --device-preprocess, then both
               held-out arms (the checkpoint, random weights) through
               cli.colorize and cli.evaluate at 224x384 on the card: exit
               0 (total_loss fell), every loss finite, launches K1 / K2b /
               K3 4 / 2 / 2 a step (no split convolution), one K1, six K2
               launches and a 224x384 frame's split convolutions a
               held-out frame in each arm, the summary's schema, device
               memory after the last step within 1% of that after step 10; ms a
               step and the loader-wait share; before it K1 at the
               evaluation's shape (B = 1, N = 1344, T = 1e-10) and K2's
               pass over a 224x384 frame against their plain versions,
               with ms, plain ms, SDPA's ms and bounds. chip_convergence.py
               runs the same demo for 1000 steps.
 16. parallel  the parallel layer, ranks as spawned processes (any rank
               that fails or runs late fails the phase; none is left
               running): K1 alone at the shard shapes (rows: N/2 queries;
               keys: N/2 keys with l) at N = 5184 and 20736 with ms, plain
               and SDPA times and bounds, and K1, K3 and K2b at a rank's
               half of the training batch (B = 8); 2 ranks sharing the
               card over gloo: correspondence_warp_sharded / _key_sharded at both N
               (sim bit-equal to unsharded K1, out within K1's tolerances
               of the plain version, ms of the call per rank), frames at
               432x768 with corr_sharding rows and keys (teacher-forced,
               within +-1 of the unsharded frames) and the data-parallel
               batched step (4 clips, 2 a rank) against the one-process
               B = 4 step; make_train_step_spmd at batch 16 (8 a rank),
               216x384, full width: its gradients against the one-process
               step's under phase train_parity's rule (T = 1, recurrence
               damped, within 3x an fp32 step's distance from float64),
               then TrainConfig defaults, ms a step and peak memory per
               rank; the same on one NCCL rank; python -m
               torch.distributed.run --nproc_per_node 2 -m
               devc_tpu_torch.cli.train (12 steps at batch 16, loss
               falling, rank 0 alone logging and checkpointing, then
               --resume for 2 more). The ranks report their launch counts:
               paths parallel, train_spmd and cli_train_ranks.

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
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
PEAK_BYTES_PER_S = 3.35e12
# the bf16 mode's per-frame times: (H, W) of the frames, timed stream and
# scan (scan only at 432x768)
BF16_SIZES = ((H, W), (2 * H, 2 * W))


def bound(flop: float, nbytes: float, tf32x3_flop: float = 0.0) -> dict:
    """The least time the card could take: the larger of the operations and
    the bytes at the memory rate. The operations are `flop` on the fp32
    pipe (FMA units, PEAK_FP32_FLOPS) and `tf32x3_flop` of fp32-accurate
    products, each of which the tensor cores form as three TF32 passes
    (3 x tf32x3_flop at PEAK_TF32_FLOPS); the two pipes run side by side,
    so the operations take the longer of the two."""
    ops_ms = max(flop / PEAK_FP32_FLOPS,
                 3 * tf32x3_flop / PEAK_TF32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def k1_bound(b: int, nq: int, nk: int, c: int = 256,
             emit_l: bool = False) -> dict:
    """K1 fp32's bound: the scores (2 b nq nk c FLOP, fp32-accurate: three
    TF32 passes on the tensor cores) beside the softmax's weights and P.V
    (2 b nq nk 3 FLOP on the fp32 pipe); theta, phi, values read once, out
    and sim (and l) written once. `fma_rate_bound_ms` is the retired bound,
    every operation at the fp32 FMA rate."""
    pairs = b * nq * nk
    nbytes = 4 * b * (nq * c + nk * (c + 3) + nq * (4 + emit_l))
    return {**bound(2 * pairs * 3, nbytes, 2 * pairs * c),
            "fma_rate_bound_ms": bound(2 * pairs * (c + 3), nbytes)["bound_ms"]}


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


def cuda_ms(fn, reps: int = 10, warmup: int = 2, queued: bool = False,
            spin_cycles: int = 2_000_000) -> float:
    """Median milliseconds of fn() over reps, each bracketed by CUDA
    events on the current stream. With queued, the card first spins for
    spin_cycles clock cycles (torch.cuda._sleep; the default is about a
    millisecond), so the host has enqueued fn's launches before the start
    event runs: the events then time the device's work alone, not the
    host's launch cost (which dominates a call of a few microseconds on
    the card). A call of many launches needs a longer spin."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin_cycles)
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


def _k1_case(theta, phi, values, t: float, emit_l: bool = False,
             timed: bool = True) -> dict:
    """K1 fp32 on these inputs against its plain version: sim within 1e-5
    of it and within 1e-6 of float64, l >= 1 (asked for in the check
    whatever emit_l); at T = 0.01 out within 1e-3 of the plain version in
    float64 and no farther from it than the fp32 plain version; at T =
    1e-10 at most 1e-3 of rows differing from the fp32 plain version.
    With timed, at emit_l: ms, plain ms, SDPA's call (sdpa_ms), the bound
    (k1_bound). Returns the case; max_abs_err is out's and sim's (sim's
    alone at T = 1e-10, where out is an argmax)."""
    import torch

    from devc_tpu_torch.ops.correspondence import (
        correspondence_fwd_plain,
        correspondence_warp_einsum,
    )
    from devc_tpu_torch.ops.cuda_corr import corr_fwd

    b, nq, c = theta.shape
    nk = phi.shape[1]
    out, sim, l = corr_fwd(theta, phi, values, t, emit_l=True)
    want_out, want_sim = correspondence_warp_einsum(theta, phi, values, t)
    sim64 = torch.bmm(theta.double(), phi.double().transpose(1, 2)
                      ).amax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    row_err = (out - want_out).abs().amax(dim=-1)
    case = {"kernel": "corr_fwd", "b": b, "nq": nq, "nk": nk, "c": c,
            "temperature": t, "emit_l": emit_l,
            "sim_max_abs_err": (sim - want_sim).abs().max().item(),
            "sim_max_abs_err_vs_float64":
                (sim.double() - sim64).abs().max().item(),
            "l_min": l.min().item()}
    del sim64
    # sim: a max of fp32 dot products summed in another order; and within
    # what the fp32 score rule may lose against float64 on unit rows
    # (tests/test_torch_corr_fp32_plan.py::SIM_FP64_BOUND)
    assert case["sim_max_abs_err"] <= 1e-5, case
    assert case["sim_max_abs_err_vs_float64"] <= 1e-6, case
    assert case["l_min"] >= 1.0, case  # the max contributes 1
    if t == 0.01:
        # exp((s - m) / T) turns a score round-off d (~1e-7) into a
        # relative weight change d / T ~ 1e-5, which moves a weighted mean
        # of values spanning 200 by ~1e-3 at most: the bound devc_tpu's
        # tests hold its Pallas kernel to against the einsum path
        # (tests/test_pallas_corr.py). Held against the plain version in
        # float64: the fp32 plain version's own cuBLAS round-off (~3e-7 in
        # a score, more than the kernel's) takes up that bound's room at N
        # = 20736. The kernel must lie no farther from float64 than the
        # fp32 plain version does.
        out64, _ = correspondence_warp_einsum(
            theta.double(), phi.double(), values.double(), t)
        case["out_max_abs_err_vs_plain_fp32"] = row_err.max().item()
        case["out_max_abs_err"] = (out.double() - out64).abs().max().item()
        case["plain_fp32_out_max_abs_err_vs_float64"] = (
            want_out.double() - out64).abs().max().item()
        del out64
        assert case["out_max_abs_err"] <= 1e-3, case
        assert case["out_max_abs_err"] <= \
            case["plain_fp32_out_max_abs_err_vs_float64"], case
        case["max_abs_err"] = max(case["out_max_abs_err"],
                                  case["sim_max_abs_err"])
    else:
        # T = 1e-10 is an exact argmax-average; a row whose two best
        # scores differ by less than the summation-order round-off may
        # pick another key (near-tie flip), so up to 0.1% of rows may
        # differ and all others must be equal
        case["rows_differing"] = (row_err > 1e-4).float().mean().item()
        assert case["rows_differing"] <= 1e-3, case
        case["max_abs_err"] = case["sim_max_abs_err"]
    del out, sim, l, want_out, want_sim, row_err
    if timed:
        plain = correspondence_fwd_plain if emit_l else \
            correspondence_warp_einsum
        case["ms"] = cuda_ms(lambda: corr_fwd(theta, phi, values, t,
                                              emit_l=emit_l), queued=True)
        case["plain_ms"] = cuda_ms(lambda: plain(theta, phi, values, t),
                                   queued=True)
        case.update(sdpa_ms(theta, phi, values, t))
        case["gflop_per_s"] = 2 * b * nq * nk * 259 / case["ms"] / 1e6
        case.update(k1_bound(b, nq, nk, emit_l=emit_l))
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
    torch.cuda.empty_cache()
    return case


def _k1_cases(rng, dev):
    """K1 against its plain version at each shape (`_k1_case`; timed at
    the path's temperature, 1e-10 for inference and 0.01 with l for
    training); returns one summary per shape (ms, plain and library ms,
    bound)."""
    import torch

    shapes = [(1, n, (0.01, 1e-10), False) for n in K1_SIZES] + [
        (K1_TRAIN[0], K1_TRAIN[1], (0.01,), True)]
    rows = []
    for b, n, temps, emit_l in shapes:
        theta, phi, values = _k1_inputs(rng, b, n, dev)
        row = {"b": b, "n": n, "c": 256, "max_abs_err": 0.0}
        for t in temps:
            case = _k1_case(theta, phi, values, t, emit_l,
                            timed=t == temps[-1])
            emit("kernels", **case)
            row["max_abs_err"] = max(row["max_abs_err"], case["max_abs_err"])
        row.update({k: case[k] for k in (
            "temperature", "emit_l", "ms", "plain_ms", "library_ms",
            "library_call", "library_value_width", "gflop_per_s",
            "bound_ms", "bound_by", "fma_rate_bound_ms")})
        rows.append(row)
        del theta, phi, values
        torch.cuda.empty_cache()
    return rows


# K1 fp32 at every shape a driven path gives it (PERF.md's table): (B,
# Nq, Nk, T, emit_l, what); Nq < Nk is a rows shard, Nk < Nq a keys shard.
# The phases drive each of them through `_k1_case` too.
K1_SWEEP = (
    (1, 5184, 5184, 1e-10, False, "main: one 432x768 frame"),
    (4, 5184, 5184, 1e-10, False, "serve: four clip slots"),
    (3, 5184, 5184, 1e-10, False, "three exemplars, theta repeated"),
    (1, 1344, 1344, 1e-10, False, "convergence: held-out 224x384"),
    (1, 20736, 20736, 1e-10, False, "one 864x1536 frame"),
    (16, 5184, 5184, 0.01, True, "train: batch 16"),
    (8, 5184, 5184, 0.01, True, "a rank's half of batch 16; the demo"),
    (1, 2592, 5184, 1e-10, False, "parallel: rows shard"),
    (1, 5184, 2592, 1e-10, True, "parallel: keys shard"),
    (1, 10368, 20736, 1e-10, False, "rows shard at 864x1536"),
    (1, 20736, 10368, 1e-10, True, "keys shard at 864x1536"),
)


def k1_sweep(seed: int):
    """K1 fp32 alone (`_k1_case`) at every shape of K1_SWEEP, in one
    process: one `kernels` line per shape; returns the rows. For comparing
    two checkouts (chip_ab.py --phases k1)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + 13)
    rows = []
    for b, nq, nk, t, emit_l, what in K1_SWEEP:
        theta = torch.from_numpy(unit_rows(rng, b, nq, 256)).to(dev)
        if what.startswith("three exemplars"):
            theta = theta[:1].expand(b, nq, 256).contiguous()
        _, phi, values = _k1_inputs(rng, b, nk, dev)
        row = dict(_k1_case(theta, phi, values, t, emit_l), check="k1_sweep",
                   path=what)
        emit("kernels", **row)
        rows.append(row)
        del theta, phi, values
    return rows


def _smooth_pass_case(rng, dev, h: int, w: int, axis: int, phase: str):
    """K2's smoother pass over one h x w frame (rows: axis 1, columns:
    axis 0) against its plain version: errors, ms, plain ms and bound."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import fgs

    src = ((rng.rand(h, w, 2) - 0.5) * 200).astype(np.float32)  # ab
    guide = np.floor(rng.rand(h, w) * 256).astype(np.float32)  # uint8
    guide[:, w // 2:] = np.floor(guide[:, w // 2:] / 8)  # an edge
    src, guide = (torch.from_numpy(x).to(dev) for x in (src, guide))
    x = fgs.smooth_pass(src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis)
    want = fgs.smooth_pass_plain(src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis)
    torch.cuda.synchronize()
    err = (x - want).abs()
    scale = want.abs().max().item()
    case = {"kernel": "smooth_pass", "h": h, "w": w, "axis": axis,
            "max_abs_err": err.max().item(),
            "max_rel_err": err.max().item() / scale}
    # rtol 1e-4; the atol of 1e-5 of the largest |x| covers entries that
    # cross zero, where a relative bound means nothing
    assert bool((err <= 1e-4 * want.abs() + 1e-5 * scale).all()), case
    case["ms"] = cuda_ms(lambda: fgs.smooth_pass(
        src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis), queued=True)
    case["plain_ms"] = cuda_ms(lambda: fgs.smooth_pass_plain(
        src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis), queued=True)
    # the same launch timed with the host's cost in it
    case["host_incl_ms"] = cuda_ms(lambda: fgs.smooth_pass(
        src, guide, FGS_LAM, fgs.SIGMA_COLOR, axis))
    # src and guide read once, the result written once (20 B a pixel); per
    # pixel two weights (exp), three coefficients and the solve of two
    # right-hand sides: about 30 FLOP
    case.update(bound(30 * h * w, 20 * h * w))
    case["gb_per_s"] = 20 * h * w / case["ms"] / 1e6
    emit(phase, **case)
    return case


def _k2_cases(rng, dev):
    """K2's smoother pass and general solve against their plain versions;
    returns (pass summaries, solve summaries)."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import fgs

    passes = [_smooth_pass_case(rng, dev, h, w, axis, "kernels")
              for h, w, axis in K2_PASSES]

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
    """Time of one PyTorch call computing K1's out on the inputs' dtype
    (fp32 or bf16): SDPA with scale 1/T on the first fused backend that
    takes them, the values as they are (width 3) or, where every fused
    backend refuses that width, zero-padded to 16-byte rows (4 fp32 or 8
    bf16 columns, the narrowest the EFFICIENT backend takes; its fp32
    products are split TF32 on the tensor cores); the MATH backend last.
    Returns library_ms, library_call (the backend), library_value_width
    and library_refused (each backend that refused, with the width)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k = theta[:, None], phi[:, None]  # one head
    fused = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION)
    padded = 16 // values.element_size()
    refused = []
    for width, backends in ((3, fused), (padded, fused),
                            (3, (SDPBackend.MATH,))):
        v = F.pad(values, (0, width - 3))[:, None]
        for backend in backends:
            call = lambda: F.scaled_dot_product_attention(
                q, k, v, scale=1.0 / temperature)
            with sdpa_kernel([backend]):
                try:  # a backend that refuses these inputs raises at once
                    call()
                except RuntimeError:
                    refused.append(f"{backend.name} (width {width})")
                    continue
                return {"library_ms": cuda_ms(call, queued=True),
                        "library_call": "F.scaled_dot_product_attention "
                                        f"({backend.name})",
                        "library_value_width": width,
                        "library_refused": refused}
    raise RuntimeError("no SDPA backend ran")


def unit_rows(rng, *shape):
    import numpy as np

    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def bwd_bounds(b: int, nq: int, nk: int, c: int) -> dict:
    """Least times of the correspondence backward on the card (`bound`),
    for the pair (the function: theta, phi, values, m, l, D, d_sim, d_out
    in; dtheta, dphi, dvalues out), for each kernel as its wrapper
    computes it, and for K3's two halves:

      ops:   every fp32-accurate product at three TF32 passes on the
             tensor cores: the scores, 2 B Nq Nk C FLOP, and dtheta and
             dphi, 2 B Nq Nk C each; on the fp32 pipe dvalues, 2 B Nq Nk 3.
             The pair: scores + dtheta + dphi; K3: scores + dphi (its score
             pass: the scores; its product: dphi); K2b: dtheta.
      bytes: each input read once, each output written once, at
             PEAK_BYTES_PER_S. K3's outputs include the df scratch
             [B, Nq', Nk'] (its score pass writes it, its product reads
             it) and K2b's inputs include it; the pair's do not.

    Retired: 6.6 ms per kernel (every product at the fp32 rate), then the
    score pass at the fp32 FMA rate (3.29 ms at B = 16, N = 5184, C = 256),
    kept as `fma_rate_bound_ms`: the products run 3xTF32 on the tensor
    cores, and so does every score (csrc/corr_score.cuh)."""
    from devc_tpu_torch.ops.cuda_corr import df_scratch_bytes

    pairs = b * nq * nk
    prod = 2 * pairs * c  # one score matrix, or one of the two products
    df_bytes = b * df_scratch_bytes(nq, nk)
    rows_in = 4 * b * nq * (1 + 1 + 1 + 1 + 3)  # m, l, D, d_sim, d_out
    theta_b, phi_b = 4 * b * nq * c, 4 * b * nk * c
    values_b = 4 * b * nk * 3
    fma_rate = lambda score_flop, tc_flop, nbytes: max(
        score_flop / PEAK_FP32_FLOPS, tc_flop / PEAK_TF32_FLOPS,
        nbytes / PEAK_BYTES_PER_S) * 1e3
    return {
        "pair": bound(2 * pairs * 3,
                      2 * theta_b + 2 * phi_b + 2 * values_b + rows_in,
                      3 * prod),
        "corr_bwd_dkv": dict(
            bound(2 * pairs * 3, theta_b + 2 * phi_b + 2 * values_b
                  + rows_in + df_bytes, 2 * prod),
            fma_rate_bound_ms=fma_rate(prod, 2 * pairs * (c + 3), theta_b
                                       + 2 * phi_b + 2 * values_b + rows_in
                                       + df_bytes)),
        "dkv_scores": bound(2 * pairs * 3, theta_b + phi_b + 2 * values_b
                            + rows_in + df_bytes, prod),
        "dkv_product": bound(0, df_bytes + theta_b + phi_b, prod),
        "corr_bwd_dq": bound(0, df_bytes + phi_b + theta_b, prod),
        "df_scratch_bytes": df_bytes,
    }


# the backward's cases: (B, N, C); the first two are timed and get the
# routing check; C = 96 and 512 at ragged N; one sample at 864x1536
BWD_CASES = ((TRAIN_B, TRAIN_N, 256), (1, TRAIN_N, 256), (2, 4500, 96),
             (1, 520, 512), (1, 20736, 256))


def bwd_float64(theta, phi, values, d_out, d_sim, temperature):
    """The correspondence's gradients (dtheta, dphi, dvalues) at these
    inputs in float64: the plain forward, then the plain backward on its
    own residuals. The backward kernels are held to it: at T = 0.01 df
    carries a score's round-off d as d / T^2, so two fp32 versions whose
    scores are summed in different orders (the kernels' 3xTF32 tensor-core
    sums, cuBLAS's fp32 product in the fp32 plain version) differ from
    each other on a few rows by more than the bound, which the kernels
    keep against float64 (the fp32 plain version does not at N =
    20736)."""
    from devc_tpu_torch.ops.correspondence import (
        correspondence_bwd_plain,
        correspondence_fwd_plain,
    )

    x = [t.double() for t in (theta, phi, values, d_out, d_sim)]
    out, sim, l = correspondence_fwd_plain(x[0], x[1], x[2], temperature)
    return correspondence_bwd_plain(x[0], x[1], x[2], sim, l, out, x[3], x[4],
                                    temperature)


def _k1_sim_is_k3_row_max(cuda_corr, theta, phi, values) -> dict:
    """K1's sim equals the row max of K3's recomputed scores, bit for bit:
    K3 at T = 1e-10 with d_out = 0 and d_sim = 1 writes df = 1[s == m],
    NaN where one of its scores exceeds m (attn = inf times 0), and a row
    whose m it never reaches has no 1."""
    import torch

    b, nq, _ = theta.shape
    nk = phi.shape[1]
    _, sim, l = cuda_corr.corr_fwd(theta, phi, values, 1e-10, emit_l=True)
    df = torch.empty((b, cuda_corr.padded(nq), cuda_corr.padded(nk)),
                     dtype=torch.float32, device=theta.device)
    cuda_corr.corr_bwd_dkv(theta, phi, values, sim, l, torch.zeros_like(sim),
                           torch.ones_like(sim),
                           torch.zeros((b, nq, 3), device=theta.device),
                           1e-10, df)
    valid = df[:, :nq, :nk]
    rec = {"rows": b * nq,
           "entries_not_0_or_1": int(((valid != 0) & (valid != 1)).sum()),
           "rows_without_max": int((valid.sum(-1) < 1).sum()),
           "rows_with_tied_max": int((valid.sum(-1) > 1).sum())}
    del df, valid
    assert rec["entries_not_0_or_1"] == 0 and rec["rows_without_max"] == 0, \
        rec
    return rec


def phase_bwd(seed: int):
    """K2b and K3 vs their plain version in float64 on the card (and,
    beside it, the fp32 plain version's distance from both), two calls
    bit-equal, a chunked run bit-equal to one chunk, K1's sim bit-equal to
    the row max K3 finds, and the sim-gradient routing check. Returns the
    per-kernel summaries (without launches)."""
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
        plain32 = correspondence_bwd_plain(*args)
        want = bwd_float64(theta, phi, values, d_out, d_sim, temperature)
        torch.cuda.synchronize()
        errs, errs32, plain32_errs = {}, {}, {}
        for name, g, w, g2, p32 in zip(("dtheta", "dphi", "dvalues"), got,
                                       want, again, plain32):
            errs[name] = (g.double() - w).abs().max().item()
            errs32[name] = (g - p32).abs().max().item()
            plain32_errs[name] = (p32.double() - w).abs().max().item()
            # devc_tpu's bound for its Pallas VJP vs einsum autodiff
            # (tests/test_pallas_grad.py)
            ok = bool(((g.double() - w).abs() <= 5e-3 + 1e-3 * w.abs()).all())
            assert ok, (b, n, c, name, errs[name])
            # and no farther from float64 than the fp32 plain version
            assert errs[name] <= plain32_errs[name], (b, n, c, name, errs,
                                                      plain32_errs)
            assert torch.equal(g, g2), (b, n, c, name, "second call differs")
        del plain32
        bounds = bwd_bounds(b, n, n, c)
        case = {"check": "vs_plain", "b": b, "n": n, "c": c,
                "temperature": temperature, "max_abs_err": errs,
                "reference": "the plain versions in float64 (bwd_float64)",
                "max_abs_err_vs_plain_fp32": errs32,
                "plain_fp32_max_abs_err_vs_float64": plain32_errs,
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
        if b == TRAIN_B or c != 256:
            case["k1_sim_is_k3_row_max"] = _k1_sim_is_k3_row_max(
                cuda_corr, theta, phi, values)
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
    # K3's two halves, each launched alone (ROADMAP B6): the score pass
    # (df, dvalues) and the product dphi = df^T theta
    halves = (torch.empty_like(phi), torch.empty_like(values))
    for half in ("scores", "product"):
        ms[f"dkv_{half}"] = cuda_ms(lambda: cuda_corr.corr_bwd_dkv_part(
            half, *kargs, *halves), queued=True)
    del halves
    # the score rule's pre-pass alone, on theta and phi as K1 and K3 each
    # run it: B (Nq + Nk) C floats read, twice that written
    split = {"ms": cuda_ms(lambda: (cuda_corr.split_tf32(theta),
                                    cuda_corr.split_tf32(phi)), queued=True),
             **bound(0, 12 * b * 2 * n * c)}
    split["share_of_own_bound"] = split["bound_ms"] / split["ms"]
    emit("bwd", check="split_tf32", b=b, n=n, c=c, **split)
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
    # K3's halves: ms, bound, share of the bound
    halves = {half: {"ms": ms[half], **bounds[half],
                     "share_of_own_bound": bounds[half]["bound_ms"] / ms[half]}
              for half in ("dkv_scores", "dkv_product")}
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
        if kernel == "corr_bwd_dkv":
            case["halves"] = halves
        emit("bwd", **case)
        if b == TRAIN_B:
            if kernel == "corr_bwd_dkv":
                summary[kernel].update(halves=halves, split_tf32=split)
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


# The split convolution's kernel launches at each frame size (H, W):
# (one frame step, one exemplar preparation), a batch counting once, as
# the card's launch plans give them; set by phase_conv_split, read by
# every launch check after it (`_split_expected`)
SPLIT_LAUNCHES = {}
# the bound of both fp32 convolutions against float64, over max |x|*|w|
# (tests/test_torch_kernels_cuda.py's CONV_FP32_BOUND), and the shapes
# (c_in, c_out, k, stride, padding, dilation, H, W) where cuDNN's fp32
# call is an FFT, 6-9x nearer float64 than its implicit GEMM: the split
# kernel is held to 2^-23 there (the card test's FFT_SHAPES)
SPLIT_FP32_BOUND = 2.0 ** -17
SPLIT_FFT_SHAPES = ((256, 64, 3, 1, 0, 1, 28, 50),
                    (256, 64, 3, 1, 0, 1, 29, 50))


def _split_expected(frames: int, preps: int, hw=(H, W)) -> int:
    """The split convolution's launches in `frames` frame steps and
    `preps` exemplar preparations at frame size hw."""
    frame, prep = SPLIT_LAUNCHES[hw]
    return frames * frame + preps * prep


def _split_record(models, fn):
    """(fn(), the split convolution calls it made): for each Conv2d call
    the rule took, its input, weights and arguments and the launches its
    launch plan gives (one, two where the depth is split); their sum is
    checked against the kernel's own counter."""
    from devc_tpu_torch.ops import conv_split
    from devc_tpu_torch.ops.layers import Conv2d

    calls = []

    def hook(m, inputs, out):
        x = inputs[0]
        if not m._engages(x):
            return
        _, c, h, wd = x.shape
        args = (m.stride[0], m.padding[0], m.dilation[0])
        k = m.kernel_size[0]
        splits = conv_split.launch_plan(c, h, wd, m.out_channels, k, *args,
                                        x.device)[2]
        calls.append({"x": x, "w_split": m._split_weight(m.weight),
                      "bias": m.bias, "w": m.weight, "args": args, "k": k,
                      "launches": 1 + (splits > 1)})

    hooks = [m.register_forward_hook(hook) for m in models.modules()
             if isinstance(m, Conv2d)]
    before = conv_split.split_conv2d.launches
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    launched = conv_split.split_conv2d.launches - before
    assert launched == sum(c["launches"] for c in calls), launched
    return out, calls


def _split_case(key, call, frame: int, prep: int) -> dict:
    """One convolution shape on its recorded inputs: the split kernel
    against its plain version and float64, and no farther from float64
    than cuDNN's fp32 call; ms of the three and the bound."""
    import torch
    import torch.nn.functional as F

    from devc_tpu_torch.ops import conv_split

    cin, cout, k, stride, pad, dil, h, w = key
    x, ws, b, wt = call["x"], call["w_split"], call["bias"], call["w"]
    args = call["args"]
    kernel = lambda: conv_split.split_conv2d(x, ws, b, *args, k, wt)
    plain = lambda: conv_split.split_conv2d_plain(x, wt, b, *args)
    library = lambda: F.conv2d(x, wt, b, *args)
    with torch.inference_mode():
        got, want, y32 = kernel(), plain(), library()
        y64 = F.conv2d(x.double(), wt.double(),
                       None if b is None else b.double(), *args)
        scale = F.conv2d(x.double().abs(), wt.double().abs(), None,
                         *args).amax().item()
        err = {name: (y.double() - ref).abs().max().item()
               for name, y, ref in (("plain", got, want.double()),
                                    ("float64", got, y64),
                                    ("library", y32, y64))}
        case = {"c_in": cin, "c_out": cout, "k": k, "stride": stride,
                "pad": pad, "dil": dil, "h": h, "w": w,
                "count_frame": frame, "count_prep": prep,
                "launches": call["launches"],
                "max_abs_err": err["float64"],
                "rel_err_vs_plain": err["plain"] / scale,
                "rel_err_vs_float64": err["float64"] / scale,
                "library_rel_err_vs_float64": err["library"] / scale,
                "library_fft": key in SPLIT_FFT_SHAPES,
                "second_call_bit_equal": torch.equal(got, kernel())}
        case["ms"] = cuda_ms(kernel, queued=True)
        case["plain_ms"] = cuda_ms(plain, reps=3, warmup=1, queued=True)
        case["library_ms"] = cuda_ms(library, queued=True)
    oh, ow = got.shape[2:]
    flop = 2.0 * cout * oh * ow * cin * k * k
    nbytes = 4 * (x.numel() + ws.numel() + got.numel() + cout)
    case.update(bound(0.0, nbytes, flop))
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    emit("conv_split", **case)
    assert not torch.backends.cudnn.allow_tf32
    assert case["second_call_bit_equal"], case
    assert max(case["rel_err_vs_plain"], case["rel_err_vs_float64"],
               case["library_rel_err_vs_float64"]) <= SPLIT_FP32_BOUND, case
    if case["library_fft"]:
        assert case["rel_err_vs_float64"] <= 2.0 ** -23, case
    else:
        assert (case["rel_err_vs_float64"]
                <= case["library_rel_err_vs_float64"]), case
    return case


def phase_conv_split(models, seed: int, card: str) -> dict:
    """The split convolution at the main path's shapes (phase 6); sets
    SPLIT_LAUNCHES. Returns the kernel's summary: a frame's 57 split calls
    summed, each distinct shape under `by_shape`."""
    import torch

    from devc_tpu_torch.pipeline import video

    recorded = {}
    for hw in ((H, W), CONV_EVAL_HW):
        ref, rgb = (torch.from_numpy(f).to(models.device)
                    for f in textured_frames(seed + 70, 2, hw))
        (_, state), prep = _split_record(
            models, lambda: video._device_ref_features(models, ref))
        carry = torch.zeros((1, hw[0] // 2, hw[1] // 2, 3),
                            device=models.device)
        _, frame = _split_record(
            models, lambda: video.frame_step(models, rgb, carry, state))
        SPLIT_LAUNCHES[hw] = (sum(c["launches"] for c in frame),
                              sum(c["launches"] for c in prep))
        recorded[hw] = prep, frame
    prep, frame = recorded[(H, W)]
    emit("conv_split", check="launches", calls_a_frame=len(frame),
         calls_a_preparation=len(prep),
         launches={f"{h}x{w}": {"frame": f, "preparation": p}
                   for (h, w), (f, p) in SPLIT_LAUNCHES.items()})
    # 57 of a frame's 60 convolutions, 28 of a preparation's 29 (the 3- and
    # 7-channel first layers and conv10_ab's 2 outputs stay on cuDNN)
    assert (len(frame), len(prep)) == (57, 28), (len(frame), len(prep))

    shapes = {}
    for where, calls in (("frame", frame), ("prep", prep)):
        for c in calls:
            x, cout = c["x"], c["w_split"].shape[1]
            key = (x.shape[1], cout, c["k"], *c["args"], *x.shape[2:])
            entry = shapes.setdefault(key, {"call": c, "frame": 0,
                                            "prep": 0})
            entry[where] += 1
    cases = [_split_case(key, **entry) for key, entry in shapes.items()]
    a_frame = lambda name: sum(c[name] * c["count_frame"] for c in cases)
    summary = {
        "shape": f"the {len(frame)} split convolutions of a {H}x{W} frame "
                 f"({sum(c['count_frame'] > 0 for c in cases)} shapes)",
        "ms": a_frame("ms"), "plain_ms": a_frame("plain_ms"),
        "library_ms": a_frame("library_ms"),
        "library_call": "F.conv2d fp32, TF32 off (cuDNN)",
        "bound_ms": a_frame("bound_ms"), "bound_by": "each shape's (by_shape)",
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_rel_err_vs_float64": max(c["rel_err_vs_float64"]
                                      for c in cases),
        "frame_launches": SPLIT_LAUNCHES[(H, W)][0],
        "by_shape": [{k: c[k] for k in (
            "c_in", "c_out", "k", "stride", "pad", "dil", "h", "w",
            "count_frame", "count_prep", "launches", "ms", "plain_ms",
            "library_ms", "bound_ms", "rel_err_vs_float64",
            "library_rel_err_vs_float64")} for c in cases]}
    summary["share_of_bound"] = summary["bound_ms"] / summary["ms"]
    emit("conv_split", check="frame", card=card,
         **{k: v for k, v in summary.items() if k != "by_shape"})
    return summary


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
    # K1 once, K2's smoother pass six times and a frame's split
    # convolutions per frame, and one exemplar's preparation; the general
    # solve is not on the path
    assert launches == {"corr_fwd": N_FRAMES, "smooth_pass": 6 * N_FRAMES,
                        "tridiag_pcr": 0, "split_conv2d": _split_expected(
                            N_FRAMES, 1)}, launches
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


def phase_layers(models, ref, rgb, card: str, compute_dtype=None):
    """One frame's stages timed apart (CUDA events, median of 5); with
    compute_dtype (bf16 models) the networks' stages in that dtype, as
    frame_step runs them."""
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
    _, state = video._device_ref_features(
        models, torch.from_numpy(ref).to(dev), compute_dtype)
    net_dtype = compute_dtype or torch.float32
    times, device_ms = {}, {}
    with torch.inference_mode():
        lab_large, lab_small = video._preprocess_device(rgb_t)
        a_l = lab_small[..., 0:1].to(net_dtype)
        hw = (a_l.shape[1], a_l.shape[2])
        feats = vgg19_extract(models.vgg, cs.gray_to_rgb(a_l), FEATURE_TAPS)
        a_n = [cs.feature_normalize(f) for f in feats[1:]]
        theta = embed_queries(models.warpnet, a_n)
        warped, sim = warp_with_keys(theta, state["phi"], state["values"], hw,
                                     1e-10, out_dtype=net_dtype)
        x = torch.cat([a_l, warped[..., 1:3], sim,
                       torch.zeros_like(lab_small, dtype=net_dtype)], dim=-1)
        ab = colorvidnet_apply(models.colorvid, x).float()
        ab_up = video._resize_nhwc(ab, (H, W)) * 1.25
        guide = torch.clamp(torch.floor(
            cs.uncenter_l(lab_large[0, ..., 0]) * 255.0 / 100.0), 0.0, 255.0)

        last = torch.zeros_like(lab_small)
        stages = {
            "preprocess": lambda: video._preprocess_device(rgb_t),
            "vgg19": lambda: vgg19_extract(
                models.vgg, cs.gray_to_rgb(a_l), FEATURE_TAPS),
            "embed_queries": lambda: embed_queries(
                models.warpnet, [cs.feature_normalize(f) for f in feats[1:]]),
            "correspondence_k1": lambda: warp_with_keys(
                theta, state["phi"], state["values"], hw, 1e-10,
                out_dtype=net_dtype),
            "colorvidnet": lambda: colorvidnet_apply(models.colorvid, x),
            "upsample_chroma": lambda: video._resize_nhwc(ab, (H, W)) * 1.25,
            "fgs_k2": lambda: fast_global_smoother(ab_up[0], guide),
            "lab_to_rgb_u8": lambda: torch.floor(torch.clamp(
                cs.lab_centered_to_rgb(torch.cat([lab_large[..., 0:1], ab_up],
                                                 dim=-1)), 0, 1) * 255).to(
                torch.uint8),
            "frame_step": lambda: video.frame_step(
                models, rgb_t, last, state, compute_dtype=compute_dtype),
        }
        for name, fn in stages.items():
            times[name] = cuda_ms(fn, 5)
            # the device's time alone: a ~30 ms spin covers the host's
            # enqueueing of the longest stage (a bf16 frame step's ~12 ms)
            device_ms[name] = cuda_ms(fn, 5, queued=True,
                                      spin_cycles=60_000_000)
    emit("layers", compute_dtype=str(net_dtype), ms=times,
         sum_of_stages_ms=sum(
             v for k, v in times.items() if k != "frame_step"),
         device_only_ms=device_ms, device_only_sum_of_stages_ms=sum(
             v for k, v in device_ms.items() if k != "frame_step"),
         card=card)
    return times


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
    k1 = [_k1_inference_case(rng, dev, b, K1_SIZES[0], shared, "serve",
                             "k1_batched") for b, shared in K1_SERVE]
    return k2, k1


def _k1_inference_case(rng, dev, b: int, n: int, shared: bool, phase: str,
                       check: str):
    """K1 at T = 1e-10 (inference) on [b, n, 256] against its plain
    version (`_k1_case`), with no row differing; ms, plain ms, SDPA's ms
    and the bound. shared: theta one frame's, repeated over b."""
    theta, phi, values = _k1_inputs(rng, b, n, dev)
    if shared:
        theta = theta[:1].expand(b, n, 256).contiguous()
    case = dict(_k1_case(theta, phi, values, 1e-10), check=check, n=n,
                theta="one frame's, repeated" if shared else "per sample")
    emit(phase, **case)
    assert case["rows_differing"] == 0, case
    return case


def _counts_zero():
    from devc_tpu_torch.ops import conv_split, cuda_corr, fgs

    cuda_corr.corr_fwd.launches = 0
    cuda_corr.corr_fwd.bf16_launches = 0
    fgs.smooth_pass.launches = 0
    fgs.tridiag_pcr.launches = 0
    conv_split.split_conv2d.launches = 0


def _counts():
    from devc_tpu_torch.ops import conv_split, cuda_corr, fgs

    return {"corr_fwd": cuda_corr.corr_fwd.launches,
            "smooth_pass": fgs.smooth_pass.launches,
            "tridiag_pcr": fgs.tridiag_pcr.launches,
            "split_conv2d": conv_split.split_conv2d.launches}


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
    steps = sched.stats["steps"]
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
    # one K1 launch, six K2 launches and a frame's split convolutions (the
    # batch in each call) per batched step; one exemplar preparation per
    # job, but the corrupt exemplar's
    assert launches == {"corr_fwd": steps, "smooth_pass": 6 * steps,
                        "tridiag_pcr": 0, "split_conv2d": _split_expected(
                            steps, len(jobs) - 1)}, (launches, steps)
    assert all(d["max"] <= 1 for d in frame0.values()), frame0

    # the same good jobs written as JPEG (the server's default): how much
    # of the wall time above is PNG encoding
    good = [j for j in range(len(jobs)) if j != SERVE_BAD_JOB]
    sched = ClipBatchScheduler(models, image_size=(H, W), slots=SERVE_SLOTS)
    results, jpg_launches, jpg_wall = run(sched, good, "_jpg")
    assert [r["frames"] for r in results] == [len(jobs[j]["frames"])
                                              for j in good], results
    emit("serve", check="scheduler_jpeg", jobs=len(good), frames=good_frames,
         steps=sched.stats["steps"], launches=jpg_launches, wall_s=jpg_wall,
         wall_ms_per_step=jpg_wall * 1e3 / sched.stats["steps"],
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
            "frames": [r["frames"] for r in results],
            "steps": sched.stats["steps"],
            "launches": launches, "frame0_vs_host_path": frame0,
            "wall_s": wall, "card": card}
    emit("serve", **case)
    assert launches == {"corr_fwd": sched.stats["steps"],
                        "smooth_pass": 6 * sched.stats["steps"],
                        "tridiag_pcr": 0, "split_conv2d": _split_expected(
                            sched.stats["steps"], len(picked))}, launches
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
    # the R = 3 exemplars prepared in one batch, and each frame's networks
    # once (the split calls take the R-batched ColorVidNet whole)
    assert multi_launches == {"corr_fwd": len(frames),
                              "smooth_pass": 6 * len(frames),
                              "tridiag_pcr": 0,
                              "split_conv2d": _split_expected(
                                  len(frames), 1)}, multi_launches
    assert all(d["max"] <= 1 for d in frame0.values()), frame0
    assert all(scan_equal) and len(scan) == len(frames), scan_equal
    assert runner.replays == len(frames)
    # a replay launches what an eager frame step does: 57 split calls and
    # their summing launches
    assert runner.kernel_launches == {
        "corr_fwd": 1, "smooth_pass": 6, "tridiag_pcr": 0,
        "split_conv2d": _split_expected(1, 0)}, runner.kernel_launches
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
    return {net: errs["cpu32"] for net, errs in
            case["grad_rel_l2_vs_fp64"].items()}


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
    cli.colorize --train_ckpt on 8 frames at 432x768, with and without
    --bf16. Returns the launch counts of the training run and of the two
    colorize runs (fp32, bf16)."""
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
        exported_sds = {
            name: torch.load(os.path.join(exported, f), weights_only=True)
            for name, f in (("vgg", "vgg19_conv.pth"),
                            ("warpnet", f"nonlocal_net_iter_{n + 2}.pth"),
                            ("colorvid", f"colornet_iter_{n + 2}.pth"))}
        models = PipelineModels.from_state_dicts(exported_sds, "cuda")
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
                                "tridiag_pcr": 0,
                                "split_conv2d": _split_expected(
                                    len(frames), 1)}, col_launches
        assert psnr > 30.0, psnr
        del models
        # cli.colorize --train_ckpt --bf16 on the same checkpoint: K1's
        # bf16 kernel once a frame; its frames against the fp32 run's
        from devc_tpu_torch.ops import cuda_corr
        from devc_tpu_torch.utils.metrics import psnr as psnr_on

        out16 = os.path.join(tmp, "colorized_bf16")
        _counts_zero()
        cli_colorize.main([
            "--clip_path", clip, "--ref_path", ref_path, "--output_path",
            out16, "--train_ckpt", ckpt, "--vgg_ckpt",
            "/nonexistent/vgg19_conv.pth", "--image_size", str(H), str(W),
            "--no_video", "--device", "cuda", "--bf16"])
        torch.cuda.synchronize()
        bf16_launches = dict(_counts(),
                             corr_fwd_bf16=cuda_corr.corr_fwd.bf16_launches)
        out16_dir = os.path.join(out16, "clip_ref")
        outs16 = [np.asarray(Image.open(os.path.join(out16_dir, f)))
                  for f in sorted(os.listdir(out16_dir))]
        psnr16 = [psnr_on(a, b, device="cuda") for a, b in zip(outs16, outs)]
        emit("cli_train", check="colorize_train_ckpt_bf16",
             frames=len(outs16), launches=bf16_launches,
             psnr_vs_fp32_run=psnr16, card=card)
        assert len(outs16) == len(frames), len(outs16)
        assert bf16_launches["corr_fwd_bf16"] == len(frames), bf16_launches
        # bf16 convolutions take cuDNN's call
        assert bf16_launches["split_conv2d"] == 0, bf16_launches
        # the bf16 mode's quality on the only trained generator at hand
        _bf16_quality(exported_sds, frames, ref,
                      f"cli.train checkpoint, step {n + 2}", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, col_launches, bf16_launches


# the convergence demo (python -m devc_tpu_torch.examples.convergence_demo)
# on a generated scene tree: CONV_SCENES folders of stills, the last
# CONV_HOLDOUT held out; its training at batch 8, 216x384 (N = 5184), its
# held-out evaluation at 224x384 (216 rounded up to H % 16): K1 at N =
# (224 / 8) * (384 / 8) = 1344, T = 1e-10, K2 over one 224x384 frame
CONV_SCENES, CONV_HOLDOUT = 12, 2
CONV_STEPS, CONV_BATCH = 40, 8
# the step whose allocated memory the last step's is held to (within 1%)
CONV_MEM_FROM = 10
CONV_EVAL_HW = (224, 384)
CONV_EVAL_N = (CONV_EVAL_HW[0] // 8) * (CONV_EVAL_HW[1] // 8)
CONV_LOSSES = ("total_loss", "l1_loss", "generator_loss",
               "discriminator_loss", "feat_loss", "contextual_loss_total",
               "smoothness_loss", "consistent_loss")
CONV_ARM_KEYS = ["psnr_mean", "scenes", "ssim_mean", "temporal_rmse"]


def write_scene_tree(root: str, seed: int) -> None:
    """The convergence demo's source tree: CONV_SCENES scene folders of
    3-4 textured colour stills (JPEG, one size a scene, 256-560 px a
    side), each scene in a palette of its own (the field's channels
    scaled and shifted per scene), so a scene's exemplar carries its
    other stills' colours."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    for s in range(CONV_SCENES):
        d = os.path.join(root, f"scene{s:02d}")
        os.makedirs(d)
        n = int(rng.randint(3, 5))
        hw = (int(rng.randint(256, 561)), int(rng.randint(256, 561)))
        scale, shift = rng.uniform(0.3, 1.0, 3), rng.uniform(0.0, 90.0, 3)
        for i, img in enumerate(textured_frames(int(rng.randint(1 << 30)),
                                                n, hw)):
            img = np.clip(img * scale + shift, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{i:02d}.jpg"),
                                      quality=95)


def _all_counts() -> dict:
    from devc_tpu_torch.ops import cuda_corr

    return dict(_counts(), **_train_counts(),
                corr_fwd_bf16=cuda_corr.corr_fwd.bf16_launches)


def run_convergence_demo(workdir: str, src: str, steps: int, batch: int,
                         holdout: int, summary_out: str,
                         workers: int = 4) -> dict:
    """python -m devc_tpu_torch.examples.convergence_demo on the card, in
    this process, with --device-preprocess, instrumented from outside:
    cli.train's summary (seconds a step, loader wait) and launches, the
    device memory allocated after each step (read where the trainer logs
    the step, after its sync), and each cli.colorize call's frames and
    launches. The counts are set to 0 first. Returns the record, with the
    demo's exit code, summary and metrics.jsonl."""
    import torch

    from devc_tpu_torch.cli import colorize as cli_colorize
    from devc_tpu_torch.cli import train as cli_train
    from devc_tpu_torch.examples import convergence_demo
    from devc_tpu_torch.utils import logging as run_logging

    rec = {"allocated_mib": {}, "colorize": []}
    real_train, real_colorize = cli_train.main, cli_colorize.main
    real_log = run_logging.MetricsLogger.log_scalars
    delta = lambda a, b: {k: a[k] - b[k] for k in a}

    def log_scalars(self, step, scalars):
        rec["allocated_mib"][int(step)] = torch.cuda.memory_allocated() / 2**20
        return real_log(self, step, scalars)

    def train(argv):
        before = _all_counts()
        rec["train"] = real_train(argv)
        rec["train_launches"] = delta(_all_counts(), before)
        return rec["train"]

    def colorize(argv):
        clip = argv[argv.index("--clip_path") + 1]
        before, t0 = _all_counts(), time.perf_counter()
        real_colorize(argv)
        torch.cuda.synchronize()
        rec["colorize"].append({
            "arm": "trained" if "--train_ckpt" in argv else "random_init",
            "scene": os.path.basename(os.path.dirname(clip)),
            "frames": len(os.listdir(clip)),
            "launches": delta(_all_counts(), before),
            "wall_s": time.perf_counter() - t0})

    _counts_zero()
    _train_counts_zero()
    cli_train.main, cli_colorize.main = train, colorize
    run_logging.MetricsLogger.log_scalars = log_scalars
    t0 = time.perf_counter()
    try:
        rec["rc"] = convergence_demo.main([
            "--src", src, "--workdir", workdir, "--steps", str(steps),
            "--batch", str(batch), "--image-size", str(TRAIN_HW[0]),
            str(TRAIN_HW[1]), "--holdout", str(holdout),
            "--workers", str(workers), "--device-preprocess",
            "--device", "cuda", "--summary-out", summary_out])
        torch.cuda.synchronize()
    finally:
        cli_train.main, cli_colorize.main = real_train, real_colorize
        run_logging.MetricsLogger.log_scalars = real_log
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = _all_counts()
    with open(summary_out) as f:
        rec["summary"] = json.load(f)
    with open(os.path.join(workdir, "runs", "metrics.jsonl")) as f:
        rec["metrics"] = [json.loads(line) for line in f]
    return rec


def convergence_report(rec: dict, steps: int, mem_from: int) -> dict:
    """The run's numbers and the checks on them: exit code 0 (total_loss
    fell), every logged loss finite, K1 / K2b / K3 launched 4 / 2 / 2 times
    a step in training, one K1 and six K2 launches a held-out frame in
    each arm, the summary schema, and the device memory allocated after
    the last step within 1% of that after step mem_from. A failed check
    raises AssertionError."""
    import numpy as np

    train = rec["train"]
    step_ms = [s * 1e3 for s in train["step_s"]]
    mem = rec["allocated_mib"]
    last = max(mem)
    report = {
        "rc": rec["rc"], "steps": train["steps"], "wall_s": rec["wall_s"],
        "train_wall_s": train["wall_s"],
        "median_step_ms_after_first": float(np.median(step_ms[1:])),
        "p90_step_ms_after_first": float(np.percentile(step_ms[1:], 90)),
        "first_step_ms": step_ms[0],
        "loader_wait_share": train["loader_wait_share"],
        "loader_wait_ms_after_first": float(
            1e3 * np.sum(train["loader_wait_s"][1:])),
        "allocated_mib_after_step": {mem_from: mem[mem_from], last: mem[last]},
        "allocated_mib_max_from_step": max(
            v for s, v in mem.items() if s >= mem_from),
        "allocated_growth": mem[last] / mem[mem_from] - 1.0,
        "train_launches": rec["train_launches"],
        "colorize": rec["colorize"], "launches": rec["launches"],
        "summary": rec["summary"],
        "nonfinite": [(m["step"], k) for m in rec["metrics"]
                      for k, v in m.items() if not np.isfinite(v)]}
    summary = rec["summary"]
    assert rec["rc"] == 0, ("total_loss did not fall", summary["losses"])
    assert not report["nonfinite"], report["nonfinite"]
    assert [m["step"] for m in rec["metrics"]] == list(range(1, steps + 1))
    # training takes no split convolution (autograd, not inference mode)
    zero = {"smooth_pass": 0, "tridiag_pcr": 0, "corr_fwd_bf16": 0,
            "split_conv2d": 0}
    assert rec["train_launches"] == dict(
        zero, corr_fwd=4 * steps, corr_bwd_dq=2 * steps,
        corr_bwd_dkv=2 * steps), rec["train_launches"]
    arms = [c["arm"] for c in rec["colorize"]]
    assert arms.count("trained") == arms.count("random_init") == len(
        arms) // 2 > 0, arms
    for c in rec["colorize"]:
        n = c["frames"]
        assert c["launches"] == dict(
            corr_fwd=n, smooth_pass=6 * n, tridiag_pcr=0, corr_bwd_dq=0,
            corr_bwd_dkv=0, corr_fwd_bf16=0,
            split_conv2d=_split_expected(n, 1, CONV_EVAL_HW)), c
    assert sorted(summary) == ["holdout", "losses", "steps", "window"]
    assert sorted(summary["losses"]) == sorted(CONV_LOSSES)
    assert all(sorted(v) == ["first", "last"]
               for v in summary["losses"].values())
    assert sorted(summary["holdout"]) == ["random_init", "trained"]
    for arm in summary["holdout"].values():
        assert sorted(arm) == CONV_ARM_KEYS, arm
        assert np.isfinite(arm["psnr_mean"]) and np.isfinite(arm["ssim_mean"])
    assert abs(report["allocated_growth"]) <= 0.01, report[
        "allocated_mib_after_step"]
    return report


def phase_convergence(seed: int, card: str):
    """The convergence demo's main path: K1 at the held-out evaluation's
    shape (B = 1, N = 1344, T = 1e-10) and K2's pass over a 224x384 frame
    against their plain versions, then the demo on a generated scene tree
    (CONV_STEPS steps at batch 8, 216x384, --holdout 2,
    --device-preprocess; both held-out arms through cli.colorize and
    cli.evaluate on the card). Returns (K1 row, K2 rows, the demo's
    launches)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.RandomState(seed + 60)
    k1 = _k1_inference_case(rng, dev, 1, CONV_EVAL_N, False, "convergence",
                            "k1_holdout_eval")
    k2 = [_smooth_pass_case(rng, dev, *CONV_EVAL_HW, axis, "convergence")
          for axis in (1, 0)]
    tmp = tempfile.mkdtemp(prefix="devc_chip_convergence_")
    try:
        src = os.path.join(tmp, "scenes")
        t0 = time.perf_counter()
        write_scene_tree(src, seed + 61)
        data_s = time.perf_counter() - t0
        rec = run_convergence_demo(os.path.join(tmp, "work"), src,
                                   CONV_STEPS, CONV_BATCH, CONV_HOLDOUT,
                                   os.path.join(tmp, "summary.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    try:
        report = convergence_report(rec, CONV_STEPS, CONV_MEM_FROM)
    finally:
        emit("convergence", check="demo", batch=CONV_BATCH,
             image_size=list(TRAIN_HW), eval_size=list(CONV_EVAL_HW),
             scenes=CONV_SCENES, holdout=CONV_HOLDOUT, data_write_s=data_s,
             rc=rec["rc"], wall_s=rec["wall_s"], summary=rec["summary"],
             train_launches=rec["train_launches"],
             colorize=rec["colorize"], launches=rec["launches"],
             step_ms=[s * 1e3 for s in rec["train"]["step_s"]],
             loader_wait_share=rec["train"]["loader_wait_share"],
             allocated_mib={s: rec["allocated_mib"].get(s)
                            for s in (1, CONV_MEM_FROM, CONV_STEPS)},
             card=card)
    emit("convergence", check="demo_report",
         **{k: v for k, v in report.items()
            if k not in ("colorize", "summary", "train_launches",
                         "launches")}, card=card)
    return k1, k2, rec["launches"]


def k1_bf16_bound(b: int, n: int, c: int = 256) -> dict:
    """K1 on bf16 embeddings: the score and value products at the card's
    bf16 tensor rate, against its bytes (theta, phi, values read once in
    bf16; out written in bf16, sim in fp32)."""
    flop = 2 * b * n * n * (c + 3)
    nbytes = 2 * b * n * (2 * c + 3 + 3) + 4 * b * n
    ops_ms = flop / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flop": flop, "bytes": nbytes, "exponentials": b * n * n}


def _k1_bf16_cases(rng, dev):
    """K1's bf16 kernel (csrc/corr_fwd_bf16.cu, scores on the tensor cores)
    at B = 1, N = 5184 and 20736 against the plain version on the same
    bf16 inputs, at T = 0.01, 1 and 1e-10: sim within 1e-5; l within 1e-5
    relative of the plain version in float64 (the fp32 plain version
    carries its own round-off, which 1 / T amplifies at T = 0.01); out,
    after its bf16 rounding, within one bf16 ulp of |out| <= 100 (0.5,
    plus 1e-3) on every row at T = 0.01 and 1, and at T = 1e-10 on all
    but at most 1e-3 of rows (near-tie flips: two best scores closer than
    the summation-order round-off). A second call bit-equal to the first; a
    duplicated key averaged exactly. Then ms of the kernel, of the fp32
    kernel on the upcast inputs, of the plain version and of SDPA on the
    bf16 inputs, with the bf16 bound."""
    import torch

    from devc_tpu_torch.ops.correspondence import (
        correspondence_fwd_plain,
        correspondence_warp_einsum,
    )
    from devc_tpu_torch.ops.cuda_corr import corr_fwd

    rows = []
    for n in K1_SIZES:
        theta, phi, values = (x.bfloat16() for x in
                              _k1_inputs(rng, 1, n, dev))
        case = {"kernel": "corr_fwd_bf16", "dtype": "bfloat16", "b": 1,
                "n": n, "c": 256, "sim_max_abs_err": 0.0,
                "out_max_abs_err_unflipped": 0.0, "l_max_rel_err": 0.0,
                "run_to_run_bit_equal": True}
        for t in (0.01, 1.0, 1e-10):
            before = corr_fwd.bf16_launches
            out, sim, l = corr_fwd(theta, phi, values, t, emit_l=True)
            again = corr_fwd(theta, phi, values, t, emit_l=True)
            want_out, want_sim = correspondence_warp_einsum(theta, phi,
                                                            values, t)
            _, _, want_l = correspondence_fwd_plain(
                theta.double(), phi.double(), values.double(), t)
            torch.cuda.synchronize()
            assert corr_fwd.bf16_launches == before + 2
            equal = all(torch.equal(x, y) for x, y in zip((out, sim, l),
                                                          again))
            sim_err = (sim - want_sim).abs().max().item()
            row_err = (out.float() - want_out.float()).abs().amax(dim=-1)
            ok = row_err <= 0.5 + 1e-3
            l_rel = ((l.double() - want_l).abs() / want_l)[ok[..., None]]
            at_t = {"temperature": t, "sim_max_abs_err": sim_err,
                    "out_max_abs_err_unflipped": row_err[ok].max().item(),
                    "rows_differing": 1.0 - ok.float().mean().item(),
                    "l_max_rel_err": l_rel.max().item(),
                    "run_to_run_bit_equal": equal}
            emit("bf16", kernel="corr_fwd_bf16", n=n, **at_t)
            assert equal, at_t
            assert sim_err <= 1e-5 and at_t["l_max_rel_err"] <= 1e-5, at_t
            assert at_t["rows_differing"] <= (1e-3 if t == 1e-10 else 0), at_t
            for k in ("sim_max_abs_err", "out_max_abs_err_unflipped",
                      "l_max_rel_err"):
                case[k] = max(case[k], at_t[k])
            case[f"rows_differing_t{t:g}"] = at_t["rows_differing"]
            del out, sim, l, again, want_out, want_sim, want_l, row_err
            torch.cuda.empty_cache()
        # an exact tie at the row max: key 5 duplicated at n - 100 (other
        # key tiles, another key range), out the exact bf16 mean, l = 2
        tied = phi.clone()
        tied[0, 5] = tied[0, n - 100] = theta[0, 0]
        out, _, l = corr_fwd(theta, tied, values, 1e-10, emit_l=True)
        mean = ((values[0, 5].float() + values[0, n - 100].float())
                / 2).bfloat16()
        case["exact_tie_mean"] = bool(torch.equal(out[0, 0], mean)
                                      and l[0, 0, 0].item() == 2.0)
        assert case["exact_tie_mean"], (out[0, 0], mean, l[0, 0, 0])
        del tied, out, l
        t = 1e-10
        case["temperature"] = t
        case["ms"] = cuda_ms(lambda: corr_fwd(theta, phi, values, t),
                             queued=True)
        up = [x.float() for x in (theta, phi, values)]
        case["fp32_kernel_on_upcast_ms"] = cuda_ms(
            lambda: corr_fwd(*up, t), queued=True)
        case["plain_ms"] = cuda_ms(lambda: correspondence_warp_einsum(
            theta, phi, values, t), queued=True)
        case.update(sdpa_ms(theta, phi, values, t))
        case.update(k1_bf16_bound(1, n))
        emit("bf16", **case)
        rows.append(case)
        del theta, phi, values, up
        torch.cuda.empty_cache()
    return rows


def _bf16_parity(sds, seed: int, card: str):
    """frame_step in bf16 on the card against the CPU's bf16 path, one
    64x128 frame from a zero carry with the CPU's bf16 exemplar state
    (teacher-forced), at the bounds of tests/test_torch_bf16.py (with the
    CPU's own fp32-vs-bf16 distance in place of devc_tpu's): T = 1 pred_ab
    relative L2 <= 0.15 and below that distance, uint8 within 12; T =
    1e-10 the share of uint8 pixels off by more than 1 at most that
    distance's share plus 0.05."""
    import numpy as np
    import torch

    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import PipelineModels

    hw = (64, 128)
    ref, rgb = (torch.from_numpy(x) for x in textured_frames(seed + 1, 2, hw))
    bf = torch.bfloat16
    cpu16 = PipelineModels.from_state_dicts(sds, "cpu", bf)
    cpu32 = PipelineModels.from_state_dicts(sds, "cpu")
    gpu16 = PipelineModels.from_state_dicts(sds, "cuda", bf)
    _, st16 = video._device_ref_features(cpu16, ref, bf)
    _, st32 = video._device_ref_features(cpu32, ref)
    last = torch.zeros((1, hw[0] // 2, hw[1] // 2, 3))
    gst = {k: v.cuda() for k, v in st16.items()}
    for t in (1.0, 1e-10):
        want, want_last = video.frame_step(cpu16, rgb, last, st16, t,
                                           compute_dtype=bf)
        base, base_last = video.frame_step(cpu32, rgb, last, st32, t)
        got, got_last = video.frame_step(gpu16, rgb.cuda(), last.cuda(), gst,
                                         t, compute_dtype=bf)
        got, got_last = got.cpu(), got_last.cpu()
        diff = np.abs(got.numpy().astype(int) - want.numpy())
        gap = np.abs(base.numpy().astype(int) - want.numpy())
        ab = _rel_l2([got_last[..., 1:].double()],
                     [want_last[..., 1:].double()])
        gap_ab = _rel_l2([base_last[..., 1:].double()],
                         [want_last[..., 1:].double()])
        case = {"check": "frame_step_vs_cpu_bf16", "hw": hw,
                "temperature": t, "pred_ab_rel_l2": ab,
                "cpu_fp32_vs_bf16_rel_l2": gap_ab,
                "u8_max_diff": int(diff.max()),
                "u8_share_off_by_more_than_1": float((diff > 1).mean()),
                "cpu_fp32_vs_bf16_share": float((gap > 1).mean()),
                "card": card}
        emit("bf16", **case)
        assert bool(torch.isfinite(got_last).all()), case
        if t == 1.0:
            assert ab <= 0.15 and ab < gap_ab and diff.max() <= 12, case
        else:
            assert (diff > 1).mean() <= (gap > 1).mean() + 0.05, case


def _device_loop_ms(models, frames, ref, compute_dtype, scan: bool):
    """ms a frame of the device loop over frames (uint8 on the card, no
    transfers): eager steps (stream) or replays of one captured step
    (scan), median of 3 runs."""
    import numpy as np
    import torch

    from devc_tpu_torch.pipeline import graph, video

    dev = models.device
    frames_dev = torch.from_numpy(np.stack(frames)).to(dev)
    h, w = frames[0].shape[:2]
    _, state = video._device_ref_features(
        models, torch.from_numpy(ref).to(dev), compute_dtype)
    carry = torch.zeros((1, h // 2, w // 2, 3), device=dev)
    step = lambda f, c: video.frame_step(models, f, c, state,
                                         compute_dtype=compute_dtype)
    if scan:
        replay = graph.CapturedStep(step, (h, w, 3), carry)
        ms = cuda_ms(lambda: replay.run(frames_dev), reps=3, warmup=1)
        del replay
    else:
        def eager():
            c = carry
            for f in frames_dev:
                _, c = step(f, c)
        ms = cuda_ms(eager, reps=3, warmup=1)
    return ms / len(frames)


def _bf16_quality(sds, frames, ref, weights: str, card: str):
    """bf16 frames against fp32 frames on the same weights (the way
    probes/ab_bf16_quality.py measures it), 432x768, T = 1e-10, WLS on:
    teacher-forced (frame i's bf16 step from the fp32 carry of frame
    i - 1) and free-running (the bf16 loop on its own carry). Per frame:
    PSNR through the port's utils/metrics.py on the card, the largest
    uint8 difference and the share of pixels that moved."""
    import numpy as np
    import torch

    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.metrics import psnr

    bf = torch.bfloat16
    m32 = PipelineModels.from_state_dicts(sds, "cuda")
    m16 = PipelineModels.from_state_dicts(sds, "cuda", bf)
    ref_t = torch.from_numpy(ref).cuda()
    _, st32 = video._device_ref_features(m32, ref_t)
    _, st16 = video._device_ref_features(m16, ref_t, bf)
    frames_t = [torch.from_numpy(f).cuda() for f in frames]
    last0 = torch.zeros((1, H // 2, W // 2, 3), device="cuda")
    outs32, carries32, last = [], [], last0
    for f in frames_t:
        out, last = video.frame_step(m32, f, last, st32)
        outs32.append(out)
        carries32.append(last)
    forced, free, last = [], [], last0
    for i, f in enumerate(frames_t):
        forced.append(video.frame_step(m16, f, carries32[i - 1] if i else
                                       last0, st16, compute_dtype=bf)[0])
        out, last = video.frame_step(m16, f, last, st16, compute_dtype=bf)
        free.append(out)

    def score(outs):
        res = {"psnr_db": [], "u8_max_diff": [], "share_moved": []}
        for a, b in zip(outs, outs32):
            d = (a.int() - b.int()).abs()
            res["psnr_db"].append(psnr(a, b, device="cuda"))
            res["u8_max_diff"].append(int(d.max()))
            res["share_moved"].append(float((d.amax(-1) > 0).float().mean()))
        res["psnr_mean_db"] = float(np.mean(
            [p for p in res["psnr_db"] if np.isfinite(p)] or [np.inf]))
        return res

    case = {"check": "quality_bf16_vs_fp32", "weights": weights,
            "image_size": [H, W], "frames": len(frames),
            "temperature": 1e-10, "teacher_forced": score(forced),
            "free_running": score(free), "card": card}
    emit("bf16", **case)
    for o in forced + free:
        assert o.dtype == torch.uint8 and tuple(o.shape) == (H, W, 3)
    del m32, m16
    torch.cuda.empty_cache()
    return case


def _bf16_cli(frames, ref, seed: int, card: str):
    """python -m devc_tpu_torch.cli.colorize with and without --bf16 on
    the 8 frames (PNG) at 432x768, then the port's cli.evaluate on the
    card over the two outputs (bf16 against fp32) and its per-clip
    temporal score."""
    from PIL import Image

    tmp = tempfile.mkdtemp(prefix="devc_chip_bf16_")
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        clip = os.path.join(tmp, "clip")
        _save_clip(clip, frames)
        ref_path = os.path.join(tmp, "ref.png")
        Image.fromarray(ref).save(ref_path)
        runs = {}
        for name, extra in (("fp32", []), ("bf16", ["--bf16"])):
            out = os.path.join(tmp, name)
            cmd = [sys.executable, "-m", "devc_tpu_torch.cli.colorize",
                   "--clip_path", clip, "--ref_path", ref_path,
                   "--output_path", out, "--image_size", str(H), str(W),
                   "--random_init", "--seed", str(seed), "--no_video",
                   "--device", "cuda", *extra]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600, cwd=root)
            if res.returncode != 0:
                raise RuntimeError(f"CLI {name} failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            runs[name] = {"wall_s": time.perf_counter() - t0,
                          "dir": os.path.join(out, "clip_ref"),
                          "stdout": res.stdout.strip().splitlines()[-1:]}
            assert len(os.listdir(runs[name]["dir"])) == len(frames)
        cmd = [sys.executable, "-m", "devc_tpu_torch.cli.evaluate",
               "--dir_a", runs["bf16"]["dir"], "--dir_b", runs["fp32"]["dir"],
               "--json", "--device", "cuda"]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                             cwd=root)
        if res.returncode != 0:
            raise RuntimeError(f"cli.evaluate failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        report = json.loads(res.stdout.strip().splitlines()[-1])
        emit("bf16", check="cli_colorize_bf16_and_evaluate",
             runs={k: {"wall_s": v["wall_s"], "stdout": v["stdout"]}
                   for k, v in runs.items()},
             evaluate_bf16_vs_fp32=report, card=card)
        assert report["frames"] == report["compared"] == len(frames), report
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_bf16(sds, frames, ref, seed: int, card: str):
    """The bf16 mode (cli.colorize --bf16) on the card: K1's bf16 kernel
    (against its plain version, a rerun, an exact tie, ms, bound, SDPA);
    frame_step against the CPU's bf16 path;
    the main path (colorize_frames, bf16 models, compute_dtype bf16) on the
    8 frames at 432x768 with its launches (read right after it ran, the
    counts at 0 before), scan bit-equal to stream; ms a frame of fp32 and
    bf16 at 432x768 (stream and scan) and 864x1536 (stream); the stages
    in bf16; the CLI end to end and cli.evaluate; quality against fp32 on
    the seeded random weights. Returns (K1's bf16 rows, the launches)."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import cuda_corr
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.pipeline.video import colorize_frames

    bf = torch.bfloat16
    k1_rows = _k1_bf16_cases(np.random.RandomState(seed + 7), "cuda")
    _bf16_parity(sds, seed, card)

    m16 = PipelineModels.from_state_dicts(sds, "cuda", bf)
    events, outs = [], []

    def on_frame(idx, rgb):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        outs.append(rgb)

    _counts_zero()
    n = colorize_frames(m16, frames, ref, on_frame, temperature=1e-10,
                        wls=True, compute_dtype=bf)
    torch.cuda.synchronize()
    launches = _counts()
    bf16_k1 = cuda_corr.corr_fwd.bf16_launches
    per_frame = [events[i - 1].elapsed_time(events[i])
                 for i in range(1, len(events))]
    scan = []
    colorize_frames(m16, frames, ref, lambda i, a: scan.append(a),
                    temperature=1e-10, wls=True, mode="scan", chunk=4,
                    compute_dtype=bf)
    scan_equal = [bool(np.array_equal(a, b)) for a, b in zip(outs, scan)]
    chroma = max(int(np.abs(o[..., 0].astype(int) - o[..., 1]).max())
                 for o in outs)
    emit("bf16", check="main", frames=n, image_size=[H, W],
         temperature=1e-10, launches=launches, corr_fwd_bf16_launches=bf16_k1,
         per_frame_ms=per_frame, mean_frame_ms=statistics.mean(per_frame),
         scan_vs_stream="bit-equal" if all(scan_equal) else scan_equal,
         max_r_minus_g=chroma, card=card)
    assert n == N_FRAMES and len(scan) == N_FRAMES, (n, len(scan))
    assert launches == {"corr_fwd": N_FRAMES, "smooth_pass": 6 * N_FRAMES,
                        "tridiag_pcr": 0, "split_conv2d": 0}, launches
    assert bf16_k1 == N_FRAMES, bf16_k1
    assert all(scan_equal), scan_equal
    assert chroma > 3, "outputs are gray: no chroma was added"

    # ms a frame, fp32 and bf16 in turns on the same frames
    m32 = PipelineModels.from_state_dicts(sds, "cuda")
    ms = {}
    for h, w in BF16_SIZES:
        big = (h, w) != (H, W)
        fr = textured_frames(seed + 3, N_FRAMES + 1, (h, w)) if big else \
            [ref] + list(frames)
        for name, models, dtype in (("fp32", m32, None), ("bf16", m16, bf)):
            key = f"{h}x{w}"
            ms.setdefault(key, {})[f"{name}_stream_ms_per_frame"] = \
                _device_loop_ms(models, fr[1:], fr[0], dtype, scan=False)
            if not big:
                ms[key][f"{name}_scan_ms_per_frame"] = _device_loop_ms(
                    models, fr[1:], fr[0], dtype, scan=True)
        del fr
        torch.cuda.empty_cache()
    emit("bf16", check="ms_per_frame", ms=ms,
         note="device loop over 8 frames on the card, no transfers; "
              "median of 3 runs", card=card)
    del m32
    layers = phase_layers(m16, ref, frames[0], card, compute_dtype=bf)
    del m16
    torch.cuda.empty_cache()
    _bf16_cli(frames, ref, seed, card)
    _bf16_quality(sds, frames, ref, f"random (host_pipeline_params({seed}))",
                  card)
    return k1_rows, dict(launches, corr_fwd_bf16=bf16_k1), layers


# ---------------------------------------------------------------- parallel
# the parallel layer on one card: 2 ranks sharing it over gloo, and one
# NCCL rank; the children report their launch counts and numbers here
PAR_WORLD = 2
PAR_K1_T = (0.01, 1e-10)  # accuracy at both; timed at 1e-10 (inference)
PAR_SPMD_TIMED_STEPS = 3  # after one warm-up step
PAR_CLI_STEPS = 12


def _par_k1_inputs(seed: int, n: int, dev):
    import numpy as np

    return _k1_inputs(np.random.RandomState(seed + n), 1, n, dev)


def _par_train_kernels(seed: int):
    """K1 (with l, as training runs it), K3 and K2b at one rank's half of
    the training batch (B = 8, N = 5184, C = 256, T = 0.01), on the card
    alone: against their plain versions, ms, plain ms and bounds (K1's
    SDPA too). Returns (K1's row, {kernel: row})."""
    import numpy as np
    import torch

    from devc_tpu_torch.ops import cuda_corr
    from devc_tpu_torch.ops.correspondence import correspondence_bwd_plain

    rng = np.random.RandomState(seed + 70)
    b, n, c, t = TRAIN_B // PAR_WORLD, TRAIN_N, 256, 0.01
    theta, phi = unit_rows(rng, b, n, c), unit_rows(rng, b, n, c)
    values = (rng.rand(b, n, 3).astype(np.float32) - 0.5) * 100
    d_out = rng.randn(b, n, 3).astype(np.float32)
    d_sim = rng.randn(b, n, 1).astype(np.float32)
    theta, phi, values, d_out, d_sim = (torch.from_numpy(x).cuda() for x in
                                        (theta, phi, values, d_out, d_sim))
    # K1 as training runs it, at T = 0.01 with l (`_k1_case`)
    k1 = dict(_k1_case(theta, phi, values, t, emit_l=True),
              kind="train_shard", n=n)
    out, sim, l = cuda_corr.corr_fwd(theta, phi, values, t, emit_l=True)
    args = (theta, phi, values, sim, l, out, d_out, d_sim, t)
    errs = {}
    # against the gradients in float64, as phase bwd, and no farther from
    # them than the fp32 plain version
    for name, g, w, p32 in zip(("dtheta", "dphi", "dvalues"),
                               cuda_corr.corr_bwd(*args),
                               bwd_float64(theta, phi, values, d_out, d_sim,
                                           t),
                               correspondence_bwd_plain(*args)):
        errs[name] = (g.double() - w).abs().max().item()
        assert bool(((g.double() - w).abs() <= 5e-3 + 1e-3 * w.abs()).all()), \
            name
        assert errs[name] <= (p32.double() - w).abs().max().item(), name
    dd = (d_out * out).sum(dim=-1, keepdim=True)
    df = torch.empty((b, cuda_corr.padded(n), cuda_corr.padded(n)),
                     dtype=torch.float32, device=theta.device)
    kargs = (theta, phi, values, sim, l, dd, d_sim, d_out, t, df)
    bounds = bwd_bounds(b, n, n, c)
    plain_ms = cuda_ms(lambda: correspondence_bwd_plain(*args), queued=True)
    bwd = {}
    # K3 first: it fills the df scratch K2b reads
    for kernel, fn, outs in (
            ("corr_bwd_dkv", lambda: cuda_corr.corr_bwd_dkv(*kargs),
             ("dphi", "dvalues")),
            ("corr_bwd_dq", lambda: cuda_corr.corr_bwd_dq(df, phi, n),
             ("dtheta",))):
        bwd[kernel] = {"b": b, "n": n, "c": c, "temperature": t,
                       "ms": cuda_ms(fn, queued=True),
                       "plain_ms_both_outputs": plain_ms, "library_ms": None,
                       "max_abs_err": max(errs[o] for o in outs),
                       **bounds[kernel]}
    del theta, phi, values, d_out, d_sim, out, sim, l, args, kargs, df
    torch.cuda.empty_cache()
    return k1, bwd


def _par_k1_reference(seed: int):
    """In this process, per N: unsharded K1 and the plain version at
    PAR_K1_T (sim in fp32, out in float64; numpy, for the ranks to hold
    their results against), and K1 alone at the two shard shapes (rows:
    N/2 queries, all keys; keys: all queries, N/2 keys with l) against its
    plain version, with ms, SDPA and the bound (`_k1_case`)."""
    import torch

    from devc_tpu_torch.ops.correspondence import correspondence_warp_einsum
    from devc_tpu_torch.ops.cuda_corr import corr_fwd

    refs, rows = {}, []
    for n in K1_SIZES:
        theta, phi, values = _par_k1_inputs(seed, n, "cuda")
        for t in PAR_K1_T:
            out, sim, _ = corr_fwd(theta, phi, values, t)
            _, p_sim = correspondence_warp_einsum(theta, phi, values, t)
            # out against the plain version in float64, as phase kernels
            p_out, _ = correspondence_warp_einsum(
                theta.double(), phi.double(), values.double(), t)
            refs[(n, t)] = {k: v.cpu().numpy() for k, v in (
                ("out", out), ("sim", sim), ("plain_out", p_out),
                ("plain_sim", p_sim))}
            del out, sim, p_out, p_sim
        # the shards (`_k1_case`): rows, N/2 queries against all keys;
        # keys, all queries against N/2 keys with l
        h, t = n // 2, PAR_K1_T[-1]
        for kind, args, emit_l in (
                ("rows", (theta[:, :h], phi, values), False),
                ("keys", (theta, phi[:, :h], values[:, :h]), True)):
            rows.append(dict(_k1_case(*(a.contiguous() for a in args), t,
                                      emit_l), kind=kind, n=n))
        del theta, phi, values
        torch.cuda.empty_cache()
    return refs, rows


def _par_rank_inference(ctx, seed: int, refs: dict):
    """One rank of the inference half: the sharded K1 at both sizes
    against the unsharded kernel (sim bit-equal) and its plain version
    (K1's tolerances), ms of the sharded call on this rank; then the
    counted path: frames at 432x768 with corr_sharding rows and keys
    (teacher-forced: each frame's carry from the unsharded step), and the
    data-parallel batched step (4 clips, 2 a rank); rank 0 then runs the
    one-process B = 4 step to hold the gathered one against."""
    import numpy as np
    import torch

    from devc_tpu_torch.parallel.inference import (
        batched_frame_step,
        prepare_references_batched,
    )
    from devc_tpu_torch.parallel.mesh import (
        gather_batch,
        make_mesh,
        shard_batch,
    )
    from devc_tpu_torch.parallel.sharded_corr import (
        correspondence_warp_key_sharded,
        correspondence_warp_sharded,
    )
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import use_full_fp32
    from devc_tpu_torch.utils import build
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    use_full_fp32()
    build.load_kernels()
    mesh = make_mesh(n_data=1, n_model=ctx.world)
    fns = {"rows": correspondence_warp_sharded,
           "keys": correspondence_warp_key_sharded}
    k1 = []
    for n in K1_SIZES:
        theta, phi, values = _par_k1_inputs(seed, n, ctx.device)
        for kind, fn in fns.items():
            case = {"kind": kind, "n": n, "rank": ctx.rank}
            for t in PAR_K1_T:
                w, s = fn(theta, phi, values, mesh, t)
                ref = refs[(n, t)]
                w, s = w.cpu().numpy(), s.cpu().numpy()
                case[f"sim_bit_equal_t{t}"] = bool(np.array_equal(
                    s, ref["sim"]))
                row_err = np.abs(w - ref["plain_out"]).max(axis=-1)
                case[f"sim_max_abs_err_vs_plain_t{t}"] = float(
                    np.abs(s - ref["plain_sim"]).max())
                case[f"out_max_abs_err_vs_plain_t{t}"] = float(row_err.max())
                case[f"out_max_abs_err_vs_kernel_t{t}"] = float(
                    np.abs(w - ref["out"]).max())
                if t == 1e-10:  # an argmax-average: near-tie flips only
                    case["rows_differing_t1e-10"] = float(
                        (row_err > 1e-4).mean())
            case["ms_per_rank"] = cuda_ms(
                lambda: fn(theta, phi, values, mesh, PAR_K1_T[-1]))
            k1.append(case)
        del theta, phi, values
        torch.cuda.empty_cache()

    models = PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(seed)), ctx.device)
    dev = ctx.device
    frames = [torch.from_numpy(f).to(dev)[None]
              for f in textured_frames(seed + 60, 2, (H, W))]
    ref_u8 = torch.from_numpy(textured_frames(seed + 61, 1, (H, W))[0]).to(
        dev)[None]
    _, state = prepare_references_batched(models, ref_u8)
    carries = [torch.zeros((1, H // 2, W // 2, 3), device=dev)]
    want = []
    for f in frames:  # the unsharded frames and their carries
        out, last = batched_frame_step(models, f, carries[-1], state)
        want.append(out)
        carries.append(last)
    clips = torch.from_numpy(np.stack(textured_frames(seed + 62, 4, (H, W))))
    clip_refs = torch.from_numpy(np.stack(textured_frames(seed + 63, 4,
                                                          (H, W))))
    torch.cuda.synchronize()

    _counts_zero()
    frames_diff = {}
    for kind in fns:
        diffs = []
        for f, carry, w in zip(frames, carries, want):
            out, _ = batched_frame_step(models, f, carry, state,
                                        corr_sharding=(mesh, "model", kind))
            diffs.append(int((out.int() - w.int()).abs().max()))
        frames_diff[kind] = diffs
    dp = make_mesh(n_data=ctx.world, n_model=1)
    local = shard_batch(dp, {"clips": clips, "refs": clip_refs})
    _, dp_state = prepare_references_batched(models, local["refs"].to(dev))
    dp_last = torch.zeros((local["clips"].shape[0], H // 2, W // 2, 3),
                          device=dev)
    t0 = time.perf_counter()
    out, last = batched_frame_step(models, local["clips"].to(dev), dp_last,
                                   dp_state)
    out, last = gather_batch(dp, (out, last))
    torch.cuda.synchronize()
    dp_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    result = {"k1": k1, "frames_max_uint8_diff": frames_diff,
              "data_parallel_step_ms_host": dp_ms, "counts": counts}
    if ctx.rank == 0:
        _, one_state = prepare_references_batched(models, clip_refs.to(dev))
        one_out, one_last = batched_frame_step(
            models, clips.to(dev), torch.zeros_like(last), one_state)
        result["data_parallel_max_uint8_diff"] = int(
            (out.int() - one_out.int()).abs().max())
        result["data_parallel_carry_max_abs_diff"] = float(
            (last - one_last).abs().max())
    return result


def _par_rank_train(ctx, seed: int, one_path: str):
    """One rank of the data-parallel training step at batch 16 (this
    rank's block of it), 216x384, full width: one step at phase
    train_parity's settings (T = 1, recurrence damped, no noise) with
    gradient-recording optimizers, held (rank 0) against the one-process
    step's gradients in one_path; then TrainConfig's defaults with the
    real optimizers: one warm-up step and PAR_SPMD_TIMED_STEPS timed,
    ms a step, peak memory and launch counts of this rank."""
    import numpy as np
    import torch

    from devc_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_params,
    )
    from devc_tpu_torch.utils.convert import use_full_fp32
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train.state import make_optimizers
    from devc_tpu_torch.utils import build
    from devc_tpu_torch.utils.convert import frozen_vgg, train_state_from_numpy

    use_full_fp32()
    build.load_kernels()
    dev = ctx.device
    mesh = make_mesh()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in shard_batch(
        mesh, synthetic_batch_u8(seed + 5, TRAIN_B, TRAIN_HW)).items()}
    result = {"rank": ctx.rank, "backend": ctx.backend,
              "batch_per_rank": int(batch["last_rgb"].shape[0])}

    vgg_np, params_g, params_d, sn = train_weights(seed, 1e-3)
    state = train_state_from_numpy(params_g, params_d, sn, GradRecorder(),
                                   GradRecorder(), device=dev)
    shard_params(mesh, [state.params_g, state.params_d, state.sn_state])
    step = loop.make_train_step_spmd(
        mesh, GradRecorder(), GradRecorder(), frozen_vgg(vgg_np, dev),
        loop.TrainConfig(luminance_noise=0.0, temperature=1.0),
        device_preprocess=True)
    new, metrics = step(state, batch)
    if ctx.rank == 0:
        one = torch.load(one_path, weights_only=True)
        grads = {g: [t.double().cpu() for t in ts]
                 for g, ts in new.opt_state_g.items()}
        grads["critic"] = [t.double().cpu() for t in new.opt_state_d[""]]
        result["grad_rel_l2_vs_one_process"] = {
            net: _rel_l2(grads[net], [t.double() for t in one["grads"][net]])
            for net in grads}
        result["grads_bit_equal_to_one_process"] = all(
            torch.equal(a.float(), b) for net in grads
            for a, b in zip(grads[net], one["grads"][net]))
        result["loss_rel_err_vs_one_process"] = {
            k: abs(v.item() - one["metrics"][k]) / max(abs(one["metrics"][k]),
                                                       1e-12)
            for k, v in metrics.items()}
    del state, new, step
    torch.cuda.empty_cache()

    vgg_np, params_g, params_d, sn = train_weights(seed)
    tx_g, tx_d = make_optimizers()
    state = train_state_from_numpy(params_g, params_d, sn, tx_g, tx_d,
                                   device=dev)
    shard_params(mesh, [state.params_g, state.params_d, state.sn_state])
    step = loop.make_train_step_spmd(mesh, tx_g, tx_d, frozen_vgg(vgg_np, dev),
                                     loop.TrainConfig(),
                                     device_preprocess=True)
    gen = torch.Generator(device=dev).manual_seed(
        loop.noise_seed(seed, mesh.index("data")))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _train_counts_zero()
    step_ms, losses = [], []
    for _ in range(1 + PAR_SPMD_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: v.item() for k, v in metrics.items()})
    result.update(counts=_train_counts(), step_ms=step_ms,
                  median_step_ms=statistics.median(step_ms[1:]),
                  peak_mem_mib=torch.cuda.max_memory_allocated() / 2**20,
                  losses_last=losses[-1],
                  finite=all(np.isfinite(v) for m in losses
                             for v in m.values()))
    return result


def _par_cli_train(tmp: str, seed: int) -> dict:
    """python -m devc_tpu_torch.cli.train under torchrun, 2 ranks on the
    one card (gloo), PAR_CLI_STEPS steps at batch 16, 216x384 on the
    generated datasets, then --resume for 2 more. Returns both runs'
    summaries of every rank and what the directories hold."""
    import numpy as np

    from devc_tpu_torch.parallel.launch import free_port

    imagenet, video = (os.path.join(tmp, d) for d in ("imagenet", "video"))
    write_imagenet_root(imagenet, seed + 40)
    write_video_root(video, seed + 41)
    ckpt = os.path.join(tmp, "ckpt")
    common = ["--data_root", video, "--data_root_imagenet", imagenet,
              "--vgg_ckpt", "/nonexistent/vgg19_conv.pth", "--seed",
              str(seed), "--checkpoint_dir", ckpt, "--workers", "4",
              "--checkpoint_step", str(PAR_CLI_STEPS), "--print_step", "1"]

    def run(log_dir, steps, *extra):
        # each rank's output to a file of its own (--redirects 3), so that
        # the ranks' lines do not interleave
        rank_logs = log_dir + "_ranks"
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nnodes", "1", "--nproc_per_node", str(PAR_WORLD),
               "--master_addr", "localhost", "--master_port",
               str(free_port()), "--log_dir", rank_logs, "--redirects", "3",
               "-m", "devc_tpu_torch.cli.train",
               *common, "--log_dir", log_dir, "--max_steps", str(steps),
               *extra]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
        if proc.returncode != 0:
            raise RuntimeError(f"torchrun cli.train exited "
                               f"{proc.returncode}:\n{out[-6000:]}")
        summaries = []
        for d, _, files in os.walk(rank_logs):
            if "stdout.log" in files:
                summaries += [json.loads(ln)["train_summary"] for ln in
                              open(os.path.join(d, "stdout.log"))
                              if ln.startswith('{"train_summary"')]
        summaries.sort(key=lambda s: s["rank"])
        if len(summaries) != PAR_WORLD:
            raise RuntimeError(f"{len(summaries)} rank summaries under "
                               f"{rank_logs}:\n{out[-6000:]}")
        lines = [json.loads(ln) for ln in
                 open(os.path.join(log_dir, "metrics.jsonl"))]
        return {"wall_s": time.perf_counter() - t0, "summaries": summaries,
                "logged_steps": [ln["step"] for ln in lines],
                "total_loss": [ln["total_loss"] for ln in lines]}

    first = run(os.path.join(tmp, "runs"), PAR_CLI_STEPS)
    files_first = sorted(os.listdir(ckpt))
    second = run(os.path.join(tmp, "runs2"), 2, "--resume")
    loss = first["total_loss"]
    return {"first": first, "second": second, "files_after_first":
            files_first, "files_after_resume": sorted(os.listdir(ckpt)),
            "first_4_mean": float(np.mean(loss[:4])),
            "last_4_mean": float(np.mean(loss[-4:]))}


def phase_parallel(seed: int, card: str, fp32_noise: dict):
    """The parallel layer (parallel/, make_train_step_spmd, cli.train
    under torchrun) on the one card, ranks as spawned processes
    (parallel/launch.py: any failed or late rank fails the phase, and
    none is left running). fp32_noise: phase train_parity's distance of
    an fp32 step's gradients from float64, per network, the yardstick of
    C8's rule. Returns (K1's rows at the shard shapes and at a rank's
    half of the training batch, K3's and K2b's rows there, launches by
    path: "parallel", "train_spmd", "cli_train_ranks")."""
    import numpy as np
    import torch

    from devc_tpu_torch.parallel.launch import spawn_ranks
    from devc_tpu_torch.train import loop

    t_phase = time.perf_counter()
    refs, k1_rows = _par_k1_reference(seed)
    k1_train, bwd_train = _par_train_kernels(seed)
    emit("parallel", check="train_shard_kernels", card=card, corr_fwd=k1_train,
         **bwd_train)
    torch.cuda.empty_cache()
    inf = spawn_ranks(_par_rank_inference, PAR_WORLD, (seed, refs),
                      device="cuda", timeout=300, collective_timeout=120)
    for r in inf:
        for case in r["k1"]:
            emit("parallel", check="k1_sharded", card=card, **case)
            for t in PAR_K1_T:
                # a max is exact in any order; out: K1's tolerances
                assert case[f"sim_bit_equal_t{t}"], case
                assert case[f"sim_max_abs_err_vs_plain_t{t}"] <= 1e-5, case
            assert case["out_max_abs_err_vs_plain_t0.01"] <= 1e-3, case
            assert case["rows_differing_t1e-10"] <= 1e-3, case
    for row in k1_rows:
        cases = [c for r in inf for c in r["k1"]
                 if c["kind"] == row["kind"] and c["n"] == row["n"]]
        row["ms_sharded_call_per_rank"] = [c["ms_per_rank"] for c in cases]
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            max(c["out_max_abs_err_vs_plain_t0.01"],
                c["sim_max_abs_err_vs_plain_t0.01"]) for c in cases])
        emit("parallel", check="k1_shard_shape", card=card, **row)
    r0 = inf[0]
    emit("parallel", check="frames_and_batched_step", hw=[H, W],
         frames_max_uint8_diff=[r["frames_max_uint8_diff"] for r in inf],
         data_parallel_max_uint8_diff=r0["data_parallel_max_uint8_diff"],
         data_parallel_carry_max_abs_diff=r0[
             "data_parallel_carry_max_abs_diff"],
         data_parallel_step_ms_host=[r["data_parallel_step_ms_host"]
                                     for r in inf],
         launches_by_rank=[r["counts"] for r in inf], card=card)
    for r in inf:
        assert all(d <= 1 for ds in r["frames_max_uint8_diff"].values()
                   for d in ds), r["frames_max_uint8_diff"]
    assert r0["data_parallel_max_uint8_diff"] <= 1, r0
    parallel = {k: sum(r["counts"][k] for r in inf) for k in r0["counts"]}
    # per rank: 2 frames x 2 kinds + the batched step, one K1 each
    assert parallel["corr_fwd"] == PAR_WORLD * 5, parallel
    assert parallel["smooth_pass"] == PAR_WORLD * 5 * 6, parallel
    # and a frame's split convolutions each, with the data-parallel
    # step's exemplar preparation (2 a rank, one batch)
    assert parallel["split_conv2d"] == PAR_WORLD * _split_expected(
        5, 1), parallel

    # the one-process step's gradients at train_parity's settings
    weights = train_weights(seed, 1e-3)
    batch_u8 = synthetic_batch_u8(seed + 5, TRAIN_B, TRAIN_HW)
    cfg = loop.TrainConfig(luminance_noise=0.0, temperature=1.0)
    metrics, grads, _ = _grad_step(weights, batch_u8, cfg, "cuda",
                                   torch.float32)
    tmp = tempfile.mkdtemp(prefix="devc_chip_parallel_")
    try:
        one_path = os.path.join(tmp, "one_process_grads.pt")
        torch.save({"metrics": metrics, "grads": {
            k: [t.float() for t in v] for k, v in grads.items()}}, one_path)
        del grads
        torch.cuda.empty_cache()
        spmd = spawn_ranks(_par_rank_train, PAR_WORLD, (seed, one_path),
                           device="cuda", timeout=360,
                           collective_timeout=180)
        (nccl,) = spawn_ranks(_par_rank_train, 1, (seed, one_path),
                              device="cuda", timeout=240,
                              collective_timeout=180)
        for name, runs in (("gloo_2_ranks", spmd), ("nccl_1_rank", [nccl])):
            emit("parallel", check="train_spmd", ranks=name, batch=TRAIN_B,
                 image_size=list(TRAIN_HW), runs=runs,
                 fp32_noise_vs_fp64=fp32_noise, card=card)
            r = runs[0]
            for k, v in r["loss_rel_err_vs_one_process"].items():
                assert v <= 1e-3, (name, k, r)
            for net, err in r["grad_rel_l2_vs_one_process"].items():
                # C8: within 3x an fp32 step's own distance from float64
                assert err <= 3 * fp32_noise[net] + 1e-3, (name, net, r)
            for rr in runs:
                assert rr["finite"], rr
                assert rr["counts"] == {
                    "corr_fwd": 4 * (1 + PAR_SPMD_TIMED_STEPS),
                    "corr_bwd_dq": 2 * (1 + PAR_SPMD_TIMED_STEPS),
                    "corr_bwd_dkv": 2 * (1 + PAR_SPMD_TIMED_STEPS)}, rr
        assert [r["backend"] for r in spmd] == ["gloo"] * PAR_WORLD
        assert nccl["backend"] == "nccl", nccl
        train_spmd = {k: sum(r["counts"][k] for r in spmd + [nccl])
                      for k in nccl["counts"]}

        cli = _par_cli_train(tmp, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first, second = cli["first"], cli["second"]
    emit("parallel", check="cli_train_torchrun", steps=PAR_CLI_STEPS,
         batch=TRAIN_B, image_size=list(TRAIN_HW), card=card,
         **{k: v for k, v in cli.items() if k not in ("first", "second")},
         first=first, second=second)
    assert [s["rank"] for s in first["summaries"]] == list(range(PAR_WORLD))
    assert all(s["backend"] == "gloo" and s["last_step"] == PAR_CLI_STEPS
               for s in first["summaries"]), first
    assert all(s["first_step"] == PAR_CLI_STEPS + 1
               and s["last_step"] == PAR_CLI_STEPS + 2
               for s in second["summaries"]), second
    # rank 0 alone logs and checkpoints: one line a step, one file a save
    assert first["logged_steps"] == list(range(1, PAR_CLI_STEPS + 1)), first
    assert second["logged_steps"] == [PAR_CLI_STEPS + 1,
                                      PAR_CLI_STEPS + 2], second
    assert cli["files_after_first"] == [
        "opt.txt", "run_metadata.json", f"step_{PAR_CLI_STEPS:09d}.pt"], cli
    assert cli["last_4_mean"] < cli["first_4_mean"], cli
    assert all(np.isfinite(v) for v in first["total_loss"]), first
    names = ("corr_fwd", "corr_bwd_dq", "corr_bwd_dkv")
    cli_counts = {k: sum(s["launches_corr_fwd_dq_dkv"][i]
                         for run in (first, second)
                         for s in run["summaries"])
                  for i, k in enumerate(names)}
    assert cli_counts["corr_bwd_dq"] == PAR_WORLD * 2 * (PAR_CLI_STEPS + 2)
    emit("parallel", check="done", seconds=time.perf_counter() - t_phase)
    return k1_rows + [k1_train], bwd_train, {
        "parallel": parallel, "train_spmd": train_spmd,
        "cli_train_ranks": cli_counts}


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
    from devc_tpu_torch.utils.convert import use_full_fp32
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
    split = phase_conv_split(models, args.seed, card)
    launches, outs, ref, frames = phase_main(models, args.seed, card)
    phase_layers(models, ref, frames[0], card)
    phase_cli(frames, ref, args.seed, outs)
    k1_bf16, bf16_launches, _ = phase_bf16(sds, frames, ref, args.seed, card)
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
    fp32_noise = phase_train_parity(args.seed)
    train = phase_train(args.seed, card)
    cli_train, cli_colorize, cli_colorize_bf16 = phase_cli_train(
        frames, ref, args.seed, card)
    torch.cuda.empty_cache()
    k1_conv, k2_conv, convergence = phase_convergence(args.seed, card)
    k1_par, bwd_par, par_paths = phase_parallel(args.seed, card, fp32_noise)

    # the serving path's shapes beside each kernel's own
    pick = ("b", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    k1_pick = pick + ("library_ms", "library_call", "library_value_width",
                      "fma_rate_bound_ms")
    for row in k1["by_shape"]:
        row["dtype"] = "float32"
    k1["by_shape"] += [dict({k: c[k] for k in k1_pick}, n=c["n"],
                            temperature=1e-10, theta=c["theta"],
                            path="serve", dtype="float32")
                       for c in k1_serve]
    # the shard shapes of the parallel layer (K1 alone on the card; the
    # sharded call's ms on each of the two ranks beside it), and a rank's
    # half of the training batch (K1, K3, K2b)
    k1["by_shape"] += [dict(r, dtype="float32", path="train_spmd"
                            if r["kind"] == "train_shard" else "parallel")
                       for r in k1_par]
    for name, row in bwd_par.items():
        bwd[name]["by_shape"] = [dict(row, path="train_spmd")]
        bwd[name]["max_abs_err"] = max(bwd[name]["max_abs_err"],
                                       row["max_abs_err"])
    # the convergence demo's held-out evaluation at 224x384 (N = 1344)
    k1["by_shape"].append(dict({k: k1_conv[k] for k in k1_pick},
                               n=k1_conv["n"], temperature=1e-10,
                               path="convergence", dtype="float32"))
    k1["max_abs_err"] = max([k1["max_abs_err"]]
                            + [c["max_abs_err"]
                               for c in k1_serve + k1_par + [k1_conv]])
    # K1's bf16 kernel at its inference shapes, N = 5184 first
    k1_bf16_rows = [dict(
        {k: c[k] for k in ("b", "n", "c", "temperature", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms",
                           "library_call", "library_value_width",
                           "fp32_kernel_on_upcast_ms", "exponentials",
                           "l_max_rel_err", "run_to_run_bit_equal",
                           "exact_tie_mean")},
        max_abs_err=max(c["sim_max_abs_err"], c["out_max_abs_err_unflipped"]),
        dtype="bfloat16", path="bf16") for c in k1_bf16]
    k1_16 = dict(k1_bf16_rows[0], by_shape=k1_bf16_rows,
                 max_abs_err=max(r["max_abs_err"] for r in k1_bf16_rows))
    smooth = k2["entries"][0]
    smooth["by_shape"] += [dict({k: c[k] for k in pick}, h=c["h"], w=c["w"],
                                axis=c["axis"], guide=c["guide"],
                                path="serve") for c in k2_serve]
    smooth["by_shape"] += [dict({k: c[k] for k in pick if k != "b"},
                                h=c["h"], w=c["w"], axis=c["axis"],
                                path="convergence") for c in k2_conv]
    smooth["max_abs_err"] = k2["max_abs_err"] = max(
        [smooth["max_abs_err"]]
        + [c["max_abs_err"] for c in k2_serve + k2_conv])
    # launches: each driven path's count, read right after that path ran
    # with the counts at 0 (inference main path, the bf16 mode's main path,
    # the batched serving scheduler, the training step, cli.train's 30
    # steps, cli.colorize --train_ckpt on its checkpoint without and with
    # --bf16, the convergence demo's training and held-out evaluation).
    # corr_fwd's wrapper counts both of K1's kernels; its bf16
    # launches are the bf16 kernel's, the rest the fp32 kernel's.
    # the parallel layer's paths count in the ranks' processes, summed
    # over the ranks: "parallel" (sharded frames and the data-parallel
    # batched step), "train_spmd" (the 2-rank and the NCCL step),
    # "cli_train_ranks" (cli.train under torchrun)
    paths = {"main": launches, "bf16": bf16_launches, "serve": serve,
             "train": train, "cli_train": cli_train,
             "cli_train_colorize": cli_colorize,
             "cli_train_colorize_bf16": cli_colorize_bf16,
             "convergence": convergence, **par_paths}

    def count(counts, name):
        if name == "corr_fwd":
            return counts.get(name, 0) - counts.get("corr_fwd_bf16", 0)
        return counts.get(name, 0)

    by_path = lambda name: {p: count(c, name) for p, c in paths.items()}
    for entry in k2["entries"]:  # K2's two entries, each with its counts
        entry["launches_by_path"] = by_path(entry["name"])
        entry["launches"] = sum(entry["launches_by_path"].values())
    rows = [("corr_fwd", "corr_fwd.cu", "devc_tpu/ops/pallas_corr.py:80", k1),
            ("corr_fwd_bf16", "corr_fwd_bf16.cu",
             "devc_tpu/ops/pallas_corr.py:80", k1_16),
            ("smooth_pass", "tridiag_pcr.cu", "devc_tpu/ops/fgs.py:68", k2),
            ("corr_bwd_dq", "corr_bwd.cu", "devc_tpu/ops/pallas_corr.py:218",
             bwd["corr_bwd_dq"]),
            ("corr_bwd_dkv", "corr_bwd.cu", "devc_tpu/ops/pallas_corr.py:246",
             bwd["corr_bwd_dkv"]),
            ("split_conv2d", "conv_split.cu",
             "none: devc_tpu's convolutions are XLA's", split)]
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
