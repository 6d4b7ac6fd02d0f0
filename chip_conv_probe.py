#!/usr/bin/env python3
"""How cuDNN runs the port's fp32 convolutions at batch > 1, on one GPU.

    python3 chip_conv_probe.py            # inference, then training
    python3 chip_conv_probe.py --train    # training only

The batched serving step (`parallel/inference.py::batched_frame_step`,
432x768, random weights, TF32 off) at batch 1 and 4, in five ways: the
batch whole with the models' layout, with NCHW-contiguous inputs, with
channels-last inputs and weights, with `torch.backends.cudnn.benchmark`,
and one sample at a time (`ops/layers.py::Conv2d`, the port's default
under inference). One JSON line each: ms per step (CUDA events, median
of 3, host launch cost included), peak memory, and how far batch 4's row
0 lies from batch 1 (uint8 output and carry); then the whole batch's
heaviest kernels under torch.profiler.

Training (`train_probe`): the GAN step at batch 16 with the batch's
convolutions whole (the port's training path) and one sample at a time
(`Conv2d.forward` replaced here by a per-sample loop under autograd). (1) The FFT / complex-GEMM kernels cuDNN runs in each, under
torch.profiler. (2) Each network's gradients (relative L2) against a
float64 step on the card, at 128x256 (a float64 step at 216x384 does not
fit in 80 GB), with train_parity's conditioning (T = 1, conv1_1a's
previous-Lab weights x 1e-3, no luminance noise); the float64 step runs
the correspondence's plain version, since the kernels are fp32 only.
(3) ms per step and peak memory of both at 216x384 with the trainer's
defaults, in turns whole, per-sample, per-sample, whole.

Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import json
import sys


def _fft_kernels(fn) -> dict:
    """FFT and complex-GEMM kernels launched by fn() (torch.profiler):
    launches and device ms of each, and their total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, total_ms = {}, 0.0
    for evt in prof.events():
        name = evt.name.lower()
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        total_ms += ms
        if "fft" in name or "cf32" in name:
            row = rows.setdefault(evt.name[:90], {"launches": 0, "ms": 0.0})
            row["launches"] += 1
            row["ms"] += ms
    return {"fft_or_cf32_ms": sum(r["ms"] for r in rows.values()),
            "kernel_ms": total_ms, "kernels": rows}


def train_probe(card: str) -> None:
    """The training step's convolutions at batch 16: whole batch against
    one sample at a time (see the module's docstring)."""
    import statistics

    import torch

    import chip_smoke as cs
    from devc_tpu_torch.ops import correspondence, cuda_corr
    from devc_tpu_torch.ops.layers import Conv2d
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train.state import make_optimizers
    from devc_tpu_torch.utils.convert import frozen_vgg, train_state_from_numpy

    b, small, full = 16, (128, 256), (216, 384)
    whole_forward = Conv2d.forward

    def per_sample_forward(self, x):
        if x.shape[0] > 1 and x.is_cuda:
            return torch.cat([torch.nn.Conv2d.forward(self, s)
                              for s in x.split(1)])
        return torch.nn.Conv2d.forward(self, x)

    def convolve(name):
        Conv2d.forward = (per_sample_forward if name == "per_sample"
                          else whole_forward)

    cfg = loop.TrainConfig(luminance_noise=0.0, temperature=1.0)
    weights = cs.train_weights(0, damp_recurrence=1e-3)
    batch_u8 = cs.synthetic_batch_u8(11, b, small)
    grads, fft = {}, {}
    for name in ("whole_batch", "per_sample"):
        convolve(name)
        fft[name] = _fft_kernels(lambda: cs._grad_step(
            weights, batch_u8, cfg, "cuda", torch.float32))
        grads[name] = cs._grad_step(weights, batch_u8, cfg, "cuda",
                                    torch.float32)[1]

    class PlainCorr:  # float64 autograd through the plain version
        @staticmethod
        def apply(theta, phi, values, temperature):
            return correspondence.correspondence_warp_einsum(
                theta, phi, values, temperature)

    real = cuda_corr.CorrFunction
    cuda_corr.CorrFunction = PlainCorr
    try:
        exact = cs._grad_step(weights, batch_u8, cfg, "cuda",
                              torch.float64)[1]
    finally:
        cuda_corr.CorrFunction = real
    row = {"config": "train_grads_b16", "hw": list(small), "batch": b,
           "temperature": 1.0, "fft": fft, "grad_rel_l2_vs_fp64": {},
           "card": card}
    for net in exact:
        row["grad_rel_l2_vs_fp64"][net] = {
            name: cs._rel_l2(g[net], exact[net]) for name, g in grads.items()}
    print(json.dumps(row), flush=True)

    # ms per step at the trainer's defaults, 216x384, in turns
    vgg_np, params_g, params_d, sn = cs.train_weights(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             cs.synthetic_batch_u8(5, b, full).items()}
    vgg = frozen_vgg(vgg_np, "cuda")
    times = {"whole_batch": [], "per_sample": []}
    peak = {}
    fft_full = {}
    for name in ("whole_batch", "per_sample", "per_sample", "whole_batch"):
        convolve(name)
        tx_g, tx_d = make_optimizers()
        state = train_state_from_numpy(params_g, params_d, sn, tx_g, tx_d,
                                       device="cuda")
        step = loop.make_train_step(tx_g, tx_d, vgg, loop.TrainConfig(),
                                    device_preprocess=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(4):  # step 0 warms up
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            state, _ = step(state, batch, gen)
            t1.record()
            t1.synchronize()
            if i:
                times[name].append(t0.elapsed_time(t1))
        peak[name] = torch.cuda.max_memory_allocated() / 2**20
        if name not in fft_full:
            holder = {"state": state}

            def one():
                holder["state"], _ = step(holder["state"], batch, gen)
            fft_full[name] = _fft_kernels(one)
        del state, step
        torch.cuda.empty_cache()
    convolve("whole_batch")
    print(json.dumps({
        "config": "train_step_ms_b16", "hw": list(full), "turns":
        "whole, per-sample, per-sample, whole", "step_ms": times,
        "median_step_ms": {k: statistics.median(v) for k, v in times.items()},
        "peak_mib": peak, "fft_or_cf32_ms": {
            k: v["fft_or_cf32_ms"] for k, v in fft_full.items()},
        "kernel_ms": {k: v["kernel_ms"] for k, v in fft_full.items()},
        "card": card}), flush=True)


def main(argv=None) -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_conv_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if "--train" in argv:
        from chip_smoke import card_line
        from devc_tpu_torch.pipeline.video import use_full_fp32

        use_full_fp32()
        train_probe(card_line())
        return 0
    from chip_smoke import card_line, cuda_ms, textured_frames
    from devc_tpu_torch.ops.layers import Conv2d
    from devc_tpu_torch.parallel.inference import (
        batched_frame_step,
        prepare_references_batched,
    )
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.pipeline.video import use_full_fp32
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    use_full_fp32()
    card = card_line()
    hw = (432, 768)
    models = PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), "cuda")
    frames = torch.from_numpy(np.stack(textured_frames(1, 4, hw))).cuda()
    refs = torch.from_numpy(np.stack(textured_frames(2, 4, hw))).cuda()
    real_conv = F.conv2d

    def contiguous(x, *args, **kw):
        return real_conv(x.contiguous(), *args, **kw)

    def channels_last(x, w, *args, **kw):
        cl = torch.channels_last
        return real_conv(x.contiguous(memory_format=cl),
                         w.contiguous(memory_format=cl), *args, **kw)

    def step(b):
        _, state = prepare_references_batched(models, refs[:b])
        last = torch.zeros((b, hw[0] // 2, hw[1] // 2, 3), device="cuda")
        return lambda: batched_frame_step(models, frames[:b], last, state)

    configs = (("whole_batch", real_conv, False, False),
               ("whole_batch_nchw_contiguous", contiguous, False, False),
               ("whole_batch_channels_last", channels_last, False, False),
               ("whole_batch_cudnn_benchmark", real_conv, True, False),
               ("one_sample_at_a_time", real_conv, False, True))
    for name, conv, bench, per_sample in configs:
        F.conv2d = conv
        torch.backends.cudnn.benchmark = bench
        Conv2d.per_sample = per_sample
        row = {"config": name, "card": card}
        outs = {}
        for b in (1, 4):
            run = step(b)
            torch.cuda.reset_peak_memory_stats()
            row[f"step_ms_b{b}"] = cuda_ms(run, reps=3, warmup=1)
            row[f"peak_mib_b{b}"] = torch.cuda.max_memory_allocated() / 2**20
            out, carry = run()
            outs[b] = (out[0].cpu().int(), carry[0].cpu())
        diff = (outs[4][0] - outs[1][0]).abs()
        row["b4_row0_vs_b1_u8_max"] = int(diff.max())
        row["b4_row0_vs_b1_u8_share"] = float((diff > 0).float().mean())
        row["b4_row0_vs_b1_carry_max"] = float(
            (outs[4][1] - outs[1][1]).abs().max())
        print(json.dumps(row), flush=True)
    F.conv2d = real_conv
    torch.backends.cudnn.benchmark = False

    from torch.profiler import ProfilerActivity, profile

    Conv2d.per_sample = False
    run = step(4)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    Conv2d.per_sample = True
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:5]
    print(json.dumps({"config": "whole_batch_b4_profile", "top_kernels": [
        {"name": e.key[:100], "calls": e.count,
         "device_ms": e.device_time_total / 1e3} for e in top],
        "card": card}), flush=True)
    train_probe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
