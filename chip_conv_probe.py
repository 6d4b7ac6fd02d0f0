#!/usr/bin/env python3
"""How cuDNN runs the port's fp32 convolutions at batch > 1, on one GPU.

    python3 chip_conv_probe.py            # inference, then training
    python3 chip_conv_probe.py --train    # training only
    python3 chip_conv_probe.py --split    # the split convolution per shape

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

The split convolution (`split_probe`, `--split`): every distinct
convolution shape of the three networks at 432x768, found by hooks on
`Conv2d` while an exemplar is prepared and one frame runs (the count a
frame and in the exemplar's preparation), then per shape at batch 1:
device ms (CUDA events, the card busy first, median of 10) of cuDNN's
fp32 call, of the split kernel (`ops/conv_split.py`) and, for the record,
of one cuDNN TF32 convolution of the split operands stacked on the
channels; the bound at 165 TFLOP/s (fp32-accurate work as three TF32
passes); whether the rule engages; the kernels each launches
(torch.profiler); and the largest distance from a float64 convolution
over max |x|*|w| of the fp32 call, the split kernel, the stacked cuDNN
call (the small products first, and the large one first) and TF32
alone. Then one frame step's device ms with the rule as it is and with
it off. One JSON line a shape and a summary; everything also goes to
chiprun_out/conv_probe_split.jsonl.

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


def _kernel_names(fn) -> list:
    """Names of the CUDA kernels fn() launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def network_conv_shapes(models, hw, seed: int = 3):
    """{(c_in, c_out, k, stride, padding, dilation, H, W): [a frame, in
    the exemplar's preparation]} of every `Conv2d` call while an exemplar
    is prepared and one frame runs at hw on the card."""
    import torch

    from chip_smoke import textured_frames
    from devc_tpu_torch.ops.layers import Conv2d
    from devc_tpu_torch.pipeline import video

    counts, phase = {}, [1]

    def hook(m, inputs, out):
        x = inputs[0]
        key = (m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0],
               m.padding[0], m.dilation[0], x.shape[2], x.shape[3])
        counts.setdefault(key, [0, 0])[phase[0]] += 1

    ref, frame = (torch.from_numpy(f).cuda()
                  for f in textured_frames(seed, 2, hw))
    hooks = [m.register_forward_hook(hook) for m in models.modules()
             if isinstance(m, Conv2d)]
    try:
        _, state = video._device_ref_features(models, ref)
        phase[0] = 0
        last = torch.zeros((1, hw[0] // 2, hw[1] // 2, 3), device="cuda")
        video.frame_step(models, frame, last, state)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return counts


def split_probe(card: str) -> None:
    """The split convolution per shape (see the module's docstring)."""
    import os

    import torch
    import torch.nn.functional as F

    from chip_smoke import cuda_ms, textured_frames
    from devc_tpu_torch.ops import conv_split
    from devc_tpu_torch.ops.layers import Conv2d
    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    os.makedirs("chiprun_out", exist_ok=True)
    log = open(os.path.join("chiprun_out", "conv_probe_split.jsonl"), "w")

    def emit(row):
        row["card"] = card
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")

    hw = (432, 768)
    models = PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), "cuda")
    shapes = network_conv_shapes(models, hw)
    gen = torch.Generator(device="cpu").manual_seed(0)
    totals = {"fp32_ms": 0.0, "cudnn_stacked_ms": 0.0, "chosen_ms": 0.0,
              "bound_ms": 0.0}
    with torch.inference_mode():
        for key, (per_frame, prep) in sorted(shapes.items()):
            cin, cout, k, stride, pad, dil, h, w = key
            x = torch.randn(1, cin, h, w, generator=gen).relu_().cuda()
            wt = (torch.randn(cout, cin, k, k, generator=gen)
                  * (2.0 / (cin * k * k)) ** 0.5).cuda()
            b = (torch.randn(cout, generator=gen) * 0.1).cuda()
            args = ((stride, stride), (pad, pad), (dil, dil))
            ws = conv_split.weight_split(wt)

            def plain():
                return F.conv2d(x, wt, b, *args)

            def split():
                return conv_split.split_conv2d(x, ws, b, stride, pad, dil, k)

            # for the record: one cuDNN TF32 convolution of the operands
            # stacked on the channels, the small products first or the
            # large one first (channels-last stacks), and TF32 alone
            wh, wl = conv_split.split_halves(wt)
            xh, xl = conv_split.split_halves(x)
            cl = torch.channels_last

            def stacked(xs, wss):
                xs = torch.cat(xs, dim=1).contiguous(memory_format=cl)
                wss = torch.cat(wss, dim=1).contiguous(memory_format=cl)
                return lambda: torch.cudnn_convolution(
                    xs, wss, args[1], args[0], args[2], 1, False, False,
                    True) + b.reshape(1, -1, 1, 1)

            small_first = stacked((xh, xl, xh), (wl, wh, wh))
            large_first = stacked((xh, xh, xl), (wh, wl, wh))

            def tf32_alone():
                return torch.cudnn_convolution(
                    x, wt, args[1], args[0], args[2], 1, False, False,
                    True) + b.reshape(1, -1, 1, 1)

            y64 = F.conv2d(x.double(), wt.double(), b.double(), *args)
            scale = F.conv2d(x.double().abs(), wt.double().abs(), None,
                             *args).amax().item()

            def err(fn):
                return (fn().double() - y64).abs().max().item() / scale

            out_hw = y64.shape[2:]
            flop = 2 * k * k * cin * cout * out_hw[0] * out_hw[1]
            engaged = conv_split.shape_rule(cin, cout, (k, k), (h, w))
            row = {
                "shape": {"c_in": cin, "c_out": cout, "k": k,
                          "stride": stride, "padding": pad, "dilation": dil,
                          "in_hw": [h, w], "out_hw": list(out_hw)},
                "per_frame": per_frame, "in_exemplar_prep": prep,
                "gflop": flop / 1e9,
                "bound_ms_165": flop / 165e12 * 1e3,
                "fp32_ms": cuda_ms(plain, queued=True),
                "engaged": engaged,
                "fp32_err": err(plain),
                "cudnn_stacked_ms": cuda_ms(small_first, queued=True),
                "cudnn_stacked_err": err(small_first),
                "cudnn_stacked_large_first_err": err(large_first),
                "tf32_alone_err": err(tf32_alone),
                "fp32_kernels": sorted(set(_kernel_names(plain))),
            }
            if cin % conv_split.ATOM == 0:
                row.update(split_ms=cuda_ms(split, queued=True),
                           split_err=err(split),
                           split_kernels=sorted(set(_kernel_names(split))))
            emit(row)
            totals["fp32_ms"] += per_frame * row["fp32_ms"]
            totals["cudnn_stacked_ms"] += per_frame * row["cudnn_stacked_ms"]
            totals["chosen_ms"] += per_frame * (
                row["split_ms"] if row["engaged"] else row["fp32_ms"])
            totals["bound_ms"] += per_frame * row["bound_ms_165"]

    # one frame step's device time, the rule as it is and switched off
    ref, frame = (torch.from_numpy(f).cuda()
                  for f in textured_frames(4, 2, hw))
    _, state = video._device_ref_features(models, ref)
    last = torch.zeros((1, hw[0] // 2, hw[1] // 2, 3), device="cuda")

    def step():
        return video.frame_step(models, frame, last, state)

    frame_ms = {}
    real_rule = conv_split.shape_rule
    for name in ("split", "plain", "plain", "split"):
        conv_split.shape_rule = (real_rule if name == "split"
                                 else lambda *a: False)
        before = (Conv2d.split_calls, Conv2d.plain_calls,
                  conv_split.split_conv2d.launches)
        step()
        calls = {"split_calls": Conv2d.split_calls - before[0],
                 "plain_calls": Conv2d.plain_calls - before[1],
                 "split_launches":
                     conv_split.split_conv2d.launches - before[2]}
        frame_ms.setdefault(name, []).append(
            cuda_ms(step, reps=10, queued=True, spin_cycles=60_000_000))
        frame_ms[name + "_calls"] = calls
    conv_split.shape_rule = real_rule

    # the host's cost of one call (the card kept busy, so that nothing
    # waits on it): Conv2d at 256 -> 256 channels, 54x96, split and plain
    import time

    conv = Conv2d(256, 256, 3, padding=1).cuda().requires_grad_(False)
    xs = torch.randn(1, 256, 54, 96, device="cuda")
    host_us = {}
    for name in ("split", "plain", "plain", "split"):
        conv_split.shape_rule = (real_rule if name == "split"
                                 else lambda *a: False)
        with torch.inference_mode():
            conv(xs)
            torch.cuda.synchronize()
            torch.cuda._sleep(400_000_000)
            t0 = time.perf_counter()
            for _ in range(200):
                conv(xs)
            host_us.setdefault(name, []).append(
                (time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    conv_split.shape_rule = real_rule
    emit({"config": "split_summary", "image_size": list(hw),
          "distinct_shapes": len(shapes),
          "convs_a_frame": sum(v[0] for v in shapes.values()),
          "convs_in_exemplar_prep": sum(v[1] for v in shapes.values()),
          "conv_ms_a_frame": totals, "frame_step_device_ms": frame_ms,
          "host_us_a_call_256x54x96": host_us})
    log.close()


def main(argv=None) -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_conv_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if "--split" in argv:
        from chip_smoke import card_line
        from devc_tpu_torch.utils.convert import use_full_fp32

        use_full_fp32()
        split_probe(card_line())
        return 0
    if "--train" in argv:
        from chip_smoke import card_line
        from devc_tpu_torch.utils.convert import use_full_fp32

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
    from devc_tpu_torch.utils.convert import use_full_fp32
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
