#!/usr/bin/env python3
"""How cuDNN runs the port's fp32 convolutions at batch > 1, on one GPU.

    python3 chip_conv_probe.py

The batched serving step (`parallel/inference.py::batched_frame_step`,
432x768, random weights, TF32 off) at batch 1 and 4, in five ways: the
batch whole with the models' layout, with NCHW-contiguous inputs, with
channels-last inputs and weights, with `torch.backends.cudnn.benchmark`,
and one sample at a time (`ops/layers.py::Conv2d`, the port's default
under inference). One JSON line each: ms per step (CUDA events, median
of 3, host launch cost included), peak memory, and how far batch 4's row
0 lies from batch 1 (uint8 output and carry); then the whole batch's
heaviest kernels under torch.profiler. Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_conv_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
