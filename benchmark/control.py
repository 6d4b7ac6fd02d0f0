"""The control of each cell's comparison: the reference put in the
program's place, computed in the nearest precision below the
configuration's (TF32 for fp32 with TF32 off), judged by the same rule as
a run, against the same judge (TF32 off, convolutions in float64). It has
to come out as not correct; its readings set the upper end of each limit
(PERF.md). For a training cell, the planted fault "half of
the batch left out, the mean taken over the rest" is read beside it.

    python3 -m benchmark.control --workload stream432 --seeds 1 2 3 \
        --frames 480
    python3 -m benchmark.control --workload serve432-b4 --seeds 1 2 3 \
        --frames 480
    python3 -m benchmark.control --workload train-b16 --seeds 1 2 3

runs it on the card and prints one JSON line per seed. The benchmark's
own runs never run it; benchmark/tests/test_bench_control.py does."""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def control_numbers(cell_name: str, seed: int, n_frames: int,
                    device: str = "cuda", tf32: bool = True,
                    root: str | None = None,
                    bench_dir: str | None = None) -> dict:
    """The reference as the program (TF32 on when tf32; else the judge's
    own reference, convolutions in float64) over the cell's first n_frames
    frames, teacher-forcing nothing: its own carry runs on. The frames the
    cell's sample rule picks are judged as a run's."""
    from benchmark import harness, scenes, weights
    from benchmark.drivers.clip import _Recorder, judge
    from benchmark.reference import infer

    run = harness.load_run(cell_name, seed, 0.0, False, device,
                           root or harness.ROOT,
                           bench_dir or harness.BENCH_DIR)
    cfg, trf = run.config, run.traffic
    dev = torch.device(device)
    h, w = cfg["image_size"]
    frames = scenes.panned_clip(seed, (h, w), trf["distinct_frames"],
                                trf["pan_px"])
    ref_rgb = scenes.exemplar(seed, (h, w))
    rec = _Recorder(trf["sample_every"], int(scenes.rng_for(seed, 2).integers(
        trf["sample_every"])))
    rec.phase = "window"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        models = infer.Models.from_state_dicts(
            weights.pipeline_state_dicts(seed, dev), dev,
            float64_convolutions=not tf32)
        with torch.no_grad():
            state = infer.prepare_reference(
                models, torch.from_numpy(ref_rgb)[None].to(dev))
            carry = torch.zeros((1, h // 2, w // 2, 3), device=dev)
            for i in range(n_frames):
                frame = torch.from_numpy(frames[i % len(frames)])[None]
                out, new = infer.step(models, frame.to(dev), carry, state,
                                      cfg["temperature"], cfg["wls"])
                if rec.sampled(i):
                    rec.samples[i] = (carry.cpu(), out[0].cpu(), new.cpu())
                carry = new
        del models, state
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    numbers = judge(run, rec.samples, frames, ref_rgb, dev)
    numbers["sampled_frames"] = len(rec.samples)
    return numbers


def serve_control_numbers(cell_name: str, seed: int, n_frames: int,
                          device: str = "cuda", tf32: bool = True,
                          root: str | None = None,
                          bench_dir: str | None = None) -> dict:
    """For a serving cell: the reference as the program (TF32 on when
    tf32; else the judge's own) over the backlog's jobs in order, each
    from the zero carry, until n_frames frames; the frames the cell's sample rule picks are
    judged as a run's (its written files aside: the control writes
    none)."""
    import shutil
    import tempfile

    from benchmark import compare, harness, scenes, weights
    from benchmark.drivers.serve import read_rgb, reference_outputs
    from benchmark.reference import infer

    run = harness.load_run(cell_name, seed, 0.0, False, device,
                           root or harness.ROOT,
                           bench_dir or harness.BENCH_DIR)
    cfg, trf = run.config, run.traffic
    dev = torch.device(device)
    h, w = cfg["image_size"]
    every = trf["sample_every"]
    offset = int(scenes.rng_for(seed, 2).integers(every))
    tmp = tempfile.mkdtemp(prefix="devc-bench-control-")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        jobs = scenes.write_serve_jobs(tmp, seed, (h, w), trf)["backlog"]
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        models = infer.Models.from_state_dicts(
            weights.pipeline_state_dicts(seed, dev), dev,
            float64_convolutions=not tf32)
        samples, done = {}, 0
        with torch.no_grad():
            for j, job in enumerate(jobs):
                if done >= n_frames:
                    break
                ref = torch.from_numpy(read_rgb(job["ref"]))[None].to(dev)
                state = infer.prepare_reference(models, ref)
                carry = torch.zeros((1, h // 2, w // 2, 3), device=dev)
                for f, path in enumerate(job["frames"][:n_frames - done]):
                    frame = torch.from_numpy(read_rgb(path))[None].to(dev)
                    out, new = infer.step(models, frame, carry, state,
                                          cfg["temperature"], cfg["wls"])
                    if f == 0 or (f + offset) % every == 0:
                        samples[(j, f)] = (carry.cpu(), out[0].cpu(),
                                           new.cpu())
                    carry = new
                    done += 1
        del models, state
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
        ref_out = reference_outputs(run, samples, jobs, dev)
        pairs = [(s[1].to(dev), ref_out[k][0], s[2].to(dev), ref_out[k][1])
                 for k, s in sorted(samples.items())]
        numbers = compare.clip_numbers(pairs)
        numbers["sampled_frames"] = len(samples)
        return numbers
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
        shutil.rmtree(tmp, ignore_errors=True)


def train_control_numbers(cell_name: str, seed: int, device: str = "cuda",
                          root: str | None = None,
                          bench_dir: str | None = None) -> dict:
    """For a training cell: the reference in TF32 ("control"), the
    reference on the first half of every batch ("half_batch") and the
    reference run again ("itself": the floor that run-to-run order of
    summation sets), each against the reference in fp32, by
    compare.train_numbers."""
    from benchmark import compare, harness
    from benchmark.drivers.train import reference_steps

    run = harness.load_run(cell_name, seed, 0.0, False, device,
                           root or harness.ROOT,
                           bench_dir or harness.BENCH_DIR)
    cfg = run.config
    dev = torch.device(device)
    ref = reference_steps(run, dev)
    out = {"control": compare.train_numbers(
        reference_steps(run, dev, tf32=True), ref)}
    out["half_batch"] = compare.train_numbers(
        reference_steps(run, dev, rows=slice(0, cfg["batch_size"] // 2)),
        ref)
    out["itself"] = compare.train_numbers(reference_steps(run, dev), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=480)
    p.add_argument("--itself", action="store_true",
                   help="the judge's own reference (TF32 off, convolutions "
                        "in float64) in the program's place (a check of "
                        "the comparison: every number 0)")
    args = p.parse_args(argv)
    from benchmark import harness

    harness.set_cache_dirs()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        driver = harness.load_run(args.workload, seed, 0.0, False,
                                  "cuda").traffic["driver"]
        if driver == "train":
            numbers = train_control_numbers(args.workload, seed)
        elif driver == "serve":
            numbers = serve_control_numbers(args.workload, seed, args.frames,
                                            tf32=not args.itself)
        else:
            numbers = control_numbers(args.workload, seed, args.frames,
                                      tf32=not args.itself)
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "tf32": not args.itself, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
