"""Colorization service in PyTorch: weights loaded once, the kernels built
and one step run at start-up, jobs submitted as JSON lines.

  python -m devc_tpu_torch.cli.serve --random_init --image_size 432 768 \\
      [--device cpu]

Protocol (stdin -> stdout, one JSON object per line), devc_tpu's
(cli/serve.py):

  {"clip_path": "...", "ref_path": "...", "output_path": "...",
   "frame_propagate": false, "wls": true,
   "mode": "stream"|"scan", "chunk": 64,
   "device_resize": false,
   "split_embed": null}                            # a job; clip_path is a
                                                   # frame folder or a video
                                                   # file; split_embed is
                                                   # accepted and ignored (a
                                                   # TPU compiler workaround
                                                   # the port has no use for)
  {"cmd": "batch", "slots": 4, "device_resize": false,
   "jobs": [{"clip_path": ..., "ref_path": ..., "output_path": ...}, ...]}
                                                   # many clips batched on
                                                   # the device
                                                   # (ClipBatchScheduler);
                                                   # folders and videos,
                                                   # mixed resolutions
  {"cmd": "ping"}                                  # liveness probe
  {"cmd": "shutdown"}                              # exit

Responses:
  {"ready": true, "warmup_seconds": S}             # first line, once
  {"ok": true, "frames": N, "seconds": S, "fps": F, "outputs": [...]}
  {"ok": true, "seconds": S, "results": [...]}     # batch
  {"ok": true, "pong": true} / {"ok": true, "bye": true}
  {"ok": false, "error": "..."}

A long-lived process is the intended deployment shape: the weights and the
built kernels stay loaded, and the start-up warm-up (the kernels' build
and one frame step on --image_size) keeps the first job from paying for
them. --device defaults to cuda and fails without a GPU. Only protocol
lines go to stdout; warnings go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _short(outputs):
    return outputs[:3] + (["..."] if len(outputs) > 3 else [])


def _batch(models, job, image_size, temperature):
    from devc_tpu_torch.pipeline.scheduler import ClipBatchScheduler

    t0 = time.time()
    sched = ClipBatchScheduler(
        models, image_size=image_size, slots=int(job.get("slots", 4)),
        temperature=temperature, wls=bool(job.get("wls", True)),
        device_resize=bool(job.get("device_resize", False)))
    for j in job["jobs"]:
        sched.submit(j["clip_path"], j["ref_path"], j["output_path"])
    results = sched.run()
    for r in results:
        if r and "outputs" in r:
            r["outputs"] = _short(r["outputs"])
    return {"ok": True, "seconds": round(time.time() - t0, 2),
            "results": results}


def _job(models, job, image_size, temperature):
    from devc_tpu_torch.pipeline.video import colorize_video

    t0 = time.time()
    written = colorize_video(
        models, job["clip_path"], job["ref_path"], job["output_path"],
        image_size=image_size, temperature=temperature,
        wls=bool(job.get("wls", True)),
        frame_propagate=bool(job.get("frame_propagate", False)),
        write_video=bool(job.get("write_video", False)),
        mode=job.get("mode", "stream"), chunk=int(job.get("chunk", 64)),
        device_resize=bool(job.get("device_resize", False)))
    dt = time.time() - t0
    return {"ok": True, "frames": len(written), "seconds": round(dt, 2),
            "fps": round(len(written) / dt, 2), "outputs": _short(written)}


def main(argv=None):
    from devc_tpu_torch.cli.colorize import add_model_args, build_models

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_size", type=int, nargs=2, default=[432, 768],
                   metavar=("H", "W"))
    add_model_args(p)
    p.add_argument("--train_ckpt", type=str, default=None,
                   help="serve the generator of a training checkpoint "
                        "directory (train/checkpoint.py) with the VGG its "
                        "run trained against, as cli.colorize does")
    p.add_argument("--train_ckpt_step", type=int, default=None,
                   help="checkpoint step to load (default: the latest)")
    p.add_argument("--no_warmup", action="store_true")
    args = p.parse_args(argv)
    h, w = args.image_size
    if h % 16 or w % 32:
        p.error(f"--image_size {h} {w}: H must be a multiple of 16 and W a "
                "multiple of 32 (the reference default is 432 768)")

    import torch

    from devc_tpu_torch.pipeline.video import _device_ref_features, frame_step

    models = build_models(args)
    t0 = time.time()
    if not args.no_warmup:
        dummy = torch.zeros((h, w, 3), dtype=torch.uint8,
                            device=models.device)
        ref_lab_small, ref_state = _device_ref_features(models, dummy)
        out, _ = frame_step(models, dummy, torch.zeros_like(ref_lab_small),
                            ref_state, args.temperature)
        out.cpu()  # waits for the step
    print(json.dumps({"ready": True,
                      "warmup_seconds": round(time.time() - t0, 1)}),
          flush=True)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"ok": False, "error": f"bad json: {e}"}),
                  flush=True)
            continue
        cmd = job.get("cmd") if isinstance(job, dict) else None
        if cmd == "shutdown":
            print(json.dumps({"ok": True, "bye": True}), flush=True)
            return
        if cmd == "ping":
            print(json.dumps({"ok": True, "pong": True}), flush=True)
            continue
        try:
            if not isinstance(job, dict):
                raise ValueError("a request is a JSON object")
            run = _batch if cmd == "batch" else _job
            resp = run(models, job, (h, w), args.temperature)
        except Exception as e:  # the job fails; the server stays up
            resp = {"ok": False, "error": str(e)}
        print(json.dumps(resp), flush=True)


if __name__ == "__main__":
    main()
