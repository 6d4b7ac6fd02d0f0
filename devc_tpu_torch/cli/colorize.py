"""Colourise a clip (a folder of frames or a video file) with one or more
exemplar images, in PyTorch.

  python -m devc_tpu_torch.cli.colorize --clip_path clips/v32 \\
      --ref_path ref/v32/01.jpg --output_path out/ \\
      --vgg_ckpt data/vgg19_conv.pth \\
      --warpnet_ckpt checkpoints/.../nonlocal_net_iter_76000.pth \\
      --colornet_ckpt checkpoints/.../colornet_iter_76000.pth

--random_init runs the whole pipeline with seeded random weights (the
same weights as `python -m cli.colorize --random_init --seed s`);
--train_ckpt runs a checkpoint of `python -m devc_tpu_torch.cli.train`
with the VGG its run trained against (refusing a mismatch). A
directory --ref_path colourises the clip against all its exemplars in one
batched pass (`colorize_video_multi`; a corrupt exemplar is dropped with a
warning), or one after the other with --serial_refs. --mode scan replays a
captured CUDA graph per frame; --device_resize moves the CenterPad onto
the device. Any other failure exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _training_vgg(args) -> dict:
    """The VGG state dict for a cli.train checkpoint (--train_ckpt),
    resolved as cli.train resolved it: --vgg_ckpt's file where it exists,
    else the seed-1 host draw cli.train falls back to. The run's
    run_metadata.json says which one it trained against; a mismatch
    either way is refused (devc_tpu's cli/colorize.py:39-70)."""
    import torch

    from devc_tpu_torch.train.checkpoint import load_run_metadata
    from devc_tpu_torch.utils.convert import vgg19_state_dict
    from devc_tpu_torch.utils.init import RANDOM_VGG_SOURCE, host_train_vgg_init

    trained_vgg = (load_run_metadata(args.train_ckpt) or {}).get(
        "vgg_source")  # None for a checkpoint without metadata
    if os.path.exists(args.vgg_ckpt):
        if trained_vgg == RANDOM_VGG_SOURCE:
            raise SystemExit(
                f"{args.train_ckpt} was trained with the seed-1 random "
                f"VGG but {args.vgg_ckpt} exists here — inference with "
                "torch VGG weights would mismatch the trained features. "
                "Point --vgg_ckpt at a nonexistent path to use the "
                "random extractor the run trained against."
            )
        return torch.load(args.vgg_ckpt, map_location="cpu",
                          weights_only=True)
    if (trained_vgg and trained_vgg.startswith("torch:")
            and not getattr(args, "allow_random_vgg", False)):
        raise SystemExit(
            f"{args.train_ckpt} was trained against torch VGG "
            f"weights ({trained_vgg}) but {args.vgg_ckpt} is "
            "missing — the random-VGG fallback would silently "
            "produce wrong colorizations. Provide --vgg_ckpt or "
            "pass --allow_random_vgg to override."
        )
    print(f"WARNING: {args.vgg_ckpt} missing; using the seed-1 random VGG "
          "(matches cli.train's fallback)", file=sys.stderr)
    return vgg19_state_dict(host_train_vgg_init())


def build_models(args):
    """PipelineModels on args.device: a training checkpoint's generator
    (--train_ckpt) with the VGG its run trained against (`_training_vgg`),
    seeded random weights (--random_init), or the reference's three .pth
    files."""
    import torch

    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    if getattr(args, "train_ckpt", None):
        from devc_tpu_torch.train.checkpoint import load_train_params_g

        sds = load_train_params_g(args.train_ckpt, args.train_ckpt_step)
        sds["vgg"] = _training_vgg(args)
    elif args.random_init:
        sds = state_dicts_from_numpy(host_pipeline_params(args.seed))
    else:
        sds = {name: load(path) for name, path in (
            ("vgg", args.vgg_ckpt), ("warpnet", args.warpnet_ckpt),
            ("colorvid", args.colornet_ckpt))}
    return PipelineModels.from_state_dicts(sds, args.device)


def add_model_args(p) -> None:
    """The weight and device options cli.colorize and cli.serve share."""
    p.add_argument("--temperature", type=float, default=1e-10)
    p.add_argument("--vgg_ckpt", type=str, default="data/vgg19_conv.pth")
    p.add_argument("--warpnet_ckpt", type=str,
                   default="checkpoints/video_moredata_l1/nonlocal_net_iter_76000.pth")
    p.add_argument("--colornet_ckpt", type=str,
                   default="checkpoints/video_moredata_l1/colornet_iter_76000.pth")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' fails when no GPU is present")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--clip_path", type=str, required=True,
                   help="directory of frames, or a video file")
    p.add_argument("--ref_path", type=str, required=True,
                   help="directory of reference images, or a single image")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--image_size", type=int, nargs=2, default=[432, 768],
                   metavar=("H", "W"))
    p.add_argument("--frame_propagate", action="store_true",
                   help="use the first frame as the reference")
    p.add_argument("--no_wls", action="store_true",
                   help="disable edge-aware post smoothing")
    add_model_args(p)
    p.add_argument("--no_video", action="store_true")
    p.add_argument("--serial_refs", action="store_true",
                   help="colourise with the reference images one at a time "
                        "(the reference's behaviour) instead of as one "
                        "batch on the device")
    p.add_argument("--mode", type=str, default="stream",
                   choices=["stream", "scan"],
                   help="stream: one device step per frame; scan: chunks "
                        "of frames, each frame a replay of one captured "
                        "CUDA graph on the card")
    p.add_argument("--chunk", type=int, default=64,
                   help="frames per host hand-off (mode scan)")
    p.add_argument("--train_ckpt", type=str, default=None,
                   help="colorize with a cli.train checkpoint directory "
                        "(overrides the .pth checkpoint flags)")
    p.add_argument("--allow_random_vgg", action="store_true",
                   help="with --train_ckpt: permit the seed-1 random VGG "
                        "even though the checkpoint records training "
                        "against torch VGG weights")
    p.add_argument("--train_ckpt_step", type=int, default=None,
                   help="checkpoint step to load (default: latest)")
    p.add_argument("--device_resize", action="store_true",
                   help="run the CenterPad resize on the device as two "
                        "matrix products (the host only decodes; one "
                        "resolution per clip; <= 1 uint8 step off the host "
                        "path)")
    args = p.parse_args(argv)

    h, w = args.image_size
    if h % 16 or w % 32:
        p.error(
            f"--image_size {h} {w}: H must be a multiple of 16 and W a "
            "multiple of 32 (the reference default is 432 768)"
        )
    from devc_tpu_torch.data.transforms import VIDEO_EXTS, is_video_file

    clip_is_video = is_video_file(args.clip_path)
    if not (os.path.isdir(args.clip_path) or clip_is_video):
        p.error(f"--clip_path {args.clip_path}: not a directory or a video "
                f"file ({'/'.join(VIDEO_EXTS)})")
    if not os.path.exists(args.ref_path):
        p.error(f"--ref_path {args.ref_path}: does not exist")
    if args.chunk < 1:
        p.error(f"--chunk {args.chunk}: must be >= 1")

    from devc_tpu_torch.pipeline.video import (
        colorize_video,
        colorize_video_multi,
    )

    models = build_models(args)
    clip_name = os.path.basename(os.path.normpath(args.clip_path))
    if clip_is_video:  # the container's extension is not part of the name
        clip_name = os.path.splitext(clip_name)[0]
    if os.path.isdir(args.ref_path):
        refs = [os.path.join(args.ref_path, r)
                for r in sorted(os.listdir(args.ref_path))]
    else:
        refs = [args.ref_path]
    out_dirs = [os.path.join(
        args.output_path,
        f"{clip_name}_{os.path.splitext(os.path.basename(r))[0]}")
        for r in refs]
    common = dict(image_size=(h, w), temperature=args.temperature,
                  wls=not args.no_wls, write_video=not args.no_video,
                  mode=args.mode, chunk=args.chunk,
                  device_resize=args.device_resize)

    if len(refs) > 1 and not args.serial_refs and not args.frame_propagate:
        print(f"colorizing {args.clip_path} against {len(refs)} exemplars "
              f"(batched) -> {args.output_path}")
        t0 = time.perf_counter()
        written = colorize_video_multi(models, args.clip_path, refs,
                                       out_dirs, **common)
        dt = time.perf_counter() - t0
        n = sum(len(w) for w in written)
        print(f"  {n} frames in {dt:.1f}s ({n / dt:.2f} fps incl. set-up) "
              f"on {args.device}")
        return

    for ref, out_dir in zip(refs, out_dirs):
        print(f"colorizing {args.clip_path} with exemplar {ref} -> {out_dir}")
        t0 = time.perf_counter()
        written = colorize_video(
            models, args.clip_path, ref, out_dir,
            frame_propagate=args.frame_propagate, **common)
        dt = time.perf_counter() - t0
        print(f"  {len(written)} frames in {dt:.1f}s "
              f"({len(written) / dt:.2f} fps incl. set-up) on {args.device}")


if __name__ == "__main__":
    main()
