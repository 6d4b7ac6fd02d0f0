"""Train the colorization networks in PyTorch on one GPU (mirrors devc_tpu's
cli/train.py; reference train.py:39-79).

  python -m devc_tpu_torch.cli.train --data_root <video_pairs> \\
      --data_root_imagenet <imagenet_pairs> --checkpoint_dir ckpt/

The flags and defaults are devc_tpu's, apart from its mesh flags
(--platform, --n_model, --spmd_step), which --device replaces: one card
has no mesh. The step is train/loop.py's GAN step; batches come from
PrefetchLoader's threads, pinned, and are copied to the card without
blocking; the luminance noise comes from one torch.Generator seeded with
--seed. Checkpoints are torch.save files (train/checkpoint.py), which
devc_tpu's orbax directories cannot read, nor the other way round.

--resume restores the latest checkpoint's step, weights and optimizer
states, and continues counting from there; the loader and the noise
start again from step 0 of --seed, as in devc_tpu (so a resumed run
does not repeat the batches an uninterrupted one would have seen).
run_metadata.json records the VGG the run trains against
(`torch:<file>`, or `random:seed1` for the seed-1 host draw used when
--vgg_ckpt is missing); --resume refuses another unless
--allow_vgg_mismatch, and cli.colorize / cli.serve / cli.export read it.

The loop times its wait for the next batch apart from the step: the
summary at the end gives the share of wall time spent waiting on the
loader.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", type=str, default=None,
                   help="video-pairs dataset root")
    p.add_argument("--data_root_imagenet", type=str, default=None,
                   help="imagenet-pairs dataset root")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, nargs=2, default=[216, 384])
    p.add_argument("--ic", type=int, default=7)
    p.add_argument("--epoch", type=int, default=40)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--allow_vgg_mismatch", action="store_true",
                   help="let --resume continue with a different VGG "
                        "provenance than the checkpoint records")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints/default")
    p.add_argument("--checkpoint_step", type=int, default=2000)
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--tb_log_step", type=int, default=50)
    p.add_argument("--print_step", type=int, default=2)
    p.add_argument("--lr_step", type=int, default=100000)
    p.add_argument("--lr_gamma", type=float, default=0.1)
    p.add_argument("--real_reference_probability", type=float, default=0.7)
    p.add_argument("--nonzero_placeholder_probability", type=float, default=0.0)
    p.add_argument("--with_bad", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--with_mid", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--weight_l1", type=float, default=2.0)
    p.add_argument("--weight_contextual", type=float, default=0.2)
    p.add_argument("--weight_perceptual", type=float, default=0.001)
    p.add_argument("--weight_smoothness", type=float, default=5.0)
    p.add_argument("--weight_gan", type=float, default=0.2)
    p.add_argument("--weight_nonlocal_smoothness", type=float, default=0.0)
    p.add_argument("--weight_consistent", type=float, default=0.02)
    p.add_argument("--weight_nonlocal_consistent", type=float, default=0.0)
    p.add_argument("--luminance_noise", type=float, default=2.0)
    # BooleanOptionalAction so --no-permute_data works (the reference's
    # `type=bool` flags are truthy for any string)
    p.add_argument("--permute_data", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--domain_invariant", action="store_true")
    p.add_argument("--contextual_loss_direction", type=str, default="forward")
    p.add_argument("--vgg_ckpt", type=str, default="data/vgg19_conv.pth")
    p.add_argument("--load_pretrained_model", type=str, nargs=2, default=None,
                   metavar=("WARPNET_PTH", "COLORNET_PTH"))
    p.add_argument("--device_preprocess", action="store_true",
                   help="loader ships uint8 RGB + fp16 flows; the Lab "
                        "conversion, jitter and placeholder run on the "
                        "device in the train step (less host work and "
                        "transfer; fp16 flow quantization moves the "
                        "consistency loss's warp targets by <= 0.5 px at "
                        "several-hundred-px flows; sentinels are clamped "
                        "before the cast)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' fails when no GPU is present")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from devc_tpu_torch.data.videoloader import (
        ImageNetPairsDataset,
        PrefetchLoader,
        VideoPairsDataset,
    )
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_run_metadata,
        save_run_metadata,
    )
    from devc_tpu_torch.train.state import create_train_state
    from devc_tpu_torch.utils.convert import (
        checked_device,
        frozen_vgg_from_state_dict,
        vgg19_state_dict,
    )
    from devc_tpu_torch.utils.init import RANDOM_VGG_SOURCE, host_train_vgg_init
    from devc_tpu_torch.utils.logging import (
        AsyncImageLogger,
        MetricsLogger,
        dump_options,
        render_lab_grids,
    )
    from devc_tpu_torch.utils.profiling import StepTimer

    device = checked_device(args.device)
    print("options:", vars(args))
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    dump_options(args, os.path.join(args.checkpoint_dir, "opt.txt"))

    # ---- data ----
    datasets = []
    if args.data_root:
        datasets.append(VideoPairsDataset(
            args.data_root, image_size=args.image_size,
            real_reference_probability=args.real_reference_probability,
            nonzero_placeholder_probability=args.nonzero_placeholder_probability,
            device_preprocess=args.device_preprocess))
    if args.data_root_imagenet:
        datasets.append(ImageNetPairsDataset(
            args.data_root_imagenet, image_size=args.image_size,
            with_bad=args.with_bad, with_mid=args.with_mid,
            real_reference_probability=args.real_reference_probability,
            nonzero_placeholder_probability=args.nonzero_placeholder_probability,
            device_preprocess=args.device_preprocess))
    if not datasets:
        raise SystemExit("need --data_root and/or --data_root_imagenet")
    total = sum(len(d) for d in datasets)
    steps = args.max_steps or (total * args.epoch) // args.batch_size
    loader = PrefetchLoader(datasets, args.batch_size, steps,
                            workers=args.workers, seed=args.seed)
    print(f"dataset: {total} pairs, {steps} steps")

    # ---- weights / state ----
    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    if os.path.exists(args.vgg_ckpt):
        vgg_sd = load(args.vgg_ckpt)
        vgg_source = f"torch:{os.path.basename(args.vgg_ckpt)}"
    else:
        print(f"WARNING: {args.vgg_ckpt} missing; random VGG weights")
        vgg_sd = vgg19_state_dict(host_train_vgg_init())
        vgg_source = RANDOM_VGG_SOURCE
    vgg = frozen_vgg_from_state_dict(vgg_sd, device)

    warm_w = warm_c = None
    if args.load_pretrained_model:
        warm_w, warm_c = (load(p) for p in args.load_pretrained_model)
    state, tx_g, tx_d = create_train_state(
        args.seed, warm_w, warm_c, in_ch=args.ic, device=device,
        lr_step=args.lr_step, lr_gamma=args.lr_gamma)

    ckpt = CheckpointManager(args.checkpoint_dir,
                             save_interval_steps=args.checkpoint_step)
    # inference (cli.colorize --train_ckpt) reads this to refuse a
    # mismatched feature extractor instead of silently degrading.
    # On --resume the EXISTING metadata is authoritative: resuming a run
    # trained against torch VGG on a host where --vgg_ckpt is missing must
    # abort, not silently continue with the seed-1 random VGG and rewrite
    # the recorded provenance.
    resuming = args.resume and ckpt.latest_step() is not None
    if resuming:
        prev_meta = load_run_metadata(args.checkpoint_dir)
        prev_vgg = (prev_meta or {}).get("vgg_source")
        if prev_vgg is not None and prev_vgg != vgg_source:
            if not args.allow_vgg_mismatch:
                raise SystemExit(
                    f"--resume: checkpoint was trained with vgg_source="
                    f"{prev_vgg!r} but this run would use {vgg_source!r}. "
                    f"Provide the matching --vgg_ckpt, or pass "
                    f"--allow_vgg_mismatch to override (this rewrites the "
                    f"recorded provenance)."
                )
            save_run_metadata(args.checkpoint_dir, {"vgg_source": vgg_source})
        elif prev_meta is None:
            save_run_metadata(args.checkpoint_dir, {"vgg_source": vgg_source})
        state = ckpt.restore(state)
        print(f"resumed at step {int(state.step)}")
    else:
        save_run_metadata(args.checkpoint_dir, {"vgg_source": vgg_source})

    cfg = loop.TrainConfig(
        weight_l1=args.weight_l1,
        weight_gan=args.weight_gan,
        weight_perceptual=args.weight_perceptual,
        weight_contextual=args.weight_contextual,
        weight_smoothness=args.weight_smoothness,
        weight_nonlocal_smoothness=args.weight_nonlocal_smoothness,
        weight_consistent=args.weight_consistent,
        weight_nonlocal_consistent=args.weight_nonlocal_consistent,
        luminance_noise=args.luminance_noise,
        permute_data=args.permute_data,
        domain_invariant=args.domain_invariant,
        contextual_direction=args.contextual_loss_direction,
    )
    step_fn = loop.make_train_step(tx_g, tx_d, vgg, cfg,
                                   device_preprocess=args.device_preprocess)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    logger = MetricsLogger(args.log_dir)
    if args.device_preprocess:
        # the logged uint8 batch goes to Lab in the logger's thread (with
        # the brightness jitter), never in the train loop
        from devc_tpu_torch.data.transforms import lab_to_network, rgb_to_lab_np

        def _render_u8(tensors):
            cur = np.stack([lab_to_network(rgb_to_lab_np(x))
                            for x in tensors["current_rgb"][:8]])
            cur[..., 0] += tensors["jitter"][:8, 0][:, None, None]
            ref = np.stack([lab_to_network(rgb_to_lab_np(x))
                            for x in tensors["ref_rgb"][:8]])
            return render_lab_grids({"current_gt": cur, "reference": ref})

        img_logger = AsyncImageLogger(logger, _render_u8)
    else:
        img_logger = AsyncImageLogger(logger, render_lab_grids)

    def to_device(v):
        t = torch.from_numpy(v)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    timer, wait_timer = StepTimer(), StepTimer()
    step_s, wait_s = [], []
    first_step = state.step
    t_start = time.perf_counter()
    batches = iter(loader)
    while True:
        wait_timer.tic()
        batch_np = next(batches, None)
        if batch_np is None:
            break
        wait_s.append(wait_timer.toc())
        timer.tic()
        batch = {k: to_device(v) for k, v in batch_np.items()}
        state, metrics = step_fn(state, batch, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step = int(state.step)
        step_s.append(timer.toc())

        if step % args.print_step == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step}/{first_step + steps} "
                  f"({step_s[-1] * 1e3:.0f} ms/step, loader wait "
                  f"{wait_s[-1] * 1e3:.0f} ms) total={m['total_loss']:.3f} "
                  f"l1={m['l1_loss']:.3f} gan={m['generator_loss']:.3f}")
            logger.log_scalars(step, m)
        if step % args.tb_log_step == 0:
            # host numpy copies only: the thread never sees the step's
            # tensors
            if args.device_preprocess:
                img_logger.put(step, {k: batch_np[k].copy() for k in
                                      ("current_rgb", "ref_rgb", "jitter")})
            else:
                img_logger.put(step, {
                    "current_gt": batch_np["current_lab"].copy(),
                    "reference": batch_np["ref_lab"].copy()})
        ckpt.save(step, state)
    wall = time.perf_counter() - t_start

    if ckpt.latest_step() != int(state.step):
        ckpt.save(int(state.step), state, force=True)
    img_logger.close()
    logger.close()
    summary = {
        "steps": len(step_s), "first_step": first_step + 1,
        "last_step": int(state.step), "wall_s": wall,
        "step_s": step_s, "loader_wait_s": wait_s,
        "step_ms_ema": None if timer.avg is None else timer.avg * 1e3,
        "loader_wait_share": sum(wait_s) / wall if wall > 0 else 0.0,
        "device": str(device)}
    print(f"loader wait {sum(wait_s):.2f} s of {wall:.2f} s wall "
          f"({summary['loader_wait_share']:.1%})")
    print(json.dumps({"train_summary": {k: v for k, v in summary.items()
                                        if k not in ("step_s",
                                                     "loader_wait_s")}}))
    print("training done")
    return summary


if __name__ == "__main__":
    main()
