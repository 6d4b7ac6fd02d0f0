"""Train the colorization networks in PyTorch on one GPU or data-parallel
over several ranks (mirrors devc_tpu's cli/train.py; reference
train.py:39-79).

  python -m devc_tpu_torch.cli.train --data_root <video_pairs> \\
      --data_root_imagenet <imagenet_pairs> --checkpoint_dir ckpt/
  torchrun --nproc_per_node 2 -m devc_tpu_torch.cli.train ... (2 ranks)

The flags and defaults are devc_tpu's; --device (cuda or cpu) takes the
place of its --platform. The step is train/loop.py's GAN step; batches
come from PrefetchLoader's threads, pinned, and are copied to the card
without blocking; the luminance noise comes from a torch.Generator seeded
from --seed and the rank's data index. Checkpoints are torch.save files
(train/checkpoint.py), which devc_tpu's orbax directories cannot read,
nor the other way round.

Under torchrun the ranks form devc_tpu's ("data", "model") mesh
(parallel/mesh.py): rank r computes on cuda:(r % device_count), over NCCL
when each rank has a card, gloo when ranks share one (or with --device
cpu). The data axis is the largest divisor of --batch_size that fits in
world // --n_model ranks, as in devc_tpu; ranks left over sit idle. Every
rank builds the same global batch from the same seeded loader and keeps
its block, so batches are those of a one-process run. --spmd_step: on
(auto with more than one rank) runs make_train_step_spmd, whose gradient
averages are one flat all_reduce per network; off keeps the same
collectives with one all_reduce per gradient tensor. Rank 0 alone writes
the options, run_metadata.json, the logs and the checkpoints; the others
wait for it at a barrier, and on --resume every rank restores the same
checkpoint.

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
    p.add_argument("--n_model", type=int, default=1,
                   help="size of the mesh's model axis (ranks per data "
                        "replica)")
    p.add_argument("--spmd_step", choices=("auto", "on", "off"),
                   default="auto",
                   help="over several ranks: on (auto) averages each "
                        "network's gradients with one flat all_reduce, "
                        "off with one all_reduce per gradient tensor")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from devc_tpu_torch.data.videoloader import (
        ImageNetPairsDataset,
        PrefetchLoader,
        VideoPairsDataset,
    )
    from devc_tpu_torch.ops import cuda_corr
    from devc_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        shard_batch,
        shard_params,
    )
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_run_metadata,
        save_run_metadata,
    )
    from devc_tpu_torch.train.state import create_train_state
    from devc_tpu_torch.utils.convert import (
        frozen_vgg_from_state_dict,
        use_full_fp32,
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

    # convolutions and matmuls in full fp32, as in inference (cuDNN's
    # default is TF32)
    use_full_fp32()
    owns_group = not dist.is_initialized()
    ctx = init_distributed(args.device)
    device = ctx.device
    # the data axis must divide the batch: the largest divisor that fits
    avail = max(1, ctx.world // args.n_model)
    n_data = max(d for d in range(1, min(avail, args.batch_size) + 1)
                 if args.batch_size % d == 0)
    mesh = make_mesh(n_data, args.n_model)
    writer = ctx.rank == 0
    if not mesh.member:
        print(f"rank {ctx.rank}: outside the {n_data} x {args.n_model} "
              "mesh, idle")
        if owns_group:
            dist.destroy_process_group()
        return None
    mesh_group = mesh.group("mesh")

    def barrier():
        if mesh_group is not None:
            dist.barrier(group=mesh_group)

    if writer:
        print("options:", vars(args))
        print(f"mesh: data={n_data}, model={args.n_model} "
              f"(world {ctx.world}, backend {ctx.backend})")
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        dump_options(args, os.path.join(args.checkpoint_dir, "opt.txt"))
    barrier()

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
    if writer:
        print(f"dataset: {total} pairs, {steps} steps")

    # ---- weights / state ----
    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    if os.path.exists(args.vgg_ckpt):
        vgg_sd = load(args.vgg_ckpt)
        vgg_source = f"torch:{os.path.basename(args.vgg_ckpt)}"
    else:
        if writer:
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
            rewrite_meta = True
        else:
            rewrite_meta = prev_meta is None
        state = ckpt.restore(state)
        if writer:
            print(f"resumed at step {int(state.step)}")
    else:
        rewrite_meta = True
    if writer and rewrite_meta:
        save_run_metadata(args.checkpoint_dir, {"vgg_source": vgg_source})
    # every rank starts from rank 0's weights (they are equal already:
    # the same seed or the same checkpoint)
    shard_params(mesh, [state.params_g, state.params_d, state.sn_state, vgg])
    barrier()

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
    if mesh.group("data") is None:
        step_fn = loop.make_train_step(
            tx_g, tx_d, vgg, cfg, device_preprocess=args.device_preprocess)
    else:
        # with a process group the step is the explicit-SPMD one, its
        # gradient averages bucketed unless --spmd_step off
        bucket = args.spmd_step != "off"
        step_fn = loop.make_train_step_spmd(
            mesh, tx_g, tx_d, vgg, cfg,
            device_preprocess=args.device_preprocess, bucket=bucket)
        if writer:
            print(f"spmd step: {'one all_reduce a network' if bucket else 'one all_reduce a tensor'}")
    generator = torch.Generator(device=device).manual_seed(
        loop.noise_seed(args.seed, mesh.index("data")))

    logger = MetricsLogger(args.log_dir) if writer else None
    if not writer:
        img_logger = None
    elif args.device_preprocess:
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

    launches = lambda: [cuda_corr.corr_fwd.launches,
                        cuda_corr.corr_bwd_dq.launches,
                        cuda_corr.corr_bwd_dkv.launches]
    launches_before = launches()
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
        batch = {k: to_device(v)
                 for k, v in shard_batch(mesh, batch_np).items()}
        state, metrics = step_fn(state, batch, generator)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step = int(state.step)
        step_s.append(timer.toc())
        if not writer:
            continue

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

    if writer:
        if ckpt.latest_step() != int(state.step):
            ckpt.save(int(state.step), state, force=True)
        img_logger.close()
        logger.close()
    barrier()  # the others wait for rank 0's last checkpoint
    summary = {
        "steps": len(step_s), "first_step": first_step + 1,
        "last_step": int(state.step), "wall_s": wall,
        "step_s": step_s, "loader_wait_s": wait_s,
        "step_ms_ema": None if timer.avg is None else timer.avg * 1e3,
        "loader_wait_share": sum(wait_s) / wall if wall > 0 else 0.0,
        "device": str(device), "rank": ctx.rank, "world": ctx.world,
        "backend": ctx.backend, "mesh": list(mesh.shape),
        "batch_per_rank": args.batch_size // n_data,
        "launches_corr_fwd_dq_dkv": [
            a - b for a, b in zip(launches(), launches_before)]}
    if writer:
        print(f"loader wait {sum(wait_s):.2f} s of {wall:.2f} s wall "
              f"({summary['loader_wait_share']:.1%})")
    print(json.dumps({"train_summary": {k: v for k, v in summary.items()
                                        if k not in ("step_s",
                                                     "loader_wait_s")}}))
    if writer:
        print("training done")
    if owns_group and dist.is_initialized():
        dist.destroy_process_group()
    return summary


if __name__ == "__main__":
    main()
