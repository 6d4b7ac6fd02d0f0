"""Driver of the training cells: the window drives the port's GAN step
(`devc_tpu_torch.train.loop.train_step_u8`, through `make_train_step` with
device preprocessing) fed by its `PrefetchLoader` over an ImageNet-pairs
tree of stills, as `cli.train --device_preprocess` runs it: wait for the
loader, copy the batch pinned and non-blocking, step, synchronise.

Set-up: the stills tree (seeded JPEGs under TMPDIR), the weights drawn on
the card and handed to the port as state dicts, the optimizers, and the
checked steps: the mix's `checked_steps` steps on batches the benchmark
draws from the seed (`scenes.train_batch_u8`, every row its own draw),
through the same call and the same copy as the window's, on the same
state object, which then goes on into the window. They are also the
warm-up (the kernel library, cuDNN's choices). Then `loader_warm_steps` of
the loader's own batches go through the step, so that its threads' first
burst of work (filling their prefetch) falls into set-up.

Correctness (the training rule of the benchmark's contract): each checked
step's losses, the norm of the first gradient as each optimizer got it
(from its first moment after step 1: mu = (1 - b1) g), and the norm of the
parameters' change over the checked steps, leaf by leaf, against the plain
reference (benchmark/reference/loop.py) run on the same weights, batches
and noise after the window, with the program freed
(compare.train_numbers). And the loader's side: one batch of the window,
drawn from the seed, against the reference's rebuild of it from the stills
tree and the loader's draws (benchmark/reference/stills.py,
compare.batch_numbers)."""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import threading
import time

import torch

from benchmark import harness, scenes, weights
from benchmark import trace as tr
from benchmark.probe import Probe


def _flat(modules) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float()
                      for m in modules for p in m.parameters()])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def noise_seed(seed: int) -> int:
    return int(scenes.rng_for(seed, 4).integers(1 << 62))


def checked_batches(run):
    cfg, trf = run.config, run.traffic
    return [scenes.train_batch_u8(run.seed, k, cfg["batch_size"],
                                  cfg["image_size"])
            for k in range(trf["checked_steps"])]


def drive_checked(step_fn, state, batches, feed, generator, device,
                  b1_g: float, b1_d: float) -> tuple:
    """Run the checked steps on `state`; returns (state, readings): the
    losses of each step, the first gradients (from the optimizers' first
    moments after step 1) and the parameters' change over the steps."""
    modules = (state.params_g, state.params_d)
    p0 = _flat(modules).cpu()
    losses, grads = [], None
    for k, batch in enumerate(batches):
        state, metrics = step_fn(state, {n: feed(v) for n, v in
                                         batch.items()}, generator)
        _sync(device)
        losses.append({n: float(metrics[n]) for n in
                       ("total_loss", "discriminator_loss")})
        if k == 0:
            grads = torch.cat([state.opt_state_g.mu / (1 - b1_g),
                               state.opt_state_d.mu / (1 - b1_d)]).cpu()
    delta = _flat(modules).cpu() - p0
    return state, {"losses": losses, "grads": grads, "delta": delta}


def run(run, entries) -> dict:
    from devc_tpu_torch.data.videoloader import (
        ImageNetPairsDataset,
        PrefetchLoader,
    )

    cfg, trf = run.config, run.traffic
    device = torch.device(run.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the config's fp32
    torch.backends.cudnn.allow_tf32 = False
    b, hw = cfg["batch_size"], cfg["image_size"]
    data_root = tempfile.mkdtemp(prefix="devc-bench-stills-")
    try:
        scenes.write_stills_tree(data_root, run.seed, trf["classes"],
                                 trf["per_class"], trf["still_h"],
                                 trf["still_w"])
        dataset = ImageNetPairsDataset(
            data_root, image_size=hw, device_preprocess=True,
            real_reference_probability=cfg["real_reference_probability"],
            nonzero_placeholder_probability=cfg[
                "nonzero_placeholder_probability"])
        loader = PrefetchLoader([dataset], b, trf["loader_steps"],
                                workers=trf["workers"],
                                seed=loader_seed(run.seed))
        outcome = _train(run, entries, loader, device, data_root)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    return outcome


def build_program(run, device):
    """The port's training step and its state from the run's seed, as
    cli.train builds them: (state, step_fn, generator, feed, (b1_g, b1_d))."""
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train.state import make_optimizers
    from devc_tpu_torch.utils import convert

    cfg = run.config
    sds = weights.train_state_dicts(run.seed, device,
                                    cfg["colorvidnet_in_channels"])
    tx_g, tx_d = make_optimizers(**cfg["optimizer"])
    state = convert.train_state_from_state_dicts(
        sds["warpnet"], sds["colorvid"], sds["critic"], tx_g, tx_d, device)
    vgg = convert.frozen_vgg_from_state_dict(sds["vgg"], device)
    step_fn = loop.make_train_step(tx_g, tx_d, vgg,
                                   loop.TrainConfig(**cfg["train_config"]),
                                   device_preprocess=True)
    generator = torch.Generator(device=device).manual_seed(
        noise_seed(run.seed))

    def feed(v):  # cli.train's copy: pinned, non-blocking
        t = torch.from_numpy(v)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return state, step_fn, generator, feed, (tx_g.b1, tx_d.b1)


def _train(run, entries, loader, device, data_root):
    trf = run.traffic
    cuda = device.type == "cuda"
    state, step_fn, generator, feed, b1 = build_program(run, device)
    probe = Probe(entries, run.traced, device)
    state, program = drive_checked(step_fn, state, checked_batches(run),
                                   feed, generator, device, *b1)
    batches = iter(loader)

    def one_step():
        nonlocal state
        batch_np = next(batches)
        batch = {k: feed(v) for k, v in batch_np.items()}
        state, _ = step_fn(state, batch, generator)
        _sync(device)
        return batch_np

    # the loader's own batches through the step until its prefetch is
    # full: its threads' first burst of work falls into set-up
    for _ in range(trf["loader_warm_steps"]):
        one_step()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    harness.note("set-up done")
    times, kept = [], []  # the window's loader batches, as handed out
    t0 = time.perf_counter()
    run.record["setup_s"] = harness.process_age_s(run.record["t_start"])
    failed = 0
    try:
        while time.perf_counter() - t0 < run.seconds:
            batch_np = one_step()
            t = time.perf_counter() - t0
            if t <= run.seconds:
                times.append(t)
                kept.append(batch_np)
        if run.traced:
            probe.start()
            for _ in range(trf["trace_steps"]):
                one_step()
            probe.stop()
    except Exception as e:  # a run that raises is reported, not hidden
        print(f"the training window raised: {e!r}", file=sys.stderr)
        failed = 1
    finally:
        probe.restore()
    harness.note(f"window done: {len(times)} steps")
    run.record.update(steps=len(times), times=times)
    card = harness.card(device)
    card["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0)
    outcome = {"attempted": len(times), "failed": failed, "device": card}
    if run.traced and not failed:
        run.trace = probe.read()
        run.record["trace_steps"] = trf["trace_steps"]
        run.entry_calls = probe.calls
        card["busy_s"] = tr.busy_us(run.trace) / 1e6
        card["window_s"] = run.trace.window_us / 1e6
        outcome["breakdown"] = tr.breakdown(run.trace)
        harness.note("trace read")

    # the program's state goes before the reference runs
    del state, step_fn, batches
    if cuda:
        torch.cuda.empty_cache()
    loader_check = LoaderCheck(run, data_root, kept)
    loader_check.start()  # on the host, beside the reference's steps
    reference = reference_steps(run, device)
    from benchmark.compare import train_numbers, verdict

    numbers = train_numbers(program, reference)
    numbers.update(loader_check.numbers())
    harness.note("reference done")
    print("readings: " + json.dumps(numbers), file=sys.stderr)
    correct, checks = verdict(numbers, harness.limits(run))
    outcome.update(correct=correct and not failed and len(times) > 0,
                   checks=checks)
    return outcome


class LoaderCheck(threading.Thread):
    """One loader batch of the window, drawn from the seed, against the
    plain rebuild of it from the stills tree: the loader's batch s is
    RandomState(its seed + s)'s, and `loader_warm_steps` of its batches
    went before the window."""

    def __init__(self, run, data_root, kept):
        super().__init__(daemon=True)
        self.bench_run, self.root = run, data_root
        self.k = (int(scenes.rng_for(run.seed, 5).integers(len(kept)))
                  if kept else None)
        self.prog = kept[self.k] if kept else None
        self.result = {}

    def run(self):
        from benchmark.compare import batch_numbers
        from benchmark.reference import stills

        run, cfg = self.bench_run, self.bench_run.config
        s = run.traffic["loader_warm_steps"] + self.k
        ref = stills.batch(self.root, loader_seed(run.seed) + s,
                           cfg["batch_size"], cfg["image_size"],
                           cfg["real_reference_probability"],
                           cfg["nonzero_placeholder_probability"])
        self.result = batch_numbers(self.prog, ref)

    def start(self):
        if self.prog is not None:
            super().start()

    def numbers(self) -> dict:
        """batch_off; nothing (so the verdict fails) without a batch."""
        if self.prog is not None:
            self.join()
        return self.result


def loader_seed(seed: int) -> int:
    return seed % (1 << 31)


def reference_steps(run, device, tf32: bool = False, rows=None) -> dict:
    """The plain reference's checked steps on the run's weights, batches
    and noise: the same readings as `drive_checked`. tf32: the reference
    in TF32 (the control); rows: a slice of every batch's rows (a planted
    fault: part of the batch left out)."""
    from benchmark.reference import loop
    from benchmark.reference.colorvidnet import ColorVidNet
    from benchmark.reference.discriminator import (
        Discriminator,
        split_state_dict,
    )
    from benchmark.reference.state import (
        TrainState,
        make_optimizers,
        param_groups,
    )
    from benchmark.reference.vgg19 import VGG19
    from benchmark.reference.warpnet import WarpNet
    from torch import nn

    cfg = run.config
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        sds = weights.train_state_dicts(run.seed, device,
                                        cfg["colorvidnet_in_channels"])
        with torch.device("meta"):
            vgg = VGG19()
            gen = nn.ModuleDict({"warpnet": WarpNet(), "colorvid":
                                 ColorVidNet(cfg["colorvidnet_in_channels"])})
            critic = Discriminator()
        vgg.load_state_dict(sds["vgg"], strict=True, assign=True)
        vgg = vgg.to(device).eval().requires_grad_(False)
        gen["warpnet"].load_state_dict(sds["warpnet"], strict=True,
                                       assign=True)
        gen["colorvid"].load_state_dict(sds["colorvid"], strict=True,
                                        assign=True)
        params_d, sn = split_state_dict(sds["critic"])
        critic.load_state_dict(params_d, strict=True, assign=True)
        tx_g, tx_d = make_optimizers(**cfg["optimizer"])
        state = TrainState(0, gen.to(device), critic.to(device), sn,
                           tx_g.init(param_groups(gen)),
                           tx_d.init(param_groups(critic)))
        step_fn = loop.make_train_step(
            tx_g, tx_d, vgg, loop.TrainConfig(**cfg["train_config"]),
            device_preprocess=True)
        generator = torch.Generator(device=device).manual_seed(
            noise_seed(run.seed))
        batches = checked_batches(run)
        if rows is not None:
            batches = [{k: v[rows] for k, v in bt.items()} for bt in batches]
        _, readings = drive_checked(
            step_fn, state, batches,
            lambda v: torch.from_numpy(v).to(device), generator, device,
            tx_g.b1, tx_d.b1)
        readings["leaves"] = [p.numel() for m in (gen, critic)
                              for p in m.parameters()]
        return readings
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
