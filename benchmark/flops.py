"""Model FLOPs from a configuration's shapes, the numerator of mfu.

Convolutions count 2 k_h k_w (C_in / groups) C_out H_out W_out each,
found by running the reference's networks on the meta device (no numbers
computed, shapes only) with a hook on every convolution; the
correspondence counts 2 B N^2 C for the scores and 2 B N^2 3 for P.V.
The rest (colour conversion, norms, the smoother) is left out: it is
elementwise work, not model FLOPs."""

from __future__ import annotations

import torch
from torch import nn


class ConvCounter:
    """Sums the FLOPs of every nn.Conv2d call under `modules` while open."""

    def __init__(self, *modules):
        self.flop = 0
        self._hooks = [m.register_forward_hook(self._hook)
                       for root in modules for m in root.modules()
                       if isinstance(m, nn.Conv2d)]

    def _hook(self, m, inputs, out):
        kh, kw = m.kernel_size
        n, c_out, h_out, w_out = out.shape
        self.flop += (2 * kh * kw * (m.in_channels // m.groups) * c_out
                      * h_out * w_out * n)

    def close(self):
        for h in self._hooks:
            h.remove()


def correspondence_flop(b: int, nq: int, nk: int, c: int) -> int:
    return 2 * b * nq * nk * c + 2 * b * nq * nk * 3


def inference_frame_flop(config: dict) -> int:
    """FLOPs of one frame's step (the exemplar's preparation, once per
    clip, left out) at config["image_size"]."""
    from benchmark.reference import infer

    h, w = config["image_size"]
    with torch.device("meta"):
        models = infer.Models()
        frame = torch.zeros((1, h, w, 3), dtype=torch.uint8)
        carry = torch.zeros((1, h // 2, w // 2, 3))
        state = infer.prepare_reference(models, frame)
        counter = ConvCounter(models)
        infer.step(models, frame, carry, state, config["temperature"],
                   wls=False)
        counter.close()
    n = (h // 8) * (w // 8)
    return counter.flop + correspondence_flop(1, n, n, config["corr_channels"])


class _NoOptimizer:
    """Stands in for the optimizers while FLOPs are counted: its update is
    zeros (an optimizer's arithmetic is not model FLOPs)."""

    def update(self, grads, state):
        return {k: [torch.zeros_like(g) for g in gs]
                for k, gs in grads.items()}, state


def train_step_flop(config: dict) -> int:
    """FLOPs of one training step at the configuration's batch and size,
    counted by torch.utils.flop_counter on the meta device (shapes only)
    through the reference's step: the forward, and the input and weight
    gradients its graph needs (the frozen VGG's weights take none), with
    activation checkpointing off so that nothing is counted twice."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import loop
    from benchmark.reference.colorvidnet import ColorVidNet
    from benchmark.reference.discriminator import Discriminator
    from benchmark.reference.state import TrainState
    from benchmark.reference.vgg19 import VGG19
    from benchmark.reference.warpnet import WarpNet

    b = config["batch_size"]
    h, w = config["image_size"]
    cfg = loop.TrainConfig(**{**config["train_config"], "remat": False})
    with torch.device("meta"):
        vgg = VGG19().requires_grad_(False)
        gen = nn.ModuleDict({
            "warpnet": WarpNet(),
            "colorvid": ColorVidNet(config["colorvidnet_in_channels"])})
        critic = Discriminator()
        sn = {name: {"u": torch.zeros(co), "v": torch.zeros(ci * kh * kw)}
              for name, (_p, ci, co, kh, kw, _s, _d) in critic.table.items()}
        state = TrainState(0, gen, critic, sn, None, None)
        u8 = lambda *s: torch.zeros(s, dtype=torch.uint8)
        batch = {"last_rgb": u8(b, h, w, 3), "current_rgb": u8(b, h, w, 3),
                 "ref_rgb": u8(b, h, w, 3),
                 "flow_forward": torch.zeros((b, h, w, 2)),
                 "flow_backward": torch.zeros((b, h, w, 2)),
                 "mask": torch.ones((b, h, w, 1)),
                 "jitter": torch.zeros((b, 1)),
                 "placeholder_flag": torch.zeros((b, 1)),
                 "self_ref_flag": torch.ones((b, 1))}
        with FlopCounterMode(display=False) as counter:
            loop.train_step_u8(state, batch, _NoOptimizer(), _NoOptimizer(),
                               vgg, cfg)
    return counter.get_total_flops()
