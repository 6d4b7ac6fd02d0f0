"""The GAN training step (mirrors devc_tpu/train/loop.py; reference
train.py:535-736), on one device.

One step:
  1. the exemplar's VGG taps (frozen extractor, no gradient);
  2. the two-frame unroll: frame 1 coloured with the placeholder as the
     previous prediction, frame 2 conditioned on frame 1's prediction;
     each frame under activation checkpointing when cfg.remat;
  3. the critic update (RaLSGAN on 6-channel [current Lab, last Lab]
     pairs, the real batch rolled by one), on the detached fake;
  4. the generator update: weighted L1 + GAN (against the updated critic)
     + perceptual + contextual + smoothness + temporal consistency.

As in devc_tpu, one forward through the unroll feeds both updates: its
autograd graph is kept while the critic steps on a detached copy, and the
generator's gradient is taken from it once, with respect to the
generator's parameters only (`torch.autograd.grad`, so nothing reaches the
critic's parameters). On the card the correspondence runs K1 forward (twice
per frame with remat: once in the forward, once when the backward
recomputes it) and K2b/K3 once per frame in the backward.

The spectral-norm state threads as in devc_tpu: the critic step runs fake
(sn -> sn1) then real (sn1 -> sn_after); the generator's GAN term starts
from sn_after and its updates are dropped; the new state keeps sn_after.
Randomness (the luminance noise) is drawn before the checkpointed frames
and passed in, so the recomputed forward sees the same values.

The single-device step only: devc_tpu's explicit-SPMD variant
(make_train_step_spmd) is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from devc_tpu_torch import colorspace as cs
from devc_tpu_torch.models.discriminator import discriminator_apply
from devc_tpu_torch.models.vgg19 import vgg19_extract
from devc_tpu_torch.pipeline.frame import FEATURE_TAPS, frame_colorization
from devc_tpu_torch.train import losses as L
from devc_tpu_torch.train.state import TrainState, apply_updates, param_groups


class TrainConfig(NamedTuple):
    weight_l1: float = 2.0
    weight_gan: float = 0.2
    weight_perceptual: float = 0.001
    weight_contextual: float = 0.2
    weight_smoothness: float = 5.0
    weight_nonlocal_smoothness: float = 0.0
    weight_consistent: float = 0.02
    weight_nonlocal_consistent: float = 0.0
    luminance_noise: float = 2.0
    temperature: float = 0.01
    permute_data: bool = True
    domain_invariant: bool = False
    contextual_direction: str = "forward"
    remat: bool = True  # recompute each frame's forward in the backward


def _vgg_feats(vgg, lab):
    """VGG taps of a Lab image, without gradient."""
    with torch.no_grad():
        return tuple(vgg19_extract(vgg, cs.lab_centered_to_rgb(lab),
                                   FEATURE_TAPS))


def _grad_vgg_feats(vgg, lab):
    """VGG taps of the prediction: frozen weights, gradient to the input."""
    return tuple(vgg19_extract(vgg, cs.lab_centered_to_rgb(lab), FEATURE_TAPS))


def _two_frame_unroll(models, batch, features_b, noise, cfg: TrainConfig):
    """reference train.py:400-428. noise: None or [2, B, H, W, 1].
    Returns (cur_ab, last_ab, cur_warped, last_warped)."""
    ref_state = {"lab": batch["ref_lab"], "features": features_b}

    def fc(a_lab, last_lab, frame_noise):
        pred_ab, warped, _sim = frame_colorization(
            models, a_lab, last_lab, ref_state, cfg.temperature,
            noise=frame_noise, luminance_noise=cfg.luminance_noise,
            joint_training=True)
        return pred_ab, warped

    def run(a_lab, last_lab, i):
        frame_noise = None if noise is None else noise[i]
        if cfg.remat:
            return checkpoint(fc, a_lab, last_lab, frame_noise,
                              use_reentrant=False)
        return fc(a_lab, last_lab, frame_noise)

    last_ab, last_nl = run(batch["last_lab"], batch["placeholder_lab"], 0)
    last_lab_pred = torch.cat([batch["last_lab"][..., 0:1], last_ab], dim=-1)
    cur_ab, cur_nl = run(batch["current_lab"], last_lab_pred, 1)
    return cur_ab, last_ab, cur_nl, last_nl


def _gan_pairs(batch, cur_ab, last_ab, permute: bool):
    """6-channel (current, last) Lab pairs with uncentered L
    (reference train.py:582-589); the real batch rolled by one."""
    cur_l = cs.uncenter_l(batch["current_lab"][..., 0:1])
    last_l = cs.uncenter_l(batch["last_lab"][..., 0:1])
    fake = torch.cat([cur_l, cur_ab, last_l, last_ab], dim=-1)
    real = torch.cat([cur_l, batch["current_lab"][..., 1:3], last_l,
                      batch["last_lab"][..., 1:3]], dim=-1)
    if permute:
        real = torch.roll(real, shifts=1, dims=0)
    return fake, real


def _g_loss(batch, outs, features_b, vgg, params_d, sn, cfg: TrainConfig):
    """The generator's weighted loss over the unroll's outputs, against
    the updated critic. Returns (total, metrics)."""
    cur_ab, last_ab, cur_nl, last_nl = outs
    cur_lab_pred = torch.cat([batch["current_lab"][..., 0:1], cur_ab], dim=-1)
    zero = cur_ab.new_zeros(())
    metrics = {}

    if (cfg.weight_perceptual > 0 or cfg.weight_contextual > 0
            or cfg.weight_nonlocal_smoothness > 0):
        if cfg.remat:
            pred_feats = checkpoint(functools.partial(_grad_vgg_feats, vgg),
                                    cur_lab_pred, use_reentrant=False)
        else:
            pred_feats = _grad_vgg_feats(vgg, cur_lab_pred)

    # weighted L1 on self-reference samples (reference :621-623)
    flag = batch["self_ref_flag"]  # [B, 1], 1 = self-reference
    w = flag[:, :, None, None] / (flag[:, 0].sum() + 1e-5)
    metrics["l1_loss"] = L.weighted_l1(
        cur_ab, batch["current_lab"][..., 1:3], w) * cfg.weight_l1

    if cfg.weight_gan > 0:
        fake, real = _gan_pairs(batch, cur_ab, last_ab, cfg.permute_data)
        fl, _, sn1 = discriminator_apply(params_d, sn, fake)
        rl, _, _ = discriminator_apply(params_d, sn1, real)
        metrics["generator_loss"] = L.ralsgan_g_loss(rl, fl) * cfg.weight_gan
    else:
        metrics["generator_loss"] = zero

    if cfg.weight_perceptual > 0:
        gt_feats = _vgg_feats(vgg, batch["current_lab"])
        scale = 1e5 * 0.2 if cfg.domain_invariant else 1.0
        metrics["feat_loss"] = L.perceptual_loss(
            pred_feats[4], gt_feats[4], cfg.domain_invariant) * (
            cfg.weight_perceptual * scale)
    else:
        metrics["feat_loss"] = zero

    if cfg.weight_contextual > 0:
        metrics["contextual_loss_total"] = L.contextual_loss_multiscale(
            pred_feats[2:5], features_b[2:5],
            direction=cfg.contextual_direction) * cfg.weight_contextual
    else:
        metrics["contextual_loss_total"] = zero

    metrics["smoothness_loss"] = (
        L.smoothness_loss(batch["current_lab"], cur_ab, alpha=10.0)
        * cfg.weight_smoothness if cfg.weight_smoothness > 0 else zero)
    metrics["nonlocal_smoothness_loss"] = (
        L.nonlocal_smoothness_loss(cur_lab_pred, pred_feats[1])
        * cfg.weight_nonlocal_smoothness
        if cfg.weight_nonlocal_smoothness > 0 else zero)
    metrics["consistent_loss"] = (
        L.consistency_loss(cur_lab_pred, last_ab, batch["flow_forward"],
                           batch["mask"]) * cfg.weight_consistent
        if cfg.weight_consistent > 0 else zero)
    metrics["nonlocal_consistent_loss"] = (
        L.consistency_loss(cur_nl, last_nl[..., 1:3], batch["flow_forward"],
                           batch["mask"]) * cfg.weight_nonlocal_consistent
        if cfg.weight_nonlocal_consistent > 0 else zero)

    total = sum(metrics.values())
    metrics["total_loss"] = total
    return total, metrics


def draw_noise(batch, generator=None):
    """Standard-normal luminance noise for both frames, [2, B, H, W, 1],
    drawn on the batch's device."""
    lab = batch["current_lab"]
    return torch.randn((2, *lab.shape[:3], 1), generator=generator,
                       device=lab.device, dtype=lab.dtype)


def train_step(state: TrainState, batch, tx_g, tx_d, vgg,
               cfg: TrainConfig = TrainConfig(), generator=None):
    """One optimisation step. batch: dict of NHWC tensors on one device:
    last_lab, current_lab, ref_lab, placeholder_lab [B, H, W, 3];
    flow_forward [B, H, W, 2]; mask [B, H, W, 1]; self_ref_flag [B, 1].
    The luminance noise comes from `generator` (a torch.Generator on the
    batch's device, or the default one). Updates the modules in place;
    returns (new_state, metrics), metrics as 0-d tensors."""
    models = types.SimpleNamespace(vgg=vgg, warpnet=state.params_g["warpnet"],
                                   colorvid=state.params_g["colorvid"])
    features_b = _vgg_feats(vgg, batch["ref_lab"])
    noise = draw_noise(batch, generator) if cfg.luminance_noise else None

    with torch.enable_grad():
        outs = _two_frame_unroll(models, batch, features_b, noise, cfg)
        cur_ab, last_ab = outs[0], outs[1]

        # critic update on the detached fake (reference :591-601)
        if cfg.weight_gan > 0:
            fake, real = _gan_pairs(batch, cur_ab.detach(), last_ab.detach(),
                                    cfg.permute_data)
            fl, _, sn1 = discriminator_apply(state.params_d, state.sn_state,
                                             fake)
            rl, _, sn_after = discriminator_apply(state.params_d, sn1, real)
            d_loss = L.ralsgan_d_loss(rl, fl)
            d_params = param_groups(state.params_d)
            d_grads = torch.autograd.grad(d_loss, d_params[""],
                                          materialize_grads=True)
            d_updates, opt_state_d = tx_d.update({"": list(d_grads)},
                                                 state.opt_state_d)
            apply_updates(state.params_d, d_updates)
        else:
            d_loss = cur_ab.new_zeros(())
            sn_after, opt_state_d = state.sn_state, state.opt_state_d

        # generator update through the same unroll graph
        g_total, metrics = _g_loss(batch, outs, features_b, vgg,
                                   state.params_d, sn_after, cfg)
        g_params = param_groups(state.params_g)
        flat = [p for ps in g_params.values() for p in ps]
        grads = iter(torch.autograd.grad(g_total, flat,
                                         materialize_grads=True))
        g_grads = {k: [next(grads) for _ in ps] for k, ps in g_params.items()}
    g_updates, opt_state_g = tx_g.update(g_grads, state.opt_state_g)
    apply_updates(state.params_g, g_updates)

    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["discriminator_loss"] = d_loss.detach()
    new_state = dataclasses.replace(
        state, step=state.step + 1, sn_state=sn_after,
        opt_state_g=opt_state_g, opt_state_d=opt_state_d)
    return new_state, metrics


def preprocess_batch_u8(batch_u8):
    """The uint8 loader batch -> the float batch train_step consumes, on
    its device: Lab conversion, the single-offset brightness jitter on the
    current frame's L (reference videoloader_imagenet.py:226) and the
    placeholder select."""
    def lab(u8):
        return cs.center_lab(cs.rgb_to_lab(u8.float() / 255.0))

    last = lab(batch_u8["last_rgb"])
    cur = lab(batch_u8["current_rgb"])
    jit_l = batch_u8["jitter"][:, :, None, None]  # [B, 1] -> [B, 1, 1, 1]
    cur = torch.cat([cur[..., 0:1] + jit_l, cur[..., 1:3]], dim=-1)
    ph = batch_u8["placeholder_flag"][:, :, None, None]
    return dict(
        last_lab=last,
        current_lab=cur,
        ref_lab=lab(batch_u8["ref_rgb"]),
        flow_forward=batch_u8["flow_forward"].float(),
        flow_backward=batch_u8["flow_backward"].float(),
        mask=batch_u8["mask"].float(),
        placeholder_lab=torch.where(ph > 0, cur, 0.0),
        self_ref_flag=batch_u8["self_ref_flag"],
    )


def train_step_u8(state, batch_u8, tx_g, tx_d, vgg,
                  cfg: TrainConfig = TrainConfig(), generator=None):
    """train_step on the uint8 loader batch (preprocess_batch_u8 first)."""
    return train_step(state, preprocess_batch_u8(batch_u8), tx_g, tx_d, vgg,
                      cfg, generator)


def make_train_step(tx_g, tx_d, vgg, cfg: TrainConfig = TrainConfig(),
                    device_preprocess: bool = False):
    """(state, batch, generator=None) -> (state, metrics), the uint8-batch
    contract when device_preprocess."""
    step = train_step_u8 if device_preprocess else train_step

    def fn(state, batch, generator=None):
        return step(state, batch, tx_g, tx_d, vgg, cfg, generator)

    return fn
