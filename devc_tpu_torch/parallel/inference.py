"""Batched inference: B independent clips advance one frame per step
(mirrors devc_tpu/parallel/inference.py).

devc_tpu shards the batch over a mesh of chips; the port runs it on one
card (sharding over several cards is ROADMAP A10). Every stage of the
step is per sample, so this is `pipeline/video.py::frame_step` with a
leading clip axis: one K1 launch at batch B, and six K2 launches with a
guide per clip, whatever B is.
"""

from __future__ import annotations

import torch

from devc_tpu_torch.ops.device_resize import device_centerpad_batched
from devc_tpu_torch.pipeline.video import _device_ref_features_multi, step_body


def prepare_references_batched(models, refs_rgb_u8):
    """Exemplar preparation for B clips: uint8 [B, H, W, 3] on the
    models' device -> (lab_small [B, H/2, W/2, 3], state batched over B)."""
    return _device_ref_features_multi(models, refs_rgb_u8)


@torch.inference_mode()
def batched_frame_step(models, frames_u8, last_lab, ref_state,
                       temperature: float = 1e-10, wls: bool = True,
                       resize_plans=None):
    """Advance B clips one frame: frames_u8 [B, H, W, 3] uint8 (one frame
    of each clip), last_lab [B, H/2, W/2, 3], ref_state batched over B ->
    (uint8 RGB [B, H, W, 3], new carries).

    resize_plans: optional (A_h [B, th, maxH], A_w [B, tw, maxW]) per-slot
    CenterPad plans (ops/device_resize.py::centerpad_plan_padded) as fp32
    tensors on the device; frames_u8 is then raw [B, maxH, maxW, 3], each
    slot's source zero-padded to the common size, and the CenterPad runs
    here as one batched product per axis, so clips of mixed resolutions
    share the step."""
    if resize_plans is not None:
        frames_u8 = device_centerpad_batched(frames_u8, *resize_plans)
    return step_body(models, frames_u8, last_lab, ref_state, temperature,
                     wls)
