"""Clip-level colourisation on tensors of network Lab (mirrors
devc_tpu/pipeline/clip.py, whose lax.scan becomes a plain loop: PyTorch
runs eagerly, and the captured frame step of scan mode lives in
pipeline/graph.py).

The exemplar's state is computed once; the previous frame's prediction
[L, ab] is the carry from one frame to the next.
"""

from __future__ import annotations

import torch

from devc_tpu_torch.pipeline.frame import frame_colorization, prepare_reference


@torch.inference_mode()
def colorize_clip(models, frames_lab, ref_lab, ref_state=None,
                  temperature: float = 1e-10):
    """Colourise a whole clip.

    frames_lab: [T, H, W, 3] network-Lab frames (only L is read); ref_lab:
    [H, W, 3] exemplar network-Lab; ref_state: optional
    prepare_reference(models, ref_lab[None]) (computed here when omitted).
    Returns pred_ab [T, H, W, 2] and similarity [T, H, W, 1].
    """
    if ref_state is None:
        ref_state = prepare_reference(models, ref_lab[None])
    t, h, w, _ = frames_lab.shape
    last = torch.zeros((1, h, w, 3), dtype=frames_lab.dtype,
                       device=frames_lab.device)
    preds, sims = [], []
    for frame_lab in frames_lab:
        pred_ab, _, sim = frame_colorization(models, frame_lab[None], last,
                                             ref_state, temperature)
        last = torch.cat([frame_lab[None, ..., 0:1], pred_ab], dim=-1)
        preds.append(pred_ab[0])
        sims.append(sim[0])
    return torch.stack(preds), torch.stack(sims)


def make_frame_step(models, temperature: float = 1e-10):
    """Streaming API: (init_fn, step_fn).

    init_fn(ref_lab [H, W, 3]) -> ref_state (kept on the device, reused
    every frame); step_fn(frame_lab [H, W, 3], last_lab [1, H, W, 3],
    ref_lab, ref_state) -> (pred_ab [1, H, W, 2], similarity [1, H, W, 1],
    new_last [1, H, W, 3]). ref_lab is accepted for devc_tpu's signature
    and not read: ref_state holds what the step needs.
    """

    @torch.inference_mode()
    def init_fn(ref_lab):
        return prepare_reference(models, ref_lab[None])

    @torch.inference_mode()
    def step_fn(frame_lab, last_lab, ref_lab, ref_state):
        pred_ab, _, sim = frame_colorization(models, frame_lab[None],
                                             last_lab, ref_state,
                                             temperature)
        new_last = torch.cat([frame_lab[None, ..., 0:1], pred_ab], dim=-1)
        return pred_ab, sim, new_last

    return init_fn, step_fn
