"""Single-frame colourisation (mirrors devc_tpu/pipeline/frame.py).

`PipelineModels` holds the three networks, frozen, in place of devc_tpu's
params dict {"vgg", "warpnet", "colorvid"}; training passes any object
with those three attributes (trainable WarpNet and ColorVidNet, frozen
VGG19). All images are NHWC network-Lab (L centered by -50).

The exemplar state `ref_state` takes one of two forms:
  * {"phi", "values"} from `prepare_reference`: the key embedding computed
    once per clip (inference);
  * {"lab", "features"}: the exemplar's Lab and VGG taps, from which
    `warpnet_apply` recomputes the key embedding on every call, under
    gradient (training, devc_tpu's features_b path).
"""

from __future__ import annotations

import torch
from torch import nn

from devc_tpu_torch import colorspace as cs
from devc_tpu_torch.models.colorvidnet import ColorVidNet, colorvidnet_apply
from devc_tpu_torch.models.vgg19 import VGG19, vgg19_extract
from devc_tpu_torch.models.warpnet import (
    WarpNet,
    embed_keys,
    embed_queries,
    warp_with_keys,
    warpnet_apply,
)
from devc_tpu_torch.utils.convert import checked_device

# VGG taps used throughout the live path
FEATURE_TAPS = ("r12", "r22", "r32", "r42", "r52")


class PipelineModels(nn.Module):
    """VGG19, WarpNet and ColorVidNet, frozen for inference."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG19()
        self.warpnet = WarpNet()
        self.colorvid = ColorVidNet()

    @classmethod
    def from_state_dicts(cls, state_dicts: dict, device) -> "PipelineModels":
        """Build on `device` from {"vgg", "warpnet", "colorvid"} state dicts
        in the reference layout; each loads with strict=True. A CUDA
        device without a GPU raises: nothing falls back to the CPU."""
        device = checked_device(device)
        with torch.device("meta"):  # no throw-away default init
            models = cls()
        for name in ("vgg", "warpnet", "colorvid"):
            getattr(models, name).load_state_dict(
                state_dicts[name], strict=True, assign=True)
        models = models.to(device).eval()
        models.requires_grad_(False)
        return models

    @property
    def device(self) -> torch.device:
        return self.vgg.conv1_1.weight.device


def extract_reference_features(vgg: VGG19, ref_lab):
    """Exemplar VGG taps r12..r52 (NHWC) from network-Lab [B, H, W, 3]."""
    return tuple(vgg19_extract(vgg, cs.lab_centered_to_rgb(ref_lab),
                               FEATURE_TAPS))


def prepare_reference(models: PipelineModels, ref_lab):
    """Clip-constant exemplar state, the WarpNet key embedding computed
    from the exemplar's VGG features. Returns dict(phi, values)."""
    features_b = extract_reference_features(models.vgg, ref_lab)
    b_n = tuple(cs.feature_normalize(f) for f in features_b[1:])
    phi, values = embed_keys(models.warpnet, ref_lab, b_n)
    return {"phi": phi, "values": values}


def _frame_features(models, a_l):
    """VGG taps r22..r52 of the gray frame a_l [B, H, W, 1], normalised;
    no gradient (a frozen extractor, as devc_tpu's stop_gradient)."""
    with torch.no_grad():
        feats_a = vgg19_extract(models.vgg, cs.gray_to_rgb(a_l), FEATURE_TAPS)
    return [cs.feature_normalize(f) for f in feats_a[1:]]


def query_embedding(models, a_l):
    """The frame side of the correspondence: theta [B, N, 256] of the gray
    frame a_l [B, H, W, 1]."""
    return embed_queries(models.warpnet, _frame_features(models, a_l))


def warp_color(models, a_l, ref_state, temperature: float = 0.01,
               differentiable: bool = False):
    """Warp the exemplar's colour onto the gray frame.

    a_l: [B, H, W, 1] centered luminance. ref_state: either form above.
    The frame's VGG features carry no gradient (a frozen extractor, as
    devc_tpu's stop_gradient). differentiable: the correspondence may be
    differentiated (training).
    Returns (warped_lab [B, H, W, 3], similarity [B, H, W, 1]).
    """
    hw = (a_l.shape[1], a_l.shape[2])
    if "phi" in ref_state:
        theta = query_embedding(models, a_l)
        return warp_with_keys(theta, ref_state["phi"], ref_state["values"],
                              hw, temperature, differentiable)
    b_n = [cs.feature_normalize(f.detach()) for f in ref_state["features"][1:]]
    return warpnet_apply(models.warpnet, ref_state["lab"],
                         _frame_features(models, a_l), b_n,
                         temperature, differentiable)


def frame_colorization(models, a_lab, a_last_lab, ref_state,
                       temperature: float = 0.01, noise=None,
                       luminance_noise: float = 0.0,
                       joint_training: bool = True):
    """Colourise one frame.

    a_lab: [B, H, W, 3] frame network-Lab (only L is used); a_last_lab: the
    previous prediction [L, ab] (zeros for the first frame).
    noise: None, or standard-normal draws [B, H, W, 1] added to L times
    luminance_noise (training). The caller draws them, so that a
    recomputed forward (activation checkpointing) sees the same noise.
    joint_training: when False the warp branch is cut from the graph
    (devc_tpu's stop_gradient; the correspondence then runs without grad).
    Returns (pred_ab [B, H, W, 2], warped_lab, similarity).
    """
    a_l = a_lab[..., 0:1]
    if luminance_noise and noise is not None:
        a_l = a_l + noise * luminance_noise
    if joint_training:
        warped_lab, similarity = warp_color(models, a_l, ref_state,
                                            temperature, differentiable=True)
    else:
        with torch.no_grad():
            warped_lab, similarity = warp_color(models, a_l, ref_state,
                                                temperature)
    color_input = torch.cat(
        [a_l, warped_lab[..., 1:3], similarity, a_last_lab], dim=-1)
    pred_ab = colorvidnet_apply(models.colorvid, color_input)
    return pred_ab, warped_lab, similarity
