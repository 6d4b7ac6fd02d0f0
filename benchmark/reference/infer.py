"""The plain inference step, the benchmark's reference for the inference
cells: a frozen copy of devc_tpu_torch/pipeline/frame.py (prepare the
exemplar, warp, ColorVidNet) and of pipeline/video.py's step_body
(preprocess, the x2 ab upsample with the 1.25 chroma boost, the smoother
guided by the truncated L, Lab -> uint8), on the plain modules beside
this file. It imports nothing of the port.

Weights come in as the state dicts {"vgg", "warpnet", "colorvid"} that
the benchmark draws from its seed and hands to the port as well.

The judge of the inference cells builds the models with
`float64_convolutions=True`: every convolution is computed in float64
and rounded to fp32, the rest stays fp32 with TF32 off. At the
correspondence's temperature (1e-10) the softmax picks a key by scores
that can tie to within fp32's rounding of the convolutions before them;
there an fp32 reference decides the tie by its own rounding and reads a
sound run as off, where float64 decides it as the truth does."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference import colorspace as cs
from benchmark.reference.colorvidnet import ColorVidNet, colorvidnet_apply
from benchmark.reference.fgs import fast_global_smoother
from benchmark.reference.layers import Conv2d
from benchmark.reference.resize import resize_bilinear
from benchmark.reference.vgg19 import VGG19, vgg19_extract
from benchmark.reference.warpnet import (
    WarpNet,
    embed_keys,
    embed_queries,
    warp_with_keys,
)

FEATURE_TAPS = ("r12", "r22", "r32", "r42", "r52")


class Models(nn.Module):
    """VGG19, WarpNet and ColorVidNet under the reference's keys."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG19()
        self.warpnet = WarpNet()
        self.colorvid = ColorVidNet()

    @classmethod
    def from_state_dicts(cls, state_dicts: dict, device,
                         float64_convolutions: bool = False) -> "Models":
        with torch.device("meta"):
            models = cls()
        for name in ("vgg", "warpnet", "colorvid"):
            getattr(models, name).load_state_dict(
                state_dicts[name], strict=True, assign=True)
        models = models.to(device).eval()
        models.requires_grad_(False)
        for m in models.modules():
            if isinstance(m, Conv2d):
                m.float64 = float64_convolutions
        return models


def _resize_nhwc(x, out_hw):
    return resize_bilinear(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def preprocess(rgb_u8):
    """uint8 RGB [B, H, W, 3] -> (lab_large, lab_small at H/2 x W/2)."""
    lab_large = cs.center_lab(cs.rgb_to_lab(rgb_u8.float() / 255.0))
    h, w = rgb_u8.shape[1], rgb_u8.shape[2]
    return lab_large, _resize_nhwc(lab_large, (h // 2, w // 2))


def prepare_reference(models: Models, ref_rgb_u8):
    """The exemplar uint8 [B, H, W, 3] -> {"phi", "values"}."""
    _, ref_lab = preprocess(ref_rgb_u8)
    feats = vgg19_extract(models.vgg, cs.lab_centered_to_rgb(ref_lab),
                          FEATURE_TAPS)
    b_n = tuple(cs.feature_normalize(f) for f in feats[1:])
    phi, values = embed_keys(models.warpnet, ref_lab, b_n)
    return {"phi": phi, "values": values}


def postprocess(lab_large, pred_ab, wls: bool = True):
    h, w = lab_large.shape[1], lab_large.shape[2]
    ab_up = _resize_nhwc(pred_ab, (h, w)) * 1.25
    l_large = lab_large[..., 0:1]
    if wls:
        guide = torch.clamp(
            torch.floor(cs.uncenter_l(l_large[..., 0]) * 255.0 / 100.0),
            0.0, 255.0)
        ab_up = fast_global_smoother(ab_up, guide)
    rgb = cs.lab_centered_to_rgb(torch.cat([l_large, ab_up], dim=-1))
    return torch.floor(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


@torch.no_grad()
def step(models: Models, frames_u8, last_lab, ref_state,
         temperature: float = 1e-10, wls: bool = True):
    """B frames uint8 [B, H, W, 3], carries [B, H/2, W/2, 3], the exemplar
    state -> (uint8 RGB [B, H, W, 3], new carries [L, predicted ab])."""
    lab_large, lab_small = preprocess(frames_u8)
    a_l = lab_small[..., 0:1]
    feats = vgg19_extract(models.vgg, cs.gray_to_rgb(a_l), FEATURE_TAPS)
    theta = embed_queries(models.warpnet,
                          [cs.feature_normalize(f) for f in feats[1:]])
    warped, sim = warp_with_keys(theta, ref_state["phi"], ref_state["values"],
                                 (a_l.shape[1], a_l.shape[2]), temperature)
    pred_ab = colorvidnet_apply(models.colorvid, torch.cat(
        [a_l, warped[..., 1:3], sim, last_lab], dim=-1)).float()
    new_last = torch.cat([a_l, pred_ab], dim=-1)
    return postprocess(lab_large, pred_ab, wls), new_last
