"""The yardstick: the bounds against PERF.md's kernel table (the bounds
chip_smoke.py computes), the model FLOP count against
torch.utils.flop_counter on the port's own step at a small size, and the
inference judge's float64 convolutions."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, roofline, weights
from benchmark.reference import infer, layers


@pytest.mark.parametrize("case, bound_ms, by", [
    (lambda: roofline.k1_bound(1, 5184, 5184), 0.0834, "operations"),
    (lambda: roofline.k1_bound(16, 5184, 5184, emit_l=True), 1.334,
     "operations"),
    (lambda: roofline.k1_bound(4, 5184, 5184), 0.334, "operations"),
    (lambda: roofline.k1_bound(1, 20736, 20736), 1.334, "operations"),
    (lambda: roofline.k1_bound(1, 1344, 1344), 0.00561, "operations"),
    (lambda: roofline.k2_pass_bound(1, 432, 768, 1), 0.00198, "bytes"),
    (lambda: roofline.k2_pass_bound(4, 432, 768, 4), 0.00792, "bytes"),
    (lambda: roofline.k2_pass_bound(3, 432, 768, 1), 0.00515, "bytes"),
    (lambda: roofline.k2_pass_bound(1, 224, 384, 1), 0.000514, "bytes"),
    (lambda: roofline.bwd_bounds(16, 5184, 5184, 256)["corr_bwd_dq"],
     1.334, "operations"),
    (lambda: roofline.bwd_bounds(16, 5184, 5184, 256)["corr_bwd_dkv"],
     2.668, "operations"),
])
def test_bounds_match_the_kernel_table(case, bound_ms, by):
    b = case()
    assert b["bound_ms"] == pytest.approx(bound_ms, rel=5e-3)
    assert b["bound_by"] == by


def test_df_scratch_is_padded_to_128():
    assert roofline.df_scratch_bytes(5184, 5184) == 4 * 5248 * 5248
    assert roofline.df_scratch_bytes(128, 1) == 4 * 128 * 128


def test_mfu_peak_is_three_tf32_passes():
    assert roofline.PEAK_FP32_ACCURATE_FLOPS == pytest.approx(165e12)


@pytest.mark.parametrize("hw", [(64, 128), (96, 160)])
def test_frame_flop_matches_flop_counter_on_the_port(hw):
    """The port's frame step on the CPU (its plain correspondence is two
    bmm) counted by torch's FlopCounterMode: convolutions and matrix
    products. The benchmark's count leaves out the colour conversion's
    3x3 products, so the two agree to a few parts in a million."""
    from benchmark import scenes, weights
    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import PipelineModels

    cfg = {"image_size": list(hw), "temperature": 1e-10,
           "corr_channels": 256}
    models = PipelineModels.from_state_dicts(
        weights.pipeline_state_dicts(3, "cpu"), "cpu")
    ref = torch.from_numpy(scenes.exemplar(3, hw))
    _, state = video._device_ref_features(models, ref)
    frame = torch.from_numpy(scenes.exemplar(4, hw))
    carry = torch.zeros((1, hw[0] // 2, hw[1] // 2, 3))
    with FlopCounterMode(display=False) as counter:
        video.frame_step(models, frame, carry, state, 1e-10, wls=False)
    counted = counter.get_total_flops()
    assert flops.inference_frame_flop(cfg) == pytest.approx(counted,
                                                            rel=1e-4)


def test_432x768_frame_is_348_gflop():
    cfg = {"image_size": [432, 768], "temperature": 1e-10,
           "corr_channels": 256}
    assert flops.inference_frame_flop(cfg) == pytest.approx(348.39e9,
                                                            rel=1e-4)


def test_the_judges_convolutions_are_float64_rounded_once():
    """Models built for the judge compute every convolution in float64 and
    round once to fp32; the default build (training, the controls) stays
    in the input's dtype."""
    sd = weights.pipeline_state_dicts(5, "cpu")
    judge = infer.Models.from_state_dicts(sd, "cpu",
                                          float64_convolutions=True)
    plain = infer.Models.from_state_dicts(sd, "cpu")
    convs = [m for m in judge.modules() if isinstance(m, layers.Conv2d)]
    assert len(convs) > 40 and all(c.float64 for c in convs)
    assert not any(m.float64 for m in plain.modules()
                   if isinstance(m, layers.Conv2d))
    conv = judge.vgg.conv1_1
    x = torch.randn(1, conv.in_channels, 9, 11, dtype=torch.float64)
    want = torch.nn.functional.conv2d(
        x, conv.weight.double(), conv.bias.double(), conv.stride,
        conv.padding, conv.dilation)
    got = conv(x.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.nn.functional.conv2d(
        x.float().double(), conv.weight.double(), conv.bias.double(),
        conv.stride, conv.padding, conv.dilation).float())
    assert (got.double() - want).abs().max() < 1e-5
