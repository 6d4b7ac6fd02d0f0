"""The port's bf16 inference mode (cli.colorize --bf16) vs devc_tpu's
(`compute_dtype="bfloat16"` with `jnp.asarray(p, bfloat16)` parameters)
on the CPU, stage by stage, on the same full-width random weights
(host_pipeline_params(0)) at 48x96 and the same bf16 inputs.

How close two bf16 implementations can be. A bf16 result is the fp32
result rounded to 8 bits: where the two fp32 sums differ in their last
bits (another summation order), about 1 output in 5000 of a convolution
rounds the other way, by one bf16 ulp. The port rounds where devc_tpu
does (a convolution's bias is added after its output is rounded, scalar
factors are rounded to bf16, the exemplar's avg-pool sums in bf16,
powers are taken in fp32), so single layers agree to one ulp on all but
a few outputs, and the pieces without a summation agree bit for bit.
Through a deep network at random weights those one-ulp flips spread:
the share of outputs that differ grows ~5-25x per layer until it
saturates. So whole models are bounded by their relative L2 distance,
as a share of the distance between devc_tpu's own bf16 and fp32 outputs
on the same inputs, and the frame step by a numeric bound at T = 1.
On this input the port's bf16 frame moves as far from devc_tpu's as it
moves from itself when only its convolutions' summation order changes
(fp32 sums of the same bf16 operands, rounded): pred_ab relative L2 0.10
(uint8 max 6), against devc_tpu's 0.11-0.12 (uint8 max 6-8), and
devc_tpu's bf16 vs fp32 gap of 0.15 (uint8 max 10).

Tolerances, each at its test: the correspondence on inputs that make
every product and partial sum exact in fp32 (sim exact, out within one
bf16 ulp); layers within 2 bf16 ulps of each element on all but 0.1% of
outputs, all within 2^-7 of the largest |output|; colour conversion and
pooling exact; models at relative L2 <= 0.8 of devc_tpu's bf16-vs-fp32
distance; the frame step at T = 1 teacher-forced: pred_ab relative L2
<= 0.15 and below devc_tpu's bf16-vs-fp32 distance, uint8 within 12; at
T = 1e-10 (argmax flips, C2/C3) the share of uint8 pixels off by more
than 1 no larger than devc_tpu's bf16-vs-fp32 share plus 0.05.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from devc_tpu import colorspace as jcs
from devc_tpu.models import colorvidnet as jcvn
from devc_tpu.models import vgg19 as jvgg
from devc_tpu.models import warpnet as jwarp
from devc_tpu.ops import layers as jl
from devc_tpu.ops import resize as jr
from devc_tpu.ops.correspondence import correspondence_warp_einsum as j_einsum
from devc_tpu.ops.pallas_corr import correspondence_warp_pallas
from devc_tpu.pipeline import frame as jframe
from devc_tpu.pipeline import video as jvideo
from devc_tpu.utils.init import host_pipeline_params
from devc_tpu_torch import colorspace as tcs
from devc_tpu_torch.cli import colorize as tcli
from devc_tpu_torch.models.colorvidnet import colorvidnet_apply
from devc_tpu_torch.models.vgg19 import vgg19_extract
from devc_tpu_torch.models.warpnet import embed_keys, embed_queries
from devc_tpu_torch.ops import layers as tl
from devc_tpu_torch.ops import resize as tr
from devc_tpu_torch.ops.correspondence import correspondence_warp
from devc_tpu_torch.pipeline import frame as tframe
from devc_tpu_torch.pipeline import video as tvideo
from devc_tpu_torch.pipeline.frame import PipelineModels
from devc_tpu_torch.utils.convert import state_dicts_from_numpy

HW = (48, 96)  # network at 24 x 48
NET = (24, 48)
BF = jnp.bfloat16
TAPS = ("r12", "r22", "r32", "r42", "r52")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """devc_tpu's bf16 and fp32 params and the port's bf16 models."""
    params = host_pipeline_params(0)
    sds = state_dicts_from_numpy(params)
    return (jax.tree.map(lambda x: jnp.asarray(x, BF), params),
            jax.tree.map(jnp.asarray, params),
            PipelineModels.from_state_dicts(sds, "cpu", dtype=torch.bfloat16),
            params)


def textured_frames(seed, n, hw=HW):
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = field * 200 + 20 + rng.randn(h, w, 3) * 12
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _bf16_values(x):
    """float32 numpy with x's values rounded to bf16 (RNE)."""
    return np.asarray(jnp.asarray(np.asarray(x, np.float32), BF), np.float32)


def _tb(x):
    """A bf16 tensor of bf16-representable float32 values (exact)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _ulps(got, want):
    """|got - want| in bf16 ulps of each element of want."""
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_layer_close(got, want):
    """Within 2 bf16 ulps on all but 0.1% of the outputs, and every output
    within 2^-7 of the largest |output| (one ulp at the top binade)."""
    assert tuple(got.shape) == tuple(want.shape)
    u = _ulps(got, want)
    assert (u > 2).mean() <= 1e-3, (u > 2).mean()
    assert np.abs(_f32(got) - _f32(want)).max() <= \
        2.0 ** -7 * np.abs(_f32(want)).max()


def _rel_l2(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_params_equal_devc_tpu_bit_for_bit(weights):
    """`from_state_dicts(..., dtype=bf16)` rounds every parameter as
    `jnp.asarray(p, bfloat16)` does (nearest even): exact."""
    jp16, _, models, _ = weights
    want = state_dicts_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jp16))
    for name, sd in want.items():
        got = getattr(models, name).state_dict()
        assert set(got) == set(sd)
        for key, value in sd.items():
            assert got[key].dtype == torch.bfloat16, key
            assert torch.equal(got[key].float(), value), key
    assert models.dtype == torch.bfloat16


@pytest.mark.parametrize("temperature", [1.0, 1e-10])
@pytest.mark.parametrize("path", ["pallas_interpret", "einsum"])
def test_bf16_correspondence_matches_devc_tpu(path, temperature):
    """bf16 theta / phi / values, multiples of 2^-6 with |x| <= 1 at
    C = 64: every product and partial sum of a score is exact in fp32 on
    both sides, so sim must match exactly; out is fp32 softmax-weighted
    values rounded to bf16, within one bf16 ulp. At T = 1e-10 the inputs'
    many exact ties are averaged alike."""
    rng = np.random.RandomState(3)
    b, nq, nk, c = 2, 200, 260, 64
    theta = rng.randint(-64, 65, (b, nq, c)).astype(np.float32) / 64
    phi = rng.randint(-64, 65, (b, nk, c)).astype(np.float32) / 64
    values = _bf16_values((rng.rand(b, nk, 3) - 0.5) * 200)
    jt, jp_, jv = (jnp.asarray(x, BF) for x in (theta, phi, values))
    if path == "pallas_interpret":
        want_out, want_sim = correspondence_warp_pallas(
            jt, jp_, jv, temperature=temperature, interpret=True)
        assert want_out.dtype == BF
    else:
        want_out, want_sim = j_einsum(jt, jp_, jv, temperature=temperature)
    got_out, got_sim = correspondence_warp(_tb(theta), _tb(phi), _tb(values),
                                           temperature)
    assert got_out.dtype == torch.bfloat16 and got_sim.dtype == torch.float32
    np.testing.assert_array_equal(got_sim.numpy(), _f32(want_sim))
    assert _ulps(got_out, want_out).max() <= 1.0


def _conv_case(weights, name, rng):
    """(port module, devc_tpu params, kwargs, input NHWC shape)."""
    jp16, _, models, _ = weights
    return {
        "vgg_conv3x3": (models.vgg.conv1_2, jp16["vgg"]["conv1_2"],
                        dict(padding=1), (1, 24, 48, 64)),
        "warpnet_stride2": (models.warpnet.layer2_1[5],
                            jp16["warpnet"]["layer2_1"]["conv2"],
                            dict(stride=2), (1, 26, 50, 128)),
        "colorvid_dilated": (models.colorvid.conv5_1,
                             jp16["colorvid"]["conv5_1"],
                             dict(padding=2, dilation=2), (1, 6, 12, 512)),
        "theta_1x1": (models.warpnet.theta, jp16["warpnet"]["theta"], {},
                      (1, 6, 12, 256)),
    }[name]


@pytest.mark.parametrize("case", ["vgg_conv3x3", "warpnet_stride2",
                                  "colorvid_dilated", "theta_1x1", "prelu",
                                  "instance_norm", "leaky_relu"])
def test_bf16_layers_match_devc_tpu(weights, case):
    """One layer on the same bf16 input as devc_tpu's, its output in bf16:
    within 2 ulps on all but 0.1% of outputs (convolutions sum in another
    order; one output in ~5000 rounds the other way)."""
    rng = np.random.RandomState(4)
    if case in ("prelu", "instance_norm", "leaky_relu"):
        x = _bf16_values(rng.randn(2, 8, 12, 16) * 3)
        jx, tx = jnp.asarray(x, BF), _tb(x).permute(0, 3, 1, 2)
        if case == "prelu":
            a = _bf16_values([0.2])
            want = jl.prelu({"a": jnp.asarray(a, BF)}, jx)
            got = tl.prelu(tx, _tb(a))
        elif case == "instance_norm":
            want, got = jl.instance_norm(jx), tl.instance_norm(tx)
        else:
            want, got = jl.leaky_relu(jx, 0.2), tl.leaky_relu(tx, 0.2)
    else:
        module, jparams, kw, shape = _conv_case(weights, case, rng)
        x = _bf16_values(rng.randn(*shape))
        jx, tx = jnp.asarray(x, BF), _tb(x).permute(0, 3, 1, 2)
        want = jl.conv2d(jparams, jx, **kw)
        with torch.inference_mode():
            got = module(tx)
    assert want.dtype == BF and got.dtype == torch.bfloat16
    _assert_layer_close(got.permute(0, 2, 3, 1), want)


def test_bf16_colour_conversion_and_pooling_match_devc_tpu():
    """The exemplar's Lab -> RGB, the frame's gray -> VGG input, the
    features' normalisation and the exemplar's 4x4 avg-pool in bf16:
    the same operations in the same dtype, bit for bit."""
    rng = np.random.RandomState(5)
    lab = _bf16_values((rng.rand(1, 24, 48, 3) - 0.5)
                       * np.array([100, 200, 200]))
    jlab, tlab = jnp.asarray(lab, BF), _tb(lab)
    pairs = [
        (tcs.lab_centered_to_rgb(tlab), jcs.lab_centered_to_rgb(jlab)),
        (tcs.vgg_preprocess(tcs.gray_to_rgb(tlab[..., :1])),
         jcs.vgg_preprocess(jcs.gray_to_rgb(jlab[..., :1]))),
        (tr.avg_pool(tlab.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1),
         jr.avg_pool(jlab, 4)),
    ]
    feat = _bf16_values(np.abs(rng.randn(1, 6, 12, 64)))
    pairs.append((tcs.feature_normalize(_tb(feat)),
                  jcs.feature_normalize(jnp.asarray(feat, BF))))
    for got, want in pairs:
        assert got.dtype == torch.bfloat16 and want.dtype == BF
        np.testing.assert_array_equal(_f32(got), _f32(want))


def _norm_feats(feats):
    return [jcs.feature_normalize(f) for f in feats[1:]]


@pytest.mark.parametrize("model", ["vgg19", "embed_queries", "embed_keys",
                                   "prepare_reference", "colorvidnet"])
def test_bf16_models_match_devc_tpu(weights, model):
    """Whole networks on the same bf16 inputs. The port's bf16 output lies
    at relative L2 <= 0.8 of the distance between devc_tpu's bf16 and fp32
    outputs (measured: VGG19's r42 / r52 taps 0.52 / 0.53, the embeddings
    0.21, the exemplar state's phi 0.6, ColorVidNet 0.40: one-ulp
    summation-order flips spread through the layers). The exemplar's
    values (avg-pooled Lab) are exact."""
    jp16, jp32, models, _ = weights
    rng = np.random.RandomState(6)
    rgb = _bf16_values(rng.rand(1, *NET, 3))
    lab = _bf16_values((rng.rand(1, *NET, 3) - 0.5) * np.array([100, 200, 200]))
    j16 = lambda x: jnp.asarray(x, BF)
    j32 = lambda x: jnp.asarray(x, jnp.float32)
    pairs = []  # (port bf16, devc_tpu bf16, devc_tpu fp32)
    with torch.inference_mode():
        if model == "vgg19":
            got = vgg19_extract(models.vgg, _tb(rgb), TAPS)
            want = jvgg.vgg19_extract(jp16["vgg"], j16(rgb), TAPS)
            base = jvgg.vgg19_extract(jp32["vgg"], j32(rgb), TAPS)
            pairs = list(zip(got, want, base))
        elif model == "prepare_reference":
            g = tframe.prepare_reference(models, _tb(lab))
            w = jframe.prepare_reference(jp16, j16(lab))
            b = jframe.prepare_reference(jp32, j32(lab))
            np.testing.assert_array_equal(_f32(g["values"]), _f32(w["values"]))
            pairs = [(g["phi"], w["phi"], b["phi"])]
        elif model == "colorvidnet":
            x = _bf16_values(rng.randn(1, *NET, 7)
                             * np.array([30, 50, 50, 0.3, 30, 50, 50]))
            pairs = [(colorvidnet_apply(models.colorvid, _tb(x)),
                      jcvn.colorvidnet_apply(jp16["colorvid"], j16(x)),
                      jcvn.colorvidnet_apply(jp32["colorvid"], j32(x)))]
        else:
            feats = _norm_feats(jvgg.vgg19_extract(jp16["vgg"], j16(rgb),
                                                   TAPS))
            t_feats = [_tb(_f32(f)) for f in feats]
            f32_feats = [f.astype(jnp.float32) for f in feats]
            if model == "embed_queries":
                pairs = [(embed_queries(models.warpnet, t_feats),
                          jwarp.embed_queries(jp16["warpnet"], feats, NET),
                          jwarp.embed_queries(jp32["warpnet"], f32_feats,
                                              NET))]
            else:
                g_phi, g_val = embed_keys(models.warpnet, _tb(lab), t_feats)
                w_phi, w_val = jwarp.embed_keys(jp16["warpnet"], j16(lab),
                                                feats)
                b_phi, _ = jwarp.embed_keys(jp32["warpnet"], j32(lab),
                                            f32_feats)
                np.testing.assert_array_equal(_f32(g_val), _f32(w_val))
                pairs = [(g_phi, w_phi, b_phi)]
    for got, want, base in pairs:
        assert got.dtype == torch.bfloat16 and want.dtype == BF
        assert tuple(got.shape) == tuple(want.shape)
        gap = _rel_l2(base, want)
        assert _rel_l2(got, want) <= 0.8 * gap, (_rel_l2(got, want), gap)


@pytest.mark.parametrize("temperature", [1.0, 1e-10])
def test_bf16_frame_step_teacher_forced(weights, temperature):
    """`frame_step(compute_dtype=bf16)` against devc_tpu's
    `_device_frame_step(compute_dtype="bfloat16")`, two frames, both from
    devc_tpu's bf16 exemplar state and carry (teacher-forced; bounds in
    the module docstring). The exemplar preparation itself: the fp32
    ref_lab_small within 1e-3, the bf16 values exact."""
    jp16, jp32, models, _ = weights
    ref, *frames = textured_frames(1, 3)
    rl16, st16 = jvideo._device_ref_features(jp16, jnp.asarray(ref),
                                             compute_dtype="bfloat16")
    rl32, st32 = jvideo._device_ref_features(jp32, jnp.asarray(ref))
    t_rl, t_st = tvideo._device_ref_features(models, torch.from_numpy(ref),
                                             torch.bfloat16)
    assert t_rl.dtype == torch.float32 and t_st["phi"].dtype == torch.bfloat16
    np.testing.assert_allclose(t_rl.numpy(), np.asarray(rl16), atol=1e-3)
    np.testing.assert_array_equal(_f32(t_st["values"]), _f32(st16["values"]))
    shared = {k: _tb(_f32(st16[k])) for k in ("phi", "values")}
    last = jnp.zeros_like(rl16)
    for rgb in frames:
        want, want_last = jvideo._device_frame_step(
            jp16, jnp.asarray(rgb), last, rl16, st16, temperature=temperature,
            wls=True, use_pallas=False, compute_dtype="bfloat16")
        base, base_last = jvideo._device_frame_step(
            jp32, jnp.asarray(rgb), last, rl32, st32, temperature=temperature,
            wls=True, use_pallas=False)
        got, got_last = tvideo.frame_step(
            models, torch.from_numpy(rgb), torch.from_numpy(np.array(last)),
            shared, temperature=temperature, compute_dtype=torch.bfloat16)
        assert got.dtype == torch.uint8 and got.shape == (*HW, 3)
        assert got_last.dtype == torch.float32
        np.testing.assert_allclose(got_last[..., 0].numpy(),
                                   np.asarray(want_last)[..., 0], atol=1e-3)
        diff = np.abs(got.numpy().astype(int) - np.asarray(want))
        gap = np.abs(np.asarray(base).astype(int) - np.asarray(want))
        if temperature == 1.0:
            ab, want_ab = got_last[..., 1:], np.asarray(want_last)[..., 1:]
            base_ab = np.asarray(base_last)[..., 1:]
            assert _rel_l2(ab, want_ab) <= 0.15
            assert _rel_l2(ab, want_ab) < _rel_l2(base_ab, want_ab)
            assert diff.max() <= 12
        else:
            assert (diff > 1).mean() <= (gap > 1).mean() + 0.05
        last = want_last  # teacher forcing


@pytest.fixture
def clip_dir(tmp_path):
    ref, *frames = textured_frames(7, 6)
    d = tmp_path / "clip"
    d.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(d / f"{i:03d}.png")
    ref_path = tmp_path / "ref.png"
    Image.fromarray(ref).save(ref_path)
    return d, ref_path


def _run_cli(clip, ref, out, *flags):
    """cli.colorize at 48x96 on the CPU; its frames (JPEG, q95) read
    back."""
    tcli.main(["--clip_path", str(clip), "--ref_path", str(ref),
               "--output_path", str(out), "--image_size", *map(str, HW),
               "--random_init", "--device", "cpu", "--no_video", *flags])
    d = out / "clip_ref"
    return [np.asarray(Image.open(d / n)) for n in sorted(
        p.name for p in d.iterdir())]


def test_cli_bf16_scan_equals_stream(clip_dir, tmp_path):
    """`cli.colorize --bf16 --device cpu`: 5 frames in stream mode and in
    scan mode (chunk 2, a tail chunk of one) give identical frames, and
    they are not fp32's frames."""
    clip, ref = clip_dir
    stream = _run_cli(clip, ref, tmp_path / "s", "--bf16")
    scan = _run_cli(clip, ref, tmp_path / "c", "--bf16", "--mode", "scan",
                    "--chunk", "2")
    fp32 = _run_cli(clip, ref, tmp_path / "f")
    assert len(stream) == len(scan) == 5
    for a, b in zip(stream, scan):
        np.testing.assert_array_equal(a, b)
    assert any(np.abs(a.astype(int) - b).max() > 1
               for a, b in zip(stream, fp32))


def test_cli_bf16_composes_with_video_device_resize_frame_propagate(
        tmp_path):
    """--bf16 with a video file at twice the target size, --device_resize
    and --frame_propagate: scan gives stream's frames bit for bit, and the
    CLI's frames are the JPEGs (q95, as the CLI saves them) of
    colorize_frames in bf16 on the decoded frames, bit for bit."""
    cv2 = pytest.importorskip("cv2")
    frames = textured_frames(8, 4, (96, 192))
    clip = tmp_path / "clip.avi"
    wr = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"DIVX"), 24,
                         (192, 96))
    for f in frames:
        wr.write(f[..., ::-1])
    wr.release()
    ref = tmp_path / "ref.png"
    Image.fromarray(frames[0]).save(ref)
    flags = ("--bf16", "--device_resize", "--frame_propagate")
    stream = _run_cli(clip, ref, tmp_path / "s", *flags)
    scan = _run_cli(clip, ref, tmp_path / "c", *flags, "--mode", "scan",
                    "--chunk", "3")
    assert len(stream) == len(scan) == 4
    for a, b in zip(stream, scan):
        np.testing.assert_array_equal(a, b)

    from devc_tpu_torch.data.transforms import centerpad_np
    from devc_tpu_torch.ops.device_resize import centerpad_plan
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy as sdn

    models = PipelineModels.from_state_dicts(sdn(host_pipeline_params(0)),
                                             "cpu", dtype=torch.bfloat16)
    decoded = list(tvideo._video_frames_rgb(str(clip)))
    want = []
    tvideo.colorize_frames(models, decoded, centerpad_np(decoded[0], HW),
                           lambda i, a: want.append(a), frame_propagate=True,
                           resize_plan=centerpad_plan((96, 192), HW),
                           compute_dtype=torch.bfloat16)
    for a, b in zip(stream, want):
        buf = io.BytesIO()
        Image.fromarray(b).save(buf, format="JPEG", quality=95)
        np.testing.assert_array_equal(a, np.asarray(Image.open(buf)))


def test_bf16_batched_exemplars_compute_in_fp32_as_devc_tpu(weights):
    """devc_tpu runs several exemplars (colorize_video_multi) with bf16
    params but no compute_dtype: its conv2d casts the bf16 weights to the
    fp32 activations, so it computes in fp32 with bf16-rounded weights:
    the step of fp32 params holding those values, to fp32 round-off (phi
    within 1e-5, uint8 within 1; XLA compiles the casts into another
    program). The port does the same, bit for bit (its layers cast their
    parameters to the input's dtype); one teacher-forced step at R = 3
    then holds against devc_tpu as test_torch_multi does in fp32
    (carry L 1e-3, ab 0.5, uint8 within 1)."""
    jp16, _, models, params = weights
    rounded = jax.tree.map(lambda x: np.asarray(x, np.float32),
                           jax.tree.map(lambda x: jnp.asarray(x, BF), params))
    jp_rounded = jax.tree.map(jnp.asarray, rounded)
    models_rounded = PipelineModels.from_state_dicts(
        state_dicts_from_numpy(rounded), "cpu")
    refs = np.stack(textured_frames(20, 3))
    rgb = textured_frames(21, 1)[0]
    rl, st = jvideo._device_ref_features_multi(jp16, jnp.asarray(refs))
    rl_r, st_r = jvideo._device_ref_features_multi(jp_rounded,
                                                   jnp.asarray(refs))
    assert st["phi"].dtype == jnp.float32
    # XLA compiles the casts into another program: fp32 round-off only
    np.testing.assert_allclose(np.asarray(st["phi"]), np.asarray(st_r["phi"]),
                               atol=1e-5)
    last = jnp.zeros_like(rl)
    kw = dict(temperature=1e-10, wls=True, use_pallas=False,
              unroll_refs=False)
    want, want_last = jvideo._device_frame_step_multi(
        jp16, jnp.asarray(rgb), last, rl, st, **kw)
    want_r, _ = jvideo._device_frame_step_multi(
        jp_rounded, jnp.asarray(rgb), last, rl_r, st_r, **kw)
    assert np.abs(np.asarray(want).astype(int)
                  - np.asarray(want_r)).max() <= 1

    _, t_st = tvideo._device_ref_features_multi(models, torch.from_numpy(refs))
    _, t_st_r = tvideo._device_ref_features_multi(models_rounded,
                                                  torch.from_numpy(refs))
    assert t_st["phi"].dtype == torch.float32
    assert torch.equal(t_st["phi"], t_st_r["phi"])
    shared = {k: torch.from_numpy(np.array(st[k])) for k in ("phi",
                                                                "values")}
    got, got_last = tvideo.frame_step_multi(
        models, torch.from_numpy(rgb), torch.from_numpy(np.array(last)),
        shared, temperature=1e-10)
    got_r, _ = tvideo.frame_step_multi(
        models_rounded, torch.from_numpy(rgb),
        torch.from_numpy(np.array(last)), shared, temperature=1e-10)
    assert torch.equal(got, got_r)
    assert got.shape == (3, *HW, 3)
    np.testing.assert_allclose(got_last[..., 0].numpy(),
                               np.asarray(want_last)[..., 0], atol=1e-3)
    assert np.abs(got_last[..., 1:].numpy()
                  - np.asarray(want_last)[..., 1:]).max() < 0.5
    assert np.abs(got.numpy().astype(int) - np.asarray(want)).max() <= 1
