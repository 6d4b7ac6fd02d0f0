"""CUDA kernels K1 (fused correspondence), K2 (the smoother pass, one
image or a batch, and the general tridiagonal solve) and the
correspondence backward kernels K2b/K3 vs their plain PyTorch versions on
the card, the split convolution (ops/conv_split.py) against float64 and
cuDNN's fp32 call, and the serving path's device steps (captured
scan-mode replays against stream mode, the batched step against the CPU,
the device CenterPad against the host). Needs no JAX.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode) and is skipped without one. Run them on the card with
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q`
(tests/conftest.py imports JAX, which the GPU machine need not have).

Tolerances: sim is a max of fp32 dot products summed in another order
(1e-5). At T = 0.01 out is a softmax average of values in +-100 (1e-3).
At T = 1e-10 out is an exact argmax-average; a row whose two best scores
differ by less than the summation-order round-off may pick another key,
so a few rows per thousand may differ, and the rest must match. The
smoother pass is held to K2's bound, rtol 1e-4 with an atol of 1e-5 of
max|x| for entries that cross zero; the whole smoother (six passes) to
2e-3 on values of +-100, the bound of its CPU test. The
backward kernels are held to devc_tpu's own bound for its Pallas VJP
against einsum autodiff (tests/test_pallas_grad.py: atol 5e-3, rtol 1e-3),
against the gradients the plain versions give in float64 (`_bwd_float64`):
at T = 0.01 the backward turns a score's round-off d into d / T^2 in df,
so two fp32 versions whose scores are summed in different orders (the
kernels' 3xTF32 tensor-core sums, cuBLAS's fp32 product) differ by more
than that bound on a few rows, while the kernels lie within it of
float64, and no farther from it than the fp32 plain version
(`_assert_near_float64`); their inputs are random unit vectors, which
leave no exact ties.
K1's bf16 kernel is held to the same bounds against the plain version on
the same bf16 inputs (its bf16 products are exact in fp32; its scores
differ only in summation order), with out compared after its bf16
rounding, within one bf16 ulp (0.5 for |out| <= 100).
"""

import numpy as np
import pytest
import torch

from devc_tpu_torch.ops import cuda_corr
from devc_tpu_torch.ops import fgs
from devc_tpu_torch.ops.correspondence import (
    correspondence_bwd_plain,
    correspondence_fwd_plain,
    correspondence_warp,
    correspondence_warp_einsum,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _corr_inputs(b, nq, nk, c, device, seed=0):
    rng = np.random.RandomState(seed)
    theta = rng.randn(b, nq, c).astype(np.float32)
    theta /= np.linalg.norm(theta, axis=-1, keepdims=True)
    phi = rng.randn(b, nk, c).astype(np.float32)
    phi /= np.linalg.norm(phi, axis=-1, keepdims=True)
    values = (rng.rand(b, nk, 3).astype(np.float32) - 0.5) * 200
    return [torch.from_numpy(x).to(device) for x in (theta, phi, values)]


# (1, 5184) and (2, 200) split the keys across blocks; (8, 4096) has
# enough query tiles to run one key range over several tiles
@pytest.mark.parametrize("b,nq,nk", [(1, 5184, 5184), (2, 200, 312),
                                     (8, 4096, 300), (1, 33, 65), (1, 1, 1)])
@pytest.mark.parametrize("temperature", [0.01, 1e-10])
def test_corr_fwd_matches_plain(cuda, b, nq, nk, temperature):
    theta, phi, values = _corr_inputs(b, nq, nk, 256, cuda)
    before = cuda_corr.corr_fwd.launches
    out, sim, l = cuda_corr.corr_fwd(theta, phi, values, temperature,
                                     emit_l=True)
    torch.cuda.synchronize()
    assert cuda_corr.corr_fwd.launches == before + 1
    want_out, want_sim = correspondence_warp_einsum(theta, phi, values,
                                                    temperature)
    torch.testing.assert_close(sim, want_sim, rtol=0, atol=1e-5)
    # l = sum_k exp((s - m) / T) >= 1 (the max contributes 1)
    assert bool((l >= 1.0).all())
    if temperature == 0.01:
        torch.testing.assert_close(out, want_out, rtol=0, atol=1e-3)
    else:
        bad = (out - want_out).abs().amax(dim=-1) > 1e-3
        assert bad.float().mean().item() <= 1e-3


# N not a multiple of the 128-row / 128-key tiles; C = 32 and 64 (one and
# two channel chunks per key tile); B > 1; C = 512 (above the resident
# query tile's limit of 320: the queries stream through the ring too)
@pytest.mark.parametrize("b,nq,nk,c", [(1, 1000, 1000, 32), (3, 130, 4500, 64),
                                       (2, 257, 129, 256), (4, 129, 5184, 64),
                                       (2, 300, 700, 512), (1, 5183, 5185, 256)])
@pytest.mark.parametrize("temperature", [0.01, 1e-10])
def test_corr_fwd_channels_batches_ragged(cuda, b, nq, nk, c, temperature):
    theta, phi, values = _corr_inputs(b, nq, nk, c, cuda)
    out, sim, l = cuda_corr.corr_fwd(theta, phi, values, temperature,
                                     emit_l=True)
    torch.cuda.synchronize()
    want_out, want_sim = correspondence_warp_einsum(theta, phi, values,
                                                    temperature)
    torch.testing.assert_close(sim, want_sim, rtol=0, atol=1e-5)
    assert bool((l >= 1.0).all())
    if temperature == 0.01:
        torch.testing.assert_close(out, want_out, rtol=0, atol=1e-3)
    else:
        bad = (out - want_out).abs().amax(dim=-1) > 1e-3
        assert bad.float().mean().item() <= 1e-3


@pytest.mark.parametrize("b,nq", [(1, 4), (8, 4096)])
def test_corr_fwd_ties_average(cuda, b, nq):
    """Two exact maxima in different key tiles: in two key ranges merged
    by the combine (1, 4), or in one range's online softmax (8, 4096)."""
    theta, phi, values = _corr_inputs(b, nq, 200, 256, cuda, seed=1)
    phi[0, 5] = theta[0, 0]
    phi[0, 150] = theta[0, 0]
    out, _, l = cuda_corr.corr_fwd(theta, phi, values, 1e-10, emit_l=True)
    torch.testing.assert_close(out[0, 0], (values[0, 5] + values[0, 150]) / 2)
    assert l[0, 0, 0].item() == 2.0


@pytest.mark.parametrize("b,nq,nk,c", [(1, 5184, 5184, 256),
                                       (2, 300, 700, 512), (3, 130, 4500, 96)])
@pytest.mark.parametrize("temperature", [0.01, 1e-10])
def test_corr_fwd_run_to_run_bit_equal(cuda, b, nq, nk, c, temperature):
    """No atomics and a fixed merge order: two runs give the same bits."""
    theta, phi, values = _corr_inputs(b, nq, nk, c, cuda, seed=2)
    first = cuda_corr.corr_fwd(theta, phi, values, temperature, emit_l=True)
    second = cuda_corr.corr_fwd(theta, phi, values, temperature, emit_l=True)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# the training shape, and ragged N at C = 96 and 512
@pytest.mark.parametrize("b,nq,nk,c", [(16, 5184, 5184, 256),
                                       (2, 130, 4500, 96), (1, 300, 520, 512)])
def test_corr_fwd_sim_is_the_row_max_k3_finds(cuda, b, nq, nk, c):
    """K1's sim equals, bit for bit, the row max of the scores K3
    recomputes. K3 at T = 1e-10 with d_out = 0 and d_sim = 1 writes df =
    attn (0 - 0) / T + 1[s == m]: a score of K3's above m would give attn
    = exp(+large) = inf and df = NaN there, and a row whose m K3 never
    reaches would have no 1. So df is all 0 and 1, with a 1 in every
    valid row."""
    theta, phi, values = _corr_inputs(b, nq, nk, c, cuda, seed=3)
    _, sim, l = cuda_corr.corr_fwd(theta, phi, values, 1e-10, emit_l=True)
    zeros = torch.zeros_like(sim)
    df = torch.empty((b, cuda_corr.padded(nq), cuda_corr.padded(nk)),
                     device=cuda)
    cuda_corr.corr_bwd_dkv(theta, phi, values, sim, l, zeros,
                           torch.ones_like(sim), torch.zeros(b, nq, 3,
                                                             device=cuda),
                           1e-10, df)
    valid = df[:, :nq, :nk]
    assert bool(((valid == 0) | (valid == 1)).all())
    assert bool((valid.sum(-1) >= 1).all())


def test_corr_fwd_rejects_bad_inputs(cuda):
    theta, phi, values = _corr_inputs(1, 64, 64, 256, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_corr.corr_fwd(theta.transpose(1, 2).contiguous().transpose(1, 2),
                           phi, values, 0.01)
    with pytest.raises(TypeError, match="float32"):
        cuda_corr.corr_fwd(theta.double(), phi, values, 0.01)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_corr.corr_fwd(theta[..., :40].contiguous(),
                           phi[..., :40].contiguous(), values, 0.01)


# bf16 embeddings (the --bf16 mode) run csrc/corr_fwd_bf16.cu, whose scores
# are bf16 tensor-core products: ragged N (33 x 65, 1000, 4500), C = 32 and
# 320 (a last half atom of 32 channels), 64 and 256 (the query tile
# resident), 512 and 1024 (the query tile streamed through the ring),
# B > 1
@pytest.mark.parametrize("b,nq,nk,c", [(1, 5184, 5184, 256), (2, 200, 312, 64),
                                       (1, 33, 65, 320), (1, 130, 4500, 512),
                                       (1, 1000, 1000, 32),
                                       (2, 300, 700, 1024)])
@pytest.mark.parametrize("temperature", [0.01, 1.0, 1e-10])
def test_corr_fwd_bf16_matches_plain(cuda, b, nq, nk, c, temperature):
    """The bf16 kernel against the plain version on the same bf16 inputs
    (widened to fp32; the scores there are fp32 matrix products). Its
    bf16 x bf16 products are exact in fp32, so its scores differ from the
    plain ones only in summation order: sim within 1e-5, l within 1e-5
    relative of the plain version in float64 (the fp32 one carries its
    own round-off, which 1 / T amplifies at T = 0.01), and out, after its
    bf16 rounding, within one bf16 ulp of |out| <= 100 (0.5, plus 1e-3)
    on every row at T = 0.01 and 1. At T = 1e-10 out is an exact
    argmax-average, and a row whose two best scores are closer than the
    summation-order round-off may pick another key: at most 3e-3 of rows
    may differ in these small shapes."""
    theta, phi, values = (x.bfloat16() for x in
                          _corr_inputs(b, nq, nk, c, cuda))
    before = cuda_corr.corr_fwd.bf16_launches
    out, sim, l = cuda_corr.corr_fwd(theta, phi, values, temperature,
                                     emit_l=True)
    torch.cuda.synchronize()
    assert cuda_corr.corr_fwd.bf16_launches == before + 1
    assert out.dtype == torch.bfloat16 and sim.dtype == l.dtype == torch.float32
    plain_out, plain_sim = correspondence_warp_einsum(theta, phi, values,
                                                      temperature)
    _, _, plain_l = correspondence_fwd_plain(
        theta.double(), phi.double(), values.double(), temperature)
    assert plain_out.dtype == torch.bfloat16
    torch.testing.assert_close(sim, plain_sim, rtol=0, atol=1e-5)
    row_err = (out.float() - plain_out.float()).abs().amax(dim=-1)
    if temperature == 1e-10:
        flipped = row_err > 0.5 + 1e-3
        assert flipped.float().mean().item() <= 3e-3
        keep = ~flipped[..., None]
        torch.testing.assert_close(l.double()[keep], plain_l[keep],
                                   rtol=1e-5, atol=0)
    else:
        assert row_err.max().item() <= 0.5 + 1e-3
        torch.testing.assert_close(l.double(), plain_l, rtol=1e-5, atol=0)


# a key duplicated, so that the row's maximum is an exact tie: in one
# tile, in two tiles of one key range, in two key ranges merged by the
# combine (N = 5184 splits the keys)
@pytest.mark.parametrize("nk,k1,k2", [(200, 5, 6), (300, 7, 250),
                                      (5184, 5, 5000)])
def test_corr_fwd_bf16_exact_tie_is_mean(cuda, nk, k1, k2):
    theta, phi, values = (x.bfloat16() for x in
                          _corr_inputs(1, 64, nk, 256, cuda, seed=1))
    phi[0, k1] = theta[0, 0]
    phi[0, k2] = theta[0, 0]
    out, _, l = cuda_corr.corr_fwd(theta, phi, values, 1e-10, emit_l=True)
    want = ((values[0, k1].float() + values[0, k2].float()) / 2).bfloat16()
    assert torch.equal(out[0, 0], want)
    assert l[0, 0, 0].item() == 2.0


@pytest.mark.parametrize("b,nq,nk,c", [(1, 5184, 5184, 256),
                                       (2, 300, 700, 1024)])
@pytest.mark.parametrize("temperature", [0.01, 1e-10])
def test_corr_fwd_bf16_run_to_run_bit_equal(cuda, b, nq, nk, c, temperature):
    """No atomics and a fixed merge order: two runs give the same bits."""
    theta, phi, values = (x.bfloat16() for x in
                          _corr_inputs(b, nq, nk, c, cuda, seed=2))
    first = cuda_corr.corr_fwd(theta, phi, values, temperature, emit_l=True)
    second = cuda_corr.corr_fwd(theta, phi, values, temperature, emit_l=True)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_corr_fwd_bf16_plan_matches_kernel(cuda):
    """The launch plan (ops/cuda_corr.py::bf16_plan, tested on the CPU)
    and the built kernel agree on the form and shared memory at every
    width."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for c in (32, 64, 96, 256, 288, 320, 352, 512, 1024, 2048):
        plan = cuda_corr.bf16_plan(1, 5184, 5184, c, sms)
        assert cuda_corr.bf16_kernel_form(c) == (plan.resident,
                                                 plan.smem_bytes), c


def test_split_tf32_rounds_to_nearest_ties_away(cuda):
    """The score rule's pre-pass (K1 fp32 and K3 run it on theta and phi)
    gives hi = tf32(x), lo = tf32(x - hi), rounded to nearest with ties
    away from zero, bit for bit: the 13 low bits are cut after adding half
    their range to the magnitude."""
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 70, 96) * 10.0 ** rng.randint(
        -30, 30, size=(3, 70, 1))).astype(np.float32)
    bits = x.view(np.int32)
    bits[0, :5] = (bits[0, :5] & ~0x1FFF) | 0x1000  # exact ties
    x = torch.from_numpy(x).to(cuda)

    def tf32(v):
        return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = tf32(x)
    got = cuda_corr.split_tf32(x)
    assert got.shape == (3, 70, 192)
    assert torch.equal(got[..., :96], hi)
    assert torch.equal(got[..., 96:], tf32(x - hi))


def test_corr_fwd_fp32_plan_matches_kernel(cuda):
    """The fp32 kernel's launch plan (ops/cuda_corr.py::fp32_plan, tested on
    the CPU) and the built kernel agree on the shared memory, the same at
    every width."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for c in (32, 96, 256, 512, 1024):
        plan = cuda_corr.fp32_plan(1, 5184, 5184, c, sms)
        assert cuda_corr.fp32_kernel_smem() == plan.smem_bytes, c


def test_corr_fwd_bf16_refuses_mixed_dtypes_and_grad(cuda):
    theta, phi, values = _corr_inputs(1, 64, 64, 256, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_corr.corr_fwd(theta.bfloat16(), phi, values, 0.01)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_corr.corr_fwd(theta.bfloat16(), phi.bfloat16(), values, 0.01)
    with pytest.raises(TypeError, match="fp32 only"):
        cuda_corr.CorrFunction.apply(theta.bfloat16(), phi.bfloat16(),
                                     values.bfloat16(), 0.01)


def _systems(length, n_sys, device, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(n_sys, length).astype(np.float32) * 0.45
    c = rng.rand(n_sys, length).astype(np.float32) * 0.45
    b = 1.0 + rng.rand(n_sys, length).astype(np.float32)
    a[:, 0] = 0
    c[:, -1] = 0
    d = rng.randn(n_sys, length).astype(np.float32) * 50
    return [torch.from_numpy(x).to(device) for x in (a, b, c, d)]


@pytest.mark.parametrize("length,n_sys", [(768, 864), (432, 1536),
                                          (1536, 1728), (1, 3), (257, 5),
                                          (4096, 3)])
def test_tridiag_pcr_matches_plain(cuda, length, n_sys):
    a, b, c, d = _systems(length, n_sys, cuda)
    before = fgs.tridiag_pcr.launches
    x = fgs.tridiag_pcr(a, b, c, d)
    torch.cuda.synchronize()
    assert fgs.tridiag_pcr.launches == before + 1
    for plain in (fgs._tridiag_pcr, fgs._tridiag_thomas):
        want = plain(a, b, c, d)
        torch.testing.assert_close(x, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


def _frame(hw, device, seed=0):
    """ab-like src in +-100 and a uint8-truncated guide with an edge."""
    rng = np.random.RandomState(seed)
    src = ((rng.rand(*hw, 2) - 0.5) * 200).astype(np.float32)
    guide = np.floor(rng.rand(*hw) * 256).astype(np.float32)
    guide[:, hw[1] // 2:] = np.floor(guide[:, hw[1] // 2:] / 8)
    return [torch.from_numpy(x).to(device) for x in (src, guide)]


# the two reference resolutions and an odd size, both axes
@pytest.mark.parametrize("hw", [(432, 768), (864, 1536), (37, 70)])
@pytest.mark.parametrize("axis", [0, 1])
def test_smooth_pass_matches_plain(cuda, hw, axis):
    src, guide = _frame(hw, cuda)
    lam = 1.5 * 500.0 * 16.0 / 63.0  # the smoother's first, largest lambda
    before = fgs.smooth_pass.launches
    x = fgs.smooth_pass(src, guide, lam, 4.0, axis)
    torch.cuda.synchronize()
    assert fgs.smooth_pass.launches == before + 1
    want = fgs.smooth_pass_plain(src, guide, lam, 4.0, axis)
    assert x.shape == want.shape and x.is_contiguous()
    torch.testing.assert_close(x, want, rtol=1e-4,
                               atol=1e-5 * want.abs().max().item())


def test_fast_global_smoother_on_card(cuda):
    """Six launches of the fused pass and no general solve; the result
    against the plain smoother on the same inputs."""
    src, guide = _frame((432, 768), cuda, seed=1)
    before = (fgs.smooth_pass.launches, fgs.tridiag_pcr.launches)
    got = fgs.fast_global_smoother(src, guide)
    torch.cuda.synchronize()
    assert (fgs.smooth_pass.launches - before[0],
            fgs.tridiag_pcr.launches - before[1]) == (6, 0)
    want = fgs.fast_global_smoother(src.cpu(), guide.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-3)


def test_frame_step_on_card_matches_cpu(cuda):
    """The device step on the card (K1 once, K2's smoother pass six times)
    against the same step on the CPU (plain versions), same weights and
    inputs."""
    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    sds = state_dicts_from_numpy(host_pipeline_params(0))
    rng = np.random.RandomState(0)
    ref = (rng.rand(64, 128, 3) * 255).astype(np.uint8)
    rgb = (rng.rand(64, 128, 3) * 255).astype(np.uint8)
    outs = {}
    for dev in ("cpu", "cuda"):
        models = PipelineModels.from_state_dicts(sds, dev)
        _, state = video._device_ref_features(
            models, torch.from_numpy(ref).to(dev))
        last = torch.zeros((1, 32, 64, 3), device=dev)
        k1, k2 = cuda_corr.corr_fwd.launches, fgs.smooth_pass.launches
        out, new_last = video.frame_step(
            models, torch.from_numpy(rgb).to(dev), last, state,
            temperature=0.01)
        launched = (cuda_corr.corr_fwd.launches - k1,
                    fgs.smooth_pass.launches - k2)
        assert launched == ((1, 6) if dev == "cuda" else (0, 0))
        outs[dev] = (out.cpu().numpy().astype(int), new_last.cpu().numpy())
    assert np.abs(outs["cuda"][1] - outs["cpu"][1]).max() < 0.5
    assert np.abs(outs["cuda"][0] - outs["cpu"][0]).max() <= 2


def test_frame_on_card_matches_golden(cuda):
    """devc_tpu's frozen golden frame (tests/golden_frame.npz, made with
    host_pipeline_params(0) on a CPU) through the port on the card, at
    tests/test_golden.py's tolerances."""
    import os

    from devc_tpu_torch.pipeline import frame
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import use_full_fp32
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    use_full_fp32()
    data = np.load(os.path.join(os.path.dirname(__file__), "golden_frame.npz"))
    models = PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), cuda)
    before = cuda_corr.corr_fwd.launches
    with torch.inference_mode():
        state = frame.prepare_reference(
            models, torch.from_numpy(data["b_lab"]).to(cuda))
        a_lab = torch.from_numpy(data["a_lab"]).to(cuda)
        pred_ab, warped, sim = frame.frame_colorization(
            models, a_lab, torch.zeros_like(a_lab), state, 1e-10)
    assert cuda_corr.corr_fwd.launches == before + 1
    np.testing.assert_allclose(sim.cpu().numpy(), data["sim"], atol=1e-3)
    np.testing.assert_allclose(warped.cpu().numpy(), data["warped"], atol=5e-2)
    np.testing.assert_allclose(pred_ab.cpu().numpy(), data["pred_ab"],
                               atol=5e-2)


def _bwd_float64(theta, phi, values, d_out, d_sim, temperature):
    """The correspondence's gradients (dtheta, dphi, dvalues) at these
    inputs, computed in float64 by the plain versions (forward, then
    backward on its own residuals)."""
    x = [t.double() for t in (theta, phi, values, d_out, d_sim)]
    out, sim, l = correspondence_fwd_plain(x[0], x[1], x[2], temperature)
    return correspondence_bwd_plain(x[0], x[1], x[2], sim, l, out, x[3], x[4],
                                    temperature)


def _assert_near_float64(got, want, plain32):
    """Each gradient within devc_tpu's bound of the float64 one, and no
    farther from it than the fp32 plain version's (`plain32`)."""
    for name, g, w, p in zip(("dtheta", "dphi", "dvalues"), got, want,
                             plain32):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g.double(), w, atol=5e-3, rtol=1e-3,
                                   msg=name)
        err, err32 = ((x.double() - w).abs().max().item() for x in (g, p))
        assert err <= err32, (name, err, err32)


def _bwd_case(b, nq, nk, c, device, seed=0):
    """K1's residuals and random cotangents for a backward call."""
    theta, phi, values = _corr_inputs(b, nq, nk, c, device, seed)
    values = values / 2  # Lab-like payload in +-50, as test_pallas_grad.py
    out, sim, l = cuda_corr.corr_fwd(theta, phi, values, 0.01, emit_l=True)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    d_out = torch.randn(b, nq, 3, generator=gen).to(device)
    d_sim = torch.randn(b, nq, 1, generator=gen).to(device)
    return theta, phi, values, sim, l, out, d_out, d_sim


# aligned, ragged (both sides, tiles of 128), batched, one sample at the
# training N (the reductions split across blocks), C = 64, and C = 32, 96
# and 512 at ragged N (a last 32-channel chunk; 512 streams the key tile
# through the ring)
@pytest.mark.parametrize("b,nq,nk,c", [(1, 256, 256, 256), (1, 200, 312, 256),
                                       (3, 130, 70, 256), (1, 5184, 5184, 256),
                                       (2, 33, 65, 64), (1, 1, 1, 256),
                                       (1, 1000, 1000, 32), (2, 130, 4500, 96),
                                       (1, 300, 520, 512)])
def test_corr_bwd_matches_plain(cuda, b, nq, nk, c):
    args = _bwd_case(b, nq, nk, c, cuda)
    dq, dkv = cuda_corr.corr_bwd_dq.launches, cuda_corr.corr_bwd_dkv.launches
    got = cuda_corr.corr_bwd(*args, 0.01)
    torch.cuda.synchronize()
    assert (cuda_corr.corr_bwd_dq.launches, cuda_corr.corr_bwd_dkv.launches) \
        == (dq + 1, dkv + 1)
    theta, phi, values, _, _, _, d_out, d_sim = args
    want = _bwd_float64(theta, phi, values, d_out, d_sim, 0.01)
    _assert_near_float64(got, want, correspondence_bwd_plain(*args, 0.01))


@pytest.mark.parametrize("b,nq,nk,c", [(2, 200, 312, 256), (1, 5184, 5184, 256),
                                       (2, 130, 4500, 96)])
def test_corr_bwd_is_deterministic(cuda, b, nq, nk, c):
    """Two calls on the same inputs give bit-equal outputs: no atomics,
    split reductions merged in split order."""
    args = _bwd_case(b, nq, nk, c, cuda)
    first = cuda_corr.corr_bwd(*args, 0.01)
    second = cuda_corr.corr_bwd(*args, 0.01)
    for name, x, y in zip(("dtheta", "dphi", "dvalues"), first, second):
        assert torch.equal(x, y), name


def test_corr_bwd_in_batch_chunks(cuda):
    """A scratch budget of two samples runs a batch of 5 in three chunks:
    one launch count per backward, the same bits as one chunk, and the
    plain version's gradients."""
    b, nq, nk, c = 5, 300, 200, 64
    args = _bwd_case(b, nq, nk, c, cuda)
    budget = 2 * cuda_corr.df_scratch_bytes(nq, nk)
    assert len(cuda_corr.plan_batch_chunks(b, nq, nk, budget)) == 3
    dq, dkv = cuda_corr.corr_bwd_dq.launches, cuda_corr.corr_bwd_dkv.launches
    chunked = cuda_corr.corr_bwd(*args, 0.01, scratch_budget=budget)
    assert (cuda_corr.corr_bwd_dq.launches, cuda_corr.corr_bwd_dkv.launches) \
        == (dq + 1, dkv + 1)
    whole = cuda_corr.corr_bwd(*args, 0.01)
    theta, phi, values, _, _, _, d_out, d_sim = args
    want = _bwd_float64(theta, phi, values, d_out, d_sim, 0.01)
    for name, x, y in zip(("dtheta", "dphi", "dvalues"), chunked, whole):
        assert torch.equal(x, y), name
    _assert_near_float64(chunked, want, correspondence_bwd_plain(*args, 0.01))


def test_corr_bwd_kernels_alone(cuda):
    """The two wrappers called one after the other, as corr_bwd does for
    one chunk: K3 writes df (zero outside the valid rows and keys), K2b
    reads it."""
    b, nq, nk, c = 2, 200, 130, 96
    theta, phi, values, sim, l, out, d_out, d_sim = _bwd_case(b, nq, nk, c,
                                                              cuda)
    dd = (d_out * out).sum(dim=-1, keepdim=True)
    df = torch.full((b, cuda_corr.padded(nq), cuda_corr.padded(nk)), 7.0,
                    device=cuda)
    dphi, dvalues = cuda_corr.corr_bwd_dkv(theta, phi, values, sim, l, dd,
                                           d_sim, d_out, 0.01, df)
    dtheta = cuda_corr.corr_bwd_dq(df, phi, nq)
    torch.cuda.synchronize()
    assert not df[:, nq:].any() and not df[:, :, nk:].any()
    want = _bwd_float64(theta, phi, values, d_out, d_sim, 0.01)
    _assert_near_float64((dtheta, dphi, dvalues), want,
                         correspondence_bwd_plain(theta, phi, values, sim, l,
                                                  out, d_out, d_sim, 0.01))


@pytest.mark.parametrize("b,n", [(1, 5184), (2, 300)])
def test_corr_bwd_routes_dsim_to_the_row_max(cuda, b, n):
    """With d_out = 0 and d_sim = 1, df is 1 exactly where the recomputed
    score equals K1's saved max: dtheta_i = phi at row i's argmax and dphi_k
    = the sum of theta over the rows whose argmax is k. A score formed in
    another order than K1's would miss the max and leave zeros."""
    theta, phi, values, sim, l, out, _, _ = _bwd_case(b, n, n, 256, cuda)
    d_out = torch.zeros_like(out)
    d_sim = torch.ones_like(sim)
    dtheta, dphi, _ = cuda_corr.corr_bwd(theta, phi, values, sim, l, out,
                                         d_out, d_sim, 0.01)
    arg = torch.bmm(theta, phi.transpose(1, 2)).argmax(dim=-1)  # [B, N]
    want_dtheta = torch.gather(phi, 1, arg[..., None].expand(-1, -1, 256))
    assert (dtheta - want_dtheta).abs().amax().item() <= 1e-6
    want_dphi = torch.zeros_like(phi)
    for i in range(b):
        want_dphi[i].index_add_(0, arg[i], theta[i])
    torch.testing.assert_close(dphi, want_dphi, atol=1e-5, rtol=1e-5)


def test_correspondence_warp_is_differentiable_on_card(cuda):
    """Under autograd the dispatch goes through CorrFunction: outputs carry
    a grad_fn, the backward launches K2b and K3 once each, and the
    gradients match autograd of the plain version in float64 (and lie no
    farther from it than autograd of the plain version in fp32)."""
    theta, phi, values = _corr_inputs(2, 200, 312, 256, cuda)
    values = values / 2
    leaves = [t.clone().requires_grad_(True) for t in (theta, phi, values)]
    out, sim = correspondence_warp(*leaves, 0.01, differentiable=True)
    assert out.grad_fn is not None and sim.grad_fn is not None
    gen = torch.Generator(device="cpu").manual_seed(3)
    d_out = torch.randn(out.shape, generator=gen).to(cuda)
    d_sim = torch.randn(sim.shape, generator=gen).to(cuda)
    dq, dkv = cuda_corr.corr_bwd_dq.launches, cuda_corr.corr_bwd_dkv.launches
    got = torch.autograd.grad((out * d_out).sum() + (sim * d_sim).sum(), leaves)
    assert (cuda_corr.corr_bwd_dq.launches, cuda_corr.corr_bwd_dkv.launches) \
        == (dq + 1, dkv + 1)
    grads = []
    for dtype in (torch.float64, torch.float32):
        ref = [t.to(dtype, copy=True).requires_grad_(True)
               for t in (theta, phi, values)]
        w_out, w_sim = correspondence_warp_einsum(*ref, 0.01)
        grads.append(torch.autograd.grad(
            (w_out * d_out.to(dtype)).sum() + (w_sim * d_sim.to(dtype)).sum(),
            ref))
    _assert_near_float64(got, *grads)


def test_kernel_paths_refuse_inputs_that_need_grad(cuda):
    """corr_fwd's outputs have no grad_fn, so it raises on inputs that
    require grad; the dispatch raises too unless differentiable=True."""
    theta, phi, values = _corr_inputs(1, 64, 64, 256, cuda)
    theta.requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_corr.corr_fwd(theta, phi, values, 0.01)
    with pytest.raises(RuntimeError, match="differentiable=True"):
        correspondence_warp(theta, phi, values, 0.01)
    with torch.no_grad():
        out, _, _ = cuda_corr.corr_fwd(theta, phi, values, 0.01)
    assert out.grad_fn is None


# --- the serving path: K2 over a batch, captured steps, batched steps ---


@pytest.mark.parametrize("hw", [(432, 768), (37, 70)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("b,shared", [(4, False), (3, True)])
def test_smooth_pass_batched_matches_plain(cuda, hw, axis, b, shared):
    """One launch for the whole batch, per-image guides or one shared
    guide: against the batched plain pass at K2's bound, and each image
    bit-equal to the kernel's own call on that image alone."""
    pairs = [_frame(hw, cuda, seed=i) for i in range(b)]
    src = torch.stack([p[0] for p in pairs])
    guide = pairs[0][1] if shared else torch.stack([p[1] for p in pairs])
    lam = 1.5 * 500.0 * 16.0 / 63.0
    before = fgs.smooth_pass.launches
    x = fgs.smooth_pass(src, guide, lam, 4.0, axis)
    torch.cuda.synchronize()
    assert fgs.smooth_pass.launches == before + 1
    want = fgs.smooth_pass_plain(src, guide, lam, 4.0, axis)
    assert x.shape == want.shape == src.shape
    torch.testing.assert_close(x, want, rtol=1e-4,
                               atol=1e-5 * want.abs().max().item())
    for i in range(b):
        alone = fgs.smooth_pass(src[i], guide if shared else guide[i], lam,
                                4.0, axis)
        assert torch.equal(x[i], alone), i


def _models(device, dtype=None):
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    return PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), device, dtype)


def _textured(seed, n, hw):
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = field * 200 + 20 + rng.randn(h, w, 3) * 12
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("multi", [False, True])
def test_scan_replays_equal_stream(cuda, multi, monkeypatch):
    """Scan mode (one captured CUDA graph replayed per frame, chunk 2 over
    5 frames, so the tail chunk holds one) gives stream mode's frames bit
    for bit, one exemplar and three; one replay launches K1 once and K2
    six times."""
    from devc_tpu_torch.pipeline import graph, video

    models = _models(cuda)
    *refs, f0, f1, f2, f3, f4 = _textured(3, 8, (64, 128))
    frames = [f0, f1, f2, f3, f4]
    runners = []

    def capture(*args):
        runners.append(graph.CapturedStep(*args))
        return runners[-1]

    monkeypatch.setattr(video, "CapturedStep", capture)
    outs = {}
    for mode in ("stream", "scan"):
        got = []
        if multi:
            video.colorize_frames_multi(models, frames, np.stack(refs),
                                        lambda i, a: got.append(a),
                                        mode=mode, chunk=2)
        else:
            video.colorize_frames(models, frames, refs[0],
                                  lambda i, a: got.append(a), mode=mode,
                                  chunk=2)
        outs[mode] = got
    assert len(outs["scan"]) == len(outs["stream"]) == 5
    for a, b in zip(outs["stream"], outs["scan"]):
        assert np.array_equal(a, b)
    (runner,) = runners
    assert runner.replays == 5
    launches = dict(runner.kernel_launches)
    split = launches.pop("split_conv2d")
    assert split == _split_launches_a_frame(
        models, frames[0], refs if multi else refs[0], multi) > 0
    assert launches == {"corr_fwd": 1, "smooth_pass": 6, "tridiag_pcr": 0}


def _split_launches_a_frame(models, rgb, ref, multi):
    """The split convolution's launches in one eager frame step (after the
    exemplar's preparation)."""
    from devc_tpu_torch.ops import conv_split
    from devc_tpu_torch.pipeline import video

    dev = models.device
    rgb = torch.from_numpy(rgb).to(dev)
    h, w = rgb.shape[0] // 2, rgb.shape[1] // 2
    if multi:
        _, state = video._device_ref_features_multi(
            models, torch.from_numpy(np.stack(ref)).to(dev))
        step = video.frame_step_multi
    else:
        _, state = video._device_ref_features(models,
                                              torch.from_numpy(ref).to(dev))
        step = video.frame_step
    carry = torch.zeros((len(ref) if multi else 1, h, w, 3), device=dev)
    before = conv_split.split_conv2d.launches
    step(models, rgb, carry, state)
    return conv_split.split_conv2d.launches - before


def test_bf16_scan_replays_equal_stream(cuda, monkeypatch):
    """--bf16 (bf16 models, compute_dtype bf16): scan mode gives stream
    mode's frames bit for bit (chunk 2 over 5 frames); each replay
    launches K1's bf16 variant once."""
    from devc_tpu_torch.pipeline import graph, video

    models = _models(cuda, torch.bfloat16)
    ref, *frames = _textured(6, 6, (64, 128))
    runners = []

    def capture(*args):
        runners.append(graph.CapturedStep(*args))
        return runners[-1]

    monkeypatch.setattr(video, "CapturedStep", capture)
    outs = {}
    for mode in ("stream", "scan"):
        got = []
        video.colorize_frames(models, frames, ref,
                              lambda i, a: got.append(a), mode=mode,
                              chunk=2, compute_dtype=torch.bfloat16)
        outs[mode] = got
    assert len(outs["scan"]) == len(outs["stream"]) == 5
    for a, b in zip(outs["stream"], outs["scan"]):
        assert np.array_equal(a, b)
    (runner,) = runners
    assert runner.replays == 5
    # bf16 convolutions take the plain call
    assert runner.kernel_launches == {"corr_fwd": 1, "smooth_pass": 6,
                                      "tridiag_pcr": 0, "split_conv2d": 0}


def test_batched_frame_step_on_card_matches_cpu(cuda):
    """B = 3 clips in one step on the card (one K1 launch at batch 3, six
    K2 launches with a guide per clip) against the same step on the CPU,
    at the bounds of test_frame_step_on_card_matches_cpu."""
    from devc_tpu_torch.parallel import inference

    frames = np.stack(_textured(4, 3, (64, 128)))
    refs = np.stack(_textured(5, 3, (64, 128)))
    outs = {}
    for dev in ("cpu", "cuda"):
        models = _models(dev)
        _, state = inference.prepare_references_batched(
            models, torch.from_numpy(refs).to(dev))
        last = torch.zeros((3, 32, 64, 3), device=dev)
        k1, k2 = cuda_corr.corr_fwd.launches, fgs.smooth_pass.launches
        out, new_last = inference.batched_frame_step(
            models, torch.from_numpy(frames).to(dev), last, state,
            temperature=0.01)
        launched = (cuda_corr.corr_fwd.launches - k1,
                    fgs.smooth_pass.launches - k2)
        assert launched == ((1, 6) if dev == "cuda" else (0, 0))
        outs[dev] = (out.cpu().numpy().astype(int), new_last.cpu().numpy())
    assert np.abs(outs["cuda"][1] - outs["cpu"][1]).max() < 0.5
    assert np.abs(outs["cuda"][0] - outs["cpu"][0]).max() <= 2


def test_device_centerpad_on_card(cuda):
    """The CenterPad plan applied on the card (fp32, TF32 off) within one
    uint8 step of the host path, one frame and a batch of padded plans."""
    from devc_tpu_torch.data.transforms import centerpad_np
    from devc_tpu_torch.ops import device_resize as dr

    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (720, 1280, 3), dtype=np.uint8)
    want = centerpad_np(raw, (432, 768)).astype(int)
    a_h, a_w = (torch.from_numpy(a).to(cuda)
                for a in dr.centerpad_plan(raw.shape[:2], (432, 768)))
    got = dr.device_centerpad(torch.from_numpy(raw).to(cuda), a_h, a_w)
    diff = np.abs(got.cpu().numpy().astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    p_h, p_w = dr.centerpad_plan_padded(raw.shape[:2], (432, 768),
                                        (800, 1400))
    padded = np.zeros((2, 800, 1400, 3), np.uint8)
    padded[:, :720, :1280] = raw
    got = dr.device_centerpad_batched(
        torch.from_numpy(padded).to(cuda),
        torch.from_numpy(np.stack([p_h, p_h])).to(cuda),
        torch.from_numpy(np.stack([p_w, p_w])).to(cuda))
    for img in got.cpu().numpy():
        diff = np.abs(img.astype(int) - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02


# The split convolution (ops/conv_split.py, csrc/conv_split.cu, run by
# layers.Conv2d): every distinct convolution of VGG19, WarpNet and
# ColorVidNet at 432x768 (the exemplar's preparation and a frame;
# chip_conv_probe.py --split lists them with their counts): (c_in, c_out,
# k, stride, padding, dilation, input H, W).
NETWORK_CONV_SHAPES = (
    (3, 64, 3, 1, 1, 1, 216, 384), (7, 32, 3, 1, 1, 1, 216, 384),
    (32, 64, 3, 1, 1, 1, 216, 384), (64, 64, 3, 1, 1, 1, 216, 384),
    (64, 128, 3, 1, 1, 1, 108, 192), (64, 128, 3, 1, 1, 1, 216, 384),
    (128, 2, 1, 1, 0, 1, 216, 384), (128, 64, 3, 1, 0, 1, 56, 98),
    (128, 64, 3, 2, 0, 1, 110, 194), (128, 128, 3, 1, 0, 1, 110, 194),
    (128, 128, 3, 1, 1, 1, 108, 192), (128, 128, 3, 1, 1, 1, 216, 384),
    (128, 256, 3, 1, 1, 1, 54, 96), (256, 64, 3, 1, 0, 1, 28, 50),
    (256, 64, 3, 1, 0, 1, 29, 50), (256, 128, 3, 1, 0, 1, 56, 98),
    (256, 128, 3, 1, 1, 1, 108, 192), (256, 256, 1, 1, 0, 1, 54, 96),
    (256, 256, 3, 1, 0, 1, 56, 98), (256, 256, 3, 1, 1, 1, 54, 96),
    (256, 512, 3, 1, 1, 1, 27, 48), (512, 256, 3, 1, 0, 1, 15, 26),
    (512, 256, 3, 1, 0, 1, 29, 50), (512, 256, 3, 1, 1, 1, 54, 96),
    (512, 512, 3, 1, 1, 1, 13, 24), (512, 512, 3, 1, 1, 1, 27, 48),
    (512, 512, 3, 1, 2, 2, 27, 48),
)
# the bound of both fp32 convolutions against float64, over max |x|*|w|
# (the convolution of the magnitudes): a few ulps of fp32 over sums of
# up to 4608 terms
CONV_FP32_BOUND = 2.0 ** -17
# The two shapes where cuDNN's fp32 call takes an FFT algorithm
# (fft2d_r2c / c2r kernels, chip_conv_probe.py --split), which lands
# 3.3-3.8e-8 from float64 there, 6-9x nearer than its implicit GEMM does
# at every other shape; the split kernel lands 3.4-4.2e-8. There the split
# call is held to 2^-23 (1.2e-7) instead, below cuDNN's distance at every
# other shape (1.5-3.6e-7).
FFT_SHAPES = ((256, 64, 3, 1, 0, 1, 28, 50), (256, 64, 3, 1, 0, 1, 29, 50))


def _conv_case(shape, device, batch=1):
    """ReLU'd inputs and weights at the networks' scale for one shape."""
    cin, cout, k, stride, pad, dil, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(cin * 7 + cout + h)
    x = torch.randn(batch, cin, h, w, generator=gen).relu_().to(device)
    wt = (torch.randn(cout, cin, k, k, generator=gen)
          * (2.0 / (cin * k * k)) ** 0.5).to(device)
    b = (torch.randn(cout, generator=gen) * 0.1).to(device)
    return x, wt, b


def _launches_of(x, cout, k, stride, pad, dil):
    """The split convolution's kernel launches in one call on x: one, and
    the summing launch where the call's depth is split."""
    from devc_tpu_torch.ops import conv_split

    _, c, h, w = x.shape
    plan = conv_split.launch_plan(c, h, w, cout, k, stride, pad, dil,
                                  x.device)
    return 1 + (plan[2] > 1)


def _conv_module(wt, b, stride, pad, dil):
    from devc_tpu_torch.ops.layers import Conv2d

    cout, cin, k, _ = wt.shape
    conv = Conv2d(cin, cout, k, stride=stride, padding=pad, dilation=dil)
    with torch.no_grad():
        conv.weight.copy_(wt)
        conv.bias.copy_(b)
    return conv.to(wt.device).requires_grad_(False)


@pytest.mark.parametrize("shape", NETWORK_CONV_SHAPES)
def test_split_conv_near_float64(cuda, shape):
    """Each network convolution at 432x768 through layers.Conv2d under
    inference mode (batch 1): where the rule engages, one launch of the
    split kernel, within the fp32 bound of the float64 convolution and no
    farther from it than cuDNN's plain fp32 call (C15; see FFT_SHAPES for
    the two where that call is an FFT); where it does not
    (3 or 7 input channels, 2 outputs), cuDNN's call, bit for bit. The
    global TF32 flag stays off."""
    import torch.nn.functional as F

    from devc_tpu_torch.ops import conv_split
    from devc_tpu_torch.ops.layers import Conv2d

    cin, cout, k, stride, pad, dil, h, w = shape
    x, wt, b = _conv_case(shape, cuda)
    conv = _conv_module(wt, b, stride, pad, dil)
    args = (stride, pad, dil)
    with torch.inference_mode():
        calls = (Conv2d.split_calls, conv_split.split_conv2d.launches)
        got = conv(x)
        y32 = F.conv2d(x, wt, b, *args)
        torch.cuda.synchronize()
        engaged = Conv2d.split_calls - calls[0]
        assert conv_split.split_conv2d.launches - calls[1] == engaged * (
            _launches_of(x, cout, k, stride, pad, dil))
    assert not torch.backends.cudnn.allow_tf32
    assert engaged == conv_split.shape_rule(cin, cout, (k, k), (h, w))
    assert got.shape == y32.shape and got.is_contiguous()
    if not engaged:
        assert cin % 32 or cout < 16
        assert torch.equal(got, y32)
        return
    y64 = F.conv2d(x.double(), wt.double(), b.double(), *args)
    scale = F.conv2d(x.double().abs(), wt.double().abs(), None,
                     *args).amax().item()
    err32, err = ((y.double() - y64).abs().max().item() / scale
                  for y in (y32, got))
    print("conv", shape, "fp32", err32, "split", err)
    assert err32 <= CONV_FP32_BOUND and err <= CONV_FP32_BOUND, (err32, err)
    if shape in FFT_SHAPES:
        assert err <= 2.0 ** -23, err
    else:
        assert err <= err32, (err, err32)


# ragged pixel tiles and output channels (48: part of a 128-channel
# tile), stride 2, dilation 2, 1x1, a batch of 3
@pytest.mark.parametrize("shape", [(32, 48, 3, 1, 1, 1, 9, 13),
                                   (64, 200, 3, 2, 0, 1, 17, 11),
                                   (96, 16, 3, 1, 2, 2, 20, 7),
                                   (160, 130, 1, 1, 0, 1, 5, 3)])
def test_split_conv_batch_and_ragged(cuda, shape):
    """A batch of 3 is one call and each sample's output is its own
    batch-1 call's bits; ragged shapes lie within the fp32 bound of the
    float64 convolution; a second call gives the same bits."""
    import torch.nn.functional as F

    from devc_tpu_torch.ops import conv_split

    cin, cout, k, stride, pad, dil, h, w = shape
    x, wt, b = _conv_case(shape, cuda, batch=3)
    ws = conv_split.weight_split(wt)
    before = conv_split.split_conv2d.launches
    got = conv_split.split_conv2d(x, ws, b, stride, pad, dil, k)
    assert conv_split.split_conv2d.launches == before + _launches_of(
        x, cout, k, stride, pad, dil)
    again = conv_split.split_conv2d(x, ws, b, stride, pad, dil, k)
    assert torch.equal(got, again)
    for i in range(3):
        one = conv_split.split_conv2d(x[i:i + 1], ws, b, stride, pad, dil, k)
        assert torch.equal(got[i:i + 1], one)
    nobias = conv_split.split_conv2d(x, ws, None, stride, pad, dil, k)
    assert torch.equal(got, nobias + b.reshape(1, -1, 1, 1))
    args = (stride, pad, dil)
    y64 = F.conv2d(x.double(), wt.double(), b.double(), *args)
    scale = F.conv2d(x.double().abs(), wt.double().abs(), None,
                     *args).amax().item()
    assert (got.double() - y64).abs().max().item() <= CONV_FP32_BOUND * scale


def test_split_weight_is_the_score_rules_split(cuda):
    """The weight the kernel reads, split by the plain version on the
    card, is K1's pre-pass (cuda_corr.split_tf32) of the tap-major weight,
    bit for bit, and the plain version gives the same bits on the CPU."""
    from devc_tpu_torch.ops import conv_split

    x, wt, b = _conv_case((64, 48, 3, 1, 1, 1, 4, 4), cuda)
    got = conv_split.weight_split(wt)
    taps = wt.permute(2, 3, 0, 1).reshape(9, 48, 64).contiguous()
    assert torch.equal(got.view(torch.int32),
                       cuda_corr.split_tf32(taps).view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32),
                       conv_split.weight_split(wt.cpu()).view(torch.int32))


def _network_inputs(models, device):
    """The three networks' inputs at 432x768 from one textured frame and
    exemplar, made in fp32: (VGG19's gray RGB, the normalised taps for the
    query embedding, ColorVidNet's 7 channels)."""
    from devc_tpu_torch import colorspace as cs
    from devc_tpu_torch.models.vgg19 import vgg19_extract
    from devc_tpu_torch.models.warpnet import embed_queries, warp_with_keys
    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import FEATURE_TAPS

    ref, rgb = (torch.from_numpy(f).to(device)
                for f in _textured(9, 2, (432, 768)))
    with torch.inference_mode():
        _, state = video._device_ref_features(models, ref)
        _, lab_small = video._preprocess_device(rgb)
        a_l = lab_small[..., 0:1]
        gray = cs.gray_to_rgb(a_l)
        feats = vgg19_extract(models.vgg, gray, FEATURE_TAPS)
        taps = [cs.feature_normalize(f) for f in feats[1:]]
        theta = embed_queries(models.warpnet, taps)
        warped, sim = warp_with_keys(theta, state["phi"], state["values"],
                                     (a_l.shape[1], a_l.shape[2]), 1e-10)
        x = torch.cat([a_l, warped[..., 1:3], sim, lab_small], dim=-1)
    return gray, taps, x


def test_split_networks_near_float64(cuda, monkeypatch):
    """VGG19, the query embedding and ColorVidNet at 432x768, each on the
    same inputs: split (the rule as it is), plain fp32 (the rule off) and
    float64. Each split network's outputs lie within 1e-4 of the largest
    float64 output and no farther from float64 than the plain fp32
    network's (C15)."""
    import copy

    from devc_tpu_torch.models.colorvidnet import colorvidnet_apply
    from devc_tpu_torch.models.vgg19 import vgg19_extract
    from devc_tpu_torch.models.warpnet import embed_queries
    from devc_tpu_torch.ops import conv_split
    from devc_tpu_torch.ops.layers import Conv2d
    from devc_tpu_torch.pipeline.frame import FEATURE_TAPS

    models = _models(cuda)
    models64 = copy.deepcopy(models).double()
    gray, taps, x = _network_inputs(models, cuda)
    nets = {
        "vgg19": lambda m, d: vgg19_extract(m.vgg, gray.to(d), FEATURE_TAPS),
        "embed_queries": lambda m, d: [embed_queries(
            m.warpnet, [t.to(d) for t in taps])],
        "colorvidnet": lambda m, d: [colorvidnet_apply(m.colorvid, x.to(d))],
    }
    real_rule = conv_split.shape_rule
    for name, net in nets.items():
        with torch.inference_mode():
            want = net(models64, torch.float64)
            calls = Conv2d.split_calls
            split = net(models, torch.float32)
            assert Conv2d.split_calls > calls, name
            monkeypatch.setattr(conv_split, "shape_rule", lambda *a: False)
            calls = Conv2d.split_calls
            plain = net(models, torch.float32)
            assert Conv2d.split_calls == calls, name
            monkeypatch.setattr(conv_split, "shape_rule", real_rule)
        for i, (s, p, w) in enumerate(zip(split, plain, want)):
            scale = w.abs().max().item()
            err_s = (s.double() - w).abs().max().item() / scale
            err_p = (p.double() - w).abs().max().item() / scale
            print("network", name, i, "fp32", err_p, "split", err_s)
            assert err_s <= 1e-4, (name, i, err_s)
            assert err_s <= err_p, (name, i, err_s, err_p)


def test_split_calls_count_a_frame(cuda):
    """After one eager frame step at 432x768, `Conv2d.split_calls` has
    grown by the number of the frame's convolutions the rule engages (57
    of 60), `plain_calls` by the rest, and the kernel's launches by those
    calls and their summing launches."""
    from devc_tpu_torch.ops import conv_split
    from devc_tpu_torch.ops.layers import Conv2d
    from devc_tpu_torch.pipeline import video

    models = _models(cuda)
    ref, rgb = (torch.from_numpy(f).to(cuda)
                for f in _textured(5, 2, (432, 768)))
    _, state = video._device_ref_features(models, ref)
    engaged, total, launches = [], [], []

    def hook(m, inputs, out):
        x = inputs[0]
        total.append(1)
        engaged.append(m._engages(x))
        if engaged[-1]:
            launches.append(_launches_of(
                x, m.out_channels, m.kernel_size[0], m.stride[0],
                m.padding[0], m.dilation[0]))

    hooks = [m.register_forward_hook(hook) for m in models.modules()
             if isinstance(m, Conv2d)]
    before = (Conv2d.split_calls, Conv2d.plain_calls,
              conv_split.split_conv2d.launches)
    try:
        video.frame_step(models, rgb, torch.zeros((1, 216, 384, 3),
                                                  device=cuda), state)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    n = sum(engaged)
    assert len(total) == 60 and n == 57
    assert Conv2d.split_calls - before[0] == n
    assert Conv2d.plain_calls - before[1] == len(total) - n
    assert conv_split.split_conv2d.launches - before[2] == sum(launches)
    assert not torch.backends.cudnn.allow_tf32
