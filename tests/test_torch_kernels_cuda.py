"""CUDA kernels K1 (fused correspondence), K2 (the smoother pass, one
image or a batch, and the general tridiagonal solve) and the
correspondence backward kernels K2b/K3 vs their plain PyTorch versions on
the card, and the serving path's device steps (captured scan-mode replays
against stream mode, the batched step against the CPU, the device
CenterPad against the host). Needs no JAX.

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
against einsum autodiff (tests/test_pallas_grad.py: atol 5e-3, rtol 1e-3);
their inputs are random unit vectors, which leave no exact ties.
"""

import numpy as np
import pytest
import torch

from devc_tpu_torch.ops import cuda_corr
from devc_tpu_torch.ops import fgs
from devc_tpu_torch.ops.correspondence import (
    correspondence_bwd_plain,
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
    from devc_tpu_torch.pipeline.video import use_full_fp32
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
    want = correspondence_bwd_plain(*args, 0.01)
    for name, g, w in zip(("dtheta", "dphi", "dvalues"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=5e-3, rtol=1e-3, msg=name)


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
    want = correspondence_bwd_plain(*args, 0.01)
    for name, x, y, w in zip(("dtheta", "dphi", "dvalues"), chunked, whole,
                             want):
        assert torch.equal(x, y), name
        torch.testing.assert_close(x, w, atol=5e-3, rtol=1e-3, msg=name)


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
    want = correspondence_bwd_plain(theta, phi, values, sim, l, out, d_out,
                                    d_sim, 0.01)
    for name, g, w in zip(("dtheta", "dphi", "dvalues"),
                          (dtheta, dphi, dvalues), want):
        torch.testing.assert_close(g, w, atol=5e-3, rtol=1e-3, msg=name)


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
    gradients match autograd of the plain version."""
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
    ref = [t.clone().requires_grad_(True) for t in (theta, phi, values)]
    w_out, w_sim = correspondence_warp_einsum(*ref, 0.01)
    want = torch.autograd.grad((w_out * d_out).sum() + (w_sim * d_sim).sum(),
                               ref)
    for name, g, w in zip(("dtheta", "dphi", "dvalues"), got, want):
        torch.testing.assert_close(g, w, atol=5e-3, rtol=1e-3, msg=name)


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


def _models(device):
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    return PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), device)


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
    assert runner.kernel_launches == {"corr_fwd": 1, "smooth_pass": 6,
                                      "tridiag_pcr": 0}


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
