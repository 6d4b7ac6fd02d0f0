"""The port's correspondence gradient on CPU vs devc_tpu: the plain version
of the backward kernels (`correspondence_bwd_plain`) against devc_tpu's
Pallas backward in interpret mode, both against autograd of the einsum
path, and `CorrFunction`'s CPU route against devc_tpu's custom VJP.

Inputs are random unit vectors (no exact ties, ROADMAP C4) at T = 0.01,
with values in +-50 and random cotangents, as tests/test_pallas_grad.py.
Tolerance: that file's bound for devc_tpu's own VJP against einsum
autodiff, atol 5e-3 and rtol 1e-3 (gradients reach ~1e3: df carries 1/T).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu.ops.correspondence import correspondence_warp_einsum as j_einsum
from devc_tpu.ops.pallas_corr import _corr_pallas_bwd, correspondence_warp_pallas
from devc_tpu_torch.ops import cuda_corr
from devc_tpu_torch.ops.correspondence import (
    correspondence_bwd_plain,
    correspondence_fwd_plain,
    correspondence_warp,
    correspondence_warp_einsum,
)

T = 0.01
TOL = dict(atol=5e-3, rtol=1e-3)
# test_pallas_grad.py's shape, a ragged batch (neither side a multiple of
# the 128 tiles), C = 256, and C = 96 (not a multiple of 64: a last
# 32-channel chunk in the kernels)
SHAPES = [(1, 160, 224, 32), (2, 200, 130, 64), (1, 70, 90, 256),
          (2, 90, 150, 96)]


def _case(b, nq, nk, c, seed=0):
    rng = np.random.RandomState(seed)
    theta = rng.randn(b, nq, c).astype(np.float32)
    theta /= np.linalg.norm(theta, axis=-1, keepdims=True)
    phi = rng.randn(b, nk, c).astype(np.float32)
    phi /= np.linalg.norm(phi, axis=-1, keepdims=True)
    values = ((rng.rand(b, nk, 3) - 0.5) * 100).astype(np.float32)
    d_out = rng.randn(b, nq, 3).astype(np.float32)
    d_sim = rng.randn(b, nq, 1).astype(np.float32)
    return theta, phi, values, d_out, d_sim


def _torch_autograd(fn, theta, phi, values, d_out, d_sim):
    leaves = [torch.tensor(x, requires_grad=True) for x in (theta, phi, values)]
    out, sim = fn(*leaves)
    loss = (out * torch.from_numpy(d_out)).sum() + \
        (sim * torch.from_numpy(d_sim)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(fn, theta, phi, values, d_out, d_sim):
    def loss(th, ph, va):
        w, s = fn(th, ph, va)
        return jnp.sum(w * d_out) + jnp.sum(s * d_sim)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(values))]


@pytest.mark.parametrize("b,nq,nk,c", SHAPES)
def test_bwd_plain_matches_pallas_bwd_and_einsum_autograd(b, nq, nk, c):
    theta, phi, values, d_out, d_sim = _case(b, nq, nk, c)
    t = [torch.from_numpy(x) for x in (theta, phi, values)]
    out, sim, l = correspondence_fwd_plain(*t, T)
    # the forward with l agrees with the plain warp
    w_out, w_sim = correspondence_warp_einsum(*t, T)
    torch.testing.assert_close(out, w_out, atol=1e-4, rtol=0)
    assert torch.equal(sim, w_sim) and bool((l >= 1).all())

    got = correspondence_bwd_plain(*t, sim, l, out, torch.from_numpy(d_out),
                                   torch.from_numpy(d_sim), T)
    pallas = _corr_pallas_bwd(
        jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(values),
        jnp.asarray(sim.numpy()), jnp.asarray(l.numpy()),
        jnp.asarray(out.numpy()), jnp.asarray(d_out), jnp.asarray(d_sim),
        T, 128, 128, True)
    autograd = _torch_autograd(lambda *a: correspondence_warp_einsum(*a, T),
                               theta, phi, values, d_out, d_sim)
    for name, g, p, a in zip(("dtheta", "dphi", "dvalues"), got, pallas,
                             autograd):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(g.numpy(), a, err_msg=name, **TOL)


def test_bwd_plain_routes_dsim_to_every_tie():
    """Two keys tied at a row's max both receive that row's d_sim (the
    kernels' rule; autograd of amax would give each half)."""
    theta, phi, values, _, _ = _case(1, 4, 16, 32, seed=1)
    phi[0, 5] = theta[0, 0]
    phi[0, 9] = theta[0, 0]
    t = [torch.from_numpy(x) for x in (theta, phi, values)]
    out, sim, l = correspondence_fwd_plain(*t, T)
    d_sim = torch.zeros(1, 4, 1)
    d_sim[0, 0, 0] = 1.0
    dtheta, dphi, _ = correspondence_bwd_plain(*t, sim, l, out,
                                               torch.zeros_like(out), d_sim, T)
    np.testing.assert_allclose(dtheta[0, 0].numpy(), phi[0, 5] + phi[0, 9],
                               rtol=1e-6)
    for k in (5, 9):
        np.testing.assert_allclose(dphi[0, k].numpy(), theta[0, 0], rtol=1e-6)


@pytest.mark.parametrize("b,nq,nk,c", SHAPES[:2] + SHAPES[3:])
def test_corr_function_cpu_matches_devc_tpu_custom_vjp(b, nq, nk, c):
    """CorrFunction on CPU tensors (plain forward with l, plain backward)
    against devc_tpu's differentiable Pallas kernel in interpret mode, and
    the dispatch's CPU route (autograd of the einsum path) against
    devc_tpu's einsum autodiff."""
    case = _case(b, nq, nk, c)
    before = (cuda_corr.corr_fwd.launches, cuda_corr.corr_bwd_dq.launches,
              cuda_corr.corr_bwd_dkv.launches)
    got = _torch_autograd(lambda *a: cuda_corr.CorrFunction.apply(*a, T),
                          *case)
    want = _jax_grads(lambda *a: correspondence_warp_pallas(
        *a, T, interpret=True, differentiable=True, tq=128, tk=128), *case)
    for name, g, w in zip(("dtheta", "dphi", "dvalues"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)

    got = _torch_autograd(
        lambda *a: correspondence_warp(*a, T, differentiable=True), *case)
    want = _jax_grads(lambda *a: j_einsum(*a, T), *case)
    for name, g, w in zip(("dtheta", "dphi", "dvalues"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    # CPU tensors never reach a kernel wrapper
    assert before == (cuda_corr.corr_fwd.launches,
                      cuda_corr.corr_bwd_dq.launches,
                      cuda_corr.corr_bwd_dkv.launches)


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch K2b / K3 or raise; they never compute on the CPU."""
    theta, phi, values, d_out, d_sim = (torch.from_numpy(x)
                                        for x in _case(1, 8, 8, 64))
    out, sim, l = correspondence_fwd_plain(theta, phi, values, T)
    df = torch.zeros(1, cuda_corr.padded(8), cuda_corr.padded(8))
    calls = ((cuda_corr.corr_bwd_dkv,
              (theta, phi, values, sim, l, sim, d_sim, d_out, T, df)),
             (cuda_corr.corr_bwd_dq, (df, phi, 8)))
    for fn, args in calls:
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        assert fn.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_corr.corr_bwd(theta, phi, values, sim, l, out, d_out, d_sim, T)


@pytest.mark.parametrize("b,nq,nk,budget_samples", [
    (16, 5184, 5184, 16), (16, 5184, 5184, 5), (3, 130, 70, 1),
    (1, 20736, 20736, 1), (7, 1, 1, 3)])
def test_plan_batch_chunks_covers_the_batch_within_the_budget(
        b, nq, nk, budget_samples):
    """Chunks are consecutive, cover [0, b), none is empty, and each
    chunk's df scratch fits the budget; a budget below one sample raises."""
    per = cuda_corr.df_scratch_bytes(nq, nk)
    assert per == 4 * (-(-nq // 128) * 128) * (-(-nk // 128) * 128)
    budget = per * budget_samples + per // 2
    chunks = cuda_corr.plan_batch_chunks(b, nq, nk, budget)
    assert chunks[0][0] == 0 and chunks[-1][1] == b
    assert all(prev[1] == nxt[0] for prev, nxt in zip(chunks, chunks[1:]))
    assert all(stop > start for start, stop in chunks)
    assert all((stop - start) * per <= budget for start, stop in chunks)
    assert len(chunks) == -(-b // min(b, budget_samples))
    with pytest.raises(ValueError, match="exceeds the budget"):
        cuda_corr.plan_batch_chunks(b, nq, nk, per - 1)


def test_default_budget_holds_the_training_and_full_resolution_shapes():
    """The training shape (B = 16, N = 5184) runs in one chunk and one
    sample at N = 20736 fits, under the default 2 GiB."""
    assert cuda_corr.plan_batch_chunks(16, 5184, 5184) == [(0, 16)]
    assert cuda_corr.plan_batch_chunks(1, 20736, 20736) == [(0, 1)]
