"""Every loss of the port's train/losses.py vs devc_tpu/train/losses.py on
CPU, same seeded numpy inputs, and the gradient of each differentiable
term with respect to the prediction.

Tolerances: rtol 1e-5 for the elementwise and patch losses (fp32 sums in
another order); the contextual loss compares cosines through a softmax
at h = 0.1 after dividing by d_min + 1e-5, which amplifies round-off, so
rtol 1e-4 there; gradients at 1e-4 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu.ops.layers import unfold_patches as j_unfold
from devc_tpu.train import losses as J
from devc_tpu_torch.ops.layers import unfold_patches
from devc_tpu_torch.train import losses as P


def _lab(rng, b=2, h=16, w=24):
    lab = np.empty((b, h, w, 3), np.float32)
    lab[..., 0] = rng.uniform(-50, 50, (b, h, w))
    lab[..., 1:] = rng.uniform(-60, 60, (b, h, w, 2))
    return lab


def _check(j_fn, p_fn, args, rtol=1e-5, grad_arg=0):
    """Values equal to rtol; the gradient w.r.t. args[grad_arg] to 1e-4 of
    its largest magnitude."""
    want = np.asarray(j_fn(*[jnp.asarray(a) for a in args]))
    leaves = [torch.tensor(a, requires_grad=(i == grad_arg))
              for i, a in enumerate(args)]
    got = p_fn(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    j_grad = np.asarray(jax.grad(
        lambda x: jnp.sum(j_fn(*[x if i == grad_arg else jnp.asarray(a)
                                 for i, a in enumerate(args)])))(
        jnp.asarray(args[grad_arg])))
    (p_grad,) = torch.autograd.grad(got.sum(), leaves[grad_arg])
    scale = np.abs(j_grad).max()
    assert scale > 0
    np.testing.assert_allclose(p_grad.numpy(), j_grad, rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("k", [3, 5])
def test_unfold_patches(k):
    x = np.random.RandomState(0).randn(2, 7, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(unfold_patches(torch.from_numpy(x), k).numpy(),
                                  np.asarray(j_unfold(jnp.asarray(x), k)))


@pytest.mark.parametrize("name", ["mse", "l1", "weighted_mse", "weighted_l1",
                                  "total_variation", "colorfulness"])
def test_elementwise_losses(name):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 12, 2).astype(np.float32) * 30
    y = rng.randn(2, 8, 12, 2).astype(np.float32) * 30
    w = rng.rand(2, 8, 12, 1).astype(np.float32)
    args = {"mse": (x, y), "l1": (x, y), "weighted_mse": (x, y, w),
            "weighted_l1": (x, y, w), "total_variation": (x,),
            "colorfulness": (x,)}[name]
    _check(getattr(J, name), getattr(P, name), args)


@pytest.mark.parametrize("beta", [0.1, 1.0, 5.0, 40.0])
def test_smooth_l1(beta):
    """Both branches at every beta: differences of 0 to ~100."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 12, 2).astype(np.float32) * 30
    y = x + rng.randn(2, 8, 12, 2).astype(np.float32) * 0.3
    y[0] = rng.randn(8, 12, 2).astype(np.float32) * 30
    _check(lambda a, b: J.smooth_l1(a, b, beta),
           lambda a, b: P.smooth_l1(a, b, beta), (x, y))


@pytest.mark.parametrize("domain_invariant", [False, True])
def test_perceptual_loss(domain_invariant):
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 4, 6, 16).astype(np.float32)
    target = rng.randn(2, 4, 6, 16).astype(np.float32)
    _check(lambda a, b: J.perceptual_loss(a, b, domain_invariant),
           lambda a, b: P.perceptual_loss(a, b, domain_invariant),
           (pred, target))


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_contextual_losses(direction):
    rng = np.random.RandomState(3)
    # relu-like (non-negative) features at the three taps' relative sizes
    feats = [np.maximum(rng.randn(2, h, w, c), 0).astype(np.float32)
             for h, w, c in ((8, 12, 32), (4, 6, 64), (2, 3, 64))]
    refs = [np.maximum(rng.randn(*f.shape), 0).astype(np.float32)
            for f in feats]
    _check(lambda x, y: J.contextual_loss(x, y, 0.1, direction),
           lambda x, y: P.contextual_loss(x, y, 0.1, direction),
           (feats[0], refs[0]), rtol=1e-4)
    _check(lambda a, b, c, x, y, z: J.contextual_loss_multiscale(
               (a, b, c), (x, y, z), direction=direction),
           lambda a, b, c, x, y, z: P.contextual_loss_multiscale(
               (a, b, c), (x, y, z), direction=direction),
           (*feats, *refs), rtol=1e-4)


def test_smoothness_losses():
    rng = np.random.RandomState(4)
    gt = _lab(rng)
    pred_ab = rng.uniform(-60, 60, gt[..., 1:].shape).astype(np.float32)
    _check(J.weighted_average, P.weighted_average, (gt,))
    _check(lambda g, p: J.weighted_average_color(g, p, 3, 10.0),
           lambda g, p: P.weighted_average_color(g, p, 3, 10.0),
           (gt, _lab(rng)), grad_arg=1)
    _check(lambda g, p: J.smoothness_loss(g, p, 10.0),
           lambda g, p: P.smoothness_loss(g, p, 10.0), (gt, pred_ab),
           grad_arg=1)


def test_nonlocal_smoothness_loss():
    rng = np.random.RandomState(5)
    lab = _lab(rng, h=32, w=48)
    feat = rng.randn(2, 32, 48, 8).astype(np.float32)
    _check(J.nonlocal_smoothness_loss, P.nonlocal_smoothness_loss,
           (lab, feat), rtol=1e-4)


def test_flow_warp_and_consistency():
    """Flows pointing inside, across the border and off the image (zeros)."""
    rng = np.random.RandomState(6)
    lab = _lab(rng)
    flow = (rng.randn(2, 16, 24, 2) * 4).astype(np.float32)
    flow[0, :2] = 30.0  # off the image: sampled as zero
    last_ab = rng.uniform(-60, 60, (2, 16, 24, 2)).astype(np.float32)
    mask = (rng.rand(2, 16, 24, 1) > 0.3).astype(np.float32)
    _check(J.flow_warp, P.flow_warp, (lab, flow))
    _check(J.consistency_loss, P.consistency_loss,
           (lab, last_ab, flow, mask))


def test_ralsgan_losses():
    rng = np.random.RandomState(7)
    real = rng.randn(4, 1).astype(np.float32)
    fake = rng.randn(4, 1).astype(np.float32)
    for name in ("ralsgan_d_loss", "ralsgan_g_loss"):
        _check(getattr(J, name), getattr(P, name), (real, fake))
        _check(getattr(J, name), getattr(P, name), (real, fake), grad_arg=1)
