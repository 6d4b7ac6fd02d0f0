"""The port's critic vs devc_tpu/models/discriminator.py on CPU: the same
numpy weights (host_discriminator_init, carried by
discriminator_state_dict), the same input.

Checked: the logit, the stage-4 features and the new spectral-norm state
of one apply (and of a second apply threaded from the first), the RaLSGAN
critic loss's gradients, and the state-dict layout against devc_tpu's
exporter. gamma is set to 0.5 so the self-attention branch counts.
Tolerances: rtol 1e-4 on logits and features (six conv + InstanceNorm
stages, summed in another order), 1e-5 on the unit u/v vectors, and
gradients to 1e-3 of each tensor's largest magnitude plus a round-off
floor of 1e-6 of the largest gradient of all (the biases that feed an
InstanceNorm have zero gradient, so theirs is round-off alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu.models.discriminator import discriminator_apply as j_apply
from devc_tpu.train.losses import ralsgan_d_loss as j_d_loss
from devc_tpu.utils.convert import discriminator_to_torch
from devc_tpu_torch.models.discriminator import (
    Discriminator,
    discriminator_apply,
    split_state_dict,
)
from devc_tpu_torch.train.losses import ralsgan_d_loss
from devc_tpu_torch.utils.convert import discriminator_state_dict
from devc_tpu_torch.utils.init import host_discriminator_init


@pytest.fixture(scope="module")
def weights():
    params, sn = host_discriminator_init(3)
    params["gamma"] = np.full((1,), 0.5, np.float32)
    model = Discriminator()
    p_sd, sn_t = split_state_dict(discriminator_state_dict(params, sn))
    model.load_state_dict(p_sd, strict=True)
    j_params = jax.tree.map(jnp.asarray, params)
    j_sn = jax.tree.map(jnp.asarray, sn)
    return model, sn_t, j_params, j_sn, params, sn


def _pair(seed, b, h, w):
    return (np.random.RandomState(seed).randn(b, h, w, 6) * 20).astype(
        np.float32)


def test_state_dict_layout_matches_devc_tpu_export(weights):
    *_, params, sn = weights
    ours = discriminator_state_dict(params, sn)
    theirs = discriminator_to_torch(params, sn)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    p_sd, sn_t = split_state_dict(ours)
    assert sorted(sn_t) == sorted(sn)
    assert len(p_sd) + 2 * len(sn_t) == len(ours)
    for name, uv in sn_t.items():
        for k in ("u", "v"):
            np.testing.assert_array_equal(uv[k].numpy(), sn[name][k])


# 216 x 384 is the training size (the [3, 6] head fits exactly); 64 x 128
# takes the head's zero pad
@pytest.mark.parametrize("b,h,w", [(2, 64, 128), (1, 216, 384)])
def test_apply_matches_devc_tpu(weights, b, h, w):
    model, sn, j_params, j_sn, *_ = weights
    x = _pair(0, b, h, w)
    sn_before = {k: {n: t.clone() for n, t in uv.items()} for k, uv in sn.items()}
    with torch.no_grad():
        logit, h4, sn1 = discriminator_apply(model, sn, torch.from_numpy(x))
        logit2, _, sn2 = discriminator_apply(model, sn1, torch.from_numpy(x))
    j_logit, j_h4, j_sn1 = j_apply(j_params, j_sn, jnp.asarray(x))
    j_logit2, _, j_sn2 = j_apply(j_params, j_sn1, jnp.asarray(x))
    assert logit.shape == (b, 1) and h4.shape == j_h4.shape
    scale = np.abs(np.asarray(j_logit)).max()
    np.testing.assert_allclose(logit.numpy(), np.asarray(j_logit), rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(logit2.numpy(), np.asarray(j_logit2),
                               rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(h4.numpy(), np.asarray(j_h4), rtol=1e-4,
                               atol=1e-4)
    for got, want in ((sn1, j_sn1), (sn2, j_sn2)):
        assert sorted(got) == sorted(want)
        for name in got:
            for k in ("u", "v"):
                np.testing.assert_allclose(got[name][k].numpy(),
                                           np.asarray(want[name][k]),
                                           atol=1e-5, err_msg=f"{name}.{k}")
    # the state passed in is not updated in place
    for name, uv in sn.items():
        for k in ("u", "v"):
            assert torch.equal(uv[k], sn_before[name][k]), name


def test_critic_loss_gradients_match_devc_tpu(weights):
    model, sn, j_params, j_sn, *_ = weights
    fake, real = _pair(1, 2, 64, 128), _pair(2, 2, 64, 128)

    def j_loss(p):
        fl, _, s1 = j_apply(p, j_sn, jnp.asarray(fake))
        rl, _, _ = j_apply(p, s1, jnp.asarray(real))
        return j_d_loss(rl, fl)

    j_val, j_grads = jax.value_and_grad(j_loss)(j_params)
    fl, _, s1 = discriminator_apply(model, sn, torch.from_numpy(fake))
    rl, _, _ = discriminator_apply(model, s1, torch.from_numpy(real))
    loss = ralsgan_d_loss(rl, fl)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()),
                                                materialize_grads=True)))
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-4)
    # carry devc_tpu's gradient pytree into the reference layout
    j_sd = discriminator_to_torch(jax.tree.map(np.asarray, j_grads),
                                  jax.tree.map(np.asarray, j_sn))
    want = {n: j_sd[n].numpy().reshape(g.shape) for n, g in grads.items()}
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for name, g in grads.items():
        # the biases under InstanceNorm (and the head's, under the
        # relativistic loss) have zero gradient: round-off alone, held to
        # the floor
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=0,
            atol=1e-3 * np.abs(want[name]).max() + floor, err_msg=name)
