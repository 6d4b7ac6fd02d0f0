"""The port's training step vs devc_tpu's on CPU, and the pieces around it.

The whole slice: one step of the port (preprocess_batch_u8, then
train_step, which is train_step_u8) against
devc_tpu.train.loop.train_step_u8 (use_pallas=False: devc_tpu's einsum
correspondence, which the port's CPU route mirrors) on the same uint8
batch, the same numpy weights (host_pipeline_params, host_discriminator_init
carried by train_state_from_numpy), luminance noise 0 and remat on.
Both steps run with "recording" optimizers that return the gradients as
their state, so the gradients are compared beside every metric and the new
spectral-norm state. The JAX step runs once per module (its CPU compile is
most of this file's time).

Size 64 x 128, batch 2: at 64 x 64 the critic's stage-6 map is 1 x 1,
InstanceNorm zeroes it and every critic gradient (and the generator's GAN
term) vanishes; at 64 x 128 all are live. The critic's attention gain is
0.3 so that branch counts too.

Reproducibility. At random weights this step is chaotic in fp32: with
T = 0.01 and the full two-frame recurrence an fp32 step's gradients lie
tens of percent (relative L2 per network) from the same step in float64
(chip_smoke.py's train_parity phase measures it), because ColorVidNet
amplifies an input change many times, the second frame takes the
first's prediction as input, and at T = 0.01 the correspondence turns
score round-off into 1/T = 100 times larger weight changes. No fp32
implementation reproduces another there. So the parity step uses T = 1
and damps the recurrent input (conv1_1a's weights on the previous-Lab
channels x 1e-3; the path still runs), where the metrics agree to ~1e-4.
Even there fp32 gradients carry percents of noise, so they are judged
against the port's float64 step: each network's fp32 gradient (devc_tpu's
and the port's) must lie within 10% (relative L2) of it, and the port's
within 3% (as this file computes them: devc_tpu 2.2 / 2.3 / 7.6%, the
port 1.3 / 1.4 / 0.6% for WarpNet / ColorVidNet / critic).

Tolerances: metrics rtol 1e-3; spectral-norm vectors 1e-5; the optimizer
to fp32 round-off over three steps.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devc_tpu.models.warpnet import warpnet_apply as j_warpnet_apply
from devc_tpu.train import loop as jloop
from devc_tpu.train.flat_opt import flat_adam
from devc_tpu.train.state import TrainState as JTrainState
from devc_tpu.utils.convert import discriminator_to_torch
from devc_tpu_torch import colorspace as cs
from devc_tpu_torch.models.warpnet import warpnet_apply
from devc_tpu_torch.train import loop as tloop
from devc_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_run_metadata,
    load_train_params_g,
    save_run_metadata,
)
from devc_tpu_torch.train.state import FlatAdam, make_optimizers
from devc_tpu_torch.utils.convert import (
    colorvidnet_state_dict,
    frozen_vgg,
    train_state_from_numpy,
    warpnet_state_dict,
)
from devc_tpu_torch.utils.init import (
    host_discriminator_init,
    host_pipeline_params,
)

B, H, W = 2, 64, 128


def synthetic_batch_u8(seed, b, h, w):
    """A uint8 loader batch from numpy: smooth textured frames, a smooth
    flow of a few pixels, a random occlusion mask, brightness jitter and
    mixed placeholder / self-reference flags."""
    rng = np.random.RandomState(seed)

    def frames():
        coarse = rng.rand(b, h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((1, 8, 8, 1)))[:, :h, :w]
        img = field * 200 + 20 + rng.randn(b, h, w, 3) * 12
        return np.clip(img, 0, 255).astype(np.uint8)

    coarse_flow = rng.randn(b, h // 16 + 1, w // 16 + 1, 2) * 3
    flow = np.kron(coarse_flow, np.ones((1, 16, 16, 1)))[:, :h, :w]
    return {
        "last_rgb": frames(), "current_rgb": frames(), "ref_rgb": frames(),
        "flow_forward": flow.astype(np.float16),
        "flow_backward": np.zeros((b, h, w, 2), np.float16),
        "mask": (rng.rand(b, h, w, 1) > 0.2).astype(np.uint8),
        "jitter": rng.uniform(-5, 5, (b, 1)).astype(np.float32),
        "placeholder_flag": (np.arange(b) % 2 == 0)[:, None].astype(np.float32),
        "self_ref_flag": (np.arange(b) % 2 == 0)[:, None].astype(np.float32),
    }


def _weights(damp_recurrence: float = 1.0):
    p = host_pipeline_params(0)
    p["colorvid"]["conv1_1a"]["w"][:, :, 4:7, :] *= damp_recurrence
    params_d, sn = host_discriminator_init(3)
    params_d["gamma"] = np.full((1,), 0.3, np.float32)
    return p, {"warpnet": p["warpnet"], "colorvid": p["colorvid"]}, params_d, sn


def _j_recorder():
    """An optax transform whose state is the last gradient and whose
    update is zero."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


class _Recorder:
    """The port's counterpart: the state is the last gradient."""

    def init(self, groups):
        return None

    def update(self, grads, state):
        return {k: [torch.zeros_like(g) for g in v]
                for k, v in grads.items()}, grads


def _port_step(p, params_g, params_d, sn, batch, dtype):
    """The port's step on CPU in `dtype` with recording optimizers:
    (metrics as floats, {network.parameter: gradient as float64}, state)."""
    state = train_state_from_numpy(params_g, params_d, sn, _Recorder(),
                                   _Recorder(), device="cpu")
    state.params_g.to(dtype)
    state.params_d.to(dtype)
    state.sn_state = {k: {n: t.to(dtype) for n, t in uv.items()}
                      for k, uv in state.sn_state.items()}
    float_batch = tloop.preprocess_batch_u8(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    new, metrics = tloop.train_step(
        state, {k: v.to(dtype) for k, v in float_batch.items()},
        _Recorder(), _Recorder(), frozen_vgg(p["vgg"], "cpu").to(dtype),
        tloop.TrainConfig(luminance_noise=0.0, temperature=PARITY_T))
    grads = {}
    for group, gs in new.opt_state_g.items():
        names = new.params_g[group].named_parameters()
        grads.update({f"{group}.{n}": g.double().numpy()
                      for (n, _), g in zip(names, gs)})
    names = new.params_d.named_parameters()
    grads.update({f"critic.{n}": g.double().numpy()
                  for (n, _), g in zip(names, new.opt_state_d[""])})
    return {k: v.item() for k, v in metrics.items()}, grads, new


PARITY_T = 1.0  # see the module docstring


@pytest.fixture(scope="module")
def both_steps():
    p, params_g, params_d, sn = _weights(damp_recurrence=1e-3)
    batch = synthetic_batch_u8(0, B, H, W)

    j_state = JTrainState(
        step=jnp.zeros((), jnp.int32),
        params_g=jax.tree.map(jnp.asarray, params_g),
        params_d=jax.tree.map(jnp.asarray, params_d),
        sn_state=jax.tree.map(jnp.asarray, sn),
        opt_state_g=None, opt_state_d=None)
    tx = _j_recorder()
    j_state = j_state._replace(opt_state_g=tx.init(j_state.params_g),
                               opt_state_d=tx.init(j_state.params_d))
    cfg = jloop.TrainConfig(use_pallas=False, luminance_noise=0.0,
                            temperature=PARITY_T)
    fn = jax.jit(functools.partial(
        jloop.train_step_u8, tx_g=tx, tx_d=tx,
        vgg_params=jax.tree.map(jnp.asarray, p["vgg"]), cfg=cfg))
    j_new, j_metrics = fn(j_state, jax.tree.map(jnp.asarray, batch),
                          jax.random.PRNGKey(0))
    j_metrics = {k: float(v) for k, v in j_metrics.items()}
    j_g = jax.tree.map(np.asarray, j_new.opt_state_g)
    j_grads = {f"warpnet.{k}": v.numpy()
               for k, v in warpnet_state_dict(j_g["warpnet"]).items()}
    j_grads.update({f"colorvid.{k}": v.numpy() for k, v in
                    colorvidnet_state_dict(j_g["colorvid"]).items()})
    j_d = discriminator_to_torch(jax.tree.map(np.asarray, j_new.opt_state_d),
                                 jax.tree.map(np.asarray, j_new.sn_state))
    j_grads.update({f"critic.{k}": v.numpy() for k, v in j_d.items()
                    if not k.endswith(("weight_u", "weight_v"))})

    port32 = _port_step(p, params_g, params_d, sn, batch, torch.float32)
    port64 = _port_step(p, params_g, params_d, sn, batch, torch.float64)
    return (j_new, j_metrics, j_grads), port32, port64


def test_train_step_metrics_match_devc_tpu(both_steps):
    (j_new, j_metrics, _), (t_metrics, _, t_new), _ = both_steps
    assert sorted(t_metrics) == sorted(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(t_metrics[k], v, rtol=1e-3, atol=1e-7,
                                   err_msg=k)
    assert j_metrics["generator_loss"] > 0
    assert t_new.step == int(j_new.step) == 1


def _rel_l2(got: dict, want: dict, prefix: str) -> float:
    keys = [k for k in want if k.startswith(prefix)]
    diff = sum(np.sum(np.square(got[k].reshape(want[k].shape) - want[k]))
               for k in keys)
    return float(np.sqrt(diff / sum(np.sum(np.square(want[k])) for k in keys)))


def test_train_step_gradients_match_devc_tpu(both_steps):
    (_, _, j_grads), (_, p_grads, _), (_, exact, _) = both_steps
    assert sorted(j_grads) == sorted(p_grads) == sorted(exact)
    for net in ("warpnet.", "colorvid.", "critic."):
        assert _rel_l2(j_grads, exact, net) <= 0.1, net
        assert _rel_l2(p_grads, exact, net) <= 0.03, net
        assert max(np.abs(exact[k]).max() for k in exact
                   if k.startswith(net)) > 0, net


def test_train_step_spectral_norm_state_matches_devc_tpu(both_steps):
    (j_new, _, _), (_, _, t_new), _ = both_steps
    for name, uv in t_new.sn_state.items():
        for k in ("u", "v"):
            np.testing.assert_allclose(uv[k].numpy(),
                                       np.asarray(j_new.sn_state[name][k]),
                                       atol=1e-5, err_msg=f"{name}.{k}")


def test_optimizer_matches_flat_adam():
    """Three steps of both optimizers with the same given gradients; the
    StepLR step of 2 makes the factor change inside the run."""
    rng = np.random.RandomState(0)
    shapes = {"warpnet": [(3, 4), (5,)], "colorvid": [(2, 2, 3)]}
    params = {k: [rng.randn(*s).astype(np.float32) for s in v]
              for k, v in shapes.items()}
    grads = [{k: [rng.randn(*s).astype(np.float32) * 10 ** -i for s in v]
              for k, v in shapes.items()} for i in range(3)]
    j_tx_g = flat_adam({"warpnet": 1e-5, "colorvid": 2e-4}, b1=0.5, b2=0.999,
                       eps=1e-5, amsgrad=True,
                       schedule_factor=optax.exponential_decay(
                           1.0, 2, 0.1, staircase=True))
    t_tx_g, _ = make_optimizers(lr_step=2)
    j_tx_d = flat_adam(2e-4, b1=0.5, b2=0.999)
    t_tx_d = FlatAdam(2e-4, b1=0.5, b2=0.999)
    for j_tx, t_tx, wrap in ((j_tx_g, t_tx_g, lambda d: d),
                             (j_tx_d, t_tx_d, lambda d: {"": sum(d.values(), [])})):
        j_p = jax.tree.map(jnp.asarray, params)
        t_p = wrap({k: [torch.from_numpy(a.copy()) for a in v]
                    for k, v in params.items()})
        j_s, t_s = j_tx.init(j_p), t_tx.init(t_p)
        for g in grads:
            j_u, j_s = j_tx.update(jax.tree.map(jnp.asarray, g), j_s)
            j_p = jax.tree.map(lambda p, u: p + u, j_p, j_u)
            t_u, t_s = t_tx.update(wrap({k: [torch.from_numpy(a) for a in v]
                                         for k, v in g.items()}), t_s)
            for k in t_p:
                torch._foreach_add_(t_p[k], t_u[k])
        got = np.concatenate([t.numpy().ravel() for v in t_p.values()
                              for t in v])
        want = np.concatenate([np.asarray(a).ravel()
                               for k in shapes for a in j_p[k]])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        assert t_s.count == 3


def test_preprocess_batch_u8_matches_devc_tpu():
    batch = synthetic_batch_u8(1, B, 32, 64)
    want = jloop.preprocess_batch_u8(jax.tree.map(jnp.asarray, batch))
    got = tloop.preprocess_batch_u8({k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        # Lab of uint8 RGB in fp32 by two implementations
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, err_msg=k)


def test_warpnet_apply_matches_devc_tpu():
    """The exemplar-recomputing WarpNet path (training's features_b path)
    at 64 x 64, T = 0.01, values and similarity."""
    from devc_tpu_torch.models.warpnet import WarpNet

    p = host_pipeline_params(0)
    model = WarpNet()
    model.load_state_dict(warpnet_state_dict(p["warpnet"]), strict=True)
    rng = np.random.RandomState(2)
    b_lab = rng.uniform(-50, 50, (1, 64, 64, 3)).astype(np.float32)
    shapes = ((32, 32, 128), (16, 16, 256), (8, 8, 512), (4, 4, 512))
    a_feats = [np.maximum(rng.randn(1, *s), 0).astype(np.float32) for s in shapes]
    b_feats = [np.maximum(rng.randn(1, *s), 0).astype(np.float32) for s in shapes]
    norm = lambda fs: [cs.feature_normalize(torch.from_numpy(f)) for f in fs]
    with torch.no_grad():
        warped, sim = warpnet_apply(model, torch.from_numpy(b_lab),
                                    norm(a_feats), norm(b_feats), 0.01,
                                    differentiable=True)
    j_norm = lambda fs: tuple(jnp.asarray(f.numpy()) for f in norm(fs))
    j_warped, j_sim = j_warpnet_apply(
        jax.tree.map(jnp.asarray, p["warpnet"]), jnp.asarray(b_lab),
        j_norm(a_feats), j_norm(b_feats), 0.01, use_pallas=False)
    np.testing.assert_allclose(sim.numpy(), np.asarray(j_sim), atol=1e-4)
    np.testing.assert_allclose(warped.numpy(), np.asarray(j_warped), atol=5e-2)


def test_train_step_moves_weights_and_checkpoint_round_trips(tmp_path):
    """A real step (AMSGrad / Adam, luminance noise from a seeded
    generator) moves both networks; a checkpoint restores bit-equal into
    a fresh state; retention and the save interval hold."""
    p, params_g, params_d, sn = _weights()
    tx_g, tx_d = make_optimizers()
    state = train_state_from_numpy(params_g, params_d, sn, tx_g, tx_d,
                                   device="cpu")
    before = {n: t.clone() for n, t in
              list(state.params_g.named_parameters())
              + list(state.params_d.named_parameters())}
    step = tloop.make_train_step(tx_g, tx_d, frozen_vgg(p["vgg"], "cpu"),
                                 tloop.TrainConfig(), device_preprocess=True)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch_u8(2, B, H, W).items()}
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    moved_g = max((t - before[n]).abs().max().item()
                  for n, t in state.params_g.named_parameters())
    moved_d = max((t - before[n]).abs().max().item()
                  for n, t in state.params_d.named_parameters())
    assert moved_g > 0 and moved_d > 0 and state.step == 1

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                            save_interval_steps=2)
    assert not mgr.save(1, state)  # off the interval
    assert mgr.save(1, state, force=True)
    fresh = train_state_from_numpy(params_g, params_d,
                                   host_discriminator_init(9)[1], tx_g, tx_d,
                                   device="cpu")
    restored = mgr.restore(fresh)
    assert restored.step == 1 and restored.opt_state_g.count == 1
    for a, b in ((state.params_g.state_dict(), restored.params_g.state_dict()),
                 (state.params_d.state_dict(), restored.params_d.state_dict())):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for name, uv in state.sn_state.items():
        assert all(torch.equal(uv[k], restored.sn_state[name][k]) for k in uv)
    for a, b in ((state.opt_state_g, restored.opt_state_g),
                 (state.opt_state_d, restored.opt_state_d)):
        for x, y in zip(a, b):
            assert (x is None and y is None) or (
                x == y if isinstance(x, int) else torch.equal(x, y))
    for s in (2, 4):
        assert mgr.save(s, state)
    assert mgr.all_steps() == [2, 4]
    gen = load_train_params_g(str(tmp_path / "ckpt"))
    assert sorted(gen) == ["colorvid", "warpnet"]
    assert torch.equal(gen["warpnet"]["theta.weight"],
                       state.params_g["warpnet"].theta.weight.detach())
    save_run_metadata(str(tmp_path / "ckpt"), {"vgg": "random"})
    assert load_run_metadata(str(tmp_path / "ckpt")) == {"vgg": "random"}
    assert load_run_metadata(str(tmp_path / "none")) is None
    assert not os.path.exists(tmp_path / "none")
