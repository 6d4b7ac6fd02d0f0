"""The port's data-parallel training step (make_train_step_spmd) and
cli.train over two CPU ranks.

The ranks are gloo processes (devc_tpu_torch.parallel.launch.spawn_ranks,
"spawn": this process has JAX loaded) running
tests/torch_parallel_workers.py, which imports neither JAX nor devc_tpu;
the JAX side runs here. One spawn serves the step's tests:

  * the RaLSGAN losses' gradient with respect to each rank's own logits,
    before any averaging: the global means go through a psum whose
    backward sums over the ranks, so each rank holds world x the
    one-process gradient of its rows (the average over ranks then is the
    one-process gradient); a missing or doubled factor of the world size
    shows here first;
  * one step of make_train_step_spmd on 2 ranks against the port's
    one-process train_step on the same global batch (B = 2, 64 x 128,
    T = 1, the recurrent input damped, luminance noise 0) in float64:
    metrics within 1e-9 relative; each network's gradient and updated
    parameters within 1e-7 relative L2. That bound is float64's own floor
    here, not the split's: the one-process step with its convolutions
    run one sample at a time instead of the batch whole lies 1.3e-8
    (gradients) and 7e-9 (ColorVidNet's parameters) from itself (as
    computed on this CPU), and the 2-rank step, whose convolutions see
    batch 1, lies 1.5e-8 / 1.2e-8 from it. A factor of the world size in
    any term moves them by percents. (One element alone is
    ill-conditioned: Adam divides a gradient near 0 by its eps.)
  * the same fp32 step against devc_tpu's make_train_step_spmd on 2
    virtual devices at tests/test_train.py:140's settings (B = 2,
    luminance noise 0, no remat, perceptual and contextual weights 0) and
    tolerances (metrics rtol 2e-3 / atol 2e-4, parameters 5e-3 / 5e-4),
    the same numpy weights and the same optimizers on both sides, at
    64 x 64 (at its 32 x 32 the critic's last 4 x 4 convolution would meet
    a 3 x 3 map, which XLA takes and PyTorch refuses);
  * --spmd_step off (one all_reduce per tensor) gives the same bits as on.

cli.train runs at 2 ranks on the CPU (64 x 64, batch 2, 2 steps, then
--resume for one more): only rank 0 writes (every writer raises on rank
1), --resume continues at step 3 on both ranks. Each full-width
checkpoint is ~770 MB: the run writes two (steps 2 and 3) and the test
removes them.

Every spawn has a deadline and a 60 s timeout at each collective: a hung
rank fails its tests, it does not hang them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from PIL import Image

from devc_tpu.parallel.mesh import make_mesh as j_make_mesh
from devc_tpu.train import losses as JL
from devc_tpu.train.loop import TrainConfig as JConfig
from devc_tpu.train.loop import make_train_step_spmd as j_spmd_step
from devc_tpu.train.state import TrainState as JTrainState
from devc_tpu.train.state import make_optimizers as j_make_optimizers
from devc_tpu.utils.convert import discriminator_to_torch
from devc_tpu_torch.parallel.launch import spawn_ranks
from devc_tpu_torch.train import losses as TL
from devc_tpu_torch.utils.convert import (
    colorvidnet_state_dict,
    warpnet_state_dict,
)
from devc_tpu_torch.utils.init import (
    host_discriminator_init,
    host_pipeline_params,
)
from test_torch_train import synthetic_batch_u8

import torch_parallel_workers as workers

WORLD = 2


def _lab_batch(b=2, h=64, w=64):
    """tests/test_train.py::_batch's contents, drawn with numpy."""
    rng = np.random.RandomState(2)
    f32 = lambda x: x.astype(np.float32)
    return {
        "last_lab": f32(rng.uniform(-50, 50, (b, h, w, 3))),
        "current_lab": f32(rng.uniform(-50, 50, (b, h, w, 3))),
        "ref_lab": f32(rng.uniform(-50, 50, (b, h, w, 3))),
        "flow_forward": f32(rng.randn(b, h, w, 2) * 2.0),
        "flow_backward": np.zeros((b, h, w, 2), np.float32),
        "mask": np.ones((b, h, w, 1), np.float32),
        "placeholder_lab": np.zeros((b, h, w, 3), np.float32),
        "self_ref_flag": np.ones((b, 1), np.float32),
    }


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(5)
    return {"logits": (rng.randn(4, 1), rng.randn(4, 1) + 0.5),
            "f64_batch": synthetic_batch_u8(0, 2, 64, 128),
            "f32_batch": _lab_batch()}


@pytest.fixture(scope="module")
def ranks(inputs):
    return spawn_ranks(workers.spmd_suite, WORLD, (inputs,), device="cpu",
                       timeout=420, collective_timeout=60)


def test_ralsgan_gradient_over_ranks(ranks, inputs):
    real, fake = (torch.from_numpy(a) for a in inputs["logits"])
    jreal, jfake = (jnp.asarray(a, jnp.float32) for a in inputs["logits"])
    for name, tfn, jfn in (("d", TL.ralsgan_d_loss, JL.ralsgan_d_loss),
                           ("g", TL.ralsgan_g_loss, JL.ralsgan_g_loss)):
        r, f = real.clone().requires_grad_(), fake.clone().requires_grad_()
        loss = tfn(r, f)
        g_real, g_fake = torch.autograd.grad(loss, (r, f))
        j_real, j_fake = jax.grad(jfn, argnums=(0, 1))(jreal, jfake)
        np.testing.assert_allclose(g_real.numpy(), np.asarray(j_real),
                                   rtol=1e-5, atol=1e-7)
        got = [rk["ralsgan"][name] for rk in ranks]
        # the ranks' losses average to the global batch's
        np.testing.assert_allclose(np.mean([g["loss"] for g in got]),
                                   loss.item(), rtol=1e-12)
        for rk, g in enumerate(got):
            rows = slice(2 * rk, 2 * rk + 2)
            np.testing.assert_allclose(g["real"], WORLD * g_real[rows].numpy(),
                                       rtol=1e-12, atol=1e-15)
            np.testing.assert_allclose(g["fake"], WORLD * g_fake[rows].numpy(),
                                       rtol=1e-12, atol=1e-15)


def test_spmd_step_matches_one_process_float64(ranks):
    res = ranks[0]["f64"]
    spmd, one = res["metrics"]
    assert sorted(spmd) == sorted(one)
    for k, v in one.items():
        assert abs(spmd[k] - v) <= 1e-9 * abs(v), (k, spmd[k], v)
    assert one["generator_loss"] > 0 and one["discriminator_loss"] > 0
    for net in ("warpnet", "colorvid", "critic"):
        assert res["grads_rel_l2"][net] <= 1e-7, (net, res)
        assert res["params_rel_l2"][net] <= 1e-7, (net, res)
    # both ranks hold the same parameters after the step
    assert ranks[0]["f64_params_sum"] == ranks[1]["f64_params_sum"]


def test_spmd_step_off_equals_on(ranks):
    """One all_reduce per gradient tensor gives the bucketed step's bits
    (two ranks: each sum is one addition either way)."""
    for rk in ranks:
        assert all(rk["f32_on_off_equal"].values()), rk["f32_on_off_equal"]


def test_spmd_step_matches_devc_tpu(ranks, inputs):
    p = host_pipeline_params(0)
    params_d, sn = host_discriminator_init(3)
    params_d["gamma"] = np.full((1,), 0.3, np.float32)
    params_g = {"warpnet": p["warpnet"], "colorvid": p["colorvid"]}
    tx_g, tx_d = j_make_optimizers()
    j_params_g = jax.tree.map(jnp.asarray, params_g)
    j_params_d = jax.tree.map(jnp.asarray, params_d)
    state = JTrainState(
        step=jnp.zeros((), jnp.int32), params_g=j_params_g,
        params_d=j_params_d, sn_state=jax.tree.map(jnp.asarray, sn),
        opt_state_g=tx_g.init(j_params_g), opt_state_d=tx_d.init(j_params_d))
    cfg = JConfig(use_pallas=False, remat=False, luminance_noise=0.0,
                  weight_perceptual=0.0, weight_contextual=0.0)
    mesh = j_make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    fn = j_spmd_step(mesh, tx_g, tx_d, jax.tree.map(jnp.asarray, p["vgg"]),
                     cfg, donate=False)
    data = lambda v: jax.device_put(
        v, NamedSharding(mesh, P(*["data"] + [None] * (v.ndim - 1))))
    repl = NamedSharding(mesh, P())
    new, metrics = fn(jax.device_put(state, repl),
                      {k: data(jnp.asarray(v))
                       for k, v in inputs["f32_batch"].items()},
                      jax.device_put(jax.random.PRNGKey(3), repl))

    got = ranks[0]["f32_on"]
    assert sorted(got["metrics"]) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    new_g = jax.tree.map(np.asarray, new.params_g)
    want = {f"warpnet.{k}": v.numpy()
            for k, v in warpnet_state_dict(new_g["warpnet"]).items()}
    want.update({f"colorvid.{k}": v.numpy() for k, v in
                 colorvidnet_state_dict(new_g["colorvid"]).items()})
    critic = discriminator_to_torch(jax.tree.map(np.asarray, new.params_d),
                                    jax.tree.map(np.asarray, new.sn_state))
    want.update({f"critic.{k}": v.numpy() for k, v in critic.items()
                 if not k.endswith(("weight_u", "weight_v"))})
    assert sorted(got["params"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k].reshape(v.shape), v,
                                   rtol=5e-3, atol=5e-4, err_msg=k)


# --------------------------------------------------------------- cli.train
def _make_imagenet_dataset(root, n_images=3):
    rng = np.random.RandomState(0)
    d = root / "class0"
    (d / "input").mkdir(parents=True)
    for i in range(n_images):
        coarse = rng.rand(80 // 8 + 1, 100 // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:80, :100]
        img = np.clip(field * 200 + 20 + rng.randn(80, 100, 3) * 12, 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(d / "input"
                                                   / f"img{i}.JPEG")
    with open(d / "pairs.txt", "w") as f:
        for i in range(n_images - 1):
            f.write(f"img{i}.JPEG img{i + 1}.JPEG 1.0\n")
    return root


def _args(data, ckpt, logs, steps, extra=()):
    return ["--data_root_imagenet", str(data), "--batch_size", "2",
            "--image_size", "64", "64", "--max_steps", str(steps),
            "--workers", "2", "--checkpoint_dir", str(ckpt),
            "--checkpoint_step", "2", "--log_dir", str(logs),
            "--print_step", "1", "--tb_log_step", "1",
            "--vgg_ckpt", "/nonexistent/forces-random-vgg.pth",
            "--device", "cpu", *extra]


def test_cli_train_two_ranks_and_resume(tmp_path):
    data = _make_imagenet_dataset(tmp_path / "data")
    ckpt = tmp_path / "ckpt"
    try:
        runs = spawn_ranks(
            workers.cli_train_ranks, WORLD,
            (_args(data, ckpt, tmp_path / "runs", 2),
             _args(data, ckpt, tmp_path / "runs2", 1, ["--resume"])),
            device="cpu", timeout=420, collective_timeout=60)
        for rank, (first, second) in enumerate(runs):
            assert first["rank"] == rank and first["world"] == WORLD
            assert first["backend"] == "gloo" and first["mesh"] == [2, 1]
            assert first["batch_per_rank"] == 1
            assert (first["first_step"], first["last_step"]) == (1, 2)
            assert (second["first_step"], second["last_step"]) == (3, 3)
        assert sorted(os.listdir(ckpt)) == [
            "opt.txt", "run_metadata.json", "step_000000002.pt",
            "step_000000003.pt"]
        assert json.load(open(ckpt / "run_metadata.json")) == {
            "vgg_source": "random:seed1"}
        for logs, steps in (("runs", [1, 2]), ("runs2", [3])):
            lines = [json.loads(line) for line in
                     open(tmp_path / logs / "metrics.jsonl")]
            assert [line["step"] for line in lines] == steps
            assert all(np.isfinite(line["total_loss"]) for line in lines)
    finally:
        for name in os.listdir(ckpt) if ckpt.exists() else ():
            if name.endswith(".pt"):
                os.remove(ckpt / name)
