"""What each rank runs in tests/test_torch_parallel.py and
tests/test_torch_train_spmd.py.

The ranks are spawned processes (devc_tpu_torch.parallel.launch), which
import this module to find these functions: it imports PyTorch and the
port only, never JAX or devc_tpu, so the JAX references stay in the test
files' own process. Inputs and results cross as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

THREADS = 2  # intra-op threads a rank (the suite runs several workers)


def _models():
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    return PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def parallel_suite(ctx, inp):
    """tests/test_torch_parallel.py's port side on this rank: the mesh
    helpers, the sharded correspondence, the sharded frame step and the
    data-parallel batched step. Returns a dict of numpy results."""
    from devc_tpu_torch.ops.correspondence import correspondence_warp
    from devc_tpu_torch.parallel import sharded_corr
    from devc_tpu_torch.parallel.inference import batched_frame_step
    from devc_tpu_torch.parallel.mesh import (
        data_sharding,
        gather_batch,
        make_mesh,
        replicated,
        shard_batch,
        shard_params,
    )
    torch.set_num_threads(THREADS)
    out = {"rank": ctx.rank}

    # mesh helpers (test_parallel.py::test_mesh_helpers's cases)
    mesh = make_mesh()
    x = torch.arange(8 * 2, dtype=torch.float32).reshape(8, 2)
    out["mesh"] = {
        "axis_names": mesh.axis_names, "shape": mesh.shape,
        "coords": mesh.coords,
        "spec": data_sharding(mesh, 4), "replicated": replicated(mesh),
        "block": shard_batch(mesh, {"a": x})["a"].numpy(),
        "block_np": shard_batch(mesh, [x.numpy()])[0],
        "gathered": gather_batch(mesh, shard_batch(mesh, x)).numpy()}
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(ctx.rank + 1))
    extra = {"v": torch.full((4,), float(ctx.rank))}
    shard_params(mesh, [lin, extra])
    out["mesh"]["params"] = [lin.weight.detach().numpy(),
                             extra["v"].numpy()]

    # the correspondence split over a 1 x 2 mesh
    mesh = make_mesh(n_data=1, n_model=ctx.world)
    fns = {"rows": sharded_corr.correspondence_warp_sharded,
           "keys": sharded_corr.correspondence_warp_key_sharded}
    out["corr"], out["corr_unsharded"] = [], []
    for kind, theta, phi, values, temperature in inp["corr"]:
        args = (_t(theta), _t(phi), _t(values))
        w, s = fns[kind](*args, mesh, temperature)
        out["corr"].append((w.numpy(), s.numpy()))
        w, s = correspondence_warp(*args, temperature)
        out["corr_unsharded"].append((w.numpy(), s.numpy()))

    # frames: corr_sharding rows / keys over the model axis, and the
    # clip axis over the data axis
    models = _models()
    fr = inp["frames"]
    state = {"phi": _t(fr["phi"]), "values": _t(fr["values"])}
    args = (models, _t(fr["frames"]), _t(fr["last"]), state)
    out["frames"] = {None: [a.numpy() for a in batched_frame_step(
        *args, wls=False)]}
    for kind in ("rows", "keys"):
        out["frames"][kind] = [a.numpy() for a in batched_frame_step(
            *args, wls=False, corr_sharding=(mesh, "model", kind))]

    dp = inp["data_parallel"]
    mesh = make_mesh(n_data=ctx.world, n_model=1)
    local = shard_batch(mesh, {k: _t(v) for k, v in dp.items()})
    rgb, last = batched_frame_step(
        models, local["frames"], local["last"],
        {"phi": local["phi"], "values": local["values"]}, wls=True)
    out["data_parallel_local"] = rgb.numpy()
    out["data_parallel"] = [a.numpy() for a in gather_batch(mesh,
                                                            (rgb, last))]
    return out


# --------------------------------------------------------------- training
def train_state(dtype, tx=None, damp_recurrence: float = 1e-3):
    """(state, tx_g, tx_d, vgg) at full width from tests/test_torch_train.py's
    seeded numpy weights, in dtype, on the CPU. tx: (tx_g, tx_d), default
    the reference's two optimizers."""
    from devc_tpu_torch.train.state import make_optimizers
    from devc_tpu_torch.utils.convert import frozen_vgg, train_state_from_numpy
    from devc_tpu_torch.utils.init import (
        host_discriminator_init,
        host_pipeline_params,
    )

    p = host_pipeline_params(0)
    p["colorvid"]["conv1_1a"]["w"][:, :, 4:7, :] *= damp_recurrence
    params_d, sn = host_discriminator_init(3)
    params_d["gamma"] = np.full((1,), 0.3, np.float32)
    tx_g, tx_d = tx or make_optimizers()
    state = train_state_from_numpy(
        {"warpnet": p["warpnet"], "colorvid": p["colorvid"]}, params_d, sn,
        tx_g, tx_d, device="cpu")
    state.params_g.to(dtype)
    state.params_d.to(dtype)
    state.sn_state = {k: {n: t.to(dtype) for n, t in uv.items()}
                      for k, uv in state.sn_state.items()}
    state.opt_state_g = tx_g.init({k: list(m.parameters())
                                   for k, m in state.params_g.items()})
    state.opt_state_d = tx_d.init({"": list(state.params_d.parameters())})
    return state, tx_g, tx_d, frozen_vgg(p["vgg"], "cpu").to(dtype)


def _float_batch(batch_u8, dtype):
    from devc_tpu_torch.train import loop

    batch = loop.preprocess_batch_u8({k: _t(v) for k, v in batch_u8.items()})
    return {k: v.to(dtype) for k, v in batch.items()}


def _flat(module) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1).double()
                      for p in module.parameters()]).numpy()


def step_result(state, metrics) -> dict:
    """Metrics, the updated parameters of each network and each
    network's gradient (FlatAdam's first moment after one step is
    (1 - b1) g = g / 2, exactly), as float64 numpy."""
    n_w = sum(p.numel() for p in state.params_g["warpnet"].parameters())
    mu_g = state.opt_state_g.mu.double().numpy() * 2.0
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": {"warpnet": _flat(state.params_g["warpnet"]),
                       "colorvid": _flat(state.params_g["colorvid"]),
                       "critic": _flat(state.params_d)},
            "grads": {"warpnet": mu_g[:n_w], "colorvid": mu_g[n_w:],
                      "critic": state.opt_state_d.mu.double().numpy() * 2.0}}


def named_params(state) -> dict:
    """{"warpnet.<name>", "colorvid.<name>", "critic.<name>": numpy}."""
    out = {f"{net}.{n}": p.detach().numpy().copy()
           for net in ("warpnet", "colorvid")
           for n, p in state.params_g[net].named_parameters()}
    out.update({f"critic.{n}": p.detach().numpy().copy()
                for n, p in state.params_d.named_parameters()})
    return out


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def spmd_suite(ctx, inp):
    """tests/test_torch_train_spmd.py's port side on this rank:

    * "ralsgan": the RaLSGAN losses' gradients with respect to this
      rank's logits, before any averaging;
    * "f32_on": one fp32 step at test_train.py's settings (rank 0: the
      updated parameters), and whether the same step with one all_reduce
      per tensor ("off") gave the same bits;
    * "f64": one make_train_step_spmd step in float64 on this rank's block
      of inp["f64_batch"]; rank 0 then runs the one-process train_step on
      the whole batch (no collective: the last thing either rank does)
      and returns how far the two lie apart (the full-width vectors stay
      in the rank).
    """
    from devc_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_params,
    )
    from devc_tpu_torch.train import loop
    from devc_tpu_torch.train import losses as L

    torch.set_num_threads(THREADS)
    mesh = make_mesh()
    group = mesh.group("data")
    out = {"rank": ctx.rank}

    real, fake = (_t(a).double() for a in inp["logits"])
    real_l, fake_l = (shard_batch(mesh, a).requires_grad_() for a in
                      (real, fake))
    got = {}
    for name, fn in (("d", L.ralsgan_d_loss), ("g", L.ralsgan_g_loss)):
        loss = fn(real_l, fake_l, group)
        g_real, g_fake = torch.autograd.grad(loss, (real_l, fake_l))
        got[name] = {"loss": loss.item(), "real": g_real.numpy(),
                     "fake": g_fake.numpy()}
    out["ralsgan"] = got

    # test_train.py::test_train_step_spmd_matches_single_program's settings
    cfg = loop.TrainConfig(remat=False, luminance_noise=0.0,
                           weight_perceptual=0.0, weight_contextual=0.0)
    batch = {k: _t(v) for k, v in inp["f32_batch"].items()}
    res, named = {}, None
    for bucket in (True, False):
        state, tx_g, tx_d, vgg = train_state(torch.float32,
                                             damp_recurrence=1.0)
        step = loop.make_train_step_spmd(mesh, tx_g, tx_d, vgg, cfg,
                                         bucket=bucket)
        res[bucket] = step_result(*step(state, shard_batch(mesh, batch)))
        if bucket and ctx.rank == 0:
            named = named_params(state)
    out["f32_on_off_equal"] = {
        f"{k}.{n}": bool(np.array_equal(res[True][k][n], res[False][k][n]))
        for k in ("params", "grads") for n in res[True][k]}
    out["f32_on_off_equal"]["metrics"] = (res[True]["metrics"]
                                          == res[False]["metrics"])
    out["f32_on"] = {"metrics": res[True]["metrics"], "params": named}
    cfg = loop.TrainConfig(luminance_noise=0.0, temperature=1.0)
    batch = _float_batch(inp["f64_batch"], torch.float64)
    state, tx_g, tx_d, vgg = train_state(torch.float64)
    shard_params(mesh, [state.params_g, state.params_d, state.sn_state])
    step = loop.make_train_step_spmd(mesh, tx_g, tx_d, vgg, cfg)
    spmd = step_result(*step(state, shard_batch(mesh, batch)))
    if ctx.rank == 0:
        state, tx_g, tx_d, vgg = train_state(torch.float64)
        one = step_result(*loop.train_step(state, batch, tx_g, tx_d, vgg,
                                           cfg))
        out["f64"] = {
            "metrics": (spmd["metrics"], one["metrics"]),
            "params_rel_l2": {k: _rel_l2(spmd["params"][k], one["params"][k])
                              for k in one["params"]},
            "grads_rel_l2": {k: _rel_l2(spmd["grads"][k], one["grads"][k])
                             for k in one["grads"]},
            "params_max_rel": {
                k: float(np.abs(spmd["params"][k] - one["params"][k]).max()
                         / np.abs(one["params"][k]).max())
                for k in one["params"]}}
    out["f64_params_sum"] = {k: float(v.sum())
                             for k, v in spmd["params"].items()}

    return out


def cli_train_ranks(ctx, argv, resume_argv):
    """python -m devc_tpu_torch.cli.train on this rank, then again with
    --resume. Every writer of the CLI (options, run metadata, logs,
    checkpoints) raises on a rank other than 0. Returns both summaries."""
    import devc_tpu_torch.train.checkpoint as ckpt_mod
    import devc_tpu_torch.utils.logging as log_mod
    from devc_tpu_torch.cli import train as ttrain

    torch.set_num_threads(THREADS)
    if ctx.rank != 0:
        def refuse(*a, **k):
            raise AssertionError(f"rank {ctx.rank} wrote")

        torch.save = refuse
        ckpt_mod.save_run_metadata = refuse
        log_mod.dump_options = refuse
        log_mod.MetricsLogger = refuse
        log_mod.AsyncImageLogger = refuse
    first = ttrain.main(argv)
    second = ttrain.main(resume_argv)
    return first, second
