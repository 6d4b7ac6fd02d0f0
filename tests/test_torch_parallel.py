"""The port's parallel layer on two CPU ranks against devc_tpu's on the
virtual CPU mesh (tests/conftest.py's 8 devices).

The ranks are two gloo processes (devc_tpu_torch.parallel.launch
.spawn_ranks, "spawn": this process has JAX loaded), running
tests/torch_parallel_workers.py::parallel_suite once for the module; it
imports neither JAX nor devc_tpu. Each test holds one of its results
against devc_tpu on the same numpy inputs and weights
(host_pipeline_params(0)):

  * correspondence_warp_sharded (rows) and _key_sharded (keys) at world
    2 against devc_tpu's (use_pallas False) at T = 0.01 / 0.02: sim
    bit-equal to the port's unsharded one (a max is exact in any order)
    and within 1e-6 relative of devc_tpu's (its scores are another
    library's fp32 products), the same bits on both ranks; out to 2e-5
    (devc_tpu's own keys-sharded error against its einsum was 1.72e-5,
    MULTICHIP_r05.json); at T = 1e-10 the row's argmax (out at a unique
    maximum is that key's value) must match;
  * batched_frame_step with corr_sharding rows and keys (B = 1, 32x64,
    no WLS, devc_tpu's exemplar state fed to both) against devc_tpu's on
    its model-sharded mesh, and bit-equal to the port's unsharded step;
  * the data-parallel batched step (4 clips over 2 data ranks, WLS on):
    each rank's block and the gathered array against devc_tpu's on a
    data-sharded mesh;
  * make_mesh / shard_batch / shard_params / gather_batch against
    test_parallel.py::test_mesh_helpers's cases.

Frame tolerances are tests/test_torch_multi.py's (uint8 within +-1, L of
the carry 1e-3, its ab 0.5). The ranks get 240 s in all and 60 s at any
collective; a hung rank fails the module's tests, it does not hang them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from devc_tpu.ops.correspondence import correspondence_warp_einsum
from devc_tpu.parallel import inference as jinf
from devc_tpu.parallel.mesh import make_mesh as j_make_mesh
from devc_tpu.parallel.sharded_corr import (
    correspondence_warp_key_sharded as j_key_sharded,
    correspondence_warp_sharded as j_row_sharded,
)
from devc_tpu.utils.init import host_pipeline_params
from devc_tpu_torch.parallel.launch import spawn_ranks

import torch_parallel_workers as workers

WORLD = 2
HW = (32, 64)  # network at 16 x 32: N = 32 rows, 16 a rank


def _corr_cases():
    """(kind, theta, phi, values, T): test_parallel.py's shapes."""
    rng = np.random.RandomState(0)
    cases = []
    for kind, nq, nk, t in (("rows", 64 * WORLD, 96, 0.01),
                            ("keys", 48, 64 * WORLD, 0.02),
                            ("keys", 48, 64 * WORLD, 0.01),
                            ("rows", 16 * WORLD, 32 * WORLD, 1e-10),
                            ("keys", 16, 32 * WORLD, 1e-10)):
        cases.append((kind, rng.randn(1, nq, 16).astype(np.float32),
                      rng.randn(1, nk, 16).astype(np.float32),
                      rng.randn(1, nk, 3).astype(np.float32), t))
    return cases


def _textured(seed, n, hw=HW):
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = field * 200 + 20 + rng.randn(h, w, 3) * 12
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(jnp.asarray, host_pipeline_params(0))


def _jstate(jparams, refs):
    _, state = jinf.prepare_references_batched(jparams, jnp.asarray(refs))
    return state


@pytest.fixture(scope="module")
def inputs(jparams):
    frames, refs = _textured(1, 1), _textured(2, 1)
    state = _jstate(jparams, refs)
    last = np.zeros((1, HW[0] // 2, HW[1] // 2, 3), np.float32)
    last[..., 0] = 10.0
    dp_frames, dp_refs = _textured(3, 4), _textured(4, 4)
    dp_state = _jstate(jparams, dp_refs)
    dp_last = np.zeros((4, HW[0] // 2, HW[1] // 2, 3), np.float32)
    return {
        "corr": _corr_cases(),
        "frames": {"frames": frames, "last": last,
                   "phi": np.asarray(state["phi"]),
                   "values": np.asarray(state["values"]), "state": state},
        "data_parallel": {"frames": dp_frames, "last": dp_last,
                          "phi": np.asarray(dp_state["phi"]),
                          "values": np.asarray(dp_state["values"])},
        "dp_state": dp_state,
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    sent = dict(inputs, frames={k: v for k, v in inputs["frames"].items()
                                if k != "state"})
    del sent["dp_state"]
    return spawn_ranks(workers.parallel_suite, WORLD, (sent,), device="cpu",
                       timeout=240, collective_timeout=60)


def _jmesh(n_data, n_model):
    return j_make_mesh(n_data=n_data, n_model=n_model,
                       devices=jax.devices()[:n_data * n_model])


def _j_corr(kind, theta, phi, values, t):
    mesh = _jmesh(1, WORLD)
    fn = j_row_sharded if kind == "rows" else j_key_sharded
    with mesh:
        w, s = fn(jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(values),
                  mesh, temperature=t, use_pallas=False)
    return np.asarray(w), np.asarray(s)


@pytest.mark.parametrize("case", [0, 1, 2], ids=["rows_t0.01", "keys_t0.02",
                                                 "keys_t0.01"])
def test_sharded_correspondence_matches_devc_tpu(ranks, inputs, case):
    kind, theta, phi, values, t = inputs["corr"][case]
    want_w, want_s = _j_corr(kind, theta, phi, values, t)
    einsum_w, einsum_s = (np.asarray(a) for a in correspondence_warp_einsum(
        jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(values),
        temperature=t))
    (w0, s0), (w1, s1) = (r["corr"][case] for r in ranks)
    # every rank holds the whole result, the same bits
    assert np.array_equal(s0, s1) and np.array_equal(w0, w1)
    assert w0.shape == want_w.shape and s0.shape == want_s.shape
    # the row max is exact: the port's unsharded sim, bit for bit
    assert np.array_equal(s0, ranks[0]["corr_unsharded"][case][1])
    np.testing.assert_allclose(s0, want_s, rtol=1e-6, atol=0)
    np.testing.assert_allclose(s0, einsum_s, rtol=1e-6, atol=0)
    np.testing.assert_allclose(w0, want_w, rtol=0, atol=2e-5)
    np.testing.assert_allclose(w0, einsum_w, rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", [3, 4], ids=["rows", "keys"])
def test_sharded_correspondence_hard_argmax(ranks, inputs, case):
    """T = 1e-10: out is the value at each row's maximum (no ties in
    these random scores), across the shards' combine."""
    kind, theta, phi, values, t = inputs["corr"][case]
    want_w, want_s = _j_corr(kind, theta, phi, values, t)
    w, s = ranks[0]["corr"][case]
    argmax = np.argmax(np.einsum("bqc,bkc->bqk", theta, phi), axis=-1)
    np.testing.assert_array_equal(w, values[0][argmax[0]][None])
    np.testing.assert_allclose(w, want_w, rtol=0, atol=1e-6)
    assert np.array_equal(s, ranks[0]["corr_unsharded"][case][1])
    np.testing.assert_allclose(s, want_s, rtol=1e-6, atol=0)


def _assert_step_close(got_rgb, got_last, want_rgb, want_last):
    want_last = np.asarray(want_last)
    np.testing.assert_allclose(got_last[..., 0], want_last[..., 0], atol=1e-3)
    assert np.abs(got_last[..., 1:] - want_last[..., 1:]).max() < 0.5
    # the floor to uint8 turns round-off at exact integers into +-1
    assert np.abs(got_rgb.astype(int)
                  - np.asarray(want_rgb).astype(int)).max() <= 1


@pytest.mark.parametrize("kind", ["rows", "keys"])
def test_frame_step_with_sharded_correspondence_matches_devc_tpu(
        ranks, inputs, jparams, kind):
    fr = inputs["frames"]
    mesh = _jmesh(1, WORLD)
    with mesh:
        want_rgb, want_last = jinf.batched_frame_step(
            jparams, jnp.asarray(fr["frames"]), jnp.asarray(fr["last"]),
            fr["state"], wls=False, use_pallas=False,
            corr_sharding=(mesh, "model", kind))
    for r in ranks:
        got_rgb, got_last = r["frames"][kind]
        _assert_step_close(got_rgb, got_last, want_rgb, want_last)
        # the split changes no bit of the port's own step here
        unsharded_rgb, unsharded_last = r["frames"][None]
        assert np.array_equal(got_rgb, unsharded_rgb)
        np.testing.assert_allclose(got_last, unsharded_last, rtol=0,
                                   atol=1e-5)


def test_batched_frame_step_data_parallel_matches_devc_tpu(ranks, inputs,
                                                           jparams):
    dp = inputs["data_parallel"]
    mesh = _jmesh(WORLD, 1)
    data = lambda x: jax.device_put(
        x, NamedSharding(mesh, P(*(["data"] + [None] * (x.ndim - 1)))))
    step = jax.jit(lambda f, l, rs: jinf.batched_frame_step(
        jparams, f, l, rs, wls=True, use_pallas=False))
    with mesh:
        want_rgb, want_last = step(data(jnp.asarray(dp["frames"])),
                                   data(jnp.asarray(dp["last"])),
                                   jax.tree.map(data, inputs["dp_state"]))
    assert want_rgb.sharding.spec[0] == "data"
    for r in ranks:
        got_rgb, got_last = r["data_parallel"]
        assert got_rgb.shape == (4, *HW, 3)
        _assert_step_close(got_rgb, got_last, want_rgb, want_last)
        # this rank's own block is its part of the global array
        block = r["data_parallel_local"]
        assert block.shape == (2, *HW, 3)
        assert np.array_equal(block, got_rgb[2 * r["rank"]:2 * r["rank"] + 2])


def test_mesh_helpers(ranks):
    """test_parallel.py::test_mesh_helpers's cases: a ("data", "model")
    mesh over every rank, the batch spec, shard_batch's blocks (tensors
    and numpy), and gather_batch undoing it; shard_params leaves rank 0's
    values on every rank."""
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    for r in ranks:
        m = r["mesh"]
        assert m["axis_names"] == ("data", "model")
        assert m["shape"] == (WORLD, 1) and m["coords"] == (r["rank"], 0)
        assert m["spec"] == ("data", None, None, None)
        assert m["replicated"] == ()
        block = x[4 * r["rank"]:4 * r["rank"] + 4]
        assert np.array_equal(m["block"], block)
        assert np.array_equal(m["block_np"], block)
        assert np.array_equal(m["gathered"], x)
        weight, v = m["params"]
        assert np.array_equal(weight, np.ones((2, 3), np.float32))
        assert np.array_equal(v, np.zeros(4, np.float32))
