"""The port's fast global smoother, its plain smoother pass and its plain
tridiagonal solvers (the plain versions of kernel K2's two entries) vs
devc_tpu on CPU.

The systems are diagonally dominant, so PCR and Thomas are well
conditioned: both sides solve the same fp32 systems with another order of
operations, held at 2e-4 (the bound devc_tpu's own solver tests use); one
smoother pass is held to the same bound. The smoother works on ab values
of +-100 through 6 passes, held at 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu.ops import fgs as jfgs
from devc_tpu_torch.ops import fgs as tfgs


def _systems(rng, length, n_sys):
    """[L, B] (devc_tpu's layout) diagonally dominant systems."""
    a = rng.rand(length, n_sys).astype(np.float32) * 0.3
    c = rng.rand(length, n_sys).astype(np.float32) * 0.3
    b = 1.0 + rng.rand(length, n_sys).astype(np.float32)
    a[0] = 0
    c[-1] = 0
    d = rng.randn(length, n_sys).astype(np.float32)
    return a, b, c, d


@pytest.mark.parametrize("length,n_sys", [(96, 200), (37, 5), (130, 64)])
@pytest.mark.parametrize("solver", ["_tridiag_pcr", "_tridiag_thomas"])
def test_plain_solvers_match_pallas_pcr(rng, length, n_sys, solver):
    a, b, c, d = _systems(rng, length, n_sys)
    want = np.asarray(jfgs._tridiag_pcr_pallas(
        *(jnp.asarray(x) for x in (a, b, c, d)), interpret=True))
    # the port takes one contiguous system per row: [B, L]
    got = getattr(tfgs, solver)(
        *(torch.from_numpy(np.ascontiguousarray(x.T)) for x in (a, b, c, d)))
    np.testing.assert_allclose(got.numpy().T, want, atol=2e-4)


def _frame(rng, hw):
    """ab-like src in +-100 and a uint8-truncated luminance guide, as
    pipeline/video.py::frame_step builds it, with an edge down the middle."""
    src = ((rng.rand(*hw, 2) - 0.5) * 200).astype(np.float32)
    lum = rng.rand(*hw) * 100.0  # L in [0, 100]
    guide = np.clip(np.floor(lum * 255.0 / 100.0), 0, 255).astype(np.float32)
    guide[:, hw[1] // 2:] = np.floor(guide[:, hw[1] // 2:] / 8)
    return src, guide


@pytest.mark.parametrize("hw", [(48, 96), (64, 128), (37, 70)])
def test_fast_global_smoother_matches_devc_tpu(rng, hw):
    src = ((rng.rand(*hw, 2) - 0.5) * 200).astype(np.float32)
    guide = np.floor(rng.rand(*hw) * 256).clip(0, 255).astype(np.float32)
    guide[:, hw[1] // 2:] = np.floor(guide[:, hw[1] // 2:] / 8)  # an edge
    want = np.asarray(jfgs.fast_global_smoother(
        jnp.asarray(src), jnp.asarray(guide), solver="pcr"))
    before = (tfgs.tridiag_pcr.launches, tfgs.smooth_pass.launches)
    got = tfgs.fast_global_smoother(torch.from_numpy(src),
                                    torch.from_numpy(guide))
    # CPU: plain path only
    assert (tfgs.tridiag_pcr.launches, tfgs.smooth_pass.launches) == before
    assert got.shape == (*hw, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


# the first (largest) and last lambda of the smoother's three iterations
@pytest.mark.parametrize("lam_t", [1.5 * 500.0 * 16.0 / 63.0,
                                   1.5 * 500.0 / 63.0])
@pytest.mark.parametrize("hw", [(37, 70), (48, 96)])
@pytest.mark.parametrize("axis", [0, 1])
def test_smooth_pass_plain_matches_devc_tpu(rng, hw, axis, lam_t):
    """One pass (K2's fused entry, plain version on CPU) against devc_tpu's
    `_smooth_axis`: axis 1 along the rows, axis 0 along the columns (the
    smoother's transposed call)."""
    src, guide = _frame(rng, hw)
    if axis == 1:
        want = jfgs._smooth_axis(jnp.asarray(src), jnp.asarray(guide), lam_t,
                                 4.0, "pcr")
    else:
        want = jnp.transpose(jfgs._smooth_axis(
            jnp.transpose(jnp.asarray(src), (1, 0, 2)), jnp.asarray(guide).T,
            lam_t, 4.0, "pcr"), (1, 0, 2))
    before = tfgs.smooth_pass.launches
    got = tfgs.smooth_pass(torch.from_numpy(src), torch.from_numpy(guide),
                           lam_t, 4.0, axis)
    assert tfgs.smooth_pass.launches == before  # CPU: the plain version
    assert got.shape == (*hw, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_smooth_pass_refuses_what_it_cannot_run(rng):
    """A bad axis, or tensors on no device it serves, raise; nothing
    falls back."""
    src, guide = _frame(rng, (8, 16))
    src, guide = torch.from_numpy(src), torch.from_numpy(guide)
    with pytest.raises(ValueError, match="axis"):
        tfgs.smooth_pass(src, guide, 10.0, 4.0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tfgs.smooth_pass(src.to("meta"), guide.to("meta"), 10.0, 4.0, 1)


def test_fast_global_smoother_matches_float64_oracle():
    """Against devc_tpu's independent float64 oracle of the published
    recurrence (dense solves), at its own bound: fp32 PCR vs an exact
    float64 solve on values spanning ~+-150."""
    from tests.test_fgs import fgs_oracle_np

    rng = np.random.RandomState(0)
    rgb = rng.rand(54, 96, 3)
    guide_u8 = (rgb.mean(-1) * 255.0).astype(np.uint8)
    src = (rgb[..., :2] - 0.5) * 200 + rng.randn(54, 96, 2) * 5
    want = fgs_oracle_np(src, guide_u8)
    got = tfgs.fast_global_smoother(torch.from_numpy(src.astype(np.float32)),
                                    torch.from_numpy(guide_u8.astype(np.float32)))
    assert np.abs(got.numpy() - want).max() < 5e-2


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """The wrapper launches K2 or raises; it never computes on the CPU."""
    a, b, c, d = (torch.from_numpy(np.ascontiguousarray(x.T))
                  for x in _systems(rng, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tfgs.tridiag_pcr(a, b, c, d)
