"""devc_tpu_torch primitives vs their devc_tpu counterparts on CPU.

The same numpy inputs go through both; the port's NCHW primitives are fed
the NHWC arrays transposed. Tolerances are fp32 round-off of the same
formulas evaluated in another order (or, for pow vs cbrt, another libm
routine): ~1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu import colorspace as jcs
from devc_tpu.ops import layers as jlayers
from devc_tpu.ops import resize as jresize
from devc_tpu_torch import colorspace as tcs
from devc_tpu_torch.ops import layers as tlayers
from devc_tpu_torch.ops import resize as tresize


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _rgb(rng, shape=(2, 8, 12, 3)):
    return rng.rand(*shape).astype(np.float32)


def _lab(rng, shape=(2, 8, 12, 3)):
    lab = rng.rand(*shape).astype(np.float32)
    lab[..., 0] *= 100.0
    lab[..., 1:] = (lab[..., 1:] - 0.5) * 256.0
    return lab


@pytest.mark.parametrize("name", ["rgb_to_lab", "srgb_to_linear"])
def test_rgb_side(rng, name):
    x = _rgb(rng)
    want = np.asarray(getattr(jcs, name)(jnp.asarray(x)))
    got = getattr(tcs, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_linear_to_srgb(rng):
    """Both branches, and values at and around the 0.0031308 threshold
    (a float32 step either side of it and exactly on it)."""
    t = np.float32(0.0031308)
    edge = np.array([0.0, 1e-12, 1e-6, np.nextafter(t, np.float32(0)), t,
                     np.nextafter(t, np.float32(1)), 0.0031, 0.0032, 1.0],
                    np.float32)
    x = np.concatenate([edge, rng.rand(64).astype(np.float32),
                        rng.rand(16).astype(np.float32) * 0.01])
    want = np.asarray(jcs.linear_to_srgb(jnp.asarray(x)))
    got = tcs.linear_to_srgb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[:4], want[:4])  # the linear branch


@pytest.mark.parametrize("name", ["lab_to_rgb", "center_lab", "uncenter_lab",
                                  "lab_centered_to_rgb"])
def test_lab_side(rng, name):
    x = _lab(rng)
    if name == "lab_centered_to_rgb":
        x[..., 0] -= 50.0
    want = np.asarray(getattr(jcs, name)(jnp.asarray(x)))
    got = getattr(tcs, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["center_l", "uncenter_l", "gray_to_rgb"])
def test_l_side(rng, name):
    x = (rng.rand(2, 8, 12, 1).astype(np.float32) - 0.5) * 100.0
    want = np.asarray(getattr(jcs, name)(jnp.asarray(x)))
    got = getattr(tcs, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_vgg_preprocess(rng):
    x = _rgb(rng)
    want = np.asarray(jcs.vgg_preprocess(jnp.asarray(x)))
    got = tcs.vgg_preprocess(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_feature_normalize(rng):
    x = rng.randn(2, 6, 10, 64).astype(np.float32)
    want = np.asarray(jcs.feature_normalize(jnp.asarray(x)))
    got = tcs.feature_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("in_hw,out_hw,atol", [
    ((48, 96), (24, 48), 1e-4),
    ((24, 48), (48, 96), 1e-4),
    ((16, 16), (16, 16), 0.0),
    # non-integer factors: torch forms the source coordinates in fp32,
    # devc_tpu in float64, so the weights differ by ~1e-7 * in_size; on
    # values of +-150 that is a few 1e-4
    ((27, 40), (13, 17), 1e-3),
])
def test_resize_bilinear(rng, in_hw, out_hw, atol):
    """F.interpolate(bilinear, align_corners=False, antialias=False) is the
    half-pixel map devc_tpu builds as interpolation matrices."""
    x = rng.randn(1, *in_hw, 3).astype(np.float32) * 50.0
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw))
    got = _nhwc(tresize.resize_bilinear(_nchw(x), out_hw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("op,arg", [("upsample_nearest", 2),
                                    ("upsample_nearest", 4),
                                    ("avg_pool", 4), ("max_pool", 2)])
def test_resample(rng, op, arg):
    x = rng.randn(2, 12, 16, 5).astype(np.float32)
    want = np.asarray(getattr(jresize, op)(jnp.asarray(x), arg))
    got = _nhwc(getattr(tresize, op)(_nchw(x), arg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_instance_norm(rng):
    x = (rng.randn(2, 9, 14, 6) * 3.0 + 1.5).astype(np.float32)
    want = np.asarray(jlayers.instance_norm(jnp.asarray(x)))
    got = _nhwc(tlayers.instance_norm(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_prelu_and_leaky_relu(rng):
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jlayers.prelu({"a": jnp.asarray([0.25])}, jnp.asarray(x)))
    got = _nhwc(tlayers.prelu(_nchw(x), torch.tensor([0.25])))
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jlayers.leaky_relu(jnp.asarray(x), 0.2))
    got = _nhwc(tlayers.leaky_relu(_nchw(x), 0.2))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("hw,pad_h,pad_w", [((6, 8), (1, 1), (0, 0)),
                                            ((6, 8), (0, 2), (3, 1)),
                                            ((1, 3), (1, 1), (1, 1))])
def test_pads(rng, hw, pad_h, pad_w):
    """(1, 3): a one-row map, as relu5_1 is at net H = 24."""
    x = rng.randn(1, *hw, 4).astype(np.float32)
    want = np.asarray(jlayers.replicate_pad(jnp.asarray(x), pad_h, pad_w))
    got = _nhwc(tlayers.replicate_pad(_nchw(x), pad_h, pad_w))
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jlayers.reflect_pad(jnp.asarray(x), 1))
    got = _nhwc(tlayers.reflect_pad(_nchw(x), 1))
    np.testing.assert_array_equal(got, want)
