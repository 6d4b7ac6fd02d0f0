"""The port's grayscale VGG19 (devc_tpu_torch/models/vgg19_gray.py) against
devc_tpu's vgg19_gray_extract, on random weights carried across through
the torchvision-layout converter, on the CPU.

Both run the same fp32 convolutions in other summation orders (devc_tpu
under 'highest' matmul precision, tests/conftest.py), so activations
agree to ~1e-6 of their scale per layer; the bound is 1e-4 of each tap's
largest magnitude, tests/test_torch_models.py's bound for the main VGG.
Weights must round-trip bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devc_tpu.models import vgg19_gray as jgray
from devc_tpu.utils import convert as jconvert
from devc_tpu_torch.models.vgg19_gray import (
    TORCHVISION_CONV_INDICES,
    vgg19_gray_extract,
)
from devc_tpu_torch.utils import convert as tconvert


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, jgray.vgg19_gray_init(
        jax.random.PRNGKey(0)))
    sd = tconvert.vgg19_gray_state_dict(params)
    return params, sd, tconvert.vgg19_gray_from_state_dict(sd, "cpu")


def test_state_dict_is_torchvisions_layout_and_round_trips(weights):
    params, sd, model = weights
    assert set(sd) == {f"{i}.{k}" for i in TORCHVISION_CONV_INDICES
                       for k in ("weight", "bias")}
    assert set(model.state_dict()) == set(sd)
    back = jconvert.vgg19_gray_from_torch(model.state_dict())
    for name, p in params.items():
        for k in p:
            np.testing.assert_array_equal(back[name][k], p[k])


@pytest.mark.parametrize("include_r21", [False, True])
@pytest.mark.parametrize("hw", [(37, 45), (64, 64)])
def test_vgg19_gray_matches_devc_tpu(weights, include_r21, hw):
    params, _sd, model = weights
    rng = np.random.RandomState(hw[0])
    gray = rng.uniform(0, 255, (2, *hw, 1)).astype(np.float32)
    x = np.repeat(gray, 3, axis=-1)  # [LLL]
    with torch.no_grad():
        got = vgg19_gray_extract(model, torch.from_numpy(x), include_r21)
    want = jgray.vgg19_gray_extract(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x), include_r21)
    assert len(got) == len(want) == (4 if include_r21 else 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))
