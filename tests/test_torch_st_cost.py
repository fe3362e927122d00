"""The segment tree's cost in the port against the JAX package on the CPU:
``gradient_x``, ``_shifted_right`` and ``color_gradient_cost_volume``.

Op by op (JAX's eager mode) the volume is bit-exact. A jitted JAX volume
may fuse the blend ``alpha * color + (1 - alpha) * grad`` into a fused
multiply-add in some elements, so against it the port is held to
``atol=1e-5, rtol=1e-6`` with the unequal elements counted."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import CostConstants as JaxConsts
from gpu_stereo_matching_tpu.ops import color as jcolor
from gpu_stereo_matching_tpu.ops import cost as jcost
from gpu_stereo_matching_tpu_torch.core.config import CostConstants
from gpu_stereo_matching_tpu_torch.ops import color as tcolor
from gpu_stereo_matching_tpu_torch.ops import cost as tcost
from tests import oracles

# (H, W, D): random pairs, D = 1, 6 and 17, W < D, a 1-column image.
CASES = [(9, 13, 1), (9, 13, 6), (20, 33, 17), (5, 4, 6), (3, 2, 17), (6, 1, 1), (48, 64, 16)]


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def jitted_cost():
    return jax.jit(jcost.color_gradient_cost_volume, static_argnums=(2, 3))


@pytest.mark.parametrize("shape", [(5, 9), (7, 2), (3, 1), (2, 4, 11), (1, 300)])
def test_gradient_x_bit_exact(shape):
    g = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = tcolor.gradient_x(torch.from_numpy(g))
    want = np.asarray(jcolor.gradient_x(jnp.asarray(g)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_gradient_x_border_columns_are_not_halved():
    g = torch.tensor([[10, 20, 50, 60]], dtype=torch.uint8)
    np.testing.assert_array_equal(tcolor.gradient_x(g).numpy(),
                                  [[137.5, 147.5, 147.5, 137.5]])


@pytest.mark.parametrize("d", [1, 2, 5, 12])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_shifted_right_bit_exact(d, dtype):
    x = np.random.default_rng(2).integers(-300, 300, (3, 4, 9)).astype(dtype)
    got = tcost._shifted_right(torch.from_numpy(x), d)
    want = np.asarray(jcost._shifted_right(jnp.asarray(x), d))
    np.testing.assert_array_equal(got.numpy(), want)
    # Left-edge replication: columns x < d repeat column 0.
    for k in range(d):
        cols = min(k, x.shape[-1])
        np.testing.assert_array_equal(got[k, ..., :cols].numpy(),
                                      np.repeat(x[..., :1], cols, axis=-1))


@pytest.mark.parametrize("h,w,d", CASES)
def test_cost_volume_matches_jax(jitted_cost, h, w, d):
    left, right = _pair(h * 100 + w, h, w)
    got = tcost.color_gradient_cost_volume(torch.from_numpy(left), torch.from_numpy(right), d)
    assert got.dtype == torch.float32
    eager = np.asarray(jcost.color_gradient_cost_volume(jnp.asarray(left), jnp.asarray(right), d))
    assert got.shape == eager.shape
    np.testing.assert_array_equal(got.numpy(), eager)
    jitted = np.asarray(jitted_cost(jnp.asarray(left), jnp.asarray(right), d, JaxConsts()))
    np.testing.assert_allclose(got.numpy(), jitted, atol=1e-5, rtol=1e-6)
    assert int((got.numpy() != jitted).sum()) <= max(2, got.numel() // 10000)


def test_cost_volume_constants_and_oracle():
    left, right = _pair(7, 12, 20)
    consts = CostConstants(tau_color=5.0, tau_gradient=3.0, alpha=0.3)
    got = tcost.color_gradient_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 8,
                                           consts)
    want = np.asarray(jcost.color_gradient_cost_volume(
        jnp.asarray(left), jnp.asarray(right), 8, JaxConsts(tau_color=5.0, tau_gradient=3.0,
                                                             alpha=0.3)))
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = oracles.color_grad_cost_volume_oracle(left, right, 8)
    default = tcost.color_gradient_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 8)
    np.testing.assert_allclose(default.numpy(), oracle, atol=1e-5, rtol=1e-5)


def test_cost_volume_on_a_shifted_pair_is_zero_at_the_shift():
    """A right view shifted by 3 columns costs 0 at d = 3 away from the
    border columns, whose gradients are one-sided differences."""
    left, _ = _pair(8, 10, 24)
    right = np.concatenate([left[:, 3:], np.repeat(left[:, -1:], 3, axis=1)], axis=1)
    got = tcost.color_gradient_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 6)
    assert float(got[3, :, 4:-4].abs().max()) == 0.0
    assert float(got[0, :, 3:].min()) >= 0.0
