"""Port block-matching ops (AD cost, box sums, WTA, unfused pipeline) vs JAX,
bit-exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.models import block_matching as jbm
from gpu_stereo_matching_tpu.ops import aggregate as jagg
from gpu_stereo_matching_tpu.ops import cost as jcost
from gpu_stereo_matching_tpu.ops import wta as jwta
from gpu_stereo_matching_tpu_torch.models import block_matching as tbm
from gpu_stereo_matching_tpu_torch.ops import aggregate as tagg
from gpu_stereo_matching_tpu_torch.ops import cost as tcost
from gpu_stereo_matching_tpu_torch.ops import wta as twta


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, shape, dtype=np.uint8),
        rng.integers(0, 256, shape, dtype=np.uint8),
    )


@pytest.mark.parametrize("hw,num_d", [((9, 13), 1), ((12, 20), 7), ((16, 40), 16)])
def test_ad_cost_volume(hw, num_d):
    left, right = _pair(1, hw)
    ad = jax.jit(jcost.ad_cost_volume, static_argnums=2)
    want = np.asarray(ad(jnp.asarray(left), jnp.asarray(right), num_d))
    got = tcost.ad_cost_volume(torch.from_numpy(left), torch.from_numpy(right), num_d)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius", [0, 1, 3, 9])
def test_aggregate_cost_volume(radius):
    rng = np.random.default_rng(2)
    vol = rng.integers(0, 256, (5, 14, 23), dtype=np.uint8)
    agg = jax.jit(jagg.aggregate_cost_volume, static_argnums=1)
    want = np.asarray(agg(jnp.asarray(vol), radius))
    got = tagg.aggregate_cost_volume(torch.from_numpy(vol), radius).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_filter_sum_float_and_one_axis():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 11)).astype(np.float32)
    want = np.asarray(jagg.box_filter_sum(jnp.asarray(x), 2, axes=(-1,)))
    got = tagg.box_filter_sum(torch.from_numpy(x), 2, dims=(-1,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # float prefix sums


@pytest.mark.parametrize("shape,radius", [((7, 9), 1), ((4, 30), 5)])
def test_window_counts(shape, radius):
    want = np.asarray(jax.jit(jagg.window_counts, static_argnums=(0, 1))(shape, radius))
    np.testing.assert_array_equal(tagg.window_counts(shape, radius).numpy(), want)


def test_wta_ties_go_to_smallest_d():
    rng = np.random.default_rng(4)
    vol = rng.integers(0, 3, (6, 8, 9)).astype(np.int32)  # many ties
    want = np.asarray(jwta.wta_disparity(jnp.asarray(vol)))
    np.testing.assert_array_equal(twta.wta_disparity(torch.from_numpy(vol)).numpy(), want)
    jd, jc = jwta.wta_with_cost(jnp.asarray(vol))
    td, tc = twta.wta_with_cost(torch.from_numpy(vol))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize(
    "hw,num_d,radius",
    [((21, 33), 8, 2), ((13, 17), 4, 1), ((30, 120), 64, 5), ((24, 40), 7, 0)],
)
def test_block_matching_disparity(hw, num_d, radius):
    left, right = _pair(5, hw)
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=radius)
    want = np.asarray(jbm.block_matching_pipeline(jnp.asarray(left), jnp.asarray(right), cfg))
    got = tbm.block_matching_disparity(torch.from_numpy(left), torch.from_numpy(right), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_matching_pipeline_batched():
    left, right = _pair(6, (3, 15, 26))
    cfg = BlockMatchingConfig(num_disparities=6, sad_radius=2)
    want = np.asarray(jbm.block_matching_pipeline(jnp.asarray(left), jnp.asarray(right), cfg))
    got = tbm.block_matching_pipeline(torch.from_numpy(left), torch.from_numpy(right), cfg)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "cfg",
    [
        BlockMatchingConfig(num_disparities=4, sad_radius=1, lr_consistency=True),
        BlockMatchingConfig(num_disparities=4, sad_radius=1, median_radius=2),
    ],
)
def test_post_filters_not_ported_raise(cfg):
    """The post-filter configs that this test once held to raising now run,
    bit-exact against JAX; the name is kept so the test's record stays
    continuous (tests/test_torch_postfilter.py covers the rest)."""
    left, right = _pair(7, (8, 10))
    want = np.asarray(jbm.block_matching_pipeline(jnp.asarray(left), jnp.asarray(right), cfg))
    got = tbm.block_matching_pipeline(torch.from_numpy(left), torch.from_numpy(right), cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pipeline_input_checks():
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    u8 = torch.zeros((8, 10), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        tbm.block_matching_pipeline(u8.to(torch.int32), u8.to(torch.int32), cfg)
    with pytest.raises(ValueError, match="shapes differ"):
        tbm.block_matching_pipeline(u8, u8[:, :9], cfg)
    with pytest.raises(ValueError, match="num_disparities"):
        tbm.block_matching_pipeline(
            u8, u8, BlockMatchingConfig(num_disparities=11, sad_radius=1)
        )
