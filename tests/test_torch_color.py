"""Port gray conversion vs the JAX package, bit-exact over every BGR triple."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.ops import color as jcolor
from gpu_stereo_matching_tpu_torch.ops import color as tcolor


@pytest.fixture(scope="module")
def all_bgr():
    """All 2**24 BGR triples as one (4096, 4096, 3) uint8 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=-1)
    return img.astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("name", ["gray_blockmatching_bgr", "gray_rec601_bgr"])
def test_gray_all_bgr_triples_bit_exact(all_bgr, name):
    want = np.asarray(getattr(jcolor, name)(jnp.asarray(all_bgr)))
    got = getattr(tcolor, name)(torch.from_numpy(all_bgr)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_float32_sum_is_not_enough(all_bgr):
    """A left-to-right float32 sum misses the JAX result on some triples, so
    the exhaustive test above can tell the FMA chain from it."""
    want = np.asarray(jcolor.gray_blockmatching_bgr(jnp.asarray(all_bgr)))
    c = torch.from_numpy(all_bgr).to(torch.float32)
    plain = c[..., 0] * 0.299 + c[..., 1] * 0.587 + c[..., 2] * 0.114
    assert (tcolor.round_sat_u8(plain).numpy() != want).sum() > 0


def test_round_sat_u8_matches_jax():
    x = np.array(
        [-3.5, -0.5, 0.4999, 0.5, 1.5, 2.5, 127.49, 127.5, 128.5, 254.5, 255.5, 300.0],
        np.float32,
    )
    want = np.asarray(jcolor.round_sat_u8(jnp.asarray(x)))
    np.testing.assert_array_equal(tcolor.round_sat_u8(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("rounding", ["half_up", "half_even"])
def test_grayscale_u8_batched_custom_weights(rounding):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    weights = (0.2, 0.5, 0.3)
    want = np.asarray(jcolor.grayscale_u8(jnp.asarray(img), weights, rounding))
    got = tcolor.grayscale_u8(torch.from_numpy(img), weights, rounding).numpy()
    np.testing.assert_array_equal(got, want)


def test_grayscale_u8_unknown_rounding():
    with pytest.raises(ValueError, match="rounding"):
        tcolor.grayscale_u8(torch.zeros((2, 2, 3), dtype=torch.uint8), (1, 0, 0), "down")
