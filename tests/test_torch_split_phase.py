"""Port split-phase kernels (SAD volume, argmin over d): the plain twins vs
JAX ``sad_volume`` / ``wta_from_sad`` in interpret mode (bit-exact), the
wrappers' dispatch, and the kernels vs their twins on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.kernels import sad_wta as jsad
from gpu_stereo_matching_tpu.kernels import split_phase as jsp
from gpu_stereo_matching_tpu.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu_torch.kernels import split_phase as tsp
from gpu_stereo_matching_tpu_torch.models.block_matching import _right_view_sad
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity

INT32_MAX = np.iinfo(np.int32).max


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, shape, dtype=np.uint8),
        rng.integers(0, 256, shape, dtype=np.uint8),
    )


def _jax_volume(left, right, num_d, radius):
    return np.asarray(
        jsp.sad_volume(jnp.asarray(left), jnp.asarray(right), num_d, radius,
                       tile_h=8, interpret=True)
    )


@pytest.mark.parametrize(
    "hw,num_d,radius",
    [((21, 140), 8, 2), ((13, 17), 4, 1), ((24, 40), 7, 0), ((11, 20), 20, 3)],
)
def test_sad_volume_twin_matches_jax(hw, num_d, radius):
    left, right = _pair(1, hw)
    got = tsp.sad_volume(torch.from_numpy(left), torch.from_numpy(right), num_d, radius)
    assert got.dtype == torch.int32 and tuple(got.shape) == (num_d, *hw)
    np.testing.assert_array_equal(got.numpy(), _jax_volume(left, right, num_d, radius))


@pytest.mark.parametrize("seed", [4, 16, 30])
def test_split_phase_differs_from_fused_exactly_where_ops_does(seed):
    """At 30x120, D=64, r=5 these seeds make the fused formula (full-window
    invalid constant) and the ops formula (clipped row count) disagree near
    the top and bottom border. The port's volume follows ops bit for bit,
    so its disparity differs from the fused one exactly where ops does."""
    left, right = _pair(seed, (30, 120))
    vol = tsp.sad_volume(torch.from_numpy(left), torch.from_numpy(right), 64, 5)
    np.testing.assert_array_equal(vol.numpy(), _jax_volume(left, right, 64, 5))
    split = tsp.split_phase_block_matching(torch.from_numpy(left), torch.from_numpy(right), 64, 5)
    fused = np.asarray(jsad.fused_block_matching(
        jnp.asarray(left), jnp.asarray(right), num_disparities=64, radius=5,
        tile_h=8, interpret=True))
    ops = np.asarray(block_matching_pipeline(
        jnp.asarray(left), jnp.asarray(right), BlockMatchingConfig(num_disparities=64, sad_radius=5)))
    assert (ops != fused).any()
    np.testing.assert_array_equal(split.numpy() != fused, ops != fused)
    np.testing.assert_array_equal(split.numpy(), ops)


def test_wta_twin_matches_jax():
    rng = np.random.default_rng(2)
    vol = rng.integers(0, 4, (9, 13, 150)).astype(np.int32)  # many ties
    want = np.asarray(jsp.wta_from_sad(jnp.asarray(vol), interpret=True))
    got = tsp.wta_from_sad(torch.from_numpy(vol))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wta_on_right_view_volume_with_int32_max():
    """The right view holds INT32_MAX where x + d is past the image; there
    JAX's packed key SAD * D + d would overflow. The argmin is the first
    minimum, INT32_MAX entries included."""
    left, right = _pair(3, (12, 40))
    sad = tsp.sad_volume(torch.from_numpy(left), torch.from_numpy(right), 16, 2)
    sad_r = _right_view_sad(sad)
    assert int(sad_r.max()) == INT32_MAX
    got = tsp.wta_from_sad(sad_r)
    np.testing.assert_array_equal(got.numpy(), wta_disparity(sad_r).numpy())
    all_max = torch.full((5, 3, 4), INT32_MAX, dtype=torch.int32)
    all_max[3, 1, 2] = INT32_MAX - 1
    want = torch.zeros((3, 4), dtype=torch.int32)
    want[1, 2] = 3
    assert torch.equal(tsp.wta_from_sad(all_max), want)


def test_cpu_wrappers_do_not_launch():
    left, right = _pair(7, (8, 12))
    before = dict(tsp.LAUNCHES)
    tsp.split_phase_block_matching(torch.from_numpy(left), torch.from_numpy(right), 4, 1)
    assert tsp.LAUNCHES == before


def test_non_cpu_tensor_never_gets_the_twin():
    meta = torch.empty((8, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsp.sad_volume(meta, meta, 4, 1)
    with pytest.raises(RuntimeError, match="no kernel"):
        tsp.wta_from_sad(torch.empty((4, 8, 12), dtype=torch.int32, device="meta"))


def test_wrapper_input_checks():
    u8 = torch.zeros((8, 12), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        tsp.sad_volume(u8[None], u8[None], 4, 1)
    with pytest.raises(ValueError, match="num_disparities"):
        tsp.sad_volume(u8, u8, 13, 1)
    with pytest.raises(ValueError, match="invalid_cost"):
        tsp.sad_volume(u8, u8, 4, 1, invalid_cost=256)
    with pytest.raises(ValueError, match="int32"):
        tsp.wta_from_sad(torch.zeros((4, 8, 12), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(D, H, W\)"):
        tsp.wta_from_sad(torch.zeros((8, 12), dtype=torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "hw,num_d,radius",
    [((21, 33), 8, 2), ((30, 120), 63, 5), ((24, 40), 40, 0), ((33, 64), 64, 5), ((40, 130), 16, 6)],
)
def test_kernels_match_twins_on_card(cuda_device, hw, num_d, radius):
    left, right = _pair(8, hw)
    lt = torch.from_numpy(left).to(cuda_device)
    rt = torch.from_numpy(right).to(cuda_device)
    before = dict(tsp.LAUNCHES)
    vol = tsp.sad_volume(lt, rt, num_d, radius)
    disp = tsp.wta_from_sad(vol)
    sad_r = _right_view_sad(vol)
    disp_r = tsp.wta_from_sad(sad_r)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES["sad_volume"] == before["sad_volume"] + 1
    assert tsp.LAUNCHES["wta_from_sad"] == before["wta_from_sad"] + 2
    assert torch.equal(vol, tsp.sad_volume_reference(lt, rt, num_d, radius))
    assert torch.equal(disp, wta_disparity(vol))
    assert torch.equal(disp_r, wta_disparity(sad_r))
