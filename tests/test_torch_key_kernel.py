"""Port partial-range key kernel: the plain twin vs JAX
``fused_block_matching_key`` in interpret mode (bit-exact), the identity
that ties the keys to ``fused_block_matching``, the wrapper's checks,
``ad_cost_volume_offset`` vs JAX, and the kernel vs its twin on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.kernels import sad_wta as jsad
from gpu_stereo_matching_tpu.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu.ops import cost as jcost
from gpu_stereo_matching_tpu_torch.kernels import sad_wta as tsad
from gpu_stereo_matching_tpu_torch.ops import cost as tcost


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, shape, dtype=np.uint8),
        rng.integers(0, 256, shape, dtype=np.uint8),
    )


def _jax_key(left, right, d_start, count, total, radius):
    return np.asarray(
        jsad.fused_block_matching_key(
            jnp.asarray(left), jnp.asarray(right), jnp.int32(d_start),
            count=count, total_disparities=total, radius=radius, tile_h=8,
            interpret=True,
        )
    )


def _port_key(left, right, d_start, count, total, radius):
    got = tsad.fused_block_matching_key(
        torch.from_numpy(left), torch.from_numpy(right), d_start, count, total, radius
    )
    assert got.dtype == torch.int32 and got.shape == left.shape
    return got.numpy()


# Even counts with r >= 1 take the TPU's packed body, odd counts and r = 0
# the legacy body; d_start is 0, odd, and total - count; widths under and
# over the TPU's 128 lanes.
@pytest.mark.parametrize(
    "hw,d_start,count,total,radius",
    [
        ((21, 33), 0, 8, 8, 2),
        ((21, 33), 3, 4, 8, 2),
        ((21, 33), 4, 4, 8, 1),
        ((13, 17), 0, 3, 8, 1),
        ((13, 17), 3, 5, 8, 2),
        ((13, 17), 5, 3, 8, 0),
        ((24, 40), 1, 6, 16, 0),
        ((9, 130), 5, 4, 12, 1),
        ((16, 257), 7, 5, 12, 2),
        ((16, 257), 8, 4, 12, 5),
        ((20, 140), 16, 16, 64, 5),
        ((20, 140), 33, 31, 64, 5),
        ((20, 140), 0, 64, 64, 5),
        ((14, 64), 48, 16, 64, 2),
    ],
)
def test_twin_matches_jax_key(hw, d_start, count, total, radius):
    left, right = _pair(1234, hw)
    np.testing.assert_array_equal(
        _port_key(left, right, d_start, count, total, radius),
        _jax_key(left, right, d_start, count, total, radius),
    )


@pytest.mark.parametrize("seed", [4, 16, 30])
def test_split_ranges_reduce_to_fused_not_ops(seed):
    """D=64, r=5 in 4 ranges: each range's keys equal JAX's, their minimum
    mod 64 is the JAX fused disparity, and that differs from the JAX ops
    pipeline near the top and bottom border on these seeds."""
    left, right = _pair(seed, (30, 120))
    keys = None
    for k in range(4):
        part = _port_key(left, right, 16 * k, 16, 64, 5)
        np.testing.assert_array_equal(part, _jax_key(left, right, 16 * k, 16, 64, 5))
        keys = part if keys is None else np.minimum(keys, part)
    fused = np.asarray(
        jsad.fused_block_matching(
            jnp.asarray(left), jnp.asarray(right), num_disparities=64, radius=5,
            tile_h=8, interpret=True,
        )
    )
    np.testing.assert_array_equal(keys % 64, fused)
    ops = np.asarray(
        block_matching_pipeline(
            jnp.asarray(left), jnp.asarray(right),
            BlockMatchingConfig(num_disparities=64, sad_radius=5),
        )
    )
    rows = np.nonzero((ops != keys % 64).any(axis=1))[0]
    assert rows.size > 0 and np.all((rows < 5) | (rows >= 25))


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 12])
def test_minimum_over_any_split_is_the_fused_twin(parts):
    """The keys of any split of the range reduce to the whole-range twin,
    batched inputs included."""
    left, right = _pair(9, (2, 19, 45))
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    count = 12 // parts
    keys = torch.stack([
        tsad.fused_block_matching_key(lt, rt, k * count, count, 12, 3) for k in range(parts)
    ]).amin(dim=0)
    assert torch.equal(keys % 12, tsad.fused_block_matching_reference(lt, rt, 12, 3))


def test_key_is_sad_times_total_plus_d():
    """One disparity: the key unpacks to the SAD volume's plane."""
    left, right = _pair(10, (12, 30))
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    key = tsad.fused_block_matching_key(lt, rt, 5, 1, 9, 1)
    assert torch.equal(key % 9, torch.full_like(key, 5))
    # Interior rows: the fused and the ops formula agree there.
    from gpu_stereo_matching_tpu_torch.kernels.split_phase import sad_volume_reference

    sad = sad_volume_reference(lt, rt, 9, 1)[5]
    assert torch.equal((key // 9)[1:-1], sad[1:-1])


def test_wrapper_raises_on_bad_ranges_and_overflow():
    u8 = torch.zeros((8, 80), dtype=torch.uint8)
    for d_start, count, total in ((0, 0, 8), (-1, 4, 8), (5, 4, 8), (8, 1, 8)):
        with pytest.raises(ValueError, match="range"):
            tsad.fused_block_matching_key(u8, u8, d_start, count, total, 1)
    with pytest.raises(ValueError, match="num_disparities"):
        tsad.fused_block_matching_key(u8, u8, 0, 4, 81, 1)
    with pytest.raises(ValueError, match="radius"):
        tsad.fused_block_matching_key(u8, u8, 0, 4, 8, -1)
    with pytest.raises(TypeError, match="uint8"):
        tsad.fused_block_matching_key(u8.float(), u8.float(), 0, 4, 8, 1)
    # 255 * 401**2 * 53 + 53 >= 2**31 > 255 * 401**2 * 52 + 52.
    wide = torch.zeros((4, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        tsad.fused_block_matching_key(wide, wide, 0, 1, 53, 200)
    assert tsad.fused_block_matching_key(wide, wide, 0, 1, 52, 200).shape == (4, 64)


def test_largest_key_at_default_config():
    """All-invalid windows at D=64, r=5 give the largest key, 1,974,783."""
    left = torch.full((12, 64), 255, dtype=torch.uint8)
    right = torch.zeros((12, 64), dtype=torch.uint8)
    key = tsad.fused_block_matching_key(left, right, 63, 1, 64, 5)
    assert int(key.max()) == 255 * 121 * 64 + 63 == 1974783


def test_cpu_wrapper_does_not_launch_and_meta_raises():
    left, right = _pair(7, (2, 8, 12))
    before = tsad.KEY_LAUNCHES
    tsad.fused_block_matching_key(torch.from_numpy(left), torch.from_numpy(right), 1, 2, 4, 1)
    assert tsad.KEY_LAUNCHES == before
    meta = torch.empty((8, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsad.fused_block_matching_key(meta, meta, 0, 2, 4, 1)


@pytest.mark.parametrize("hw,count,d_offset,invalid", [
    ((9, 20), 4, 0, 255), ((9, 20), 3, 5, 255), ((7, 33), 8, 16, 200), ((5, 12), 6, 6, 255),
])
def test_ad_cost_volume_offset_matches_jax(hw, count, d_offset, invalid):
    left, right = _pair(11, hw)
    want = np.asarray(
        jcost.ad_cost_volume_offset(
            jnp.asarray(left), jnp.asarray(right), count, jnp.int32(d_offset), invalid
        )
    )
    got = tcost.ad_cost_volume_offset(
        torch.from_numpy(left), torch.from_numpy(right), count, d_offset, invalid
    )
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_ad_cost_volume_offset_zero_is_the_whole_volume():
    left, right = _pair(12, (6, 15))
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    assert torch.equal(tcost.ad_cost_volume_offset(lt, rt, 7, 0), tcost.ad_cost_volume(lt, rt, 7))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,d_start,count,total,radius",
    [
        ((21, 33), 0, 8, 8, 2),
        ((21, 33), 3, 5, 8, 0),
        ((3, 70, 250), 5, 3, 16, 7),
        ((30, 120), 16, 16, 64, 5),
        ((30, 120), 48, 16, 64, 5),
        ((2, 37, 300), 33, 31, 64, 1),
        ((33, 64), 0, 64, 64, 5),
    ],
)
def test_key_kernel_matches_twin_on_card(cuda_device, shape, d_start, count, total, radius):
    left, right = _pair(8, shape)
    lt = torch.from_numpy(left).to(cuda_device)
    rt = torch.from_numpy(right).to(cuda_device)
    before = tsad.KEY_LAUNCHES
    got = tsad.fused_block_matching_key(lt, rt, d_start, count, total, radius)
    torch.cuda.synchronize()
    assert tsad.KEY_LAUNCHES == before + 1
    assert torch.equal(
        got, tsad.fused_block_matching_key_reference(lt, rt, d_start, count, total, radius)
    )
