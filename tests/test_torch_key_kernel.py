"""Port partial-range key kernel: the plain twin vs JAX
``fused_block_matching_key`` in interpret mode (bit-exact), the identity
that ties the keys to ``fused_block_matching``, the strip body's arithmetic
over a runtime range (16:16 keys widened once) emulated in torch against the
twin, the wrapper's checks, ``ad_cost_volume_offset`` vs JAX, and the
kernel's two bodies vs its twin on a card."""

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
from tests.test_torch_sad_wta import STRUCTURED, _packed_pair_emulation, _structured_pair


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


# Where ties and extremes decide the key, over ranges that start at an odd d
# (the staged right tile's offset is wrong only where d_start > 0), with odd
# and even counts, up to the total and short of it.
@pytest.mark.parametrize("kind", STRUCTURED)
@pytest.mark.parametrize(
    "d_start,count,total,radius",
    [(17, 15, 64, 5), (33, 31, 64, 5), (5, 8, 65, 2), (47, 18, 65, 7), (1, 1, 64, 1)],
)
def test_twin_matches_jax_key_on_structured_inputs(kind, d_start, count, total, radius):
    left, right = _structured_pair(kind, (19, 90))
    want = _jax_key(left, right, d_start, count, total, radius)
    np.testing.assert_array_equal(_port_key(left, right, d_start, count, total, radius), want)
    if kind == "constant":  # every d ties at SAD 0 but for the invalid columns
        assert (want[:, total + radius:] == d_start).all()


def _emulated_pair(kind, shape, seed):
    if kind == "random":
        return _pair(seed, shape)
    return _structured_pair(kind, shape)


# (d_start, count, total, (H, W)): odd and even starts and counts, ranges that
# end at the total, totals of 64, 65 and 255; 37 rows and 70 columns cross a
# tile's and a strip's edge.
EMULATED_RANGES = [
    (0, 64, 64, (37, 70)), (16, 16, 64, (37, 70)), (17, 15, 64, (37, 70)),
    (33, 31, 64, (37, 70)), (5, 8, 65, (37, 70)), (48, 17, 65, (37, 70)),
    (101, 6, 255, (12, 260)), (246, 9, 255, (12, 260)),
]


@pytest.mark.parametrize("kind", ["extremes", "two_level", "constant", "random"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("d_start,count,total,shape", EMULATED_RANGES)
def test_packed_range_arithmetic_matches_key_twin(d_start, count, total, shape, radius, kind):
    """The strip body over a runtime range, for every radius it serves: the
    loop's key is ``(SAD << 16) | d`` with the global d and is widened once to
    ``SAD * total + d``. For d < total < 2**16 and SAD < 2**16 both order the
    pairs (SAD, d) alike, so the widened minimum is the twin's minimum."""
    left, right = _emulated_pair(kind, shape, radius)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    want = tsad.fused_block_matching_key_reference(lt, rt, d_start, count, total, radius)
    got = _packed_pair_emulation(lt, rt, count, radius, d_start=d_start, total=total)
    assert torch.equal(got, want.to(torch.int64))


@pytest.mark.parametrize("mutation,kind,d_start,count", [
    ("local_d", "constant", 17, 15),     # the key must carry the global d
    ("no_invalid", "random", 17, 15),    # an odd count's dead half must not win
    ("shift_kept", "random", 16, 16),    # the widening takes the << 16 out
])
def test_packed_range_emulation_catches_mutations(mutation, kind, d_start, count):
    """The emulation is a yardstick only if breaking it shows: each mutation
    of one step differs from the twin, and the unbroken form does not."""
    left, right = _emulated_pair(kind, (37, 70), 3)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    want = tsad.fused_block_matching_key_reference(lt, rt, d_start, count, 64, 5).to(torch.int64)
    assert torch.equal(_packed_pair_emulation(lt, rt, count, 5, d_start=d_start, total=64), want)
    broken = _packed_pair_emulation(lt, rt, count, 5, d_start=d_start, total=64,
                                    mutation=mutation)
    assert not torch.equal(broken, want)


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


# Both bodies of the kernel (the strip body serves r = 1..7, the general one
# r = 0 and r >= 8), on random and structured inputs: ragged tiles and strips,
# ranges that start at an odd d, odd counts, totals of 65 and 129.
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random"] + STRUCTURED)
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
        ((3, 33, 257), 17, 15, 64, 5),
        ((1, 65, 129), 101, 28, 129, 7),
        ((1, 17, 385), 31, 33, 65, 1),
        ((2, 40, 130), 17, 15, 64, 8),
        ((1, 65, 129), 1, 128, 129, 9),
    ],
)
def test_key_kernel_matches_twin_on_card(cuda_device, shape, d_start, count, total, radius, kind):
    if kind == "random":
        left, right = _pair(8, shape)
    else:
        left, right = _structured_pair(kind, shape)
    lt = torch.from_numpy(left).to(cuda_device)
    rt = torch.from_numpy(right).to(cuda_device)
    before = tsad.KEY_LAUNCHES
    got = tsad.fused_block_matching_key(lt, rt, d_start, count, total, radius)
    torch.cuda.synchronize()
    assert tsad.KEY_LAUNCHES == before + 1
    assert torch.equal(
        got, tsad.fused_block_matching_key_reference(lt, rt, d_start, count, total, radius)
    )
    assert tsad.key_kernel_body(count, total, radius) == (
        "strips" if 1 <= radius <= 7 else "general")


@pytest.mark.gpu
def test_key_kernel_body_follows_count_total_radius(cuda_device):
    """The body is a function of (count, total, radius) alone: strips for
    r = 1..7 while a disparity fits the key's low half and the staged tile
    fits shared memory, the general body otherwise. (The rule lives in the
    C library, which only a machine with nvcc builds.)"""
    assert tsad.key_kernel_body(16, 64, 5) == tsad.key_kernel_body(64, 64, 5) == "strips"
    assert tsad.key_kernel_body(16, 64, 0) == tsad.key_kernel_body(16, 64, 8) == "general"
    assert tsad.key_kernel_body(16, 65535, 7) == "strips"
    assert tsad.key_kernel_body(16, 65536, 7) == "general"
    assert tsad.key_kernel_body(6000, 8000, 5) == "general"  # the staged tile is too large
    plan = tsad.key_launch_plan((1, 1090, 1920), 16, 64, 5, cuda_device)
    assert plan["body"] == "strips" and plan["blocks"] == 35 * 15
