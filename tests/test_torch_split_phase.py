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


def _structured_pair(kind, shape, seed=21):
    """Inputs on which a matcher's faults show: a constant pair, ties almost
    everywhere (two levels), the largest SAD the radius allows (255 against
    0), a known shift."""
    rng = np.random.default_rng(seed)
    if kind == "constant":
        return np.full(shape, 77, np.uint8), np.full(shape, 77, np.uint8)
    if kind == "two_level":
        return (rng.integers(0, 2, shape, dtype=np.uint8),
                rng.integers(0, 2, shape, dtype=np.uint8))
    if kind == "extremes":
        return np.full(shape, 255, np.uint8), np.zeros(shape, np.uint8)
    assert kind == "shifted"
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.integers(-2, 3, shape)
    right = np.clip(np.roll(left, -9, axis=-1) + noise, 0, 255).astype(np.uint8)
    return left, right


STRUCTURED = ["constant", "two_level", "extremes", "shifted"]


def _inputs(source, shape):
    """A random pair from a seed, or a structured pair by its kind."""
    return _pair(source, shape) if isinstance(source, int) else _structured_pair(source, shape)


# The main path's D=64, r=5 too: at 30x120 the seeds 4, 16 and 30 are those
# on which the clipped-window formula and the fused one pick different
# disparities, and on 255 against 0 every invalid column's cost shows.
@pytest.mark.parametrize(
    "hw,num_d,radius,source",
    [pytest.param((21, 140), 8, 2, 1, id="hw0-8-2"),
     pytest.param((13, 17), 4, 1, 1, id="hw1-4-1"),
     pytest.param((24, 40), 7, 0, 1, id="hw2-7-0"),
     pytest.param((11, 20), 20, 3, 1, id="hw3-20-3"),
     pytest.param((30, 120), 64, 5, 4, id="hw4-64-5-seed4"),
     pytest.param((30, 120), 64, 5, 16, id="hw4-64-5-seed16"),
     pytest.param((30, 120), 64, 5, 30, id="hw4-64-5-seed30"),
     pytest.param((30, 120), 64, 5, "extremes", id="hw4-64-5-extremes"),
     pytest.param((9, 70), 63, 5, "shifted", id="hw5-63-5-shifted")],
)
def test_sad_volume_twin_matches_jax(hw, num_d, radius, source):
    left, right = _inputs(source, hw)
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


def _packed_volume_emulation(left, right, num_d, radius, invalid, tile=32, steps=32,
                             mutation=None):
    """The CUDA strip body's arithmetic under the volume kernel's policy, in
    torch, on int64 tensors cut to 32 bits after every operation. The range
    is cut into parts of ``steps`` disparities (one block each); in a part
    two disparities share a word (d in the low half, d + 1 in the high
    half), both passes slide a window sum with one add and one subtract per
    step (restarting every ``tile`` rows and columns, as the kernel's tiles
    and strips do), and every step's halves go to the planes d and d + 1. A
    half whose column is invalid (x < d, or the dead d + 1 of an odd part)
    sums, in place of the absolute differences, ``invalid`` for each row of
    the window inside the image and 0 for the rest.

    Returns a (num_d + 1, H, W) buffer that starts at -1, so a store past
    the volume's last plane shows. ``mutation`` breaks one step on purpose:
    ``"fused_constant"`` starts an invalid half from the fused kernels'
    ``255 * (2r + 1)`` and feeds it nothing; ``"dead_half_stored"`` stores
    the high half of an odd part's last step."""
    m32 = 0xFFFFFFFF
    k = 2 * radius + 1
    h, w = left.shape
    li = torch.nn.functional.pad(left.to(torch.int64), (0, 0, radius, radius))
    ri = torch.nn.functional.pad(right.to(torch.int64), (0, 0, radius, radius))
    feed = torch.nn.functional.pad(torch.full((h, 1), invalid, dtype=torch.int64),
                                   (0, 0, radius, radius))  # per staged row
    fused = mutation == "fused_constant"
    col = torch.arange(w)
    out = torch.full((num_d + 1, h, w), -1, dtype=torch.int64)
    for d_start in range(0, num_d, steps):
        d_end = min(d_start + steps, num_d)
        for d0 in range(d_start, d_end, 2):
            d1 = d0 + 1
            ok0, ok1 = col >= d0, (col >= d1) & (d1 < d_end)
            idle = torch.zeros_like(li) if fused else feed.expand(-1, w)
            a0 = idle.clone()
            a0[:, d0:] = (li[:, d0:] - ri[:, : w - d0]).abs()
            a1 = idle.clone()
            if d1 < d_end:
                a1[:, d1:] = (li[:, d1:] - ri[:, : w - d1]).abs()
            pair = a0 | (a1 << 16)
            fix = torch.zeros(w, dtype=torch.int64)
            if fused:
                fix = torch.where(ok0, 0, 255 * k) | torch.where(ok1, 0, (255 * k) << 16)
            v = torch.zeros((h, w + 2 * radius), dtype=torch.int64)  # zero columns outside
            for y in range(h):
                if y % tile == 0:
                    s = (fix + pair[y:y + k].sum(0)) & m32
                else:
                    s = (s + pair[y + 2 * radius] - pair[y - 1]) & m32
                v[y, radius:radius + w] = s
            for x in range(w):
                if x % tile == 0:
                    s = v[:, x:x + k].sum(1) & m32
                else:
                    s = (s + v[:, x + 2 * radius] - v[:, x - 1]) & m32
                out[d0, :, x] = s & 0xFFFF
                if d1 < d_end or mutation == "dead_half_stored":
                    out[d1, :, x] = s >> 16
    return out


def _emulated_pair(kind, shape, seed):
    if kind == "random":
        return _pair(seed, shape)
    return _structured_pair(kind, shape)


@pytest.mark.parametrize("invalid", [0, 1, 255])
@pytest.mark.parametrize("kind", ["extremes", "two_level", "constant", "random"])
@pytest.mark.parametrize("rows", ["clipped", "tall"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6, 7])
def test_packed_volume_arithmetic_matches_twin(radius, rows, kind, invalid):
    """Every radius the strip body serves, under the volume's policy: the
    packed halves with the row-masked invalid feed give
    ``invalid x cnt(y)`` where x < d, at r + 1 rows (every row's window is
    clipped, so the fused constant would show at every pixel) and at 37 (a
    tile's restart); 255 against 0 is the largest SAD the radius allows; D
    is odd at odd radii (the last step's high half is dead) and spans two
    parts of the range."""
    num_d = 63 if radius % 2 else 64
    shape = (radius + 1 if rows == "clipped" else 37, 70)
    left, right = _emulated_pair(kind, shape, radius)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    want = tsp.sad_volume_reference(lt, rt, num_d, radius, invalid)
    got = _packed_volume_emulation(lt, rt, num_d, radius, invalid)
    assert torch.equal(got[:num_d], want.to(torch.int64))
    assert bool((got[num_d] == -1).all())


@pytest.mark.parametrize("mutation,kind,num_d", [
    ("fused_constant", "random", 64),    # x < d costs invalid x cnt(y), not 255 * (2r + 1)
    ("dead_half_stored", "random", 63),  # an odd D's dead half stays in the block
])
def test_packed_volume_emulation_catches_mutations(mutation, kind, num_d):
    """The emulation is a yardstick only if breaking it shows: each mutation
    of one step differs from the twin, and the unbroken form does not."""
    left, right = _emulated_pair(kind, (6, 70), 3)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    want = torch.full((num_d + 1, 6, 70), -1, dtype=torch.int64)
    want[:num_d] = tsp.sad_volume_reference(lt, rt, num_d, 5, 255)
    assert torch.equal(_packed_volume_emulation(lt, rt, num_d, 5, 255), want)
    broken = _packed_volume_emulation(lt, rt, num_d, 5, 255, mutation=mutation)
    assert not torch.equal(broken, want)


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


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8], ids=["i32", "u8"])
@pytest.mark.parametrize("max_diff", [0, 1, 3])
@pytest.mark.parametrize("shape,num_d,radius", [((12, 40), 16, 2), ((9, 70), 63, 5), ((5, 300), 260, 1)])
def test_lr_check_twin_matches_jax(shape, num_d, radius, max_diff, out_dtype):
    """The right-view entry's twin equals the JAX bm path's right view, its
    argmin, the LR mask, the ``where`` and the uint8 cast of the median's
    input (D = 260: the cast wraps)."""
    from gpu_stereo_matching_tpu.models.block_matching import _right_view_sad as jax_right_view
    from gpu_stereo_matching_tpu.ops.postprocess import lr_consistency_mask as jax_lr_mask
    from gpu_stereo_matching_tpu.ops.wta import wta_disparity as jax_wta

    left, right = _pair(9, shape)
    sad = tsp.sad_volume(torch.from_numpy(left), torch.from_numpy(right), num_d, radius)
    disp = tsp.wta_from_sad(sad)
    jsad = jnp.asarray(sad.numpy())
    jdisp = jnp.asarray(disp.numpy())
    want = jnp.where(jax_lr_mask(jdisp, jax_wta(jax_right_view(jsad)), max_diff), jdisp, 0)
    want = np.asarray(want.astype(jnp.uint8 if out_dtype == torch.uint8 else jnp.int32))
    got = tsp.lr_check_from_sad(sad, disp, max_diff, out_dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_do_not_launch():
    left, right = _pair(7, (8, 12))
    before = dict(tsp.LAUNCHES)
    tsp.split_phase_block_matching(torch.from_numpy(left), torch.from_numpy(right), 4, 1)
    assert tsp.LAUNCHES == before


def test_volume_bench_runs_on_the_card_only():
    """``bench/fused_kernel.py --volume`` has no CPU mode: without a card it
    raises, and it takes one of ``--key`` and ``--volume``."""
    from gpu_stereo_matching_tpu_torch.bench import fused_kernel

    argv = ["--volume", "--shapes", "2x40x130", "--disparities", "16", "--radius", "2",
            "--reps", "1"]
    with pytest.raises(RuntimeError, match="CUDA device only"):
        fused_kernel.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit):
        fused_kernel.main(argv + ["--key", "0,8,16"])
    if torch.cuda.is_available():
        assert fused_kernel.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused_kernel.main(argv)


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


# Both bodies of the volume kernel (the strip body serves r = 1..7, the
# general one r = 0 and r >= 8), on random and structured inputs: ragged
# tiles (W = 128k + 1, H = 32k + 1), widths that are no multiple of 4, H < r,
# odd D, D = W, every invalid cost that the border formula scales.
@pytest.mark.gpu
@pytest.mark.parametrize("invalid", [0, 1, 128, 255])
@pytest.mark.parametrize("kind", ["random"] + STRUCTURED)
@pytest.mark.parametrize(
    "hw,num_d,radius",
    [((33, 257), 64, 5), ((65, 129), 129, 7), ((17, 385), 65, 1), ((40, 130), 63, 3),
     ((4, 140), 64, 5), ((70, 256), 33, 2), ((36, 132), 64, 4), ((40, 128), 64, 6),
     ((33, 257), 63, 0), ((40, 130), 64, 8), ((65, 129), 129, 9)],
)
def test_volume_kernel_matches_twin_on_card(cuda_device, hw, num_d, radius, kind, invalid):
    left, right = _inputs(8 if kind == "random" else kind, hw)
    lt = torch.from_numpy(left).to(cuda_device)
    rt = torch.from_numpy(right).to(cuda_device)
    before = tsp.LAUNCHES["sad_volume"]
    vol = tsp.sad_volume(lt, rt, num_d, radius, invalid)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES["sad_volume"] == before + 1
    assert torch.equal(vol, tsp.sad_volume_reference(lt, rt, num_d, radius, invalid))
    assert tsp.volume_kernel_body(num_d, radius) == ("strips" if 1 <= radius <= 7 else "general")


@pytest.mark.gpu
def test_volume_kernel_body_and_plan_on_card(cuda_device):
    """The body is chosen from (D, r) alone; the plan says how it launches."""
    assert [tsp.volume_kernel_body(64, r) for r in (0, 1, 5, 7, 8)] == [
        "general", "strips", "strips", "strips", "general"]
    assert tsp.volume_kernel_body(1000, 5) == "strips"
    plan = tsp.volume_launch_plan((1080, 1920), 64, 5, cuda_device)
    assert plan["body"] == "strips" and (plan["tile_rows"], plan["tile_cols"]) == (32, 128)
    assert plan["blocks"] == 34 * 15 * plan["disparity_parts"] and plan["blocks_per_sm"] >= 1
    general = tsp.volume_launch_plan((1080, 1920), 64, 8, cuda_device)
    assert general["body"] == "general" and general["disparity_parts"] == 1


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
