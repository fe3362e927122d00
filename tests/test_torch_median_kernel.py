"""The median kernel's rank-select body (``kernels/csrc/ctmf_median.cu``,
radius 1..7) emulated step by step in torch, held bit-exact against the
port's histogram twin and the JAX CTMF kernel in interpret mode; three
mutations of it must fail. Then both bodies of the kernel against the twin
on a card, and the launch plan and the bench there."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gpu_stereo_matching_tpu.kernels.ctmf_median import ctmf_median_u8 as jax_ctmf
from gpu_stereo_matching_tpu_torch.kernels import ctmf_median as tcm
from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8

M32 = 0xFFFFFFFF
LOW7, TOP, ONES = 0x7F7F7F7F, 0x80808080, 0x01010101
KINDS = ["random", "zeros", "full", "checkerboard", "two_level", "disparity", "odd_pixel"]
MASKS = ["none", "random", "holes"]


def _image(kind, shape, seed=0):
    """Inputs on which a median's faults show: constant 0 and 255, 0/255
    checkerboards, two levels, a disparity-like map (0..63 with LR-hole
    zeros), a single odd pixel in a constant field."""
    rng = np.random.default_rng(seed)
    h, w = shape[-2:]
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind in ("zeros", "full"):
        return np.full(shape, 0 if kind == "zeros" else 255, np.uint8)
    if kind == "checkerboard":
        board = (np.add.outer(np.arange(h), np.arange(w)) % 2 * 255).astype(np.uint8)
        return np.broadcast_to(board, shape).copy()
    if kind == "two_level":
        return np.where(rng.random(shape) < 0.5, 37, 200).astype(np.uint8)
    if kind == "disparity":
        disp = np.repeat(rng.integers(0, 64, (*shape[:-1], -(-w // 5))), 5, axis=-1)[..., :w]
        return np.where(rng.random(shape) < 0.2, 0, disp).astype(np.uint8)
    img = np.full(shape, 90, np.uint8)  # odd_pixel
    img[..., h // 2, w // 2] = 7
    return img


def _mask(kind, shape, radius, seed=1):
    """No mask, a random mask, or one with a block no window inside sees."""
    if kind == "none":
        return None
    h, w = shape
    if kind == "random":
        return np.random.default_rng(seed).random(shape) > 0.3
    mask = np.ones(shape, bool)
    mask[:, 5:5 + 2 * radius + 3] = False
    return mask


def _pack(b):
    """(..., 4k) int64 bytes -> (..., k) words, byte i of a word in bits 8i."""
    b = b.reshape(*b.shape[:-1], -1, 4)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _below(a, c):
    """The kernel's ``below``: bit 7 of each byte is (a < c) for that byte."""
    hi = a | LOW7
    d = ((a & LOW7) + TOP - (c & LOW7)) & M32
    ch = c & TOP
    return ((~(hi ^ ch) & ~d) | (~hi & ch)) & M32


def _rank_select_emulation(x, radius, valid_mask=None, mutation=None):
    """The rank-select body's arithmetic on one (H, W) uint8 image, in torch,
    on int64 tensors cut to 32 bits after every operation: the image staged
    with 255 for every pixel outside it or its mask; 4 outputs a word; n from
    the clipped extents (no mask) or the packed box count of the staged 0/1
    validity (mask); rank n/2 + 1 a byte; 8 passes from the top bit, each
    counting per byte lane the window bytes below ``med | bit`` and keeping
    the bit where the count is below the rank.

    ``mutation`` breaks one step on purpose: ``"rank_n_half"`` takes rank
    n/2, ``"stand_in_0"`` stages missing pixels as 0, ``"count_le"`` counts
    the window bytes ``<=`` the candidate."""
    r = radius
    h, w = x.shape
    wp = -(-w // 4) * 4
    stand_in = 0 if mutation == "stand_in_0" else 255
    pix = x.to(torch.int64)
    ok = torch.ones((h, w), dtype=torch.int64)
    if valid_mask is not None:
        pix = torch.where(valid_mask, pix, stand_in)
        ok = valid_mask.to(torch.int64)
    pad = (r, r + wp - w, r, r)
    staged = F.pad(pix, pad, value=stand_in)
    staged_ok = F.pad(ok, pad, value=0)

    def windows(tile):
        return [_pack(tile[dy:dy + h, dx:dx + wp])
                for dy in range(2 * r + 1) for dx in range(2 * r + 1)]

    one = 0 if mutation == "rank_n_half" else 1
    if valid_mask is None:
        y, xs = torch.arange(h), torch.arange(wp)
        ny = (y + r).clamp(max=h - 1) - (y - r).clamp(min=0) + 1
        nx = ((xs + r).clamp(max=w - 1) - (xs - r).clamp(min=0) + 1).clamp(min=0)
        rank = _pack((ny[:, None] * nx[None, :]) // 2 + one)
    else:
        n = sum(windows(staged_ok)) & M32  # <= 225 a byte: no carry
        rank = ((n >> 1) & LOW7) + one * ONES
    med = torch.zeros_like(rank)
    for b in range(7, -1, -1):
        bit = ONES << b
        cand = med | bit
        cnt = torch.zeros_like(rank)
        for a in windows(staged):
            flags = (~_below(cand, a)) & TOP if mutation == "count_le" else _below(a, cand)
            cnt = (cnt + (flags >> 7)) & M32
        med = med | (bit & ((_below(cnt, rank) >> 7) * 0xFF))
    out = torch.stack([(med >> (8 * i)) & 0xFF for i in range(4)], dim=-1).reshape(h, wp)
    return out[:, :w].to(torch.uint8)


def _case(kind, mask_kind, shape, radius, seed=0):
    img = torch.from_numpy(_image(kind, shape, seed))
    mask = _mask(mask_kind, shape, radius)
    return img, None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6, 7])
def test_rank_select_arithmetic_matches_twin_and_jax(radius, kind, mask_kind):
    """Every radius of the rank-select body, on the structured inputs, with no
    mask, a random mask and all-invalid windows; 2r + 3 rows (every window
    clipped but those of the middle three rows) and 37 columns (a last word
    with one live lane)."""
    shape = (2 * radius + 3, 37)
    img, mask = _case(kind, mask_kind, shape, radius)
    got = _rank_select_emulation(img, radius, mask)
    want = median_filter_u8(img, radius, "histogram", mask)
    assert torch.equal(got, want)
    jax_mask = None if mask is None else jnp.asarray(mask.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ctmf(jnp.asarray(img.numpy()), radius, jax_mask,
                                         interpret=True)))
    if mask_kind == "holes":
        assert bool((got[:, 5 + radius:8 + radius] == 255).all())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(1, 9), (9, 1), (7, 3), (2, 41), (4, 130)])
@pytest.mark.parametrize("radius", [1, 3, 5, 7])
def test_rank_select_arithmetic_at_clipped_shapes(radius, shape, masked):
    """H or W = 1, W < 4, H < 2r + 1, a ragged last word."""
    img = torch.from_numpy(_image("random", shape, radius))
    mask = torch.from_numpy(_mask("random", shape, radius)) if masked else None
    assert torch.equal(_rank_select_emulation(img, radius, mask),
                       median_filter_u8(img, radius, "histogram", mask))


@pytest.mark.parametrize("mutation,mask_kind", [
    ("rank_n_half", "none"),   # the (n//2 + 1)-th smallest, not the (n//2)-th
    ("stand_in_0", "random"),  # a missing pixel is 255, never below a candidate
    ("count_le", "none"),      # count the bytes below the candidate, not <=
])
def test_rank_select_emulation_catches_mutations(mutation, mask_kind):
    """The emulation is a yardstick only if breaking it shows: each mutation
    of one step differs from the twin, and the unbroken form does not."""
    img, mask = _case("random", mask_kind, (9, 37), 3, seed=4)
    want = median_filter_u8(img, 3, "histogram", mask)
    assert torch.equal(_rank_select_emulation(img, 3, mask), want)
    assert not torch.equal(_rank_select_emulation(img, 3, mask, mutation), want)


def test_median_bench_runs_on_the_card_only():
    """``bench/fused_kernel.py --median R`` has no CPU mode: without a card it
    raises, and it excludes ``--key`` and ``--volume``."""
    from gpu_stereo_matching_tpu_torch.bench import fused_kernel

    argv = ["--median", "3", "--shapes", "2x40x130", "--reps", "1"]
    with pytest.raises(RuntimeError, match="CUDA device only"):
        fused_kernel.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit):
        fused_kernel.main(argv + ["--volume"])
    if torch.cuda.is_available():
        assert fused_kernel.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused_kernel.main(argv)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# Both bodies on the card: every radius of the rank-select body, the first
# radius past it and 60 on the histogram body; shapes that leave ragged
# tiles (W = 128k + 1, a 1-row last tile of 32), W < 4, H < 2r + 1, H = 1,
# W = 1, and a batch of 2 that shares its mask.
@pytest.mark.gpu
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(33, 257), (2, 65, 129), (5, 3), (1, 300), (300, 1)])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6, 7, 8, 60])
def test_median_bodies_match_twin_on_card(cuda_device, radius, shape, kind, mask_kind):
    img = torch.from_numpy(_image(kind, shape, radius)).to(cuda_device)
    mask = _mask(mask_kind, shape[-2:], min(radius, 7))
    mask = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = tcm.LAUNCHES
    got = tcm.median_u8(img, radius, mask)
    torch.cuda.synchronize()
    assert tcm.LAUNCHES == before + 1
    assert torch.equal(got, median_filter_u8(img, radius, "histogram", mask))
    assert tcm.median_kernel_body(radius) == ("rank_select" if radius <= 7 else "histogram")


@pytest.mark.gpu
def test_median_launch_plan_on_card(cuda_device):
    """The post-filter's r=3 at 1080p takes the rank-select body."""
    assert [tcm.median_kernel_body(r) for r in (1, 3, 7, 8, 127)] == [
        "rank_select", "rank_select", "rank_select", "histogram", "histogram"]
    plan = tcm.median_launch_plan((1080, 1920), 3, cuda_device)
    assert plan["body"] == "rank_select" and plan["tile_cols"] == 128
    assert plan["blocks"] == 15 * -(-1080 // plan["tile_rows"]) and plan["blocks_per_sm"] >= 1
    assert tcm.median_launch_plan((2, 1080, 1920), 3, cuda_device)["blocks"] == 2 * plan["blocks"]
    assert tcm.median_launch_plan((1080, 1920), 8, cuda_device)["body"] == "histogram"
