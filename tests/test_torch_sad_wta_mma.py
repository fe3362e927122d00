"""Port of the ``mxu=True`` fused matcher: ``fused_block_matching(...,
mxu=True)`` on the CPU (its plain twin, the band product in float64) vs JAX's
banded matrix-unit body in interpret mode, bit for bit; the twin vs the
strip body's twin; the band, the packed-pair rule and the refusals vs
JAX's; the tensor-core kernel's fragment arithmetic emulated in numpy; and
the kernel vs its twin on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.kernels import sad_wta as jsad
from gpu_stereo_matching_tpu_torch.kernels import sad_wta as tsad


def _pair(rng, shape):
    return (
        rng.integers(0, 256, shape, dtype=np.uint8),
        rng.integers(0, 256, shape, dtype=np.uint8),
    )


def _structured_pair(kind, shape, seed=21):
    """Every d ties (constant), ties almost everywhere (two levels), the
    largest SAD (255 against 0), a known shift of 9."""
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


# The three shapes of tests/test_kernels.py::test_fused_mxu_variant_bitwise
# (with their tile_h), then r = 1 and r = 5 at D = 2 and D = 64 with W not a
# multiple of 8 and H not a multiple of 32 (JAX's default tile_h, 32).
@pytest.mark.parametrize(
    "hw,num_d,radius,tile_h",
    [
        ((21, 33), 8, 2, 8),
        ((40, 150), 16, 3, 16),
        ((37, 160), 64, 5, 16),
        ((33, 67), 2, 1, 32),
        ((45, 99), 64, 1, 32),
        ((19, 75), 2, 5, 32),
        ((70, 130), 64, 5, 32),
    ],
)
def test_mxu_matches_jax_mxu(hw, num_d, radius, tile_h):
    left, right = _pair(np.random.default_rng(1600 + num_d + radius), hw)
    want = np.asarray(
        jsad.fused_block_matching(
            jnp.asarray(left), jnp.asarray(right), num_disparities=num_d, radius=radius,
            tile_h=tile_h, interpret=True, mxu=True,
        )
    )
    got = tsad.fused_block_matching(torch.from_numpy(left), torch.from_numpy(right), num_d,
                                    radius, mxu=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["random"] + STRUCTURED)
@pytest.mark.parametrize(
    "shape,num_d,radius",
    [((1, 21, 33), 8, 2), ((2, 30, 120), 64, 5), ((1, 65, 131), 130, 4), ((3, 33, 257), 256, 5),
     ((1, 17, 9), 2, 1), ((1, 40, 64), 64, 3)],
)
def test_mma_twin_matches_strip_twin(shape, num_d, radius, kind):
    """The band product's twin and the strip body's twin are one function:
    batches, ragged tiles (H = 32k + 1, W off 8 and 128), D = W, D = 256."""
    if kind == "random":
        left, right = _pair(np.random.default_rng(num_d), shape)
    else:
        left, right = _structured_pair(kind, shape)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    want = tsad.fused_block_matching_reference(lt, rt, num_d, radius)
    got = tsad.fused_block_matching_mma_reference(lt, rt, num_d, radius)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tile_h,halo_rows,k", [(32, 42, 11), (16, 26, 11), (8, 12, 5),
                                                (32, 34, 3), (16, 20, 5)])
def test_band_matches_jax_band(tile_h, halo_rows, k):
    want = np.asarray(jsad._banded_vertical_matrix(tile_h, halo_rows, k).astype(jnp.float32))
    got = tsad._banded_vertical_matrix(tile_h, halo_rows, k)
    assert got.shape == (tile_h, halo_rows) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0.0, 1.0}


def test_packed_pair_rule_matches_jax():
    for num_d in (1, 2, 3, 8, 63, 64, 254, 255, 256, 257, 258, 512):
        for radius in range(0, 9):
            assert tsad._packed_pair_supported(num_d, radius) == jsad._packed_pair_supported(
                num_d, radius), (num_d, radius)


# Odd D, D > 256, r = 0, r = 6: JAX refuses each with this message.
@pytest.mark.parametrize("hw,num_d,radius", [((20, 40), 7, 2), ((12, 300), 258, 2),
                                             ((20, 40), 8, 0), ((20, 40), 8, 6)])
def test_mxu_refuses_what_jax_refuses(hw, num_d, radius):
    left, right = _pair(np.random.default_rng(3), hw)
    with pytest.raises(ValueError, match="mxu variant requires a packed-pair config"):
        jsad.fused_block_matching(jnp.asarray(left), jnp.asarray(right), num_disparities=num_d,
                                  radius=radius, interpret=True, mxu=True)
    with pytest.raises(ValueError, match="mxu variant requires a packed-pair config"):
        tsad.fused_block_matching(torch.from_numpy(left), torch.from_numpy(right), num_d,
                                  radius, mxu=True)
    # Without mxu both take the configuration.
    tsad.fused_block_matching(torch.from_numpy(left[:4, :]), torch.from_numpy(right[:4, :]),
                              num_d, radius)


def test_cpu_mxu_does_not_launch_and_off_cpu_raises():
    left, right = _pair(np.random.default_rng(7), (8, 12))
    before = (tsad.LAUNCHES, tsad.MMA_LAUNCHES)
    tsad.fused_block_matching(torch.from_numpy(left), torch.from_numpy(right), 4, 1, mxu=True)
    assert (tsad.LAUNCHES, tsad.MMA_LAUNCHES) == before
    meta = torch.empty((8, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsad.fused_block_matching(meta, meta, 4, 1, mxu=True)


def test_mma_tensor_ops_counts_the_tiling():
    # 1080p: 34 x 15 blocks, 18 n-tiles at r = 5, two m16n8k32 products each.
    assert tsad.mma_tensor_ops((1, 1080, 1920), 64, 5) == 510 * 64 * 18 * 2 * 8192
    assert tsad.mma_tensor_ops((2, 33, 129), 2, 1) == 2 * 2 * 2 * 2 * 17 * 2 * 8192


# --- The kernel's arithmetic, lane by lane -------------------------------------------
#
# csrc/sad_wta_mma.cu in numpy: the [column][12] word staging, the band's A
# registers, the B registers from __vabsdiffu4 words, mma.sync.m16n8k32's
# fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k32" with .u8:
# a0..a3 = rows g, g+8, g, g+8 at columns 4t.., 4t.., 16+4t.., 16+4t..; b0, b1
# = K rows 4t.. and 16+4t.. of column g; c0..c3 = (g, 2t), (g, 2t+1),
# (g+8, 2t), (g+8, 2t+1); g = lane / 4, t = lane % 4, byte e of a register is
# element e), the packing into (d, d + 1) halves with the invalid and outside
# columns, the stores into the sums buffer (whose unwritten words hold
# garbage), and the strip body's horizontal pass and key minimum.

TILE_H, TILE_W, WORDS, WARPS, STRIP_W = 32, 128, 12, 5, 32
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def _strip_vstride(r):
    loads = (STRIP_W + 2 * r + 3) // 4
    chunks = (TILE_W - STRIP_W) // 4 + loads
    return 4 * (chunks if chunks % 2 else chunks + 1)


def _words(img, h, w, y0, gx0, cols, r):
    """(cols, 12) uint32: column col is image column gx0 + col, word q packs
    staged rows 4q..4q+3 (image row y0 - r + j), 0 outside the image."""
    out = np.zeros((cols, WORDS), np.uint32)
    for col in range(cols):
        gx = gx0 + col
        if not 0 <= gx < w:
            continue
        for q in range(WORDS):
            for b in range(4):
                gy = y0 - r + 4 * q + b
                if 0 <= gy < h:
                    out[col, q] |= np.uint32(img[gy, gx]) << np.uint32(8 * b)
    return out


def _bytes(words):
    return np.stack([(words >> np.uint32(8 * e)) & np.uint32(255) for e in range(4)], -1)


def _vabsdiffu4(a, b):
    da = _bytes(a).astype(np.int64) - _bytes(b).astype(np.int64)
    return (np.abs(da) << (8 * np.arange(4))).sum(-1).astype(np.uint32)


def _band_word(row, col0, k):
    j = col0[..., None] + np.arange(4)
    ones = (j >= row[..., None]) & (j < row[..., None] + k)
    return (ones.astype(np.uint32) << np.uint32(8) * np.arange(4, dtype=np.uint32)).sum(-1)


def _mma(a, b0, b1):
    """The warp's product from its lanes' registers: a (32, 4), b0, b1 (32,)
    -> c (32, 4), by the m16n8k32 fragment layouts."""
    A = np.zeros((16, 32), np.int64)
    for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 16), (8, 16)]):
        for e in range(4):
            A[G + dr, 4 * T + e + dc] = _bytes(a[:, reg])[:, e]
    B = np.zeros((32, 8), np.int64)
    for reg, dk in ((b0, 0), (b1, 16)):
        for e in range(4):
            B[4 * T + e + dk, G] = _bytes(reg)[:, e]
    D = A @ B
    return np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T], D[G + 8, 2 * T + 1]], -1)


def _mma_emulation(left, right, num_d, r, mutation=None, seed=0):
    """Disparities of one (H, W) pair by the kernel's steps. ``mutation``
    breaks one of them: ``"b1_word"`` takes b1 from the same word as b0,
    ``"second_window"`` starts the second m-tile's window at row 32,
    ``"no_invalid"`` leaves the columns x < d at their sums."""
    h, w = left.shape
    k, nt = 2 * r + 1, (TILE_W + 2 * r + 7) // 8
    cp, vs, invalid = 8 * nt, _strip_vstride(r), 255 * (2 * r + 1)
    loads = (STRIP_W + 2 * r + 3) // 4
    garbage = np.random.default_rng(seed)
    a = np.stack([_band_word(G, 4 * T, k), _band_word(G + 8, 4 * T, k),
                  _band_word(G, 16 + 4 * T, k), _band_word(G + 8, 16 + 4 * T, k)], -1)
    out = np.zeros((h, w), np.int32)
    for y0 in range(0, h, TILE_H):
        for x0 in range(0, w, TILE_W):
            lt = _words(left, h, w, y0, x0 - r, cp, r)
            rt = _words(right, h, w, y0, x0 - r - (num_d - 1), cp + num_d - 1, r)
            best = np.full((TILE_H, TILE_W), 0xFFFFFFFF, np.uint64)
            for d0 in range(0, num_d, 2):
                d1 = d0 + 1
                v = garbage.integers(0, 2**32, (TILE_H, vs), dtype=np.uint64).astype(np.uint32)
                for n in range(nt):  # each warp's n-tiles, n = warp + 5 i
                    cols = 8 * n + G
                    words = [4 * m + T for m in range(3)]
                    e0 = [_vabsdiffu4(lt[cols, q], rt[cols + num_d - 1 - d0, q]) for q in words]
                    e1 = [_vabsdiffu4(lt[cols, q], rt[cols + num_d - 1 - d1, q]) for q in words]
                    c = 8 * n + 2 * T
                    for mt in range(2):
                        lo, hi = (mt, mt + 1)
                        if mutation == "b1_word":
                            hi = lo
                        if mutation == "second_window" and mt == 1:
                            lo, hi = 2, 2
                        s0, s1 = _mma(a, e0[lo], e0[hi]), _mma(a, e1[lo], e1[hi])
                        for reg in range(4):
                            col = c + (reg & 1)
                            row = 16 * mt + G + 8 * (reg >> 1)
                            xc = x0 - r + col
                            past0 = (xc < d0) & (mutation != "no_invalid")
                            past1 = (xc < d1) & (mutation != "no_invalid")
                            word = (np.where(past0, invalid, s0[:, reg])
                                    | np.where(past1, invalid, s1[:, reg]) << 16)
                            word = np.where((xc < 0) | (xc >= w), 0, word).astype(np.uint32)
                            keep = c + 1 < vs
                            v[row[keep], col[keep]] = word[keep]
                # Horizontal pass: row hrow, strip s, output j sums columns
                # 32 s + j .. 32 s + j + 2r of v, packed.
                for strip in range(TILE_W // STRIP_W):
                    wv = v[:, STRIP_W * strip:STRIP_W * strip + 4 * loads].astype(np.uint64)
                    s = wv[:, :k].sum(1) & 0xFFFFFFFF
                    for j in range(STRIP_W):
                        if j > 0:
                            s = (s + wv[:, j + 2 * r] - wv[:, j - 1]) & 0xFFFFFFFF
                        key_lo = ((s << 16) & 0xFFFFFFFF) | d0
                        key_hi = (s & 0xFFFF0000) | d1
                        x = STRIP_W * strip + j
                        best[:, x] = np.minimum(best[:, x], np.minimum(key_lo, key_hi))
            rows, cols = min(TILE_H, h - y0), min(TILE_W, w - x0)
            out[y0:y0 + rows, x0:x0 + cols] = (best[:rows, :cols] & 0xFFFF).astype(np.int32)
    return out


@pytest.mark.parametrize("kind", ["random", "extremes", "two_level"])
@pytest.mark.parametrize("hw,num_d,radius", [((40, 150), 8, 1), ((33, 137), 12, 5),
                                             ((21, 45), 20, 3), ((9, 17), 16, 2)])
def test_fragment_arithmetic_matches_twin(hw, num_d, radius, kind):
    """Ragged tiles (H = 32k + 1, W off 8), D = W - 1 at a 1-column image
    edge, 255 against 0 (the largest sums: no half may carry), ties."""
    if kind == "random":
        left, right = _pair(np.random.default_rng(radius), hw)
    else:
        left, right = _structured_pair(kind, hw)
    want = tsad.fused_block_matching_reference(torch.from_numpy(left), torch.from_numpy(right),
                                               num_d, radius)
    np.testing.assert_array_equal(_mma_emulation(left, right, num_d, radius), want.numpy())


@pytest.mark.parametrize("mutation", ["b1_word", "second_window", "no_invalid"])
def test_fragment_emulation_catches_a_wrong_step(mutation):
    """The emulation is not blind: each broken step changes the answer."""
    left, right = _pair(np.random.default_rng(11), (40, 70))
    want = tsad.fused_block_matching_reference(torch.from_numpy(left), torch.from_numpy(right),
                                               16, 3)
    got = _mma_emulation(left, right, 16, 3, mutation=mutation)
    assert not np.array_equal(got, want.numpy())


# --- On a card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# Ragged tiles (W = 128k + 1, H = 32k + 1, W off 8), D = W, D = 256, r = 1..5.
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random"] + STRUCTURED)
@pytest.mark.parametrize(
    "hw,num_d,radius",
    [((21, 33), 8, 2), ((30, 120), 64, 5), ((33, 257), 64, 5), ((65, 130), 130, 4),
     ((17, 385), 256, 1), ((40, 64), 64, 3), ((1080, 1920), 64, 5)],
)
def test_mma_kernel_matches_twins_on_card(cuda_device, hw, num_d, radius, kind):
    if kind == "random":
        left, right = _pair(np.random.default_rng(8), hw)
    else:
        left, right = _structured_pair(kind, hw)
    lt = torch.from_numpy(left).to(cuda_device)
    rt = torch.from_numpy(right).to(cuda_device)
    before = (tsad.LAUNCHES, tsad.MMA_LAUNCHES)
    got = tsad.fused_block_matching(lt, rt, num_d, radius, mxu=True)
    torch.cuda.synchronize()
    assert (tsad.LAUNCHES, tsad.MMA_LAUNCHES) == (before[0], before[1] + 1)
    assert torch.equal(got, tsad.fused_block_matching_mma_reference(lt, rt, num_d, radius))
    assert torch.equal(got, tsad.fused_block_matching(lt, rt, num_d, radius))
