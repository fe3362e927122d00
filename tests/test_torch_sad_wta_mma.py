"""Port of the ``mxu=True`` fused matcher: ``fused_block_matching(...,
mxu=True)`` on the CPU (its plain twin, both band products in float64) vs
JAX's banded matrix-unit body in interpret mode, bit for bit; the twin vs
the strip body's twin; the band, the packed-pair rule and the refusals vs
JAX's; the tensor-core kernel's fragment arithmetic emulated in numpy; the
readers of the build's ptxas report and of the SASS that phase 22 prints;
and the kernel vs its twin on a card."""

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
    # 1080p: 34 x 30 warps of 32 x 64 outputs, two 16-row halves each; at
    # r = 5, 10 vertical products (64 + 10 columns) and 16 horizontal ones
    # (8 output n-tiles, two byte planes) a half and disparity.
    assert tsad.mma_tensor_ops((1, 1080, 1920), 64, 5) == 1020 * 2 * 64 * (10 + 16) * 8192
    # Ragged: 2 x 3 warps a frame hold a pixel (both halves run); r = 1
    # takes 9 V n-tiles.
    assert tsad.mma_tensor_ops((2, 33, 129), 2, 1) == 2 * 2 * 3 * 2 * 2 * (9 + 16) * 8192


# --- The kernel's arithmetic, lane by lane -------------------------------------------
#
# csrc/sad_wta_mma.cu in numpy: the raw row-major staging (16-byte chunks
# from a 16-aligned column, 0 outside the image) and its layout as 4-row
# words, 12 a column; each warp's 32 x 64 tile in two 16-row halves; the
# vertical band's A registers; the B registers from __vabsdiffu4 words, the
# halves sharing the middle one (the upper half with its K halves swapped
# against a swapped band); mma.sync.m16n8k32's
# fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k32" with .u8:
# a0..a3 = rows g, g+8, g, g+8 at columns 4t.., 4t.., 16+4t.., 16+4t..; b0, b1
# = K rows 4t.. and 16+4t.. of column g; c0..c3 = (g, 2t), (g, 2t+1),
# (g+8, 2t), (g+8, 2t+1); g = lane / 4, t = lane % 4, byte e of a register is
# element e); the invalid and outside columns set in the B registers (255
# and 0); the accumulators of
# two n-tiles packed by byte permutes into the A registers of both byte
# planes, K slot 16h + 4t + e standing for V column 8 (2h + e // 2) + 2t +
# e % 2 of the pair, packed into alternate halves of each plane's A
# registers (an odd output pair reads its K halves swapped, and its band's B
# registers swap with them); the high plane's word shifted left 4 bits; the
# horizontal band built with that permutation, and times 16 for the high
# plane; the two planes' products chained in one accumulator, the keys
# SAD << 16 | d and their three-way minimum; the 8-byte stores.

TILE_H, TILE_W, WARP_W, WORDS, ROWS = 32, 128, 64, 12, 48
VCOLS = TILE_W + 16
LANES = np.arange(32)
G, T = LANES // 4, LANES % 4
ELEMENT = np.arange(4)  # accumulator element i: row + 8 (i >> 1), column + (i & 1)


def _raw_pitch(lead):
    return VCOLS + 16 * ((lead + 15) // 16)


def _raw(img, h, w, gy0, gx0, pitch):
    """(48, pitch) uint8: row j is image row gy0 + j, byte i image column
    gx0 + i, 0 outside the image."""
    out = np.zeros((ROWS, pitch), np.uint8)
    ys, xs = gy0 + np.arange(ROWS), gx0 + np.arange(pitch)
    iy, ix = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
    out[np.ix_(iy, ix)] = img[np.ix_(ys[iy], xs[ix])]
    return out


def _lay_out(raw, cols, off):
    """(cols, 12) uint32: word q of column c packs raw rows 4q..4q+3 of raw
    column off + c."""
    r = raw[:, off:off + cols].astype(np.uint32).reshape(WORDS, 4, cols)
    return (r << (8 * np.arange(4, dtype=np.uint32))[None, :, None]).sum(1).T.astype(np.uint32)


def _bytes(words):
    return np.stack([(words >> np.uint32(8 * e)) & np.uint32(255) for e in range(4)], -1)


def _word(bytes4):
    return (bytes4.astype(np.uint32) << (8 * np.arange(4, dtype=np.uint32))).sum(-1).astype(
        np.uint32)


def _vabsdiffu4(a, b):
    da = _bytes(a).astype(np.int64) - _bytes(b).astype(np.int64)
    return _word(np.abs(da))


def _byte_perm(x, y, selector):
    b = np.concatenate([_bytes(x), _bytes(y)], -1)
    return _word(np.stack([b[..., (selector >> (4 * i)) & 7] for i in range(4)], -1))


def _vband_word(row, k0, r):
    k = k0[..., None] + np.arange(4)
    return _word((k >= row[..., None]) & (k <= row[..., None] + 2 * r))


def _slot_column(k):
    """The V column (from the pair's first) that K slot k of the horizontal
    product stands for."""
    return 16 * (k >> 4) + 8 * ((k & 3) >> 1) + 2 * ((k >> 2) & 3) + (k & 1)


def _hband_word(j, k0, r, shift=0):
    c = _slot_column(k0[..., None] + np.arange(4))
    lo = j[..., None] + shift
    return _word((c >= lo) & (c <= lo + 2 * r))


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


def _pack_planes(a, b, mutation):
    """{lo row g, lo row g + 8, 16 hi row g, 16 hi row g + 8} from the
    (32, 4) accumulators of n-tiles n0 (a) and n0 + 1 (b)."""
    planes = [None] * 4
    for h in range(2):
        if mutation == "k_permutation":  # columns in another order than the band's
            ta = _byte_perm(a[:, 2 * h], b[:, 2 * h], 0x5140)
            tb = _byte_perm(a[:, 2 * h + 1], b[:, 2 * h + 1], 0x5140)
        else:
            ta = _byte_perm(a[:, 2 * h], a[:, 2 * h + 1], 0x5140)
            tb = _byte_perm(b[:, 2 * h], b[:, 2 * h + 1], 0x5140)
        planes[h] = _byte_perm(ta, tb, 0x5410)
        hi = _byte_perm(ta, tb, 0x7632)
        planes[2 + h] = hi if mutation == "hi_unshifted" else (hi << np.uint32(4)).astype(np.uint32)
    return planes


def _mma_emulation(left, right, num_d, r, mutation=None):
    """Disparities of one (H, W) pair by the kernel's steps. ``mutation``
    breaks one of them: ``"b1_word"`` takes b1 from the same word as b0,
    ``"second_window"`` starts the second row half's window 4 rows high,
    ``"no_invalid"`` leaves the columns x < d at their sums,
    ``"border_row"`` leaves them so only within r rows of the image's top
    and bottom, ``"k_permutation"`` packs a lane's four columns in another
    order than the band's, ``"no_high_plane"`` drops V's high byte plane,
    ``"hi_unshifted"`` leaves the high plane unshifted, ``"band_off_by_one"``
    shifts the horizontal band one column."""
    h, w = left.shape
    nv = (WARP_W + 2 * r + 7) // 8
    lp, rpitch = _raw_pitch(r), _raw_pitch(r + num_d - 1)
    va = np.stack([_vband_word(G, 4 * T, r), _vband_word(G + 8, 4 * T, r),
                   _vband_word(G, 16 + 4 * T, r), _vband_word(G + 8, 16 + 4 * T, r)], -1)
    shift = 1 if mutation == "band_off_by_one" else 0
    hb = [[[(_hband_word(8 * q + G, 4 * T, r, shift) * weight).astype(np.uint32),
            (_hband_word(8 * q + G, 16 + 4 * T, r, shift) * weight).astype(np.uint32)]
           for weight in (1, 16)] for q in range(2)]
    # Row half mt's K rows 4t.. and 16 + 4t.. are words 4 mt + t, 4 mt + 4 + t.
    first = [0, 3 if mutation == "second_window" else 4]
    out = np.zeros((h, w), np.int32)
    for y0 in range(0, h, TILE_H):
        for x0 in range(0, w, TILE_W):
            lwords = _lay_out(_raw(left, h, w, y0 - r, x0 + VCOLS - lp, lp), VCOLS,
                              lp - VCOLS - r)
            rwords = _lay_out(_raw(right, h, w, y0 - r, x0 + VCOLS - rpitch, rpitch),
                              VCOLS + num_d - 1, rpitch - VCOLS - r - (num_d - 1))
            for half in range(2):
                xw = x0 + WARP_W * half
                if xw >= w:
                    continue
                words = [(f + T, f + T if mutation == "b1_word" else f + 4 + T) for f in first]
                cols = WARP_W * half + G
                xv = xw - r
                checked = not (xv >= num_d - 1 and xv + 8 * nv <= w)
                best = np.full((2, 8, 32, 4), 0xFFFFFFFF, np.int64)
                for d0 in range(0, num_d, 2):
                    # [row half][d0, d0 + 1][plane lo, 16 hi][register]: V pair m
                    # is packed into half m % 2 of the A registers.
                    a = np.zeros((2, 2, 2, 4, 32), np.uint32)
                    for m in range(5):
                        for s in range(2):
                            d = d0 + s
                            v = [[], []]
                            for k in range(2):
                                n = 2 * m + k
                                for mt in range(2):
                                    if n >= nv:
                                        v[mt].append(np.zeros((32, 4), np.uint32))
                                        continue
                                    rc = cols + 8 * n + num_d - 1 - d
                                    lc = cols + 8 * n
                                    e = [_vabsdiffu4(lwords[lc, q], rwords[rc, q]) for q in words[mt]]
                                    if checked:
                                        # B column xb: 255 in every K row where
                                        # 0 <= xb < d, 0 outside the image.
                                        xb = xv + 8 * n + G
                                        keep = np.where((xb >= 0) & (xb < w), 0xFFFFFFFF, 0)
                                        past = np.where(xb < d, 0xFFFFFFFF, 0)
                                        if mutation == "no_invalid":
                                            past = 0 * past
                                        plain = [(ek & keep).astype(np.uint32) for ek in e]
                                        e = [(ek | past) & keep for ek in e]
                                    # The upper half takes its K halves swapped,
                                    # against the band's registers swapped.
                                    band = va if mt == 0 else va[:, [2, 3, 0, 1]]
                                    order = 1 if mt == 0 else -1
                                    vk = _mma(band, *[ek.astype(np.uint32) for ek in e][::order])
                                    if checked and mutation == "border_row":
                                        rows = y0 + 16 * mt + G[:, None] + 8 * (ELEMENT >> 1)
                                        vk = np.where((rows < r) | (rows >= h - r),
                                                      _mma(band, *plain[::order]), vk)
                                    v[mt].append(vk.astype(np.uint32))
                            for mt in range(2):
                                planes = _pack_planes(v[mt][0], v[mt][1], mutation)
                                half_m = 2 * (m % 2)
                                a[mt, s, 0, half_m:half_m + 2] = planes[:2]
                                a[mt, s, 1, half_m:half_m + 2] = planes[2:]
                        if m > 0:
                            swap = (m - 1) % 2  # output pair m - 1 reads its K halves swapped
                            for mt in range(2):
                                for q in range(2):
                                    keys = []
                                    for s in range(2):
                                        b_lo, b_hi = hb[q]
                                        sad = _mma(a[mt, s, 0].T, b_lo[swap], b_lo[1 - swap])
                                        if mutation != "no_high_plane":
                                            sad = sad + _mma(a[mt, s, 1].T, b_hi[swap],
                                                             b_hi[1 - swap])
                                        keys.append(sad * 65536 + d0 + s)
                                    o = 2 * (m - 1) + q
                                    best[mt, o] = np.minimum(best[mt, o], np.minimum(*keys))
                for mt in range(2):
                    rows = y0 + 16 * mt + G[:, None] + 8 * (ELEMENT >> 1)
                    for o in range(8):
                        x = xw + 8 * o + 2 * T[:, None] + (ELEMENT & 1)
                        keep = (rows < h) & (x < w)
                        out[rows[keep], x[keep]] = best[mt, o][keep] & 0xFFFF
    return out


@pytest.mark.parametrize("kind", ["random", "extremes", "two_level"])
@pytest.mark.parametrize("hw,num_d,radius", [((40, 150), 8, 1), ((33, 137), 12, 5),
                                             ((21, 45), 20, 3), ((9, 17), 16, 2)])
def test_fragment_arithmetic_matches_twin(hw, num_d, radius, kind):
    """Ragged tiles (H = 32k + 1, W off 8 and 64, a warp of one column), D =
    W - 1 at a 1-column image edge, 255 against 0 (the largest sums, both
    planes full), ties."""
    if kind == "random":
        left, right = _pair(np.random.default_rng(radius), hw)
    else:
        left, right = _structured_pair(kind, hw)
    want = tsad.fused_block_matching_mma_reference(torch.from_numpy(left),
                                                   torch.from_numpy(right), num_d, radius)
    np.testing.assert_array_equal(_mma_emulation(left, right, num_d, radius), want.numpy())


@pytest.mark.parametrize("mutation", ["b1_word", "second_window", "no_invalid", "border_row",
                                      "k_permutation", "no_high_plane", "hi_unshifted",
                                      "band_off_by_one"])
def test_fragment_emulation_catches_a_wrong_step(mutation):
    """The emulation is not blind: each broken step changes the answer."""
    left, right = _pair(np.random.default_rng(11), (40, 70))
    want = tsad.fused_block_matching_reference(torch.from_numpy(left), torch.from_numpy(right),
                                               16, 3)
    got = _mma_emulation(left, right, 16, 3, mutation=mutation)
    assert not np.array_equal(got, want.numpy())


# --- The build's reports that phase 22 prints ----------------------------------------

PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118sad_wta_mma_kernelILi5EEEvPKhS2_Piiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118sad_wta_mma_kernelILi5EEEvPKhS2_Piiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10gsm_strips12strip_kernelILi5EEEvPKhS2_Piiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN10gsm_strips12strip_kernelILi5EEEvPKhS2_Piiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 16 bytes smem, 392 bytes cmem[0]
"""


def test_ptxas_usage_reads_the_build_report(tmp_path, monkeypatch):
    from gpu_stereo_matching_tpu_torch.kernels import _build

    log = tmp_path / "lib.ptxas.txt"
    log.write_text(PTXAS_LOG)
    monkeypatch.setattr(_build, "build", lambda: None)
    monkeypatch.setattr(_build, "ptxas_log_path", lambda: log)
    usage = _build.ptxas_usage("sad_wta_mma_kernel")
    assert usage == {"_ZN12_GLOBAL__N_118sad_wta_mma_kernelILi5EEEvPKhS2_Piiiii": {
        "registers": 255, "spill_stores": 4, "spill_loads": 4, "stack": 8, "static_smem": 0}}
    strips = _build.ptxas_usage("strip_kernel")
    assert list(strips.values()) == [{"registers": 96, "spill_stores": 0, "spill_loads": 0,
                                      "stack": 0, "static_smem": 16}]


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_118sad_wta_mma_kernelILi3EEEvPKhS2_Piiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   STS [R3], R4 ;
        /*0040*/                   LDS R5, [R6] ;
        /*0050*/                   IMMA.16832.U8.U8 R8, R12.ROW, R10.COL, RZ ;
        /*0060*/                   MEMBAR.SC.GPU ;
        /*0070*/               @P0 BRA 0x40 ;
        /*0080*/                   STG.E.64 desc[UR4][R2.64], R8 ;
        /*0090*/                   EXIT ;
		Function : _ZN10gsm_strips12strip_kernelILi3EEEvPKhS2_Piiiii
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0010*/               @P0 BRA 0x0 ;
"""


def test_mma_sass_report_finds_the_disparity_loops(monkeypatch):
    """Phase 22's reading of the SASS: a body's IMMA, barriers and cp.async
    copies, and each loop that holds an IMMA with what it holds; MEMBAR is
    no barrier, the staging's barrier and shared store lie outside the loop,
    another kernel's function is not read."""
    from pathlib import Path

    from gpu_stereo_matching_tpu_torch.bench import fused_kernel
    from gpu_stereo_matching_tpu_torch.kernels import _build

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    monkeypatch.setattr(fused_kernel, "_sass", lambda library: SASS)
    monkeypatch.setattr(_build, "build", lambda: "lib.so")
    assert chip_smoke.mma_sass_report() == {3: {
        "imma": 1, "barriers": 1, "ldgsts": 1,
        "loops": [{"instructions": 4, "imma": 1, "barriers": 0, "shared_stores": 0,
                   "local_loads_and_stores": 0}]}}


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
