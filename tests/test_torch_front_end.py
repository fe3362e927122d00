"""The rig's front end (``kernels/remap.py::rectify_gray_pair``) and the
redesigned remap body behind it and ``remap_bilinear_u8_direct``.

- On the CPU, ``rectify_gray_pair`` is its plain twin and equals, per view,
  the JAX package's ``gray_blockmatching_bgr`` then
  ``remap_bilinear_u8_planned`` (Pallas in interpret mode) and then the JAX
  and port gathers, through the maps of tests/test_torch_remap.py.
- A numpy emulation of the u8 entry's indexing (8 flat output pixels a
  thread in groups of 4 adjacent ones, a warp's lanes on neighbouring
  groups, the frame loop, the vector and the scalar body) and of the front
  end's (16 x 128 tiles of both views in one output, 8 pixels a thread, each
  tile's source window from its maps, the staged-or-gather choice, the
  staged path's 16-byte chunks and byte copies at a frame's edges, its gray
  levels and four-level interpolation, the gather path's six bytes a BGR
  row) writes every output byte exactly once, reads and stages only bytes of
  the frame, and equals the twins on ragged shapes, wild maps, the
  benchmark rig's maps at a reduced size, an affine map of small rotation,
  the staging budget's edge and a launch that mixes both paths; mutations
  of it fail. The host mirror of the choice (``front_end_tiles`` on the
  CPU) counts the emulation's tiles, and 100% staged on the benchmark
  rig's maps.
- On a card, both entries against their twins, the front end at 800x1280
  on the rig's maps, wild maps and a mix, and the kernel's own tile counts
  against the emulation's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.kernels.remap import build_remap_plan, remap_bilinear_u8_planned
from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr as jax_gray
from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8 as jax_remap
from gpu_stereo_matching_tpu_torch.calib.rectify import rectification_maps_from_calibration
from gpu_stereo_matching_tpu_torch.io.calib_yaml import StereoCalibration
from gpu_stereo_matching_tpu_torch.kernels import remap as tremap
from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig
from gpu_stereo_matching_tpu_torch.ops import remap as plain
from tests.test_torch_gray_kernel import _gray_levels
from tests.test_torch_remap import _identity, _jitter, _out_of_bounds, _resize, _smooth

PIXELS = 8     # output pixels a thread owns (csrc/remap.cu kPixels) ...
GROUP = 4      # ... in groups of adjacent pixels (kGroup)
THREADS = 256  # threads a block
BM_WEIGHTS = (0.299, 0.587, 0.114)
# The front end (csrc/remap.cu): tiles of TILE_ROWS x TILE_COLS output
# pixels, 8 a thread (pixel k of thread t at row 2 (t // 32) + k // 4,
# column t % 32 + 32 (k % 4)); a window of at most WINDOW_ROWS x
# WINDOW_COLS source pixels is staged, BGR_PITCH bytes a staged row.
TILE_ROWS, TILE_COLS, WINDOW_ROWS, WINDOW_COLS = 16, 128, 28, 160
BGR_PITCH = (15 + 3 * WINDOW_COLS + 15) // 16 * 16
_T, _K = np.arange(THREADS)[:, None], np.arange(PIXELS)[None, :]
TILE_R = (2 * (_T // 32) + _K // 4).reshape(-1)
TILE_C = (_T % 32 + 32 * (_K % 4)).reshape(-1)
RIG_CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "rig800-fused.json"


def _bm_gray(c0, c1, c2):
    """gray.cuh's device function at a tap: block-matching weights, half to
    even, as a float."""
    return _gray_levels(c0, c1, c2, BM_WEIGHTS, "half_even").astype(np.float32)


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize(
    "make,hw",
    [(_smooth, (40, 96)), (_out_of_bounds, (40, 96)), (_jitter, (32, 72)), (_resize, (48, 160)),
     (_identity, (24, 40))],
)
def test_twin_matches_jax_gray_then_planned_remap(make, hw, batch):
    rng = np.random.default_rng(1234)
    shape = (batch, *hw, 3) if batch > 1 else (*hw, 3)
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = rng.integers(0, 256, shape, dtype=np.uint8)
    (_, lmx, lmy), (_, rmx, rmy) = make(rng, *hw), make(rng, *hw)
    before = (tremap.LAUNCHES, tremap.PAIR_LAUNCHES)
    got = tremap.rectify_gray_pair(*_tensors(left, right, lmx, lmy, rmx, rmy))
    assert (tremap.LAUNCHES, tremap.PAIR_LAUNCHES) == before
    for bgr, mx, my, out in ((left, lmx, lmy, got[0]), (right, rmx, rmy, got[1])):
        plan = build_remap_plan(mx, my, hw)
        assert plan is not None
        frames = bgr if batch > 1 else bgr[None]
        want = np.stack([
            np.asarray(remap_bilinear_u8_planned(jax_gray(jnp.asarray(f)), plan, interpret=True))
            for f in frames])
        jax_ops = np.asarray(
            jax_remap(jax_gray(jnp.asarray(frames)), jnp.asarray(mx), jnp.asarray(my)))
        port_ops = plain.remap_bilinear_u8(
            plain.gray_blockmatching_bgr(torch.from_numpy(frames)), *_tensors(mx, my))
        got_frames = out.numpy() if batch > 1 else out.numpy()[None]
        np.testing.assert_array_equal(got_frames, jax_ops)
        np.testing.assert_array_equal(got_frames, port_ops.numpy())
        # The JAX package's planned kernel and its XLA gather differ by one
        # level on a few near-tie pixels (ROADMAP queue 3); the port follows
        # the gather, and equals the planned kernel everywhere else.
        split = want != jax_ops
        np.testing.assert_array_equal(got_frames[~split], want[~split])
        assert split.mean() < 1e-3
        assert np.abs(want[split].astype(int) - jax_ops[split]).max(initial=0) <= 1


# ---- Emulation of csrc/remap.cu ---------------------------------------------


def _bgr_row_pair(buf, a, stride):
    """The gray levels of the BGR pixels at byte addresses a and a + stride
    (3; a mutation reads 1), six byte loads; also the addresses read."""
    addrs = [a + k for k in range(3)] + [a + stride + k for k in range(3)]
    c = [buf[i].astype(np.uint64) for i in addrs]
    return _bm_gray(*c[:3]), _bm_gray(*c[3:]), addrs


def _emulate(frames, maps, *, bgr, src_base=0, aligned=True, mutation=None):
    """What one launch of csrc/remap.cu writes. ``frames``: per view a
    (B, Hs, Ws[, 3]) uint8 array, placed at byte ``src_base`` of a buffer
    that starts on a 16-byte boundary; ``maps``: per view (map_x, map_y);
    one output of (views, B, Ho, Wo) bytes. BGR frames (two views) run the
    front end (:func:`_emulate_front_end`), gray ones the u8 entry.
    ``aligned=False`` stands for a map or output base that is not aligned.
    Returns the output, whether each of its bytes was written exactly once
    (and nothing past it), whether every byte read or staged lay in its
    frame, and the front end's tiles by path (None for the u8 entry).

    Mutations: ``"dropped_tail"`` (blocks for the whole threads, or tiles,
    only), ``"swapped_view_stride"`` (a view's output at view * n, a frame's
    at b * B * n), ``"tap_stride"`` (a BGR pixel's bytes 1 byte apart, not
    3); the front end's also ``"window_last_row"`` and ``"window_last_col"``
    (the window one row or column short) and ``"unchecked_chunks"`` (every
    16-byte chunk staged whole, past the frame's edges too).
    """
    if bgr:
        return _emulate_front_end(frames, maps, src_base=src_base, mutation=mutation)
    b_count, hs, ws = frames[0].shape[:3]
    ho, wo = maps[0][0].shape
    n = ho * wo
    vec = aligned and n % GROUP == 0
    per_block = PIXELS * THREADS
    blocks = n // per_block if mutation == "dropped_tail" else -(-n // per_block)
    # Thread t of block k starts at k * per_block + t * GROUP; its group i
    # lies THREADS * GROUP * i further on.
    base = (np.arange(blocks)[:, None] * per_block + np.arange(THREADS) * GROUP).reshape(-1)
    base = base[base < n]                    # threads past n return at once
    offsets = (np.arange(PIXELS // GROUP)[:, None] * THREADS * GROUP + np.arange(GROUP)).reshape(-1)
    p = base[:, None] + offsets              # (threads, PIXELS)
    live = p < n                             # the scalar body's mask
    if vec:  # whole groups: a group is all in or all out
        groups = live.reshape(-1, GROUP)
        assert (groups.all(-1) == groups.any(-1)).all()
    total = len(frames) * b_count * n
    out = np.zeros(total + b_count * b_count * n, np.uint8)  # room for a mutation's strays
    writes = np.zeros(out.size, np.int64)
    for view, (src, (map_x, map_y)) in enumerate(zip(frames, maps)):
        flat_x, flat_y = map_x.reshape(-1), map_y.reshape(-1)
        mx = np.where(live, flat_x[np.minimum(p, n - 1)], np.float32(-1))
        my = np.where(live, flat_y[np.minimum(p, n - 1)], np.float32(-1))
        fx, fy, gx, gy, valid, off = _taps(mx, my, hs, ws)
        out_view = view * n if mutation == "swapped_view_stride" else view * b_count * n
        frame_stride = b_count * n if mutation == "swapped_view_stride" else n
        at = off[valid]
        for b in range(b_count):
            img = src[b].reshape(-1).astype(np.float32)
            vals = np.zeros(p.shape, np.uint8)
            vals[valid] = _bilinear(fx[valid], fy[valid], gx[valid], gy[valid], img[at],
                                    img[at + 1], img[at + ws], img[at + ws + 1])
            dst = out_view + b * frame_stride + p
            # The vector body stores whole groups and skips a group past n,
            # the scalar body each pixel before n: the same bytes.
            np.add.at(writes, dst[live], 1)
            out[dst[live]] = vals[live]
    once = bool((writes[:total] == 1).all() and not writes[total:].any())
    return out[:total].reshape(len(frames), b_count, ho, wo), once, True, None


def _taps(mx, my, hs, ws):
    """tap_of: the weights, the validity and the top-left tap's offset
    (-1 where not valid) of float32 maps over an (hs, ws) source."""
    with np.errstate(invalid="ignore"):
        x0f, y0f = np.floor(mx), np.floor(my)
        valid = ((x0f >= 0) & (y0f >= 0) & (x0f <= np.float32(ws - 2))
                 & (y0f <= np.float32(hs - 2)))
        fx, fy = mx - x0f, my - y0f
    gx, gy = np.float32(1) - fx, np.float32(1) - fy
    off = np.where(valid, np.where(valid, y0f, 0).astype(np.int64) * ws
                   + np.where(valid, x0f, 0).astype(np.int64), -1)
    return fx, fy, gx, gy, valid, off


def _bilinear(fx, fy, gx, gy, q11, q12, q21, q22):
    """The interpolated bytes, each float32 operation rounded on its own."""
    top = gy * (gx * q11 + fx * q12)
    bot = fy * (gx * q21 + fx * q22)
    return np.clip(np.rint(top + bot), 0, 255).astype(np.uint8)


def _tile_window(mx, my, hs, ws, mutation=None):
    """A tile's source window from its pixels' maps, by the kernel's rule:
    (x0, y0, rows, cols, staged), or None where no tap is valid (the tile
    gathers, reading nothing)."""
    _, _, _, _, valid, _ = _taps(mx, my, hs, ws)
    if not valid.any():
        return None
    xs, ys = np.floor(mx[valid]).astype(np.int64), np.floor(my[valid]).astype(np.int64)
    rows = int(ys.max() - ys.min()) + 2 - (mutation == "window_last_row")
    cols = int(xs.max() - xs.min()) + 2 - (mutation == "window_last_col")
    return int(xs.min()), int(ys.min()), rows, cols, rows <= WINDOW_ROWS and cols <= WINDOW_COLS


def _tile_maps(map_x, map_y, ty, tx):
    """Tile (ty, tx)'s output rows and columns in the threads' order, whether
    each is inside the output, and its maps (-1 outside)."""
    ho, wo = map_x.shape
    y, x = ty * TILE_ROWS + TILE_R, tx * TILE_COLS + TILE_C
    inside = (y < ho) & (x < wo)
    yc, xc = np.minimum(y, ho - 1), np.minimum(x, wo - 1)
    mx = np.where(inside, map_x[yc, xc], np.float32(-1)).astype(np.float32)
    my = np.where(inside, map_y[yc, xc], np.float32(-1)).astype(np.float32)
    return y, x, inside, mx, my


def _emulated_paths(maps, hs, ws):
    """The front end's tiles by path over both views' maps: what the
    emulation counts, without running a frame."""
    paths = {"staged": 0, "gathered": 0}
    for map_x, map_y in maps:
        ho, wo = map_x.shape
        for ty in range(-(-ho // TILE_ROWS)):
            for tx in range(-(-wo // TILE_COLS)):
                win = _tile_window(*_tile_maps(map_x, map_y, ty, tx)[3:], hs, ws)
                paths["staged" if win is not None and win[4] else "gathered"] += 1
    return paths


def _emulate_front_end(frames, maps, *, src_base=0, mutation=None):
    """One launch of front_end_kernel (see :func:`_emulate`): per view and
    tile the window from the maps, then per frame the staged path (16-byte
    chunks of each window row from the boundary at or before its first
    byte, whole where inside the frame and byte by byte at its edges; each
    staged pixel's gray level once; four levels a pixel, weights 0 where a
    tap is not valid) or the gather path. Shared memory starts as garbage."""
    b_count, hs, ws = frames[0].shape[:3]
    ho, wo = maps[0][0].shape
    n, frame_bytes = ho * wo, hs * ws * 3
    whole = mutation == "dropped_tail"
    tiles_y = ho // TILE_ROWS if whole else -(-ho // TILE_ROWS)
    tiles_x = wo // TILE_COLS if whole else -(-wo // TILE_COLS)
    total = 2 * b_count * n
    out = np.zeros(total + b_count * b_count * n, np.uint8)
    writes = np.zeros(out.size, np.int64)
    bytes_in_frame = True
    paths = {"staged": 0, "gathered": 0}
    stride = 1 if mutation == "tap_stride" else 3
    garbage = np.random.default_rng(99)
    for view, (src, (map_x, map_y)) in enumerate(zip(frames, maps)):
        buf = np.zeros(src_base + src.size + 64, np.uint8)
        buf[src_base:src_base + src.size] = src.reshape(-1)
        out_view = view * n if mutation == "swapped_view_stride" else view * b_count * n
        frame_stride = b_count * n if mutation == "swapped_view_stride" else n
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                y, x, inside, mx, my = _tile_maps(map_x, map_y, ty, tx)
                fx, fy, gx, gy, valid, off = _taps(mx, my, hs, ws)
                win = _tile_window(mx, my, hs, ws, mutation)
                staged = win is not None and win[4]
                paths["staged" if staged else "gathered"] += 1
                stage = garbage.integers(0, 256, (WINDOW_ROWS, BGR_PITCH), dtype=np.uint8)
                # (a row more: what a mutated window reads past the levels)
                gray = garbage.uniform(0, 1e4, (WINDOW_ROWS + 1) * WINDOW_COLS + 1).astype(
                    np.float32)
                if staged:
                    x0, y0, rows, cols, _ = win
                    fl_x = np.where(valid, np.floor(mx), x0).astype(np.int64)
                    fl_y = np.where(valid, np.floor(my), y0).astype(np.int64)
                    at = (fl_y - y0) * WINDOW_COLS + fl_x - x0
                    w = [np.where(valid, v, np.float32(0)) for v in (fx, fy, gx, gy)]
                for b in range(b_count):
                    lo = src_base + b * frame_bytes
                    if staged:
                        for r in range(rows):
                            first = lo + ((y0 + r) * ws + x0) * 3
                            base = first & ~15
                            chunks = (first + 3 * cols - base + 15) >> 4
                            # A chunk wholly in the frame is copied whole, any
                            # other byte by byte, its bytes in the frame only.
                            a = base + np.arange(16 * chunks)
                            keep = (a >= lo) & (a < lo + frame_bytes)
                            if mutation == "unchecked_chunks":
                                keep[:] = True
                            bytes_in_frame &= bool(((a[keep] >= lo)
                                                    & (a[keep] < lo + frame_bytes)).all())
                            row = stage[r, :16 * chunks]
                            row[keep] = buf[np.minimum(a[keep], buf.size - 1)]
                            lead = first & 15
                            px = stage[r, lead + stride * np.arange(cols)[:, None]
                                       + np.arange(3)].astype(np.uint64)
                            gray[r * WINDOW_COLS:r * WINDOW_COLS + cols] = _bm_gray(
                                px[:, 0], px[:, 1], px[:, 2])
                        vals = _bilinear(w[0], w[1], w[2], w[3], gray[at], gray[at + 1],
                                         gray[at + WINDOW_COLS], gray[at + WINDOW_COLS + 1])
                    else:
                        vals = np.zeros(y.shape, np.uint8)
                        tap = off[valid]
                        q11, q12, read_t = _bgr_row_pair(buf, lo + 3 * tap, stride)
                        q21, q22, read_b = _bgr_row_pair(buf, lo + 3 * (tap + ws), stride)
                        for i in (*read_t, *read_b):
                            bytes_in_frame &= bool(((i >= lo) & (i < lo + frame_bytes)).all())
                        vals[valid] = _bilinear(fx[valid], fy[valid], gx[valid], gy[valid],
                                                q11, q12, q21, q22)
                    dst = out_view + b * frame_stride + y * wo + x
                    np.add.at(writes, dst[inside], 1)
                    out[dst[inside]] = vals[inside]
    once = bool((writes[:total] == 1).all() and not writes[total:].any())
    return out[:total].reshape(2, b_count, ho, wo), once, bytes_in_frame, paths


def _wild_maps(rng, hs, ws, ho, wo):
    """Maps over and past the source, with NaN, coordinates past int32,
    exact last-row and last-column coordinates, negative fractions and
    integer coordinates."""
    mx = rng.uniform(-2.5, ws + 1.5, (ho, wo)).astype(np.float32)
    my = rng.uniform(-2.5, hs + 1.5, (ho, wo)).astype(np.float32)
    mx.flat[0], my.flat[1] = np.nan, np.nan
    mx.flat[2], my.flat[3] = 3e9, -3e9
    mx.flat[4], my.flat[5] = np.float32(2**31), np.float32(-(2**31) - 256.0)
    mx.flat[6], my.flat[6] = ws - 1, 1.5         # last column: invalid
    mx.flat[7], my.flat[7] = 1.25, hs - 1        # last row: invalid
    mx.flat[8], my.flat[8] = ws - 2, hs - 2      # the last valid tap, fractions 0
    mx.flat[9], my.flat[9] = -0.25, 2.5          # a negative fraction: invalid
    mx.flat[10], my.flat[10] = 2.75, -0.5
    mx.flat[11], my.flat[11] = 3.0, 4.0
    return mx, my


# (Hs, Ws, Ho, Wo, B, src_base, aligned), through wild maps: Ho * Wo % 4
# != 0 with odd W; whole threads with odd source width and Ho != Hs; B = 1;
# an unaligned map (the scalar body on a shape the vector body could take);
# several blocks.
EMULATION_CASES = [
    (23, 31, 13, 37, 3, 1, True),
    (20, 33, 16, 24, 3, 3, True),
    (9, 10, 8, 8, 1, 0, True),
    (24, 32, 24, 32, 3, 2, False),
    (70, 45, 61, 67, 2, 0, True),
]
# (..., maps) through the front end's kinds of maps: the benchmark rig's at
# an eighth of 800x1280 and an affine map of small rotation (every tile
# stages; odd frame sizes at odd bases, so chunks cross the frames' edges);
# the staging budget's edge (a tile of 27 x 160 source pixels stages, one of
# 27 x 163 and one of 29 x 160 gather); and a launch that mixes staged
# tiles, gathering ones and tiles with no valid tap.
STAGED_CASES = [
    (100, 160, 100, 160, 2, 1, True, "rig"),
    (41, 301, 37, 299, 3, 3, True, "affine"),
    (60, 400, 32, 256, 2, 5, True, "budget"),
    (44, 300, 48, 256, 2, 7, True, "mixed"),
]


def _rig_maps(hw):
    """Both views' maps of the benchmark rig (``rig800-fused``'s
    calibration), its intrinsics scaled from 800x1280 to ``hw``."""
    cal = {k: np.asarray(v, np.float64)
           for k, v in json.loads(RIG_CONFIG.read_text())["calibration"].items()}
    for key in ("left_intrinsics", "right_intrinsics"):
        cal[key][:2] *= hw[0] / 800
    pairs = rectification_maps_from_calibration(StereoCalibration(**cal), hw)
    return [tuple(np.asarray(m, np.float32) for m in pair) for pair in pairs]


def _affine_maps(rng, ho, wo, angle=0.02):
    yy, xx = np.meshgrid(np.arange(ho, dtype=np.float64), np.arange(wo, dtype=np.float64),
                         indexing="ij")
    shift = rng.uniform(0.1, 0.9, 2)
    c, s_ = 0.99 * np.cos(angle), 0.99 * np.sin(angle)
    return ((c * xx - s_ * yy + 1.5 + shift[0]).astype(np.float32),
            (s_ * xx + c * yy + 0.5 + shift[1]).astype(np.float32))


def _budget_maps(rng, ho, wo):
    yy, xx = np.meshgrid(np.arange(ho, dtype=np.float32), np.arange(wo, dtype=np.float32),
                         indexing="ij")
    mx = np.where(xx < 128, np.float32(1.25) * xx, 160 + np.float32(1.27) * (xx - 128))
    my = np.where(yy < 16, np.float32(1.7) * yy, np.float32(27.2) + np.float32(1.8) * (yy - 16))
    return mx.astype(np.float32), my.astype(np.float32)


def _mixed_maps(rng, hs, ws, ho, wo):
    mx, my = _affine_maps(rng, ho, wo)
    wx, wy = _wild_maps(rng, hs, ws, ho, wo)
    mx[:, 128:], my[:, 128:] = wx[:, 128:], wy[:, 128:]
    mx[32:], my[32:] = -5.0, -5.0     # a tile row with no valid tap
    return mx, my


def _maps_of(kind, rng, hs, ws, ho, wo, views):
    if kind == "rig":
        return _rig_maps((ho, wo))[:views]
    make = {"wild": lambda: _wild_maps(rng, hs, ws, ho, wo),
            "affine": lambda: _affine_maps(rng, ho, wo),
            "budget": lambda: _budget_maps(rng, ho, wo),
            "mixed": lambda: _mixed_maps(rng, hs, ws, ho, wo)}[kind]
    return [make() for _ in range(views)]


def _case_inputs(case, bgr, seed):
    hs, ws, ho, wo, b, src_base, aligned, *kind = case
    rng = np.random.default_rng(seed)
    shape = (b, hs, ws, 3) if bgr else (b, hs, ws)
    views = 2 if bgr else 1
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(views)]
    maps = _maps_of(kind[0] if kind else "wild", rng, hs, ws, ho, wo, views)
    return frames, maps, dict(bgr=bgr, src_base=src_base, aligned=aligned)


def _twins(frames, maps, bgr):
    if bgr:
        (lmx, lmy), (rmx, rmy) = maps
        pair = tremap.rectify_gray_pair(*_tensors(frames[0], frames[1], lmx, lmy, rmx, rmy))
        return np.stack([t.numpy() for t in pair])
    return tremap.remap_bilinear_u8_direct(*_tensors(frames[0], *maps[0])).numpy()[None]


# What each kind of map makes of the front end's tiles (staged, gathered),
# both views; None: whatever the maps give.
EXPECTED_PATHS = {"rig": (28, 0), "affine": (18, 0), "budget": (2, 6), "mixed": (4, 8),
                  "wild": None}


@pytest.mark.parametrize("bgr", [True, False], ids=["front_end", "u8"])
@pytest.mark.parametrize("case", EMULATION_CASES + STAGED_CASES)
def test_indexing_emulation_writes_once_and_equals_twin(case, bgr):
    frames, maps, opts = _case_inputs(case, bgr, seed=sum(case[:7]))
    got, once, bytes_ok, paths = _emulate(frames, maps, **opts)
    assert once
    assert bytes_ok
    np.testing.assert_array_equal(got, _twins(frames, maps, bgr))
    hs, ws, ho, wo = case[:4]
    kind = case[7] if len(case) > 7 else "wild"
    if kind == "wild":
        valid = np.isfinite(maps[0][0]) & (np.floor(maps[0][0]) <= ws - 2) & (maps[0][0] >= 0)
        assert 0 < valid.mean() < 1  # the maps hit both valid and invalid pixels
    if bgr:
        # The host mirror of the kernel's rule counts the emulation's tiles.
        mirror = tremap.front_end_tiles((hs, ws), *_tensors(*maps[0], *maps[1]))
        assert (mirror["staged"], mirror["gathered"]) == (paths["staged"], paths["gathered"])
        assert EXPECTED_PATHS[kind] in (None, (paths["staged"], paths["gathered"]))


def test_emulation_covers_both_bodies():
    bodies = {(case[2] * case[3] % GROUP == 0 and case[6]) for case in EMULATION_CASES}
    assert bodies == {True, False}
    # The front end's cases take both paths, and one launch mixes them.
    paths = [_emulated_paths(_case_inputs(case, True, seed=sum(case[:7]))[1], *case[:2])
             for case in EMULATION_CASES + STAGED_CASES]
    assert sum(p["staged"] for p in paths) > 0 and sum(p["gathered"] for p in paths) > 0
    assert any(p["staged"] and p["gathered"] for p in paths)


@pytest.mark.parametrize("mutation", ["dropped_tail", "swapped_view_stride", "tap_stride",
                                      "window_last_row", "window_last_col", "unchecked_chunks"])
def test_indexing_emulation_fails_under_mutation(mutation):
    failed = 0
    for case in EMULATION_CASES + STAGED_CASES:
        frames, maps, opts = _case_inputs(case, True, seed=sum(case[:7]))
        got, once, bytes_ok, _ = _emulate(frames, maps, mutation=mutation, **opts)
        failed += int(not once or not bytes_ok
                      or not np.array_equal(got, _twins(frames, maps, True)))
    assert failed > 0


def test_front_end_tiles_rule_on_rig_and_wild_maps():
    """The host mirror of the staged-or-gather rule: every tile of the
    benchmark rig's maps at 800x1280 stages, as the rig records at
    construction; wild maps gather."""
    maps = _tensors(*_rig_maps((800, 1280))[0], *_rig_maps((800, 1280))[1])
    tiles = tremap.front_end_tiles((800, 1280), *maps)
    assert tiles == {"staged": 1000, "gathered": 0, "staged_share": 100.0}
    config = json.loads(RIG_CONFIG.read_text())
    cal = StereoCalibration(**{k: np.asarray(v, np.float64)
                               for k, v in config["calibration"].items()})
    assert StereoRig(cal, (800, 1280), device="cpu").front_end_tiles == tiles
    rng = np.random.default_rng(5)
    wild = _tensors(*_wild_maps(rng, 800, 1280, 800, 1280), *_wild_maps(rng, 800, 1280, 800, 1280))
    assert tremap.front_end_tiles((800, 1280), *wild)["staged_share"] < 100.0


def test_wrapper_checks_and_no_fallback():
    frame = torch.zeros((6, 7, 3), dtype=torch.uint8)
    m = torch.zeros((4, 5), dtype=torch.float32)
    with pytest.raises(ValueError, match="BGR"):
        tremap.rectify_gray_pair(frame, frame[:, :6], m, m, m, m)
    with pytest.raises(ValueError, match="BGR"):
        tremap.rectify_gray_pair(frame.float(), frame.float(), m, m, m, m)
    with pytest.raises(ValueError, match="BGR"):
        tremap.rectify_gray_pair(frame[..., :2], frame[..., :2], m, m, m, m)
    with pytest.raises(ValueError, match="smaller than 2x2"):
        tremap.rectify_gray_pair(frame[:1], frame[:1], m, m, m, m)
    with pytest.raises(TypeError, match="float32"):
        tremap.rectify_gray_pair(frame, frame, m, m, m.double(), m.double())
    with pytest.raises(ValueError, match="equal-shape"):
        tremap.rectify_gray_pair(frame, frame, m, m[:, :4], m, m)
    with pytest.raises(ValueError, match="differ in shape"):
        tremap.rectify_gray_pair(frame, frame, m, m, m[:3], m[:3])
    meta = torch.empty((6, 7, 3), dtype=torch.uint8, device="meta")
    mm = torch.empty((4, 5), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tremap.rectify_gray_pair(meta, meta, mm, mm, mm, mm)
    with pytest.raises(ValueError, match="several devices"):
        tremap.rectify_gray_pair(frame, frame, m, m, mm, mm)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bgr", [True, False], ids=["front_end", "u8"])
def test_kernel_matches_twin_on_card(cuda_device, bgr):
    bodies = dict.fromkeys(tremap.BODIES, 0)
    paths = {"staged": 0, "gathered": 0}
    for case in EMULATION_CASES + STAGED_CASES:
        frames, maps, opts = _case_inputs(case, bgr, seed=sum(case[:7]))
        frames = [torch.from_numpy(f).to(cuda_device) for f in frames]
        maps = [[torch.from_numpy(m).to(cuda_device) for m in mm] for mm in maps]
        if not opts["aligned"]:  # a map one float off its 16-byte alignment
            maps = [[torch.cat([m.reshape(-1)[:1], m.reshape(-1)])[1:].view(m.shape) for m in mm]
                    for mm in maps]
        before = dict(tremap.BODY_LAUNCHES)
        if bgr:
            got = tremap.rectify_gray_pair(frames[0], frames[1], *maps[0], *maps[1])
            want = plain.rectify_gray_pair(frames[0], frames[1], *maps[0], *maps[1])
            tiles = tremap.front_end_tiles(case[:2], *maps[0], *maps[1])
            emulated = _emulated_paths([[m.cpu().numpy() for m in mm] for mm in maps], *case[:2])
            assert (tiles["staged"], tiles["gathered"]) == tuple(emulated.values()), case
            for k in paths:
                paths[k] += emulated[k]
        else:
            got = [tremap.remap_bilinear_u8_direct(frames[0], *maps[0])]
            want = [plain.remap_bilinear_u8(frames[0], *maps[0])]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), case
        for k in bodies:
            bodies[k] += tremap.BODY_LAUNCHES[k] - before[k]
    if bgr:
        assert all(paths.values()) and not any(bodies.values()), (paths, bodies)
    else:
        assert all(bodies.values()), bodies


def _rig_800_cases(rng):
    """(name, both views' maps) at 800x1280: the benchmark rig's, wild ones
    (every tile gathers) and a mix (the rig's left half, wild right half)."""
    rig = _rig_maps((800, 1280))
    wild = [_wild_maps(rng, 800, 1280, 800, 1280) for _ in range(2)]
    mixed = []
    for (mx, my), (wx, wy) in zip(rig, wild):
        mx, my = mx.copy(), my.copy()
        mx[:, 640:], my[:, 640:] = wx[:, 640:], wy[:, 640:]
        mixed.append((mx, my))
    return [("rig", rig), ("wild", wild), ("mixed", mixed)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_front_end_at_800x1280_on_card(cuda_device, batch):
    """The front end equals the twin at the benchmark's size on the rig's
    maps, on maps that force gathering and on a mix; the kernel's tile
    counts equal the emulation's, and each call is one launch."""
    rng = np.random.default_rng(batch)
    for name, maps in _rig_800_cases(rng):
        if name != "rig" and batch == 16:
            continue
        dev_maps = [torch.from_numpy(m).to(cuda_device) for mm in maps for m in mm]
        left, right = (torch.from_numpy(rng.integers(0, 256, (batch, 800, 1280, 3),
                                                     dtype=np.uint8)).to(cuda_device)
                       for _ in range(2))
        before = (tremap.LAUNCHES, tremap.PAIR_LAUNCHES)
        got = tremap.rectify_gray_pair(left, right, *dev_maps)
        assert (tremap.LAUNCHES, tremap.PAIR_LAUNCHES) == (before[0], before[1] + 1)
        want = plain.rectify_gray_pair(left, right, *dev_maps)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        plan = tremap.front_end_plan((800, 1280), (800, 1280), batch, device=cuda_device,
                                     maps=dev_maps)
        emulated = _emulated_paths(maps, 800, 1280)
        assert (plan["staged_tiles"], plan["gathered_tiles"]) == tuple(emulated.values()), name
        if name == "rig":
            assert plan["staged_share"] == 100.0
        else:
            assert plan["staged_share"] < 100.0


@pytest.mark.gpu
def test_pair_is_one_launch_on_card(cuda_device):
    rng = np.random.default_rng(8)
    frames = [torch.from_numpy(rng.integers(0, 256, (2, 40, 64, 3), dtype=np.uint8)).to(cuda_device)
              for _ in range(2)]
    _, mx, my = _jitter(rng, 40, 64)
    maps = [torch.from_numpy(m).to(cuda_device) for m in (mx, my)]
    before = (tremap.LAUNCHES, tremap.PAIR_LAUNCHES)
    got = tremap.rectify_gray_pair(frames[0], frames[1], *maps, *maps)
    torch.cuda.synchronize()
    assert (tremap.LAUNCHES, tremap.PAIR_LAUNCHES) == (before[0], before[1] + 1)
    plan = tremap.front_end_plan((40, 64), (40, 64), 2, device=cuda_device)
    # 3 tiles a view, both views, the 2 frames in groups of frames_per_block.
    assert plan["body"] == "tiled" and plan["blocks"] == 2 * 3 * -(-2 // plan["frames_per_block"])
    for g, f in zip(got, frames):
        assert torch.equal(g, plain.remap_bilinear_u8(plain.gray_blockmatching_bgr(f), *maps))
