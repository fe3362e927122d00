"""The rig's front end (``kernels/remap.py::rectify_gray_pair``) and the
redesigned remap body behind it and ``remap_bilinear_u8_direct``.

- On the CPU, ``rectify_gray_pair`` is its plain twin and equals, per view,
  the JAX package's ``gray_blockmatching_bgr`` then
  ``remap_bilinear_u8_planned`` (Pallas in interpret mode) and then the JAX
  and port gathers, through the maps of tests/test_torch_remap.py.
- A numpy emulation of the kernel's indexing (8 flat output pixels a
  thread in groups of 4 adjacent ones, a warp's lanes on neighbouring
  groups, the frame loop, both views in one output, the vector and the
  scalar body, a BGR row's two taps as six bytes) writes every output byte
  exactly once, reads only bytes of the image, and equals the twins on
  ragged shapes and wild maps; three mutations of it fail.
- On a card, both entries against their twins.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.kernels.remap import build_remap_plan, remap_bilinear_u8_planned
from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr as jax_gray
from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8 as jax_remap
from gpu_stereo_matching_tpu_torch.kernels import remap as tremap
from gpu_stereo_matching_tpu_torch.ops import remap as plain
from tests.test_torch_gray_kernel import _gray_levels
from tests.test_torch_remap import _identity, _jitter, _out_of_bounds, _resize, _smooth

PIXELS = 8     # output pixels a thread owns (csrc/remap.cu kPixels) ...
GROUP = 4      # ... in groups of adjacent pixels (kGroup)
THREADS = 256  # threads a block
BM_WEIGHTS = (0.299, 0.587, 0.114)


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
    (B, Hs, Ws[, 3]) uint8 array, placed at byte ``src_base`` of a buffer;
    ``maps``: per view (map_x, map_y); one output of
    (views, B, Ho, Wo) bytes. ``aligned=False`` stands for a map or output
    base that is not aligned. Returns the output, whether each of its bytes
    was written exactly once (and nothing past it), and whether every byte
    read lay in the image.

    Mutations: ``"dropped_tail"`` (blocks for the whole threads only),
    ``"swapped_view_stride"`` (a view's output at view * n, a frame's at
    b * B * n), ``"tap_stride"`` (a BGR row's right tap 1 byte on, not 3).
    """
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
    bytes_in_image = True
    stride = 1 if mutation == "tap_stride" else 3
    for view, (src, (map_x, map_y)) in enumerate(zip(frames, maps)):
        flat_x, flat_y = map_x.reshape(-1), map_y.reshape(-1)
        mx = np.where(live, flat_x[np.minimum(p, n - 1)], np.float32(-1))
        my = np.where(live, flat_y[np.minimum(p, n - 1)], np.float32(-1))
        with np.errstate(invalid="ignore"):
            x0f, y0f = np.floor(mx), np.floor(my)
            valid = ((x0f >= 0) & (y0f >= 0) & (x0f <= np.float32(ws - 2))
                     & (y0f <= np.float32(hs - 2)))
            fx, fy = mx - x0f, my - y0f
        gx, gy = np.float32(1) - fx, np.float32(1) - fy
        off = np.where(valid, np.where(valid, y0f, 0).astype(np.int64) * ws
                       + np.where(valid, x0f, 0).astype(np.int64), -1)
        nbytes = src.size
        buf = np.zeros(src_base + nbytes + 8, np.uint8)
        buf[src_base:src_base + nbytes] = src.reshape(-1)
        out_view = view * n if mutation == "swapped_view_stride" else view * b_count * n
        frame_stride = b_count * n if mutation == "swapped_view_stride" else n
        at = off[valid]
        for b in range(b_count):
            if bgr:
                base = src_base + b * hs * ws * 3
                q11, q12, read_t = _bgr_row_pair(buf, base + 3 * at, stride)
                q21, q22, read_b = _bgr_row_pair(buf, base + 3 * (at + ws), stride)
                for i in (*read_t, *read_b):
                    bytes_in_image &= bool(((i >= src_base) & (i < src_base + nbytes)).all())
            else:
                img = src[b].reshape(-1).astype(np.float32)
                q11, q12, q21, q22 = img[at], img[at + 1], img[at + ws], img[at + ws + 1]
            fxv, fyv, gxv, gyv = fx[valid], fy[valid], gx[valid], gy[valid]
            top = gyv * (gxv * q11 + fxv * q12)
            bot = fyv * (gxv * q21 + fxv * q22)
            vals = np.zeros(p.shape, np.uint8)
            vals[valid] = np.clip(np.rint(top + bot), 0, 255).astype(np.uint8)
            dst = out_view + b * frame_stride + p
            # The vector body stores whole groups and skips a group past n,
            # the scalar body each pixel before n: the same bytes.
            np.add.at(writes, dst[live], 1)
            out[dst[live]] = vals[live]
    once = bool((writes[:total] == 1).all() and not writes[total:].any())
    return out[:total].reshape(len(frames), b_count, ho, wo), once, bytes_in_image


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


# (Hs, Ws, Ho, Wo, B, src_base, aligned): Ho * Wo % 4 != 0 with odd W;
# whole threads with odd source width and Ho != Hs; B = 1; an unaligned map
# (the scalar body on a shape the vector body could take); several blocks.
EMULATION_CASES = [
    (23, 31, 13, 37, 3, 1, True),
    (20, 33, 16, 24, 3, 3, True),
    (9, 10, 8, 8, 1, 0, True),
    (24, 32, 24, 32, 3, 2, False),
    (70, 45, 61, 67, 2, 0, True),
]


def _case_inputs(case, bgr, seed):
    hs, ws, ho, wo, b, src_base, aligned = case
    rng = np.random.default_rng(seed)
    shape = (b, hs, ws, 3) if bgr else (b, hs, ws)
    views = 2 if bgr else 1
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(views)]
    maps = [_wild_maps(rng, hs, ws, ho, wo) for _ in range(views)]
    return frames, maps, dict(bgr=bgr, src_base=src_base, aligned=aligned)


def _twins(frames, maps, bgr):
    if bgr:
        (lmx, lmy), (rmx, rmy) = maps
        pair = tremap.rectify_gray_pair(*_tensors(frames[0], frames[1], lmx, lmy, rmx, rmy))
        return np.stack([t.numpy() for t in pair])
    return tremap.remap_bilinear_u8_direct(*_tensors(frames[0], *maps[0])).numpy()[None]


@pytest.mark.parametrize("bgr", [True, False], ids=["front_end", "u8"])
@pytest.mark.parametrize("case", EMULATION_CASES)
def test_indexing_emulation_writes_once_and_equals_twin(case, bgr):
    frames, maps, opts = _case_inputs(case, bgr, seed=sum(case))
    got, once, bytes_ok = _emulate(frames, maps, **opts)
    assert once
    assert bytes_ok
    np.testing.assert_array_equal(got, _twins(frames, maps, bgr))
    hs, ws, ho, wo = case[:4]
    valid = np.isfinite(maps[0][0]) & (np.floor(maps[0][0]) <= ws - 2) & (maps[0][0] >= 0)
    assert 0 < valid.mean() < 1  # the maps hit both valid and invalid pixels


def test_emulation_covers_both_bodies():
    bodies = {(case[2] * case[3] % GROUP == 0 and case[6]) for case in EMULATION_CASES}
    assert bodies == {True, False}


@pytest.mark.parametrize("mutation", ["dropped_tail", "swapped_view_stride", "tap_stride"])
def test_indexing_emulation_fails_under_mutation(mutation):
    failed = 0
    for case in EMULATION_CASES:
        frames, maps, opts = _case_inputs(case, True, seed=sum(case))
        got, once, _ = _emulate(frames, maps, mutation=mutation, **opts)
        failed += int(not once or not np.array_equal(got, _twins(frames, maps, True)))
    assert failed > 0


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
    for case in EMULATION_CASES:
        frames, maps, opts = _case_inputs(case, bgr, seed=sum(case))
        frames = [torch.from_numpy(f).to(cuda_device) for f in frames]
        maps = [[torch.from_numpy(m).to(cuda_device) for m in mm] for mm in maps]
        if not opts["aligned"]:  # a map one float off its 16-byte alignment
            maps = [[torch.cat([m.reshape(-1)[:1], m.reshape(-1)])[1:].view(m.shape) for m in mm]
                    for mm in maps]
        before = dict(tremap.BODY_LAUNCHES)
        if bgr:
            got = tremap.rectify_gray_pair(frames[0], frames[1], *maps[0], *maps[1])
            want = plain.rectify_gray_pair(frames[0], frames[1], *maps[0], *maps[1])
        else:
            got = [tremap.remap_bilinear_u8_direct(frames[0], *maps[0])]
            want = [plain.remap_bilinear_u8(frames[0], *maps[0])]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), case
        for k in bodies:
            bodies[k] += tremap.BODY_LAUNCHES[k] - before[k]
    assert all(bodies.values()), bodies


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
    assert tremap.front_end_plan((40, 64), (40, 64), 2, device=cuda_device)["body"] == "vector"
    for g, f in zip(got, frames):
        assert torch.equal(g, plain.remap_bilinear_u8(plain.gray_blockmatching_bgr(f), *maps))
