"""The argmin kernel's right-view body, ``kernels/split_phase.py::
lr_check_from_sad``: the right view's argmin read on the left volume's
diagonal, then the LR check of the left map against it.

On the CPU its plain twin (the right-view volume, its argmin, the mask, the
``where``, the cast) is held to a loop written from the kernel's own
formula, which reads no right-view volume and fills nothing past the edge;
on a card the kernel is held to the twin bit for bit, and the bm+ path to
its plain reference. The file imports nothing of JAX."""

import numpy as np
import pytest
import torch

from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu_torch.kernels import split_phase as tsp
from gpu_stereo_matching_tpu_torch.models import block_matching as tbm

INT32_MAX = np.iinfo(np.int32).max


def _volume(kind, shape, seed=5):
    """A (D, H, W) int32 volume: few levels (ties almost everywhere), one
    constant (every d ties), falling along x (so a read past the edge would
    win), or reaching INT32_MAX (the plain right view's fill)."""
    rng = np.random.default_rng(seed)
    num_d, h, w = shape
    if kind == "levels":
        return rng.integers(0, 4, shape).astype(np.int32)
    if kind == "constant":
        return np.full(shape, 9, np.int32)
    if kind == "falling":
        return np.broadcast_to(np.arange(w, 0, -1, dtype=np.int32), shape).copy()
    assert kind == "int32_max"
    vol = rng.integers(INT32_MAX - 3, INT32_MAX, shape, endpoint=True).astype(np.int32)
    vol[:, :, ::3] = INT32_MAX
    return vol


def _any_map(shape, seed=6):
    """Any int32 left map of a (D, H, W) volume: negative, 0, past x and
    past D included."""
    num_d, h, w = shape
    return np.random.default_rng(seed).integers(-2, num_d + 3, (h, w)).astype(np.int32)


def _left_map(kind, vol):
    """The volume's own left argmin, or any map."""
    return vol.argmin(0).astype(np.int32) if kind == "argmin" else _any_map(vol.shape)


def _diagonal_lr_check(vol, dl, max_diff, out_dtype):
    """The kernel's formula in numpy: for each x', the first d < D with
    x' + d < W of least ``vol[d, y, x' + d]``; then ``dl`` where dl > 0,
    x - dl >= 0 and |dl - dr(x - dl)| <= max_diff, else 0, cut to 8 bits
    for uint8."""
    num_d, h, w = vol.shape
    best = vol[0].astype(np.int64)
    dr = np.zeros((h, w), np.int64)
    for d in range(1, min(num_d, w)):
        cand = np.full((h, w), np.iinfo(np.int64).max)
        cand[:, : w - d] = vol[d, :, d:]
        better = cand < best
        best = np.where(better, cand, best)
        dr = np.where(better, d, dr)
    x = np.arange(w)[None, :]
    src = x - dl.astype(np.int64)
    at = np.take_along_axis(dr, np.clip(src, 0, w - 1), axis=1)
    ok = (dl > 0) & (src >= 0) & (np.abs(dl - at) <= max_diff)
    out = np.where(ok, dl.astype(np.int64), 0)
    return out.astype(np.uint8) if out_dtype == torch.uint8 else out.astype(np.int32)


# D = 1, D = W, D > W, D > 256 (the uint8 map wraps), rows wider than a
# block's 256 threads, widths that are no multiple of 4 or 32.
SHAPES = [(1, 3, 17), (17, 4, 17), (6, 2, 5), (8, 5, 33), (300, 2, 301), (40, 3, 517)]


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8], ids=["i32", "u8"])
@pytest.mark.parametrize("max_diff", [0, 1, 2, 3])
@pytest.mark.parametrize("left", ["argmin", "any"])
@pytest.mark.parametrize("kind", ["levels", "constant", "falling", "int32_max"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_twin_equals_the_diagonal_read(shape, kind, left, max_diff, out_dtype):
    vol = _volume(kind, shape)
    dl = _left_map(left, vol)
    before = dict(tsp.LAUNCHES)
    got = tsp.lr_check_from_sad(torch.from_numpy(vol), torch.from_numpy(dl), max_diff, out_dtype)
    assert tsp.LAUNCHES == before
    assert got.dtype == out_dtype and tuple(got.shape) == shape[1:]
    np.testing.assert_array_equal(got.numpy(), _diagonal_lr_check(vol, dl, max_diff, out_dtype))


def test_uint8_map_wraps_past_255():
    """D > 256: a kept disparity of 256 or more is cut to its low 8 bits,
    as ``.to(torch.uint8)`` cuts it."""
    vol = _volume("falling", (300, 1, 301))
    dl = np.zeros((1, 301), np.int32)
    # On a falling volume dr(x') = min(299, 300 - x'): the last d inside the image.
    dl[0, 290] = 290  # x - dl = 0, dr(0) = 299: 9 apart, dropped
    dl[0, 300] = 299  # x - dl = 1, dr(1) = 299: kept
    got = tsp.lr_check_from_sad(torch.from_numpy(vol), torch.from_numpy(dl), 3, torch.uint8)
    assert int(got[0, 300]) == 299 - 256 and int(got[0, 290]) == 0
    assert int(got.sum()) == 299 - 256


@pytest.mark.parametrize("bad,match", [
    (dict(sad=torch.zeros((4, 8, 12), dtype=torch.int64)), "int32 volume"),
    (dict(sad=torch.zeros((8, 12), dtype=torch.int32)), r"\(D, H, W\)"),
    (dict(sad=torch.zeros((0, 8, 12), dtype=torch.int32)), "non-empty"),
    (dict(disp_left=torch.zeros((8, 12), dtype=torch.int64)), "left map"),
    (dict(disp_left=torch.zeros((8, 11), dtype=torch.int32)), "left map"),
    (dict(out_dtype=torch.float32), "out_dtype"),
    (dict(out_dtype=torch.int64), "out_dtype"),
    (dict(max_diff=2**31), "max_diff"),
])
def test_wrapper_input_checks(bad, match):
    args = dict(sad=torch.zeros((4, 8, 12), dtype=torch.int32),
                disp_left=torch.zeros((8, 12), dtype=torch.int32), max_diff=1,
                out_dtype=torch.int32)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        tsp.lr_check_from_sad(**args)


def test_non_cpu_tensor_never_gets_the_twin():
    sad = torch.empty((4, 8, 12), dtype=torch.int32, device="meta")
    disp = torch.empty((8, 12), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsp.lr_check_from_sad(sad, disp, 1)


@pytest.mark.parametrize("median_radius", [0, 2])
@pytest.mark.parametrize("max_diff", [0, 1, 3])
def test_pipeline_equals_the_reference_on_the_cpu(max_diff, median_radius):
    """With the LR check on, the pipeline takes the new entry and the
    reference the plain composition; both give the same int32 maps."""
    rng = np.random.default_rng(11)
    left = torch.from_numpy(rng.integers(0, 256, (2, 20, 70), dtype=np.uint8))
    right = torch.from_numpy(np.roll(left.numpy(), -5, axis=-1))
    cfg = BlockMatchingConfig(num_disparities=16, sad_radius=2, lr_consistency=True,
                              lr_max_diff=max_diff, median_radius=median_radius)
    got = tbm.block_matching_pipeline(left, right, cfg)
    assert got.dtype == torch.int32
    assert torch.equal(got, tbm.block_matching_reference(left, right, cfg))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# 800x1280 D=64 is the benchmark's bm+ frame; 37x301 a ragged width, no
# multiple of 4 or 32, wider than one chunk of 256; 3x12300 rows whose
# argmins need more than 48 KB of shared memory; 300x4x333 a uint8 wrap.
CARD_SHAPES = [(64, 800, 1280), (64, 37, 301), (4, 3, 12300), (300, 4, 333), (1, 5, 7),
               (17, 6, 17)]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.uint8], ids=["i32", "u8"])
@pytest.mark.parametrize("kind", ["real", "constant", "levels", "falling"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_equals_twin_on_card(cuda_device, shape, kind, out_dtype):
    """The kernel against its twin run on the card's tensors, bit for bit,
    on the volume's own left map and on any map, at tolerances 0, 1, 3."""
    num_d, h, w = shape
    if kind == "real":
        rng = np.random.default_rng(h + w)
        left = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)).to(cuda_device)
        vol = tsp.sad_volume(left, torch.roll(left, -7, dims=1), num_d, 5)
    else:
        vol = torch.from_numpy(_volume(kind, shape)).to(cuda_device)
    for left_kind in ("argmin", "any"):
        dl = (tsp.wta_from_sad(vol) if left_kind == "argmin"
              else torch.from_numpy(_any_map(shape)).to(cuda_device))
        for max_diff in (0, 1, 3):
            before = tsp.LAUNCHES["lr_check_from_sad"]
            got = tsp.lr_check_from_sad(vol, dl, max_diff, out_dtype)
            torch.cuda.synchronize()
            assert tsp.LAUNCHES["lr_check_from_sad"] == before + 1
            want = tsp.lr_check_from_sad_reference(vol, dl, max_diff, out_dtype)
            assert got.dtype == out_dtype
            assert torch.equal(got, want), (left_kind, max_diff)


@pytest.mark.gpu
def test_kernel_refuses_rows_past_shared_memory(cuda_device):
    sad = torch.zeros((1, 1, tsp.MAX_LR_WIDTH + 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="W <="):
        tsp.lr_check_from_sad(sad, torch.zeros(sad.shape[1:], dtype=torch.int32,
                                               device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("median_radius", [0, 3])
def test_bm_plus_on_card_equals_the_reference(cuda_device, median_radius):
    """The benchmark's bm+ frame, 800x1280 D=64 r=5: the pipeline (one
    volume, one left argmin, one right-view launch a frame) against the
    plain reference on the card."""
    rng = np.random.default_rng(23)
    left = torch.from_numpy(rng.integers(0, 256, (2, 800, 1280), dtype=np.uint8)).to(cuda_device)
    right = torch.roll(left, -11, dims=2)
    cfg = BlockMatchingConfig(num_disparities=64, sad_radius=5, lr_consistency=True,
                              lr_max_diff=1, median_radius=median_radius)
    before = dict(tsp.LAUNCHES)
    got = tbm.block_matching_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    assert {k: tsp.LAUNCHES[k] - before[k] for k in before} == {
        "sad_volume": 2, "wta_from_sad": 2, "lr_check_from_sad": 2}
    assert torch.equal(got, tbm.block_matching_reference(left, right, cfg))
