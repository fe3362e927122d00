"""Port fused SAD + WTA: the plain twin vs JAX ``fused_block_matching`` in
interpret mode (bit-exact), the wrapper's dispatch, and the kernel vs its
twin on a card."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.kernels import sad_wta as jsad
from gpu_stereo_matching_tpu.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.kernels import sad_wta as tsad


def _pair(rng, shape):
    return (
        rng.integers(0, 256, shape, dtype=np.uint8),
        rng.integers(0, 256, shape, dtype=np.uint8),
    )


def _jax_fused(left, right, num_d, radius):
    return np.asarray(
        jsad.fused_block_matching(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=num_d, radius=radius, tile_h=8, interpret=True,
        )
    )


# The shapes of tests/test_kernels.py: packed and unpacked TPU bodies,
# widths off the 128-lane tile, odd D, r = 6.
@pytest.mark.parametrize(
    "hw,num_d,radius",
    [
        ((21, 33), 8, 2),
        ((13, 17), 4, 1),
        ((9, 130), 4, 1),
        ((40, 64), 16, 3),
        ((16, 257), 12, 4),
        ((24, 40), 7, 2),
        ((24, 40), 8, 6),
    ],
)
def test_twin_matches_jax_fused(hw, num_d, radius):
    left, right = _pair(np.random.default_rng(1234), hw)
    got = tsad.fused_block_matching(torch.from_numpy(left), torch.from_numpy(right), num_d, radius)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_fused(left, right, num_d, radius))


@pytest.mark.parametrize("seed", [4, 16, 30])
def test_twin_matches_fused_where_fused_and_ops_differ(seed):
    """At these seeds the fused formula (full-window invalid constant) and
    the ops path (clipped-row count) pick different disparities near the
    top/bottom border; the twin follows the fused kernel."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (30, 120), dtype=np.uint8)
    right = rng.integers(0, 256, (30, 120), dtype=np.uint8)
    want = _jax_fused(left, right, 64, 5)
    got = tsad.fused_block_matching(torch.from_numpy(left), torch.from_numpy(right), 64, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    ops = np.asarray(
        block_matching_pipeline(
            jnp.asarray(left), jnp.asarray(right),
            BlockMatchingConfig(num_disparities=64, sad_radius=5),
        )
    )
    rows = np.nonzero((ops != want).any(axis=1))[0]
    assert rows.size > 0 and np.all((rows < 5) | (rows >= 25))


def _structured_pair(kind, shape, seed=21):
    """Inputs on which a matcher's faults show: every d ties (constant,
    answer 0), ties almost everywhere (two levels), the largest SAD the
    radius allows (255 against 0), a known shift."""
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


@pytest.mark.parametrize("kind", STRUCTURED)
def test_twin_matches_jax_fused_on_structured_inputs(kind):
    """The yardstick itself, at the main path's D=64 r=5, where ties and
    extremes decide the answer."""
    left, right = _structured_pair(kind, (19, 90))
    want = _jax_fused(left, right, 64, 5)
    got = tsad.fused_block_matching(torch.from_numpy(left), torch.from_numpy(right), 64, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "constant":
        assert not want.any()
    if kind == "shifted":
        assert (want[5:-5, 70:] == 9).mean() > 0.9


def _packed_pair_emulation(left, right, num_d, radius, tile=32, d_start=0, total=None,
                           mutation=None):
    """The CUDA strip body's arithmetic in torch, on int64 tensors cut to 32
    bits after every operation, over the ``num_d`` disparities from
    ``d_start``: two disparities share a word (d in the low half, d + 1 in
    the high half), both passes slide a window sum with one add and one
    subtract per step (restarting every ``tile`` rows and columns, as the
    kernel's tiles and strips do), each output keeps the minimum of the keys
    ``(SAD << 16) | d`` with the global d, and an odd ``num_d`` runs its last
    step with the high half held at the invalid constant.

    What leaves is the whole-range kernel's disparity, the key's low half
    (``total`` None), or the key kernel's ``SAD * total + d``, widened once
    from the smallest key (int64). ``mutation`` breaks one step on purpose:
    ``"local_d"`` keys with d - d_start, ``"no_invalid"`` leaves the odd
    count's dead half at the sum of nothing, ``"shift_kept"`` widens without
    taking the ``<< 16`` out."""
    m32 = 0xFFFFFFFF
    k = 2 * radius + 1
    invalid = 255 * k
    h, w = left.shape
    d_end = d_start + num_d
    li = torch.nn.functional.pad(left.to(torch.int64), (0, 0, radius, radius))
    ri = torch.nn.functional.pad(right.to(torch.int64), (0, 0, radius, radius))
    col = torch.arange(w)
    best = torch.full((h, w), m32, dtype=torch.int64)
    for d0 in range(d_start, d_end, 2):
        d1 = d0 + 1
        ok0, ok1 = col >= d0, (col >= d1) & (d1 < d_end)
        pair = torch.zeros_like(li)
        pair[:, d0:] = (li[:, d0:] - ri[:, : w - d0]).abs()
        if d1 < d_end:
            pair[:, d1:] |= (li[:, d1:] - ri[:, : w - d1]).abs() << 16
        held = col >= d1 if mutation == "no_invalid" else ok1
        fix = torch.where(ok0, 0, invalid) | torch.where(held, 0, invalid << 16)
        v = torch.zeros((h, w + 2 * radius), dtype=torch.int64)  # zero columns outside
        for y in range(h):
            if y % tile == 0:
                s = (fix + pair[y:y + k].sum(0)) & m32
            else:
                s = (s + pair[y + 2 * radius] - pair[y - 1]) & m32
            v[y, radius:radius + w] = s
        shift = d_start if mutation == "local_d" else 0
        for x in range(w):
            if x % tile == 0:
                s = v[:, x:x + k].sum(1) & m32
            else:
                s = (s + v[:, x + 2 * radius] - v[:, x - 1]) & m32
            key_lo = ((s << 16) & m32) | (d0 - shift)
            key_hi = (s & 0xFFFF0000) | (d1 - shift)
            best[:, x] = torch.minimum(best[:, x], torch.minimum(key_lo, key_hi))
    if total is None:
        return (best & 0xFFFF).to(torch.int32)
    if mutation == "shift_kept":
        return (best & 0xFFFF0000) * total + (best & 0xFFFF)
    return (best >> 16) * total + (best & 0xFFFF)


@pytest.mark.parametrize("kind", ["extremes", "two_level", "random"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6, 7])
def test_packed_pair_arithmetic_matches_twin(radius, kind):
    """Every radius the strip body serves, where a carry between the halves
    or a tie that went to d + 1 before d would show: the largest SAD the
    radius allows (255 against 0; 255 * 15**2 = 57375 at r = 7 still fits
    16 bits), ties everywhere (two levels), and odd D at odd radii."""
    num_d = 63 if radius % 2 else 64
    shape = (37, 70)
    if kind == "random":
        left, right = _pair(np.random.default_rng(radius), shape)
    else:
        left, right = _structured_pair(kind, shape)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    want = tsad.fused_block_matching_reference(lt, rt, num_d, radius)
    got = _packed_pair_emulation(lt, rt, num_d, radius)
    assert torch.equal(got, want)


def test_twin_batched_matches_jax_batched():
    left, right = _pair(np.random.default_rng(5), (3, 19, 70))
    want = np.asarray(
        jsad.fused_block_matching_batched(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=10, radius=2, tile_h=8, interpret=True,
        )
    )
    got = tsad.fused_block_matching_batched(torch.from_numpy(left), torch.from_numpy(right), 10, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_twin_edge_cases_r0_and_d_equals_w():
    """r = 0 (single-pixel window) and D = W against JAX."""
    left, right = _pair(np.random.default_rng(6), (11, 20))
    for num_d, radius in ((20, 0), (20, 2), (5, 0)):
        got = tsad.fused_block_matching(
            torch.from_numpy(left), torch.from_numpy(right), num_d, radius
        )
        np.testing.assert_array_equal(got.numpy(), _jax_fused(left, right, num_d, radius))


def test_cpu_wrapper_does_not_launch():
    left, right = _pair(np.random.default_rng(7), (2, 8, 12))
    before = tsad.LAUNCHES
    tsad.fused_block_matching_batched(torch.from_numpy(left), torch.from_numpy(right), 4, 1)
    assert tsad.LAUNCHES == before


def test_fused_kernel_bench_runs_on_the_card_only():
    """``bench/fused_kernel.py`` has no CPU mode: without a card it raises."""
    from gpu_stereo_matching_tpu_torch.bench import fused_kernel

    argv = ["--shapes", "2x40x130", "--disparities", "16", "--radius", "2", "--reps", "1"]
    with pytest.raises(RuntimeError, match="CUDA device only"):
        fused_kernel.main(argv + ["--device", "cpu"])
    if torch.cuda.is_available():
        assert fused_kernel.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused_kernel.main(argv)


def test_non_cpu_tensor_never_gets_the_twin():
    """A tensor off the CPU launches the kernel or raises; here (no card)
    it raises."""
    meta = torch.empty((8, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tsad.fused_block_matching(meta, meta, 4, 1)


def test_wrapper_input_checks():
    u8 = torch.zeros((8, 12), dtype=torch.uint8)
    with pytest.raises(ValueError, match="batched"):
        tsad.fused_block_matching(u8[None], u8[None], 4, 1)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        tsad.fused_block_matching_batched(u8, u8, 4, 1)
    with pytest.raises(TypeError, match="uint8"):
        tsad.fused_block_matching(u8.float(), u8.float(), 4, 1)
    with pytest.raises(ValueError, match="num_disparities"):
        tsad.fused_block_matching(u8, u8, 13, 1)
    with pytest.raises(ValueError, match="num_disparities"):
        tsad.fused_block_matching(u8, u8, 0, 1)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: loading the kernels raises; nothing falls back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_library", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_library_name_tracks_sources_and_flags(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != path
    monkeypatch.undo()
    assert _build.library_path() == path
    # A copy of the sources names the same library until a source, or the
    # header that three of them include, is edited: a stale build is not loaded.
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path() == path
    for user in ("sad_wta.cu", "sad_wta_key.cu", "split_phase.cu"):
        assert '#include "sad_strips.cuh"' in (copy / user).read_text()
    for name in ("sad_strips.cuh", "sad_wta_key.cu"):
        with open(copy / name, "a") as f:
            f.write("// edited\n")
        edited = _build.library_path()
        assert edited != path
        path = edited


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# Both bodies of the kernel (the strip body serves r = 1..7, the general one
# r = 0 and r >= 8), on random and structured inputs: ragged tiles and strips
# (W = 128k + 1, H = 32k + 1), odd D, D = W, B = 3.
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random"] + STRUCTURED)
@pytest.mark.parametrize(
    "shape,num_d,radius",
    [((1, 21, 33), 8, 2), ((2, 30, 120), 63, 5), ((1, 24, 40), 40, 0), ((1, 40, 130), 16, 6),
     ((3, 33, 257), 64, 5), ((1, 65, 129), 129, 7), ((1, 40, 130), 64, 8), ((3, 33, 257), 63, 0),
     ((1, 17, 385), 65, 1)],
)
def test_kernel_matches_twin_on_card(cuda_device, shape, num_d, radius, kind):
    if kind == "random":
        left, right = _pair(np.random.default_rng(8), shape)
    else:
        left, right = _structured_pair(kind, shape)
    lt = torch.from_numpy(left).to(cuda_device)
    rt = torch.from_numpy(right).to(cuda_device)
    before = tsad.LAUNCHES
    got = tsad.fused_block_matching_batched(lt, rt, num_d, radius)
    torch.cuda.synchronize()
    assert tsad.LAUNCHES == before + 1
    want = tsad.fused_block_matching_reference(lt, rt, num_d, radius)
    assert torch.equal(got, want)
    assert tsad.kernel_body(num_d, radius) == ("strips" if 1 <= radius <= 7 else "general")
