"""Port fused SAD + WTA: the plain twin vs JAX ``fused_block_matching`` in
interpret mode (bit-exact), the wrapper's dispatch, and the kernel vs its
twin on a card."""

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


def test_library_name_tracks_sources_and_flags(monkeypatch):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,num_d,radius",
    [((1, 21, 33), 8, 2), ((2, 30, 120), 63, 5), ((1, 24, 40), 40, 0), ((1, 40, 130), 16, 6)],
)
def test_kernel_matches_twin_on_card(cuda_device, shape, num_d, radius):
    left, right = _pair(np.random.default_rng(8), shape)
    lt = torch.from_numpy(left).to(cuda_device)
    rt = torch.from_numpy(right).to(cuda_device)
    before = tsad.LAUNCHES
    got = tsad.fused_block_matching_batched(lt, rt, num_d, radius)
    torch.cuda.synchronize()
    assert tsad.LAUNCHES == before + 1
    want = tsad.fused_block_matching_reference(lt, rt, num_d, radius)
    assert torch.equal(got, want)
