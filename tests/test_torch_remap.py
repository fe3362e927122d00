"""Port remap: the plain gather vs JAX ``remap_bilinear_u8_planned`` (interpret
mode) and ``ops.remap.remap_bilinear_u8``, bit-exact; the wrapper's dispatch;
the kernel vs its twin on a card.

Maps are built as in tests/test_remap_kernel.py, with fractional parts away
from exact .5, where one ulp may legally flip round-half-even.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.kernels.remap import build_remap_plan, remap_bilinear_u8_planned
from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8 as jax_remap
from gpu_stereo_matching_tpu_torch.kernels import remap as tremap
from gpu_stereo_matching_tpu_torch.ops.remap import remap_bilinear_u8


def _grids(h, w):
    return np.meshgrid(
        np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij"
    )


def _smooth(rng, h, w):
    yy, xx = _grids(h, w)
    mx = (xx + 5.3 * np.sin(yy / 31.0) + 0.1).astype(np.float32)
    my = (yy + 2.1 * np.cos(xx / 53.0) - 1.7).astype(np.float32)
    return (h, w), mx, my


def _out_of_bounds(rng, h, w):
    yy, xx = _grids(h, w)
    mx = (xx - 12.3 + 5.3 * np.sin(yy / 31.0)).astype(np.float32)
    my = (yy + 8.2 + 2.1 * np.cos(xx / 53.0)).astype(np.float32)
    return (h, w), mx, my


def _jitter(rng, h, w):
    yy, xx = _grids(h, w)
    mx = (xx + rng.uniform(-3, 3, (h, w)) * 0.99 + 0.005).astype(np.float32)
    my = (yy + rng.uniform(-3, 3, (h, w)) * 0.99 + 0.005).astype(np.float32)
    return (h, w), mx, my


def _resize(rng, h, w):
    yy, xx = _grids(32, 96)
    return (h, w), (xx * 1.3 + 3.2).astype(np.float32), (yy * 1.1 + 2.3).astype(np.float32)


def _identity(rng, h, w):
    yy, xx = _grids(h, w)
    return (h, w), xx, yy


@pytest.mark.parametrize(
    "make,hw",
    [
        (_smooth, (96, 200)),
        (_out_of_bounds, (96, 200)),
        (_jitter, (64, 144)),
        (_resize, (48, 160)),
        (_identity, (40, 136)),
    ],
)
def test_plain_gather_matches_jax_planned_and_ops(make, hw):
    rng = np.random.default_rng(1234)
    src = rng.integers(0, 256, hw, dtype=np.uint8)
    src_hw, mx, my = make(rng, *hw)
    plan = build_remap_plan(mx, my, src_hw)
    assert plan is not None
    planned = np.asarray(remap_bilinear_u8_planned(jnp.asarray(src), plan, interpret=True))
    ops = np.asarray(jax_remap(jnp.asarray(src), jnp.asarray(mx), jnp.asarray(my)))
    got = remap_bilinear_u8(torch.from_numpy(src), torch.from_numpy(mx), torch.from_numpy(my))
    np.testing.assert_array_equal(got.numpy(), planned)
    np.testing.assert_array_equal(got.numpy(), ops)


def test_plain_gather_wild_maps_match_jax_ops():
    """Maps far outside the source, and a scrambled map the TPU plan
    rejects, against the JAX gather."""
    rng = np.random.default_rng(3)
    h, w = 32, 140
    src = rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = _grids(h, w)
    for mx, my in (
        ((xx - 500).astype(np.float32), yy),
        (rng.uniform(-3, w + 2, (h, w)).astype(np.float32),
         rng.uniform(-3, h + 2, (h, w)).astype(np.float32)),
    ):
        want = np.asarray(jax_remap(jnp.asarray(src), jnp.asarray(mx), jnp.asarray(my)))
        got = remap_bilinear_u8(torch.from_numpy(src), torch.from_numpy(mx), torch.from_numpy(my))
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_batched_equals_per_frame_on_cpu():
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.integers(0, 256, (3, 40, 50), dtype=np.uint8))
    _, mx, my = _jitter(rng, 40, 50)
    mx, my = torch.from_numpy(mx), torch.from_numpy(my)
    before = tremap.LAUNCHES
    batch = tremap.remap_bilinear_u8_direct(src, mx, my)
    assert tremap.LAUNCHES == before
    for b in range(3):
        assert torch.equal(batch[b], tremap.remap_bilinear_u8_direct(src[b], mx, my))


def test_wrapper_checks_and_no_fallback():
    src = torch.zeros((8, 9), dtype=torch.uint8)
    m = torch.zeros((4, 5), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        tremap.remap_bilinear_u8_direct(src, m.double(), m.double())
    with pytest.raises(ValueError, match="equal-shape"):
        tremap.remap_bilinear_u8_direct(src, m, m[:, :4])
    with pytest.raises(ValueError, match="uint8"):
        tremap.remap_bilinear_u8_direct(src.float(), m, m)
    with pytest.raises(ValueError, match="smaller than 2x2"):
        tremap.remap_bilinear_u8_direct(src[:1], m, m)
    meta = torch.empty((8, 9), dtype=torch.uint8, device="meta")
    mm = torch.empty((4, 5), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tremap.remap_bilinear_u8_direct(meta, mm, mm)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_twin_on_card(cuda_device):
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(0, 256, (2, 96, 200), dtype=np.uint8)).to(cuda_device)
    _, mx, my = _jitter(rng, 96, 200)
    mx, my = torch.from_numpy(mx).to(cuda_device), torch.from_numpy(my).to(cuda_device)
    before = tremap.LAUNCHES
    got = tremap.remap_bilinear_u8_direct(src, mx, my)
    torch.cuda.synchronize()
    assert tremap.LAUNCHES == before + 1
    assert torch.equal(got, remap_bilinear_u8(src, mx, my))
