"""The gray kernel's wrappers (``kernels/gray.py``): on the CPU they are the
plain twin and equal the JAX package over every BGR triple; their checks;
a numpy emulation of the kernel's thread (16 pixels from three 16-byte
words, the scalar tail, the scalar body for an unaligned base) against the
twin; and, on a card, the kernel against the twin over every triple."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.ops import color as jcolor
from gpu_stereo_matching_tpu_torch.kernels import gray
from gpu_stereo_matching_tpu_torch.ops import color as tcolor

NAMES = ["gray_blockmatching_bgr", "gray_rec601_bgr"]
CONVENTIONS = {  # name -> (weights, rounding), as ops/color.py defines them
    "gray_blockmatching_bgr": ((0.299, 0.587, 0.114), "half_even"),
    "gray_rec601_bgr": ((0.114, 0.587, 0.299), "half_up"),
}
PIXELS = 16  # a thread's pixels (csrc/gray.cu kPixels)


@pytest.fixture(scope="module")
def all_bgr():
    """All 2**24 BGR triples as one (4096, 4096, 3) uint8 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=-1)
    return img.astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("name", NAMES)
def test_wrappers_on_cpu_equal_twin_and_jax_over_all_triples(all_bgr, name):
    before = gray.LAUNCHES
    got = getattr(gray, name)(torch.from_numpy(all_bgr))
    assert gray.LAUNCHES == before
    twin = getattr(tcolor, name)(torch.from_numpy(all_bgr))
    np.testing.assert_array_equal(got.numpy(), twin.numpy())
    jax_gray = np.asarray(getattr(jcolor, name)(jnp.asarray(all_bgr)))
    np.testing.assert_array_equal(got.numpy(), jax_gray)


@pytest.mark.parametrize("rounding", ["half_up", "half_even"])
def test_grayscale_u8_custom_weights_matches_jax(rounding):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    weights = (0.2, 0.5, 0.3)
    want = np.asarray(jcolor.grayscale_u8(jnp.asarray(img), weights, rounding))
    np.testing.assert_array_equal(
        gray.grayscale_u8(torch.from_numpy(img), weights, rounding).numpy(), want)


def test_checks_and_no_fallback():
    img = torch.zeros((4, 5, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        gray.gray_blockmatching_bgr(img.float())
    with pytest.raises(ValueError, match=r"\(\.\.\., 3\)"):
        gray.gray_blockmatching_bgr(torch.zeros((4, 5, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="rounding"):
        gray.grayscale_u8(img, (1, 0, 0), "down")
    with pytest.raises(ValueError, match="3 weights"):
        gray.grayscale_u8(img, (1, 0), "half_up")
    meta = torch.empty((4, 5, 3), dtype=torch.uint8, device="meta")
    for name in NAMES:
        with pytest.raises(RuntimeError, match="no kernel"):
            getattr(gray, name)(meta)


def _gray_levels(c0, c1, c2, weights, rounding):
    """The device function of csrc/gray.cuh on integer channel arrays:
    each FMA step rounded to float32 once (exact in float64 first)."""
    w = np.asarray(weights, np.float32).astype(np.float64)
    g = (c0 * w[0]).astype(np.float32)
    g = (c1 * w[1] + g.astype(np.float64)).astype(np.float32)
    g = (c2 * w[2] + g.astype(np.float64)).astype(np.float32)
    r = np.rint(g) if rounding == "half_even" else np.floor(g + np.float32(0.5))
    return np.clip(r, 0, 255).astype(np.uint8)


def _emulate_gray_kernel(buf, src_base, n, out_base, weights, rounding, drop_tail=False):
    """What csrc/gray.cu writes for the n pixels at byte ``src_base`` of
    ``buf`` into an output at byte ``out_base``: thread t owns pixels
    [16t, 16t + 16); with both bases 16-byte aligned a whole thread reads
    three 16-byte words and writes one, a tail thread (and every thread of
    an unaligned launch) works byte by byte. Returns the output and the
    number of writes to each byte of it."""
    out = np.zeros(n, np.uint8)
    writes = np.zeros(n, np.int64)
    vec = (src_base | out_base) % 16 == 0
    threads = -(-n // PIXELS)
    whole = n // PIXELS if vec else 0
    if whole:
        words = buf[src_base:src_base + 3 * PIXELS * whole].view("<u4").reshape(whole, 12)
        b = 3 * np.arange(PIXELS)
        chans = [(words[:, (b + c) >> 2] >> (8 * ((b + c) & 3)).astype(np.uint32)) & 0xFF
                 for c in range(3)]
        levels = _gray_levels(*chans, weights, rounding).astype(np.uint32)
        out_words = np.zeros((whole, 4), np.uint32)
        for i in range(PIXELS):
            out_words[:, i >> 2] |= levels[:, i] << np.uint32(8 * (i & 3))
        out[:PIXELS * whole] = out_words.view(np.uint8).reshape(-1)
        writes[:PIXELS * whole] += 1
    for t in range(whole, threads - 1 if drop_tail else threads):
        p = np.arange(PIXELS * t, min(PIXELS * t + PIXELS, n))
        px = buf[src_base + 3 * p[:, None] + np.arange(3)].astype(np.uint32)
        out[p] = _gray_levels(px[:, 0], px[:, 1], px[:, 2], weights, rounding)
        writes[p] += 1
    return out, writes


def _ragged_cases(rng):
    for n in (1, 15, 16, 17, 33, 1000, 4099):
        buf = rng.integers(0, 256, 3 * n + 64, dtype=np.uint8)
        for src_base, out_base in ((0, 0), (16, 0), (1, 0), (3, 0), (0, 5)):
            yield buf, src_base, n, out_base


@pytest.mark.parametrize("name", NAMES)
def test_thread_emulation_equals_twin_on_ragged_lengths(name):
    weights, rounding = CONVENTIONS[name]
    rng = np.random.default_rng(21)
    cases = 0
    for buf, src_base, n, out_base in _ragged_cases(rng):
        got, writes = _emulate_gray_kernel(buf, src_base, n, out_base, weights, rounding)
        want = getattr(tcolor, name)(torch.from_numpy(buf[src_base:src_base + 3 * n].reshape(n, 3)))
        assert (writes == 1).all(), (n, src_base, out_base)
        np.testing.assert_array_equal(got, want.numpy())
        cases += 1
    assert cases == 35


def test_thread_emulation_fails_when_the_tail_is_dropped():
    weights, rounding = CONVENTIONS["gray_blockmatching_bgr"]
    rng = np.random.default_rng(22)
    missed = with_tail = 0
    for buf, src_base, n, out_base in _ragged_cases(rng):
        _, writes = _emulate_gray_kernel(buf, src_base, n, out_base, weights, rounding,
                                         drop_tail=True)
        missed += int((writes == 0).any())
        with_tail += int(n % PIXELS != 0 or (src_base | out_base) % 16 != 0)
    assert missed == with_tail == 33


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_twin_over_all_triples_on_card(cuda_device, all_bgr, name):
    src = torch.from_numpy(all_bgr)
    before = gray.LAUNCHES
    got = getattr(gray, name)(src.to(cuda_device))
    torch.cuda.synchronize()
    assert gray.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), getattr(tcolor, name)(src))


@pytest.mark.gpu
def test_kernel_ragged_and_unaligned_on_card(cuda_device):
    weights, rounding = CONVENTIONS["gray_rec601_bgr"]
    rng = np.random.default_rng(23)
    flat = torch.from_numpy(rng.integers(0, 256, 3 * 5000 + 64, dtype=np.uint8)).to(cuda_device)
    bodies = set()
    for n in (1, 15, 16, 17, 4099):
        for base in (0, 1, 3, 16):
            img = flat[base:base + 3 * n].view(n, 3)
            out = torch.empty(n, dtype=torch.uint8, device=cuda_device)
            bodies.add(gray.gray_kernel_body(img, out))
            got = gray.grayscale_u8(img, weights, rounding)
            want = tcolor.grayscale_u8(img.cpu(), weights, rounding)
            assert torch.equal(got.cpu(), want), (n, base)
    assert bodies == {"scalar", "vector"}
