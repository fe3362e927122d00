"""ST-2 in the port (``models/segment_tree.py``) against the JAX package's on
the CPU: the right-view cost bit for bit, phase 1's packed map and the whole
``st2_disparity`` by the share of equal pixels (XLA contracts the jitted
filter's multiply-adds, so near-tied WTA decisions may flip), the composed
NumPy oracle, and one case bit for bit against JAX run op by op. Then the
checks, and on a card the card against the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig as JaxConfig
from gpu_stereo_matching_tpu.models import segment_tree as jst
from gpu_stereo_matching_tpu.ops.cost import right_cost_from_left as jax_right_cost
from gpu_stereo_matching_tpu.tree.builder import color_depth_edge_weights, color_edge_weights
from gpu_stereo_matching_tpu.tree.stride import converged_stride_batch as jax_converged
from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.models import segment_tree as tst
from gpu_stereo_matching_tpu_torch.ops.cost import right_cost_from_left
from tests import oracles
from tests.test_segment_tree_pipeline import _oracle_aggregate_select
from tests.test_torch_segment_tree import _art_pair, _pair
from tests.torch_st_helpers import fresh_registries  # noqa: F401


@pytest.mark.parametrize("dhw", [(6, 12, 20), (25, 3, 7), (4, 5, 1), (1, 4, 9), (60, 4, 33)])
def test_right_cost_from_left_is_exact(dhw):
    """D < W, D > W, W = 1, D = 1 and the pipeline's D: one gather equals the
    JAX scan and the oracle bit for bit."""
    cost = np.random.default_rng(sum(dhw)).random(dhw).astype(np.float32)
    got = right_cost_from_left(torch.from_numpy(cost))
    assert got.dtype == torch.float32 and tuple(got.shape) == dhw
    assert torch.equal(got, torch.tensor(np.asarray(jax_right_cost(jnp.asarray(cost)))))
    assert torch.equal(got, torch.from_numpy(oracles.right_cost_from_left_oracle(cost)))


def _group(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8) for _ in range(2)]


def test_phase1_group_matches_jax(fresh_registries):
    """A 2-frame group through both packages' phase 1, each with its own
    σ₁ plans over the same trees."""
    cfg = SegmentTreeConfig(max_disp_levels=8)
    lefts, rights = _group(20, 2, 16, 24)
    imgs = list(lefts) + list(rights)
    plans = tst.converged_stride_batch([tst._sigma1_tree(im, cfg) for im in imgs], cfg.sigma_one)
    jplans = jax_converged([jst._sigma1_tree(im, JaxConfig(max_disp_levels=8)) for im in imgs],
                           cfg.sigma_one)
    packed = tst._st2_phase1_group(torch.from_numpy(lefts), torch.from_numpy(rights), plans,
                                   8, cfg.lr_max_diff)
    want = np.asarray(jst._st2_phase1_group_jit(jnp.asarray(lefts), jnp.asarray(rights),
                                                jplans.to_device(), 8, cfg.lr_max_diff))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (2, 16, 24)
    for got, exp in zip(tst._unpack_phase1(packed), jst._unpack_phase1(want)):
        assert float(np.mean(got == exp)) >= 0.99
    assert int((packed & 0x7F).max()) < 8


def test_phase1_packing_refuses_more_than_128_levels():
    lefts, rights = (torch.from_numpy(a) for a in _group(21, 1, 2, 130))
    with pytest.raises(ValueError, match="num_disp <= 128"):
        tst._st2_phase1_group(lefts, rights, None, 129, 1)
    with pytest.raises(ValueError, match="num_disp <= 128"):
        tst.st2_disparity(lefts[0], rights[0], SegmentTreeConfig(max_disp_levels=129),
                          device="cpu")


def test_unpack_phase1_splits_the_bits():
    packed = torch.tensor([[0, 5, 127, 128, 133, 255]], dtype=torch.uint8)
    disp, mask = tst._unpack_phase1(packed)
    assert isinstance(disp, np.ndarray) and disp.dtype == np.uint8
    np.testing.assert_array_equal(disp, [[0, 5, 127, 0, 5, 127]])
    np.testing.assert_array_equal(mask, [[False, False, False, True, True, True]])


def test_st1_device_group_refuses_other_plans():
    lefts, rights = (torch.from_numpy(a) for a in _group(22, 1, 4, 8))
    with pytest.raises(TypeError, match="StridePlan"):
        tst._st1_device_group(lefts, rights, object(), 4)


@pytest.mark.parametrize("h,w,d", [(9, 12, 5), (24, 40, 6), (24, 40, 16)])
def test_st2_matches_jax_on_random_pairs(h, w, d):
    """Random noise is full of near ties, and ST-2 compounds a flip: a
    phase-1 pixel that flips changes the mask and the color+depth weights,
    so the final tree. On the (24, 40, 6) pair the port equals the JAX
    function run op by op bit for bit, while the jitted JAX function differs
    from that on 2.8% of the pixels; hence the band of the reference's own
    ST-2 oracle test (0.97), not ST-1's 0.99."""
    left, right = _pair(h * w + d + 1, h, w)
    got = tst.st2_disparity(left, right, SegmentTreeConfig(max_disp_levels=d), device="cpu")
    want = jst.st2_disparity(left, right, JaxConfig(max_disp_levels=d))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (h, w)
    assert float(np.mean(got.numpy() == want)) >= 0.97


def test_st2_matches_jax_on_the_art_crop():
    left, right = _art_pair()
    got = tst.st2_disparity(left, right, SegmentTreeConfig(), device="cpu").numpy()
    want = jst.st2_disparity(left, right, JaxConfig())
    assert float(np.mean(got == want)) >= 0.995
    # The crop's true disparity is 5 (20 after the scale of 4).
    assert float(np.mean(np.abs(got[:, 60:].astype(int) - 20) <= 4)) >= 0.9


def test_st2_matches_composed_oracle():
    """As ``tests/test_segment_tree_pipeline.py::test_st2_matches_composed_oracle``:
    the sequential oracles of every stage, composed."""
    rng = np.random.default_rng(1234)
    left = rng.integers(0, 256, size=(9, 12, 3), dtype=np.uint8)
    right = rng.integers(0, 256, size=(9, 12, 3), dtype=np.uint8)
    cfg = SegmentTreeConfig(max_disp_levels=5, tau=90.0, min_size_seg=5)
    got = tst.st2_disparity(left, right, cfg, device="cpu").numpy()
    cost_l = oracles.color_grad_cost_volume_oracle(left, right, cfg.max_disp_levels)
    cost_r = oracles.right_cost_from_left_oracle(cost_l)
    disp_l = _oracle_aggregate_select(cost_l, color_edge_weights(left), cfg.sigma_one, cfg)
    disp_r = _oracle_aggregate_select(cost_r, color_edge_weights(right), cfg.sigma_one, cfg)
    mask = oracles.lr_mask_oracle(disp_l.astype(np.int32), disp_r.astype(np.int32),
                                  cfg.lr_max_diff)
    weights = color_depth_edge_weights(left, disp_l, mask, cfg.max_disp_levels,
                                       cfg.alpha_dep_seg)
    disp = _oracle_aggregate_select(cost_l, weights, cfg.sigma, cfg, weight_scale=255.0)
    want = np.minimum(disp.astype(np.int32) * cfg.disparity_scale, 255).astype(np.uint8)
    assert float(np.mean(got == want)) >= 0.97


def test_st2_equals_jax_op_by_op(fresh_registries):
    """Run op by op, the JAX ST-2 does the port's float operations in the
    port's order: the maps are equal bit for bit (about 30 s, since every
    op compiles apart)."""
    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)
    right = np.ascontiguousarray(np.roll(left, -2, axis=1))
    got = tst.st2_disparity(left, right, SegmentTreeConfig(max_disp_levels=6), device="cpu")
    with jax.disable_jit():
        want = jst.st2_disparity(left, right, JaxConfig(max_disp_levels=6))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("left,right,match", [
    (np.zeros((5, 8, 3), np.uint8), np.zeros((5, 9, 3), np.uint8), "st2: left/right shapes"),
    (np.zeros((5, 8), np.uint8), np.zeros((5, 8), np.uint8), r"st2: expected \(H, W, 3\)"),
    (np.zeros((5, 8, 3), np.float32), np.zeros((5, 8, 3), np.float32), "st2: expected uint8"),
    (np.zeros((5, 4, 3), np.uint8), np.zeros((5, 4, 3), np.uint8), "st2: .*exceeds width"),
])
def test_st2_refuses_bad_pairs(left, right, match):
    with pytest.raises((ValueError, TypeError), match=match):
        tst.st2_disparity(left, right, SegmentTreeConfig(max_disp_levels=6), device="cpu")


def test_st2_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right = _pair(5, 10, 14)
    for call in (tst.st2_disparity, tst.segment_tree_disparity):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(left, right, SegmentTreeConfig(max_disp_levels=6, iterate=True))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the median kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_st2_on_the_card_equals_the_cpu(card):
    """Every float op is the same on both devices and kernel D gives its
    twin's integers: the maps are equal bit for bit, with D launched three
    times (both views' phase 1 and phase 2)."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median

    left, right = _art_pair(crop=(120, 200))
    before = ctmf_median.LAUNCHES
    got = tst.st2_disparity(left, right, SegmentTreeConfig(), device=card)
    assert ctmf_median.LAUNCHES == before + 3
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), tst.st2_disparity(
        left, right, SegmentTreeConfig(), device="cpu").numpy())
