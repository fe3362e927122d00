"""ST-1 in the port (``models/segment_tree.py``) against the JAX package's
``st1_disparity`` on the CPU: random pairs and a crop of
``examples/art_left.png`` against a shifted copy. The filters sum floats in
their own orders, so near-tied WTA decisions may flip: the maps are held to
a share of equal pixels. Then the checks, the dispatch on ``iterate``
(ST-2 itself is ``tests/test_torch_st2.py``), and on a card the card
against the CPU."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig as JaxConfig
from gpu_stereo_matching_tpu.models import segment_tree as jst
from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr
from gpu_stereo_matching_tpu_torch.models import segment_tree as tst
from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume
from gpu_stereo_matching_tpu_torch.tree.builder import build_segment_tree, color_edge_weights
from gpu_stereo_matching_tpu_torch.tree.filter import TreeFilterPlan
from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan

ART = Path(__file__).resolve().parents[1] / "examples" / "art_left.png"


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _art_pair(shift=5, crop=(96, 128)):
    """A crop of the art view as the left image; the right view is the left
    shifted by ``shift`` columns, its last column repeated."""
    img = load_image_bgr(str(ART))[100 : 100 + crop[0], 150 : 150 + crop[1]]
    cols = np.minimum(np.arange(crop[1]) + shift, crop[1] - 1)
    return np.ascontiguousarray(img), np.ascontiguousarray(img[:, cols])


@pytest.fixture(scope="module")
def jax_maps():
    """The JAX package's ST-1 maps, computed once per case."""
    cache = {}

    def get(key, left, right, **cfg):
        if key not in cache:
            cache[key] = jst.st1_disparity(left, right, JaxConfig(**cfg))
        return cache[key]

    return get


@pytest.mark.parametrize("h,w,d", [(10, 14, 6), (24, 40, 6), (24, 40, 16)])
def test_st1_matches_jax_on_random_pairs(jax_maps, h, w, d):
    left, right = _pair(h * w + d, h, w)
    got = tst.st1_disparity(left, right, SegmentTreeConfig(max_disp_levels=d), device="cpu")
    want = jax_maps((h, w, d), left, right, max_disp_levels=d)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (h, w)
    assert float(np.mean(got.numpy() == want)) >= 0.99


def test_st1_matches_jax_on_the_art_crop(jax_maps):
    left, right = _art_pair()
    got = tst.st1_disparity(left, right, SegmentTreeConfig(), device="cpu").numpy()
    want = jax_maps("art", left, right)
    assert float(np.mean(got == want)) >= 0.995
    # The crop's true disparity is 5 (20 after the scale of 4) away from
    # the left columns that have no match.
    assert float(np.mean(np.abs(got[:, 60:].astype(int) - 20) <= 4)) >= 0.9


def test_st1_takes_tensors_and_scales(jax_maps):
    left, right = _pair(3, 10, 14)
    cfg = SegmentTreeConfig(max_disp_levels=6, disparity_scale=40)
    got = tst.st1_disparity(torch.from_numpy(left), torch.from_numpy(right), cfg, device="cpu")
    unscaled = tst.st1_disparity(left, right, SegmentTreeConfig(max_disp_levels=6,
                                                                disparity_scale=1), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.minimum(unscaled.numpy().astype(int) * 40, 255))
    want = jst.st1_disparity(left, right, JaxConfig(max_disp_levels=6, disparity_scale=40))
    assert float(np.mean(got.numpy() == want)) >= 0.99


def test_segment_tree_disparity_dispatch():
    """``iterate`` picks ST-1 or ST-2, as the JAX function's dispatch does."""
    left, right = _pair(4, 10, 14)
    cfg = SegmentTreeConfig(max_disp_levels=6)
    np.testing.assert_array_equal(
        tst.segment_tree_disparity(left, right, cfg, device="cpu").numpy(),
        tst.st1_disparity(left, right, cfg, device="cpu").numpy())
    st2_cfg = SegmentTreeConfig(max_disp_levels=6, iterate=True)
    got = tst.segment_tree_disparity(left, right, st2_cfg, device="cpu").numpy()
    np.testing.assert_array_equal(got, tst.st2_disparity(left, right, st2_cfg,
                                                         device="cpu").numpy())
    want = jst.segment_tree_disparity(left, right, JaxConfig(max_disp_levels=6, iterate=True))
    assert float(np.mean(got == want)) >= 0.97


@pytest.mark.parametrize("left,right,match", [
    (np.zeros((5, 8, 3), np.uint8), np.zeros((5, 9, 3), np.uint8), "shapes differ"),
    (np.zeros((5, 8), np.uint8), np.zeros((5, 8), np.uint8), r"\(H, W, 3\)"),
    (np.zeros((5, 8, 3), np.float32), np.zeros((5, 8, 3), np.float32), "uint8"),
    (np.zeros((5, 4, 3), np.uint8), np.zeros((5, 4, 3), np.uint8), "exceeds width"),
])
def test_st1_refuses_bad_pairs(left, right, match):
    with pytest.raises((ValueError, TypeError), match=match):
        tst.st1_disparity(left, right, SegmentTreeConfig(max_disp_levels=6), device="cpu")


def test_st1_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right = _pair(5, 10, 14)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tst.st1_disparity(left, right, SegmentTreeConfig(max_disp_levels=6))


def test_aggregate_select_and_both_plans():
    """``_aggregate_select`` (host tree, device filter) against the JAX one,
    and the stride plan against the level-scan plan through
    ``_filter_wta_median``."""
    left, right = _pair(6, 24, 40)
    cfg = SegmentTreeConfig(max_disp_levels=16)
    cost = color_gradient_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 16)
    got = tst._aggregate_select(cost, left, cfg.sigma, cfg).numpy()
    want = jst._aggregate_select(jnp.asarray(cost.numpy()), left, cfg.sigma, JaxConfig(
        max_disp_levels=16))
    assert float(np.mean(got == want)) >= 0.99
    tree = build_segment_tree(color_edge_weights(left), 24, 40)
    nodes = tst._to_nodes(cost)
    by_stride = tst._filter_wta_median(nodes, StridePlan.from_tree(tree, cfg.sigma), (24, 40))
    by_level = tst._filter_wta_median(nodes, TreeFilterPlan.from_tree(tree, cfg.sigma), (24, 40))
    np.testing.assert_array_equal(by_stride.numpy(), got)
    assert float(np.mean(by_level.numpy() == got)) >= 0.99


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the median kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_st1_on_the_card_equals_the_cpu(card):
    """The filter's float ops are the same on both devices, and the median
    kernel gives the twin's integers: the maps are equal bit for bit."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median

    left, right = _art_pair(crop=(120, 200))
    before = ctmf_median.LAUNCHES
    got = tst.st1_disparity(left, right, SegmentTreeConfig(), device=card)
    assert ctmf_median.LAUNCHES == before + 1
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), tst.st1_disparity(
        left, right, SegmentTreeConfig(), device="cpu").numpy())
