"""Non-local segment-tree stereo, ST-1 and ST-2, as ``gpu_stereo_matching_tpu/
models/segment_tree.py``.

Mirrors the reference drivers ``stereo_disparity_normal`` and
``stereo_disparity_iteration`` (``STMatching/StereoDisparity.cpp:57-162``):

ST-1: color+gradient cost volume → segment tree (color weights, σ, τ=1200)
→ non-local filter → WTA → 7×7 median → ×scale.

ST-2: left volume + right volume derived from it → per-view trees with
σ₁=0.08 → filter/WTA/median per view → left-right consistency mask on the
*median-filtered* maps → fresh cost volume → tree rebuilt with joint
color+depth weights (stable pixels only) at the user σ → filter → WTA →
median → ×scale.

The trees are built on the host (C++, ``tree/builder.py``) and emitted as
stride-bucket plans (``tree/stride.py``); the plans are uploaded and every
dense stage (cost, filter, WTA, median) runs on the device: the filter and
the rest as plain torch, the median as kernel D (``kernels/ctmf_median.py``)
on a CUDA tensor. The entry points run on the card unless the caller passes
``device="cpu"``. ST-2's one sync point is the fetch of phase 1's packed
map, which the host needs for the color+depth weights.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.core.validation import check_bgr_pair
from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.ops.cost import (
    color_gradient_cost_volume,
    right_cost_from_left,
)
from gpu_stereo_matching_tpu_torch.ops.postprocess import lr_consistency_mask, median_filter_u8
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity
from gpu_stereo_matching_tpu_torch.tree.builder import (
    build_segment_tree,
    color_depth_edge_weights,
    color_edge_weights,
)
from gpu_stereo_matching_tpu_torch.tree.filter import tree_filter_nodes
from gpu_stereo_matching_tpu_torch.tree.stride import (
    StridePlan,
    converged_stride_batch,
    tree_filter_nodes_sb,
)


def _to_nodes(cost: torch.Tensor) -> torch.Tensor:
    d, h, w = cost.shape
    return cost.movedim(0, -1).reshape(h * w, d)


def _filter_wta_median(cost_nodes, plan, shape_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, D) costs → median-filtered uint8 disparity (H, W), on the plan's
    device. ``plan`` is a :class:`StridePlan` or a ``TreeFilterPlan``."""
    h, w = shape_hw
    if isinstance(plan, StridePlan):
        filtered = tree_filter_nodes_sb(cost_nodes, plan)
    else:
        filtered = tree_filter_nodes(cost_nodes, plan)
    disp = wta_disparity(filtered, dim=1).reshape(h, w)
    return median_filter_u8(disp.to(torch.uint8), 3)


def _st1_device(left_bgr, right_bgr, plan, num_disp: int) -> torch.Tensor:
    """Cost volume → tree filter → WTA → median, on the inputs' device."""
    cost = color_gradient_cost_volume(left_bgr, right_bgr, num_disp)
    d, h, w = cost.shape
    return _filter_wta_median(_to_nodes(cost), plan, (h, w))


def _equal_bands(x, num_bands: int, dim: int = 0) -> List:
    """``x`` (a numpy array or a tensor) cut along ``dim`` into ``num_bands``
    equal bands, top to bottom. Raises unless they divide it: the contract
    of the banded pipeline and the sharded entries (the tiled ones take
    unequal bands)."""
    h = x.shape[dim]
    if h % num_bands:
        raise ValueError(f"H={h} must divide into {num_bands} equal bands")
    hb = h // num_bands
    lead = (slice(None),) * dim
    return [x[(*lead, slice(t * hb, (t + 1) * hb))] for t in range(num_bands)]


def _st1_device_group(left_b, right_b, plans, num_disp: int) -> torch.Tensor:
    """A frame group: (B, H, W, 3) pairs and a B-stacked :class:`StridePlan`
    → (B, H, W) uint8 median-filtered disparities, one frame after another
    on the inputs' device: the one-band case of
    :func:`_st1_device_group_banded`."""
    return _st1_device_group_banded(left_b, right_b, plans, num_disp, 1)


def _st1_device_group_banded(left_b, right_b, plans, num_disp: int, num_bands: int) -> torch.Tensor:
    """A frame group with per-band trees: (B, H, W, 3) pairs and a
    (B·num_bands)-stacked :class:`StridePlan`, frame g's band t at index
    g·num_bands + t → (B, H, W) uint8, on the inputs' device.

    Per frame: one full-frame cost volume, cut into ``num_bands`` equal
    bands (the cost has no vertical taps, so a band's slice is the cost of
    its crop, bit for bit); each band runs filter → WTA → 7×7 median on its
    own tree, and the bands are concatenated. Equal to
    ``models.segment_tree_tiled.st1_disparity_tiled`` with equal bands.
    """
    if not isinstance(plans, StridePlan):
        raise TypeError(f"expected a stacked StridePlan, got {type(plans).__name__}")
    outs = []
    for g in range(left_b.shape[0]):
        cost = color_gradient_cost_volume(left_b[g], right_b[g], num_disp)
        outs.append(torch.cat([
            _filter_wta_median(_to_nodes(band), plans.frame(g * num_bands + t), band.shape[1:])
            for t, band in enumerate(_equal_bands(cost, num_bands, dim=1))
        ]))
    return torch.stack(outs)


def _st2_phase1_group(left_b, right_b, plans_lr, num_disp: int, lr_max_diff: int) -> torch.Tensor:
    """ST-2 phase 1 for a frame group, on the inputs' device.

    Per frame: cost_left → derived cost_right (``StereoHelper.cpp:156-180``),
    both views filtered through their σ₁ trees, WTA, 7×7 median, then the
    left-right stability mask on the median-filtered maps
    (``StereoDisparity.cpp:107-147``). ``plans_lr`` is a 2B-stacked
    :class:`StridePlan`: frame g's left tree at index g, its right tree at
    B + g. Returns one (B, H, W) uint8 tensor packing both host inputs of
    the color+depth re-segmentation: bits 0-6 the left map (below 128
    levels), bit 7 the mask (unpack with :func:`_unpack_phase1`).
    """
    if num_disp > 128:
        raise ValueError("phase-1 packing needs num_disp <= 128 (7 bits)")
    b = left_b.shape[0]
    packed = []
    for g in range(b):
        cost_l = color_gradient_cost_volume(left_b[g], right_b[g], num_disp)
        cost_r = right_cost_from_left(cost_l)
        h, w = cost_l.shape[1:]
        disp_l = _filter_wta_median(_to_nodes(cost_l), plans_lr.frame(g), (h, w))
        disp_r = _filter_wta_median(_to_nodes(cost_r), plans_lr.frame(b + g), (h, w))
        mask = lr_consistency_mask(disp_l.to(torch.int32), disp_r.to(torch.int32), lr_max_diff)
        packed.append(disp_l | (mask.to(torch.uint8) << 7))
    return torch.stack(packed)


def _unpack_phase1(packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: a (…, H, W) uint8 tensor on any device → (left disparity
    uint8 from bits 0-6, mask bool from bit 7) as numpy arrays. On a card
    this fetch waits for phase 1."""
    p = packed.cpu().numpy()
    return p & 0x7F, (p & 0x80) != 0


def _sigma1_tree(img_bgr: np.ndarray, config: SegmentTreeConfig):
    h, w = img_bgr.shape[:2]
    return build_segment_tree(
        color_edge_weights(img_bgr), h, w,
        tau=config.tau, min_size=config.min_size_seg,
        penalty=config.penalty_cross_seg, weight_scale=1.0,
    )


def _final_tree(
    left_bgr: np.ndarray, disp_l: np.ndarray, mask: np.ndarray,
    config: SegmentTreeConfig,
):
    h, w = left_bgr.shape[:2]
    weights = color_depth_edge_weights(
        left_bgr, disp_l, mask, config.max_disp_levels, config.alpha_dep_seg
    )
    return build_segment_tree(
        weights, h, w,
        tau=config.tau, min_size=config.min_size_seg,
        penalty=config.penalty_cross_seg, weight_scale=255.0,
    )


def _aggregate_select(
    cost: torch.Tensor, img_bgr: np.ndarray, sigma: float, cfg: SegmentTreeConfig,
    weights: Optional[np.ndarray] = None,
    weight_scale: float = 1.0,
) -> torch.Tensor:
    """Tree build (host) + filter/WTA/median (the cost's device) → uint8
    (H, W) on that device."""
    d, h, w = cost.shape
    if weights is None:
        weights = color_edge_weights(img_bgr)
        weight_scale = 1.0
    tree = build_segment_tree(
        weights, h, w,
        tau=cfg.tau, min_size=cfg.min_size_seg, penalty=cfg.penalty_cross_seg,
        weight_scale=weight_scale,
    )
    plan = StridePlan.from_tree(tree, sigma, device=cost.device)
    return _filter_wta_median(_to_nodes(cost), plan, (h, w))


def _pair(left_bgr, right_bgr, num_disp: int, what: str):
    """Check a BGR pair (numpy arrays or tensors) → both as CPU tensors."""
    left, right = (
        torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x.cpu()
        for x in (left_bgr, right_bgr)
    )
    check_bgr_pair(left, right, num_disp, what)
    return left, right


def st1_disparity(
    left_bgr,
    right_bgr,
    config: SegmentTreeConfig = SegmentTreeConfig(),
    device="cuda",
) -> torch.Tensor:
    """ST-1 scaled disparity of a BGR uint8 pair → (H, W) uint8 on ``device``.

    ``left_bgr``/``right_bgr`` are (H, W, 3) numpy arrays or tensors. The
    host builds the tree from the left view and emits its plan; the pair and
    the plan are uploaded and the rest runs on ``device`` (the card unless
    the caller asks for ``"cpu"``; it raises where there is no card).
    """
    dev = resolve_device(device)
    left, right = _pair(left_bgr, right_bgr, config.max_disp_levels, "st1")
    h, w = left.shape[:2]
    weights = color_edge_weights(left.numpy())
    tree = build_segment_tree(
        weights, h, w,
        tau=config.tau, min_size=config.min_size_seg,
        penalty=config.penalty_cross_seg, weight_scale=1.0,
    )
    plan = StridePlan.from_tree(tree, config.sigma, device=dev)
    disp = _st1_device(left.to(dev), right.to(dev), plan, config.max_disp_levels)
    return _scale_u8(disp, config.disparity_scale)


def st2_disparity(
    left_bgr,
    right_bgr,
    config: SegmentTreeConfig = SegmentTreeConfig(),
    device="cuda",
) -> torch.Tensor:
    """ST-2 (iteration + LR consistency + re-segmentation) → (H, W) uint8 on
    ``device``.

    The host builds both views' σ₁ trees and one stacked plan; phase 1 (both
    view filters, WTA, median, the LR mask) runs on ``device``; its packed
    map is fetched, the host rebuilds the left tree from color and depth
    (``StereoDisparity.cpp:91-159``), and phase 2 is the ST-1 program over
    that tree. This is the B=1 case of the group path that
    :class:`models.segment_tree_stream.SegmentTreeST2BatchPipeline` batches.
    """
    dev = resolve_device(device)
    left, right = _pair(left_bgr, right_bgr, config.max_disp_levels, "st2")
    left_np, right_np = left.numpy(), right.numpy()
    plans1 = converged_stride_batch(
        [_sigma1_tree(left_np, config), _sigma1_tree(right_np, config)], config.sigma_one,
    ).to(dev)
    lb, rb = left.to(dev)[None], right.to(dev)[None]
    packed = _st2_phase1_group(lb, rb, plans1, config.max_disp_levels, config.lr_max_diff)
    disp_l, mask = _unpack_phase1(packed)
    plan2 = converged_stride_batch(
        [_final_tree(left_np, disp_l[0], mask[0], config)], config.sigma
    ).to(dev)
    disp = _st1_device_group(lb, rb, plan2, config.max_disp_levels)[0]
    return _scale_u8(disp, config.disparity_scale)


def segment_tree_disparity(
    left_bgr,
    right_bgr,
    config: SegmentTreeConfig = SegmentTreeConfig(),
    device="cuda",
) -> torch.Tensor:
    """Dispatch ST-1 / ST-2 on ``config.iterate`` (the CLI ``method`` arg)."""
    fn = st2_disparity if config.iterate else st1_disparity
    return fn(left_bgr, right_bgr, config, device)


def _scale_u8(disp: torch.Tensor, scale: int) -> torch.Tensor:
    return torch.clamp(disp.to(torch.int32) * scale, max=255).to(torch.uint8)
