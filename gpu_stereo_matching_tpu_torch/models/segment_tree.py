"""Non-local segment-tree stereo, ST-1, as ``gpu_stereo_matching_tpu/models/
segment_tree.py``.

Mirrors the reference function ``stereo_disparity_normal``
(``STMatching/StereoDisparity.cpp:57-90``): color+gradient cost volume →
segment tree (color weights, σ, τ=1200) → non-local filter → WTA → 7×7
median → ×scale.

The tree is built on the host (C++, ``tree/builder.py``) and emitted as a
stride-bucket plan (``tree/stride.py``); the plan is uploaded and every
dense stage (cost, filter, WTA, median) runs on the device: the filter and
the rest as plain torch, the median as kernel D (``kernels/ctmf_median.py``)
on a CUDA tensor. The entry points run on the card unless the caller passes
``device="cpu"``.

ST-2 (the left-right iteration and re-segmentation) is not ported yet:
``segment_tree_disparity`` raises for ``config.iterate``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.core.validation import check_bgr_pair
from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume
from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity
from gpu_stereo_matching_tpu_torch.tree.builder import build_segment_tree, color_edge_weights
from gpu_stereo_matching_tpu_torch.tree.filter import tree_filter_nodes
from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan, tree_filter_nodes_sb


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


def segment_tree_disparity(
    left_bgr,
    right_bgr,
    config: SegmentTreeConfig = SegmentTreeConfig(),
    device="cuda",
) -> torch.Tensor:
    """ST-1 for ``config.iterate=False`` (the CLI's ``--method st1``).

    ST-2 (``config.iterate=True``) is not ported yet and raises.
    """
    if config.iterate:
        raise NotImplementedError(
            "ST-2 (config.iterate=True) is not ported yet; a later slice of "
            "the port adds it. Use ST-1 (iterate=False)."
        )
    return st1_disparity(left_bgr, right_bgr, config, device)


def _scale_u8(disp: torch.Tensor, scale: int) -> torch.Tensor:
    return torch.clamp(disp.to(torch.int32) * scale, max=255).to(torch.uint8)
