"""Segment-tree stereo with per-band trees, as ``gpu_stereo_matching_tpu/
models/segment_tree_tiled.py``.

The segment tree is global: it does not tile the way window ops do
(SURVEY §7 hard part 3). The tiled scheme is **independent per-band
trees**: the image splits into horizontal bands, and each band builds and
filters its own spanning tree (the host builds per band, the band's device
filters it; no halo, nothing crosses a band). It is an approximation,
since aggregation stops at band borders, so it ships with
:func:`tiling_accuracy_report`, the bad-2.0 of per-band trees against the
global tree on a scene with ground truth.

Bands split H as ``np.linspace(0, h, n + 1).astype(int)`` does, so they may
be unequal; the banded pipeline (``models/segment_tree_stream.py``) and the
sharded entries (``parallel/segment_tree.py``) take equal bands only. Each
entry runs on the card unless the caller passes ``device="cpu"`` and
returns an (H, W) uint8 tensor on that device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.models.segment_tree import (
    _aggregate_select,
    _pair,
    _scale_u8,
    st2_disparity,
)
from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume


def _bounds(h: int, num_tiles: int):
    """Band edges as the JAX function computes them (numpy, not torch, whose
    float32 ``linspace`` may round an edge the other way)."""
    bounds = np.linspace(0, h, num_tiles + 1).astype(int)
    return [(int(bounds[t]), int(bounds[t + 1])) for t in range(num_tiles)]


def st1_disparity_tiled(
    left_bgr,
    right_bgr,
    num_tiles: int,
    config: SegmentTreeConfig = SegmentTreeConfig(),
    device="cuda",
) -> torch.Tensor:
    """ST-1 with independent per-band segment trees → (H, W) uint8 on
    ``device``.

    One full-frame cost volume on ``device``; each band passes its slice of
    it, with its own crop's tree, through build → filter → WTA → median
    (the per-band work a ``space`` shard runs in the sharded entry).
    """
    dev = resolve_device(device)
    left, right = _pair(left_bgr, right_bgr, config.max_disp_levels, "st1_tiled")
    cost = color_gradient_cost_volume(left.to(dev), right.to(dev), config.max_disp_levels)
    left_np = left.numpy()
    parts = [
        _aggregate_select(cost[:, y0:y1, :], left_np[y0:y1], config.sigma, config)
        for y0, y1 in _bounds(left.shape[0], num_tiles)
    ]
    return _scale_u8(torch.cat(parts), config.disparity_scale)


def st2_disparity_tiled(
    left_bgr,
    right_bgr,
    num_tiles: int,
    config: SegmentTreeConfig = SegmentTreeConfig(),
    device="cuda",
) -> torch.Tensor:
    """ST-2 with independent per-band pipelines → (H, W) uint8 on ``device``.

    Each band runs the whole iteration pipeline (:func:`st2_disparity`) on
    its crop: the per-view σ₁ trees, the LR consistency and the color+depth
    re-segmentation (``STMatching/StereoDisparity.cpp:91-159``) are all
    band-local. The LR check looks along rows only and the cost volume has
    no vertical taps, so what tiling loses is the trees' support and the
    median and presmooth windows across band borders, as ST-1 tiling does.
    """
    dev = resolve_device(device)
    left, right = _pair(left_bgr, right_bgr, config.max_disp_levels, "st2_tiled")
    return torch.cat([
        st2_disparity(left[y0:y1], right[y0:y1], config, device=dev)
        for y0, y1 in _bounds(left.shape[0], num_tiles)
    ])


def tiling_accuracy_report(
    scene,
    tile_counts=(1, 2, 4, 8),
    config: Optional[SegmentTreeConfig] = None,
    delta: float = 2.0,
    device="cuda",
):
    """bad-δ (all valid pixels and non-occluded) of per-band trees against
    the global tree (``tile_counts`` holding 1), one row per tile count."""
    from gpu_stereo_matching_tpu_torch.io.middlebury import GT_SCALE, bad_pixel_rate, nonocc_mask

    config = config or SegmentTreeConfig(max_disp_levels=80, disparity_scale=1)
    mask = (
        nonocc_mask(scene.gt_left, scene.gt_right)
        if scene.gt_right is not None
        else None
    )
    rows = []
    for s in tile_counts:
        disp = st1_disparity_tiled(scene.left_bgr, scene.right_bgr, s, config,
                                   device=device).cpu().numpy()
        bad = bad_pixel_rate(disp, scene.gt_left, delta=delta, gt_scale=GT_SCALE)
        bad_no = (
            bad_pixel_rate(disp, scene.gt_left, delta=delta, gt_scale=GT_SCALE, mask=mask)
            if mask is not None
            else None
        )
        rows.append({"tiles": s, "bad2": bad, "bad2_nonocc": bad_no})
        non = "n/a" if bad_no is None else f"{100 * bad_no:.2f}%"
        print(f"tiles={s}: bad2={100 * bad:.2f}% nonocc={non}")
    return rows
