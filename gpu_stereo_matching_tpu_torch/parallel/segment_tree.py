"""Sharded segment-tree stereo over the ``space`` mesh axis, as
``gpu_stereo_matching_tpu/parallel/segment_tree.py``.

The segment tree is global (``STMatching/SegmentTree.cpp:148-181``
aggregates over one spanning tree of the whole image), so the sharded
scheme is **independent per-band trees**: the image splits into equal
horizontal bands, the host builds one tree per band, and each band's
cost → filter → WTA → median runs on its own device of the mesh. The maps
equal ``models.segment_tree_tiled``'s with as many tiles, bit for bit.

Each band's cost is computed from its crop. That equals the tiled path's
slice of the full-frame cost because the color+gradient cost
(``STMatching/StereoHelper.cpp:102-126``) has no vertical taps; the edge
weights, the trees and the median do have vertical extent, and each band
computes them from its own crop, as the tiled path does.

The JAX package runs every band as one ``shard_map`` program, replicated
over ``data`` and ``disp``. The port is single-controller, as
``parallel/stereo.py``: band t runs once, on ``mesh.devices[0, t, 0]``,
with its plan frame uploaded there, and the map is assembled on
``mesh.devices[0, 0, 0]``. The bands' work is enqueued one device after
another and fetched after the last, so distinct cards overlap; on a
:func:`parallel.mesh.virtual_mesh` every band runs on one device in turn.

ST-2 (``STMatching/StereoDisparity.cpp:91-159``) is two device stages with
one host stage between them: phase A filters both views through per-view
σ₁ band trees and forms the LR-stability mask; the host fetches the left
maps and masks once and builds each band's color+depth tree from them;
phase B filters the fresh cost through the rebuilt trees. Phase A returns
the map and the mask apart, as the JAX one does, so the sharded ST-2 has no
128-level limit (the per-frame ST-2 packs them into one byte).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.models.segment_tree import (
    _equal_bands,
    _filter_wta_median,
    _pair,
    _scale_u8,
    _st1_device,
    _to_nodes,
)
from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume, right_cost_from_left
from gpu_stereo_matching_tpu_torch.ops.postprocess import lr_consistency_mask
from gpu_stereo_matching_tpu_torch.parallel.mesh import DeviceMesh
from gpu_stereo_matching_tpu_torch.tree.builder import (
    build_segment_tree,
    color_depth_edge_weights,
    color_edge_weights,
)
from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan, converged_stride_batch


def _band_trees(img_bgr: np.ndarray, num_bands: int, config: SegmentTreeConfig,
                weights_per_band=None, weight_scale: float = 1.0):
    trees = []
    for t, band in enumerate(_equal_bands(img_bgr, num_bands)):
        weights = (
            color_edge_weights(band)
            if weights_per_band is None
            else weights_per_band[t]
        )
        hb, w = band.shape[:2]
        trees.append(
            build_segment_tree(
                weights, hb, w,
                tau=config.tau, min_size=config.min_size_seg,
                penalty=config.penalty_cross_seg, weight_scale=weight_scale,
            )
        )
    return trees


def build_band_plans(
    left_bgr: np.ndarray,
    num_bands: int,
    config: SegmentTreeConfig,
    sigma: Optional[float] = None,
) -> StridePlan:
    """Host stage: one segment tree per equal-height band → stacked plan
    (on the host).

    Weights come from each band's crop (the 3×3 presmooth and all), as in
    ``st1_disparity_tiled``. The plan has a leading ``num_bands`` axis on
    its per-frame arrays and one registry-converged layout.
    """
    trees = _band_trees(np.asarray(left_bgr), num_bands, config)
    return converged_stride_batch(trees, config.sigma if sigma is None else sigma)


def _band_devices(mesh: DeviceMesh) -> List[torch.device]:
    """The device of each band: ``(data 0, band t, disp 0)``."""
    return list(mesh.devices[0, :, 0])


def _band_pairs(left: torch.Tensor, right: torch.Tensor, devs):
    """Each band's (left crop, right crop, device), the crops on the device."""
    n = len(devs)
    return [(lb.to(dev), rb.to(dev), dev)
            for lb, rb, dev in zip(_equal_bands(left, n), _equal_bands(right, n), devs)]


def _st1_bands(left, right, plan: StridePlan, devs, num_disp: int) -> torch.Tensor:
    """Each band's cost → filter → WTA → median on its device; the map
    assembled on the first band's device."""
    bands = [
        _st1_device(lb, rb, plan.frame(t).to(dev), num_disp)
        for t, (lb, rb, dev) in enumerate(_band_pairs(left, right, devs))
    ]
    return torch.cat([b.to(devs[0]) for b in bands])


def st1_disparity_sharded(
    left_bgr,
    right_bgr,
    mesh: DeviceMesh,
    config: SegmentTreeConfig = SegmentTreeConfig(),
    plan: Optional[StridePlan] = None,
) -> torch.Tensor:
    """ST-1 with per-band trees across the ``space`` axis → (H, W) uint8 on
    ``mesh.devices[0, 0, 0]``.

    One host stage (the per-band trees; a caller's stacked ``plan``, as
    :func:`build_band_plans` gives it, skips it) and one device stage per
    band. Equal to ``st1_disparity_tiled(…, num_tiles=space)`` bit for bit.
    """
    left, right = _pair(left_bgr, right_bgr, config.max_disp_levels, "st1_sharded")
    devs = _band_devices(mesh)
    if plan is None:
        plan = build_band_plans(left.numpy(), len(devs), config)
    disp = _st1_bands(left, right, plan, devs, config.max_disp_levels)
    return _scale_u8(disp, config.disparity_scale)


def _st2_phase_a(left, right, plan_l: StridePlan, plan_r: StridePlan, devs, num_disp: int,
                 lr_max_diff: int) -> np.ndarray:
    """Phase A on each band's device: both views' σ₁ filters, WTA, median
    and the LR mask. Returns, fetched once, a (2, bands, hb, W) uint8 array:
    the left maps, then the masks."""
    out = []
    for t, (lb, rb, dev) in enumerate(_band_pairs(left, right, devs)):
        cost_l = color_gradient_cost_volume(lb, rb, num_disp)
        cost_r = right_cost_from_left(cost_l)
        hw = cost_l.shape[1:]
        disp_l = _filter_wta_median(_to_nodes(cost_l), plan_l.frame(t).to(dev), hw)
        disp_r = _filter_wta_median(_to_nodes(cost_r), plan_r.frame(t).to(dev), hw)
        mask = lr_consistency_mask(disp_l.to(torch.int32), disp_r.to(torch.int32), lr_max_diff)
        out.append(torch.stack([disp_l, mask.to(torch.uint8)]))
    return torch.stack([o.to(devs[0]) for o in out], dim=1).cpu().numpy()


def st2_disparity_sharded(
    left_bgr,
    right_bgr,
    mesh: DeviceMesh,
    config: SegmentTreeConfig = SegmentTreeConfig(),
) -> torch.Tensor:
    """ST-2 with the whole iteration per band across the ``space`` axis →
    (H, W) uint8 on ``mesh.devices[0, 0, 0]``.

    Host: per-view σ₁ band trees; phase A on each band's device; host:
    color+depth weights → per-band trees at the user σ; phase B: the ST-1
    device stage over them. Equal to ``st2_disparity_tiled(…,
    num_tiles=space)`` bit for bit, and unlike it not limited to 128 levels.
    """
    left, right = _pair(left_bgr, right_bgr, config.max_disp_levels, "st2_sharded")
    devs = _band_devices(mesh)
    n_space = len(devs)
    left_np, right_np = left.numpy(), right.numpy()

    plan_l = converged_stride_batch(_band_trees(left_np, n_space, config), config.sigma_one)
    plan_r = converged_stride_batch(_band_trees(right_np, n_space, config), config.sigma_one)
    disp_l_b, mask_b = _st2_phase_a(left, right, plan_l, plan_r, devs, config.max_disp_levels,
                                    config.lr_max_diff)

    weights = [
        color_depth_edge_weights(
            band, disp_l_b[t], mask_b[t].astype(bool), config.max_disp_levels,
            config.alpha_dep_seg,
        )
        for t, band in enumerate(_equal_bands(left_np, n_space))
    ]
    plan_f = converged_stride_batch(
        _band_trees(left_np, n_space, config, weights_per_band=weights, weight_scale=255.0),
        config.sigma,
    )
    disp = _st1_bands(left, right, plan_f, devs, config.max_disp_levels)
    return _scale_u8(disp, config.disparity_scale)
