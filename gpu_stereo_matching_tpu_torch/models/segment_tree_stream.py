"""Streaming segment-tree pipelines, as ``gpu_stereo_matching_tpu/models/
segment_tree_stream.py``.

Per-frame ST has a host stage (C++ weights → FH spanning tree → stride
plan) and a device stage (cost → tree filter → WTA → median). Run one
after the other they serialize; these pipelines overlap them, the
software-pipelining analog of the reference's absent streaming mode
(SURVEY §2.5 "PP analog"):

    host (a thread):   build weights + trees + plans of frame/group n+1
    main thread:       enqueue the device work of frame/group n

In PyTorch the enqueue itself is host work: the stride filter makes
thousands of launches from the Python thread. So the next host stage is
*submitted* to a stage thread before the current device work is enqueued,
and collected after; the C++ tree build and plan emit release the GIL
(ctypes), so they run while the main thread enqueues. This changes when the
host work runs, not what it computes: every pipeline yields the maps that
its per-frame call gives, bit for bit.

Each pipeline runs on the card unless the caller passes ``device="cpu"``
and yields (H, W) uint8 tensors on that device, in input order.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.models.segment_tree import (
    _final_tree,
    _pair,
    _scale_u8,
    _sigma1_tree,
    _st1_device,
    _st1_device_group,
    _st2_phase1_group,
    _unpack_phase1,
)
from gpu_stereo_matching_tpu_torch.tree.builder import build_segment_tree, color_edge_weights
from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan, converge_stride_plans

Frame = Tuple[np.ndarray, np.ndarray]


def _st1_plan(left_bgr: np.ndarray, cfg: SegmentTreeConfig) -> StridePlan:
    """ST-1's host stage for one left view: weights, tree, plan (on the host)."""
    h, w = left_bgr.shape[:2]
    tree = build_segment_tree(
        color_edge_weights(left_bgr), h, w,
        tau=cfg.tau, min_size=cfg.min_size_seg,
        penalty=cfg.penalty_cross_seg, weight_scale=1.0,
    )
    return StridePlan.from_tree(tree, cfg.sigma)


def _checked(frame, cfg: SegmentTreeConfig, what: str) -> Frame:
    """One input pair checked as the per-frame call checks it → numpy arrays."""
    left, right = _pair(frame[0], frame[1], cfg.max_disp_levels, what)
    return left.numpy(), right.numpy()


def _groups(frames: Iterable, size: int, cfg: SegmentTreeConfig, what: str) -> Iterator[list]:
    buf = []
    for f in frames:
        buf.append(_checked(f, cfg, what))
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


def _padded(group: List[Frame], size: int):
    """Stack a (possibly short) group, padded by repeating its last frame:
    (lefts, rights) as (size, H, W, 3) tensors on the host."""
    padded = list(group) + [group[-1]] * (size - len(group))
    return (torch.from_numpy(np.stack([f[0] for f in padded])),
            torch.from_numpy(np.stack([f[1] for f in padded])))


class SegmentTreeVideoPipeline:
    """Streaming ST-1 over an iterator of (left_bgr, right_bgr) frames:
    frame n+1's host stage on a stage thread while frame n is enqueued."""

    def __init__(self, config: SegmentTreeConfig = SegmentTreeConfig(), device="cuda") -> None:
        self.config = config
        self.device = resolve_device(device)

    def process(self, frames: Iterable[Frame]) -> Iterator[torch.Tensor]:
        """Yield scaled uint8 disparity maps, one per input frame pair."""
        cfg, dev = self.config, self.device
        it = (_checked(f, cfg, "st1") for f in frames)
        with ThreadPoolExecutor(1) as stage:
            cur = next(it, None)
            if cur is None:
                return
            cur_plan = stage.submit(_st1_plan, cur[0], cfg)
            while cur is not None:
                plan = cur_plan.result()
                nxt = next(it, None)
                if nxt is not None:
                    cur_plan = stage.submit(_st1_plan, nxt[0], cfg)
                disp = _st1_device(torch.from_numpy(cur[0]).to(dev),
                                   torch.from_numpy(cur[1]).to(dev), plan.to(dev),
                                   cfg.max_disp_levels)
                yield _scale_u8(disp, cfg.disparity_scale)
                cur = nxt


class SegmentTreeBatchPipeline:
    """Batched streaming ST-1: G frames per device group.

    The host stage of a group (G tree builds and plan emits on a pool of
    ``workers`` threads, converged to one layout and stacked) runs on a
    stage thread while the previous group's device work is enqueued. A short
    last group is padded by repeating its last frame and trimmed on output.
    """

    def __init__(
        self,
        config: SegmentTreeConfig = SegmentTreeConfig(),
        group_size: int = 8,
        workers: int = 2,
        bands: int = 1,
        device="cuda",
    ) -> None:
        if group_size < 1:
            raise ValueError("group_size must be >= 1")
        if bands < 1:
            raise ValueError("bands must be >= 1")
        if bands > 1:
            raise NotImplementedError(
                "bands > 1 (per-band trees) comes with the tiled segment-tree slice of the "
                "port (models/segment_tree_tiled.py and _st1_device_group_banded); use bands=1"
            )
        self.config = config
        self.group_size = group_size
        self.workers = workers
        self.device = resolve_device(device)

    def _host_build_group(self, group: List[Frame], pool):
        lefts, rights = _padded(group, self.group_size)
        plans = converge_stride_plans(
            [lambda im=im: _st1_plan(im, self.config) for im in lefts.numpy()], pool)
        return lefts, rights, plans, len(group)

    def process(self, frames: Iterable[Frame]) -> Iterator[torch.Tensor]:
        """Yield scaled uint8 disparity maps, one per input frame pair."""
        cfg, dev = self.config, self.device
        groups = _groups(frames, self.group_size, cfg, "st1")
        with ThreadPoolExecutor(1) as stage, ThreadPoolExecutor(self.workers) as pool:
            cur = next(groups, None)
            if cur is None:
                return
            cur_host = stage.submit(self._host_build_group, cur, pool)
            while cur_host is not None:
                lefts, rights, plans, n_real = cur_host.result()
                nxt = next(groups, None)
                cur_host = (stage.submit(self._host_build_group, nxt, pool)
                            if nxt is not None else None)
                out = _st1_device_group(lefts.to(dev), rights.to(dev), plans.to(dev),
                                        cfg.max_disp_levels)
                for row in out[:n_real]:
                    yield _scale_u8(row, cfg.disparity_scale)


class SegmentTreeST2BatchPipeline:
    """Batched streaming ST-2 (``STMatching/StereoDisparity.cpp:91-159``):
    G frames per group, two device stages per group with one host tree
    rebuild between them, the least the ST-2 data dependency allows.

    Per group:

    * host σ₁ stage: the left and right view trees of every frame (2G
      builds on the pool), stacked into one 2G plan;
    * device phase 1: per frame cost_left → derived cost_right → both view
      filters → WTA → median → LR mask, packed into one u8 map;
    * the fetch of the packed maps (the sync point), then the host rebuild:
      color+depth weights → re-segmentation trees → stacked σ plan (pool);
    * device phase 2: the ST-1 group program over the rebuilt trees.

    The next group's σ₁ stage is submitted to a stage thread before this
    group's phase 1 is enqueued. ``lean`` picks the plan format: True (the
    default) ships the smaller payload and inverts the perm on the device,
    False ships the inverse perm. The maps are the same either way.
    """

    def __init__(
        self,
        config: SegmentTreeConfig = SegmentTreeConfig(),
        group_size: int = 8,
        workers: int = 4,
        lean: bool = True,
        device="cuda",
    ) -> None:
        if group_size < 1:
            raise ValueError("group_size must be >= 1")
        self.config = config
        self.group_size = group_size
        self.workers = workers
        self.lean = lean
        self.device = resolve_device(device)

    def _plan(self, tree, sigma: float) -> StridePlan:
        return StridePlan.from_tree(tree, sigma, lean=self.lean)

    def _sigma1_group(self, group: List[Frame], pool):
        """Stack a (possibly short) group; build the 2G σ₁ plan."""
        cfg = self.config
        lefts, rights = _padded(group, self.group_size)
        imgs = list(lefts.numpy()) + list(rights.numpy())
        plans = converge_stride_plans(
            [lambda im=im: self._plan(_sigma1_tree(im, cfg), cfg.sigma_one) for im in imgs],
            pool)
        return lefts, rights, plans, len(group)

    def _final_plans(self, lefts: np.ndarray, disp_l, mask, pool) -> StridePlan:
        cfg = self.config
        return converge_stride_plans(
            [lambda i=i: self._plan(_final_tree(lefts[i], disp_l[i], mask[i], cfg), cfg.sigma)
             for i in range(len(lefts))],
            pool)

    def process(self, frames: Iterable[Frame]) -> Iterator[torch.Tensor]:
        """Yield scaled uint8 ST-2 disparity maps, one per frame pair."""
        cfg, dev = self.config, self.device
        groups = _groups(frames, self.group_size, cfg, "st2")
        with ThreadPoolExecutor(1) as stage, ThreadPoolExecutor(self.workers) as pool:
            cur = next(groups, None)
            if cur is None:
                return
            cur_h1 = stage.submit(self._sigma1_group, cur, pool)
            while cur_h1 is not None:
                lefts, rights, plans1, n_real = cur_h1.result()
                nxt = next(groups, None)
                cur_h1 = stage.submit(self._sigma1_group, nxt, pool) if nxt is not None else None
                l_dev, r_dev = lefts.to(dev), rights.to(dev)
                packed = _st2_phase1_group(l_dev, r_dev, plans1.to(dev), cfg.max_disp_levels,
                                           cfg.lr_max_diff)
                disp_l, mask = _unpack_phase1(packed)
                plans2 = self._final_plans(lefts.numpy(), disp_l, mask, pool)
                out = _st1_device_group(l_dev, r_dev, plans2.to(dev), cfg.max_disp_levels)
                for row in out[:n_real]:
                    yield _scale_u8(row, cfg.disparity_scale)
