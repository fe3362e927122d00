"""Middlebury accuracy and timing harness (bad-δ metric), as
``gpu_stereo_matching_tpu/bench/middlebury.py``.

The reference ships Middlebury GT (``Images/*/disp1.png``) but never
evaluates against it (SURVEY §4.4); this harness turns it into the
project's quantitative accuracy gate: bad-2.0 rate per scene and pipeline,
plus wall-clock time per run.

The pipelines ``bm``, ``bm+``, ``st1`` and ``st2`` run on ``device`` (the
card unless the caller passes ``"cpu"``): on the card ``bm`` launches the
gray kernel, the SAD-volume kernel and the argmin kernel, ``bm+`` the argmin
kernel twice and the median kernel, and the ST pipelines the median kernel.
The OpenCV baselines run on the host and import ``cv2`` when called.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig, SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.io.middlebury import (
    GT_SCALE,
    MiddleburyScene,
    bad_pixel_rate,
    list_middlebury_scenes,
    load_middlebury_scene,
    nonocc_mask,
)
from gpu_stereo_matching_tpu_torch.kernels.gray import gray_rec601_bgr
from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu_torch.models.segment_tree import segment_tree_disparity


@dataclasses.dataclass
class SceneResult:
    scene: str
    pipeline: str
    bad2: Optional[float]          # all valid-GT pixels
    bad2_nonocc: Optional[float]   # non-occluded pixels (GT cross-check)
    seconds: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


# Evaluation configs: a disparity range covering the full GT range (the
# reference CLI default of 60 levels truncates Art/Laundry at ~77), and no
# output scaling (the reference's ×4 uint8 scaling saturates at 255 = 63.75
# true disparities, which would corrupt the metric).
BM_CONFIG = BlockMatchingConfig(num_disparities=80)
ST_CONFIG = SegmentTreeConfig(max_disp_levels=80, disparity_scale=1)


def pipeline_disparity(
    scene: MiddleburyScene,
    pipeline: str = "st1",
    bm_config: BlockMatchingConfig = BM_CONFIG,
    st_config: SegmentTreeConfig = ST_CONFIG,
    device="cuda",
):
    """One pipeline's map of one scene → (disparity on the host, its scale)."""
    dev = resolve_device(device)
    if pipeline in ("bm", "bm+"):
        if pipeline == "bm+":
            # BASELINE config 2: box aggregation + LR consistency + median.
            bm_config = dataclasses.replace(
                bm_config, lr_consistency=True, median_radius=3
            )
        left = gray_rec601_bgr(torch.from_numpy(scene.left_bgr).to(dev))
        right = gray_rec601_bgr(torch.from_numpy(scene.right_bgr).to(dev))
        return block_matching_pipeline(left, right, bm_config).cpu().numpy(), 1.0
    if pipeline in ("st1", "st2"):
        cfg = dataclasses.replace(st_config, iterate=(pipeline == "st2"))
        disp = segment_tree_disparity(scene.left_bgr, scene.right_bgr, cfg, device=dev)
        return disp.cpu().numpy(), float(cfg.disparity_scale)
    if pipeline in ("opencv-bm", "opencv-sgbm"):
        return _opencv_baseline(scene, pipeline, bm_config.num_disparities), 1.0
    raise ValueError(f"unknown pipeline {pipeline!r}")


def evaluate_scene(
    scene: MiddleburyScene,
    pipeline: str = "st1",
    bm_config: BlockMatchingConfig = BM_CONFIG,
    st_config: SegmentTreeConfig = ST_CONFIG,
    delta: float = 2.0,
    device="cuda",
) -> SceneResult:
    """Run one pipeline on one scene; bad-δ against GT when available.
    ``seconds`` is the host's time from the inputs on the host to the map
    back on the host."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    disp, disp_scale = pipeline_disparity(scene, pipeline, bm_config, st_config, dev)
    seconds = time.perf_counter() - t0

    bad2 = bad2_nonocc = None
    if scene.gt_left is not None:
        bad2 = bad_pixel_rate(
            disp, scene.gt_left, delta=delta, disp_scale=disp_scale, gt_scale=GT_SCALE
        )
        if scene.gt_right is not None:
            bad2_nonocc = bad_pixel_rate(
                disp, scene.gt_left, delta=delta, disp_scale=disp_scale,
                gt_scale=GT_SCALE,
                mask=nonocc_mask(scene.gt_left, scene.gt_right),
            )
    return SceneResult(
        scene=scene.name, pipeline=pipeline, bad2=bad2,
        bad2_nonocc=bad2_nonocc, seconds=seconds,
    )


def _opencv_baseline(scene: MiddleburyScene, pipeline: str, num_disp: int):
    """External OpenCV baselines — the reference's own comparison pattern
    (``BM_SBM`` wrapping ``cv::StereoBM``, ``Utility.cpp:67-95``). Never on
    the product path; requires cv2 at call time."""
    import cv2

    nd = ((num_disp + 15) // 16) * 16
    if pipeline == "opencv-bm":
        gl = cv2.cvtColor(scene.left_bgr, cv2.COLOR_BGR2GRAY)
        gr = cv2.cvtColor(scene.right_bgr, cv2.COLOR_BGR2GRAY)
        matcher = cv2.StereoBM_create(numDisparities=nd, blockSize=9)
        disp = matcher.compute(gl, gr)
    else:
        matcher = cv2.StereoSGBM_create(
            minDisparity=0, numDisparities=nd, blockSize=5,
            P1=8 * 3 * 25, P2=32 * 3 * 25,
            uniquenessRatio=10, speckleWindowSize=100, speckleRange=2,
        )
        disp = matcher.compute(scene.left_bgr, scene.right_bgr)
    return np.maximum(disp.astype(np.float64) / 16.0, 0.0)


def run_middlebury_suite(
    root: str,
    pipelines: List[str] = ("bm", "st1"),
    scenes: Optional[List[str]] = None,
    **kwargs,
) -> List[SceneResult]:
    """Every pipeline on every scene (those with GT unless ``scenes`` names
    them), one printed line each; ``kwargs`` go to :func:`evaluate_scene`."""
    names = scenes or list_middlebury_scenes(root, with_gt_only=True)
    results = []
    for name in names:
        scene = load_middlebury_scene(root, name)
        for pipeline in pipelines:
            res = evaluate_scene(scene, pipeline, **kwargs)
            results.append(res)
            bad = "n/a" if res.bad2 is None else f"{100 * res.bad2:.2f}%"
            non = "n/a" if res.bad2_nonocc is None else f"{100 * res.bad2_nonocc:.2f}%"
            print(
                f"{name:12s} {pipeline:4s} bad2={bad:>8s} nonocc={non:>8s}"
                f" {res.seconds * 1e3:8.1f} ms"
            )
    return results
