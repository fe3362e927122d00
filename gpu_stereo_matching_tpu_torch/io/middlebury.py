"""Middlebury 2005/2006 third-size dataset access + bad-pixel metrics.

The port's own copy of the JAX package's ``io/middlebury.py`` (plain numpy,
the same arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the
two together.

The reference bundles nine scenes under ``Images/`` (six with ground-truth
``disp1/disp5`` at GT scale factor 3; see SURVEY.md §2.3) but never computes
an error metric. Here the GT becomes a first-class quantitative gate:
``bad_pixel_rate`` implements the standard bad-δ metric used as the
project's north-star accuracy number (bad-2.0).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr, load_image_gray

GT_SCALE = 3.0  # Middlebury third-size ground truth: disp_png = 3 * true_disp

SCENES_WITH_GT = ("Art", "Books", "Dolls", "Laundry", "Moebius", "Reindeer")
SCENES_NO_GT = ("Computer", "Drumsticks", "Dwarves")


@dataclasses.dataclass
class MiddleburyScene:
    name: str
    left_bgr: np.ndarray           # view1 (H, W, 3) uint8
    right_bgr: np.ndarray          # view5
    gt_left: Optional[np.ndarray]  # raw disp1 png values (scale GT_SCALE), or None
    gt_right: Optional[np.ndarray]


def list_middlebury_scenes(root: str | os.PathLike, with_gt_only: bool = False) -> List[str]:
    names = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if os.path.isdir(d) and os.path.exists(os.path.join(d, "view1.png")):
            if with_gt_only and not os.path.exists(os.path.join(d, "disp1.png")):
                continue
            names.append(name)
    return names


def load_middlebury_scene(root: str | os.PathLike, name: str) -> MiddleburyScene:
    d = os.path.join(root, name)
    gt1 = os.path.join(d, "disp1.png")
    gt5 = os.path.join(d, "disp5.png")
    return MiddleburyScene(
        name=name,
        left_bgr=load_image_bgr(os.path.join(d, "view1.png")),
        right_bgr=load_image_bgr(os.path.join(d, "view5.png")),
        gt_left=load_image_gray(gt1) if os.path.exists(gt1) else None,
        gt_right=load_image_gray(gt5) if os.path.exists(gt5) else None,
    )


def nonocc_mask(gt_left_png: np.ndarray, gt_right_png: np.ndarray,
                gt_scale: float = GT_SCALE) -> np.ndarray:
    """Non-occluded valid pixels via GT left↔right cross-checking."""
    gl = gt_left_png.astype(np.float64) / gt_scale
    gr = gt_right_png.astype(np.float64) / gt_scale
    h, w = gl.shape
    x = np.arange(w)[None, :].repeat(h, 0)
    src = np.clip(np.rint(x - gl).astype(np.int64), 0, w - 1)
    gr_s = np.take_along_axis(gr, src, axis=1)
    return (
        (gt_left_png > 0)
        & (x - gl >= 0)
        & (np.abs(gl - gr_s) <= 1.0)
    )


def bad_pixel_rate(
    disp: np.ndarray,
    gt_png: np.ndarray,
    delta: float = 2.0,
    disp_scale: float = 1.0,
    gt_scale: float = GT_SCALE,
    mask: "np.ndarray | None" = None,
) -> float:
    """Fraction of valid-GT pixels with |disp/disp_scale - gt/gt_scale| > delta.

    ``disp_scale`` converts the pipeline's output (which, like the reference,
    may be pre-multiplied by the CLI ``scale``) back to true disparities;
    GT value 0 marks unknown pixels and is excluded.
    """
    gt = gt_png.astype(np.float64)
    valid = (gt > 0) if mask is None else ((gt > 0) & mask)
    est = disp.astype(np.float64) / disp_scale
    err = np.abs(est - gt / gt_scale)
    bad = (err > delta) & valid
    return float(bad.sum()) / max(int(valid.sum()), 1)
