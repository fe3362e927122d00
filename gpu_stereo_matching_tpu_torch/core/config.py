"""Typed configuration for both stereo pipelines.

Collects every tunable the reference hard-codes at call sites or as
compile-time constants, so one dataclass drives the whole engine:

* block matching demo constants: SAD half-window 5, 64 disparities
  (reference ``BlockMatching/Caller.cpp:19``),
* segment-tree CLI defaults: 60 levels, scale 4, sigma 0.1
  (``STMatching/main.cpp:49-67``),
* compile-time constants ``TAU=1200``, ``SIGMA_ONE=0.08``
  (``STMatching/Toolkit.h:34-35``), ``PENALTY_CROSS_SEG=5``,
  ``MIN_SIZE_SEG=50`` (``STMatching/segment-graph.h:24,36``),
  matching-cost constants 7 / 2 / 0.11 (``STMatching/StereoHelper.cpp:80-83``)
  and ``ALPHA_DEP_SEG=0.5`` (``STMatching/SegmentTree.cpp:205``).

The port's own copy of the JAX package's ``core/config.py`` (plain numpy, the same
arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the two
together.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """Color+gradient matching-cost constants (``StereoHelper.cpp:80-83``)."""

    tau_color: float = 7.0   # truncation of mean |ΔBGR|
    tau_gradient: float = 2.0  # truncation of |Δgrad|
    alpha: float = 0.11      # weight of the color term (1-alpha on gradient)


@dataclasses.dataclass(frozen=True)
class BlockMatchingConfig:
    """Config for the SAD block-matching pipeline (reference ``BlockMatching/``).

    ``sad_radius`` is the half window: window size is ``(2r+1)²``
    (r=5 → 11×11 in the reference demo, ``Caller.cpp:19``).
    """

    num_disparities: int = 64
    sad_radius: int = 5
    # Cost assigned where the right-image sample x-d falls outside the image
    # (reference assigns 255 per pixel for out-of-range, BlockMatching.cpp:210).
    invalid_cost: float = 255.0
    # Optional post-processing (the reference block matcher has none; these
    # bring it to parity with the segment-tree pipeline's post stages).
    lr_consistency: bool = False
    lr_max_diff: int = 1
    median_radius: int = 0  # 0 disables the median post-filter
    # Compute dtype for the aggregated cost volume.
    dtype: str = "float32"

    @property
    def window_area(self) -> int:
        return (2 * self.sad_radius + 1) ** 2


@dataclasses.dataclass(frozen=True)
class SegmentTreeConfig:
    """Config for the non-local segment-tree pipeline (reference ``STMatching/``)."""

    max_disp_levels: int = 60
    disparity_scale: int = 4      # output disparity multiplier (main.cpp:50)
    sigma: float = 0.1            # edge-weight bandwidth of the final tree
    sigma_one: float = 0.08       # bandwidth of per-view trees in ST-2 (Toolkit.h:35)
    tau: float = 1200.0           # FH segmentation threshold constant (Toolkit.h:34)
    penalty_cross_seg: float = 5.0  # added to cross-segment joining edges
    min_size_seg: int = 50        # segments smaller than this join without penalty
    alpha_dep_seg: float = 0.5    # color/depth mix in the ST-2 re-segmentation weight
    cost: CostConstants = dataclasses.field(default_factory=CostConstants)
    presmooth_radius: int = 1     # 3×3 median before edge weights (SegmentTree.cpp:185)
    median_radius: int = 3        # 7×7 median post-filter (StereoDisparity.cpp:85)
    lr_max_diff: int = 1          # LR-consistency tolerance (StereoDisparity.cpp:141)
    iterate: bool = False         # False = ST-1, True = ST-2 (LR + re-segmentation)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for distributed execution.

    Axes: ``data`` shards frame batches (pure DP, no halo), ``space`` tiles
    the image H axis (neighbours exchange halo rows for window ops),
    ``disp`` shards the disparity range (WTA becomes a minimum of packed
    keys across the shards).
    """

    data: int = 1
    space: int = 1
    disp: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "space", "disp")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.space, self.disp)

    @property
    def num_devices(self) -> int:
        return self.data * self.space * self.disp
