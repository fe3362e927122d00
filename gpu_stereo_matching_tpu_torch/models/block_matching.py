"""SAD block matching on the unfused ops path: AD cost volume -> clipped
(2r+1)**2 box sums -> WTA, as ``gpu_stereo_matching_tpu/models/block_matching.py``.

Only the plain configuration is ported: a config asking for the LR check or
the median post-filter raises (ROADMAP queue 1, item 6 ports both).
"""

from __future__ import annotations

import torch

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.ops.aggregate import aggregate_cost_volume
from gpu_stereo_matching_tpu_torch.ops.cost import ad_cost_volume
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity


def _check_config(config: BlockMatchingConfig) -> None:
    if config.lr_consistency or config.median_radius > 0:
        raise NotImplementedError(
            "LR consistency and the median post-filter are not ported yet "
            "(ROADMAP.md queue 1, item 6: BM post-filters)"
        )


def block_matching_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> torch.Tensor:
    """Disparity of a (H, W) uint8 gray pair -> (H, W) int32."""
    _check_config(config)
    cost = ad_cost_volume(
        left_gray, right_gray, config.num_disparities, int(config.invalid_cost)
    )
    sad = aggregate_cost_volume(cost, config.sad_radius)
    return wta_disparity(sad)


def block_matching_pipeline(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> torch.Tensor:
    """Checked (H, W) or (B, H, W) block matching -> int32 disparities."""
    check_gray_pair(left_gray, right_gray, config.num_disparities, "block_matching")
    _check_config(config)
    if left_gray.dim() == 3:
        return torch.stack(
            [block_matching_disparity(l, r, config) for l, r in zip(left_gray, right_gray)]
        )
    return block_matching_disparity(left_gray, right_gray, config)
