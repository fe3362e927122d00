"""Absolute-difference matching cost volume, (D, H, W) layout as in the JAX
package's ``ops/cost.py``."""

from __future__ import annotations

import torch


def ad_cost_volume(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int,
    invalid_cost: int = 255,
) -> torch.Tensor:
    """|L(y, x) - R(y, x - d)| of a (H, W) uint8 pair -> (D, H, W) uint8.

    Columns ``x < d`` hold ``invalid_cost``.
    """
    h, w = left_gray.shape
    li = left_gray.to(torch.int16)
    ri = right_gray.to(torch.int16)
    out = torch.empty((num_disparities, h, w), dtype=torch.uint8, device=left_gray.device)
    for d in range(num_disparities):
        out[d, :, :d] = invalid_cost
        out[d, :, d:] = (li[:, d:] - ri[:, : w - d]).abs().to(torch.uint8)
    return out
