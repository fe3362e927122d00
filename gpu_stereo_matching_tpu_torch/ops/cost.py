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


def ad_cost_volume_offset(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    count: int,
    d_offset: int,
    invalid_cost: int = 255,
) -> torch.Tensor:
    """AD cost for disparities ``d_offset .. d_offset + count - 1`` of a
    (H, W) uint8 pair -> (count, H, W) uint8, ``invalid_cost`` where ``x < d``.

    ``d_offset`` is the start of one shard's range in the disparity-sharded
    step. The mesh is driven by one process, so it is a plain int here
    (the JAX function takes a traced value).
    """
    h, w = left_gray.shape
    li = left_gray.to(torch.int16)
    ri = right_gray.to(torch.int16)
    out = torch.empty((count, h, w), dtype=torch.uint8, device=left_gray.device)
    for i in range(count):
        d = min(d_offset + i, w)
        out[i, :, :d] = invalid_cost
        out[i, :, d:] = (li[:, d:] - ri[:, : w - d]).abs().to(torch.uint8)
    return out
