"""Clipped-window box sums from prefix sums, exact in int32.

As ``gpu_stereo_matching_tpu/ops/aggregate.py``: windows are clipped at the
border and only in-bounds pixels contribute; sums are not normalised.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _box1d_sum(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """Clipped-window running sum of length ``2r+1`` along ``dim``."""
    if radius <= 0:
        return x
    if not x.is_floating_point():
        x = x.to(torch.int32)
    n = x.shape[dim]
    c = torch.cumsum(x, dim=dim, dtype=x.dtype)
    idx = torch.arange(n, device=x.device)
    hi = torch.clamp(idx + radius, max=n - 1)
    lo = idx - radius - 1
    take_hi = c.index_select(dim, hi)
    take_lo = c.index_select(dim, torch.clamp(lo, min=0))
    shape = [1] * x.dim()
    shape[dim] = n
    mask = (lo >= 0).reshape(shape)
    return take_hi - torch.where(mask, take_lo, torch.zeros_like(take_lo))


def box_filter_sum(
    x: torch.Tensor, radius: int, dims: Sequence[int] = (-2, -1)
) -> torch.Tensor:
    """Separable clipped-window box sum over ``dims`` (default: H, W)."""
    out = x
    for dim in dims:
        out = _box1d_sum(out, radius, dim)
    return out


def window_counts(
    shape: Tuple[int, int], radius: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """In-bounds pixels of each clipped (2r+1)**2 window -> (H, W) int32."""
    h, w = shape
    ch = _box1d_sum(torch.ones((h, 1), dtype=torch.int32, device=device), radius, 0)
    cw = _box1d_sum(torch.ones((1, w), dtype=torch.int32, device=device), radius, 1)
    return ch * cw


def aggregate_cost_volume(cost: torch.Tensor, radius: int) -> torch.Tensor:
    """SAD aggregation of a (..., D, H, W) cost volume -> int32 (uint8 is
    promoted so the sums are exact)."""
    return box_filter_sum(cost, radius, dims=(-2, -1))
