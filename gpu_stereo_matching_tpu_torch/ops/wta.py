"""Winner-take-all disparity: argmin over the disparity axis, ties to the
smallest d (``torch.argmin`` returns the first minimum)."""

from __future__ import annotations

from typing import Tuple

import torch


def wta_disparity(cost: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Argmin over the disparity axis of a (D, ..., H, W) volume -> int32."""
    return torch.argmin(cost, dim=dim).to(torch.int32)


def wta_with_cost(cost: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmin (int32) and the winning cost."""
    best, disp = torch.min(cost, dim=dim)
    return disp.to(torch.int32), best
