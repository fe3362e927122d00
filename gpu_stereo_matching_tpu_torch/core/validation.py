"""Input checks on tensors at the port's public functions.

The JAX package's ``core/validation.py`` compares ``str(dtype)`` with
``"uint8"``, which a torch tensor spells ``torch.uint8``; these checks take
tensors.
"""

from __future__ import annotations

import torch


def check_gray_pair(
    left: torch.Tensor, right: torch.Tensor, num_disparities: int, what: str
) -> None:
    """(H, W) or (B, H, W) uint8 pair on one device, D in [1, W]."""
    if left.dim() not in (2, 3):
        raise ValueError(
            f"{what}: expected (H, W) or (B, H, W) gray tensors, got {tuple(left.shape)}"
        )
    if left.shape != right.shape:
        raise ValueError(
            f"{what}: left/right shapes differ: {tuple(left.shape)} vs {tuple(right.shape)}"
        )
    if left.dtype != torch.uint8 or right.dtype != torch.uint8:
        raise TypeError(f"{what}: expected uint8 inputs, got {left.dtype}/{right.dtype}")
    if left.device != right.device:
        raise ValueError(f"{what}: left on {left.device}, right on {right.device}")
    if not 1 <= num_disparities <= left.shape[-1]:
        raise ValueError(
            f"{what}: num_disparities={num_disparities} must be in [1, width "
            f"{left.shape[-1]}]"
        )
