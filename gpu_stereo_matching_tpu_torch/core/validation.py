"""Input checks on tensors at the port's public functions.

The JAX package's ``core/validation.py`` compares ``str(dtype)`` with
``"uint8"``, which a torch tensor spells ``torch.uint8``; these checks take
tensors.
"""

from __future__ import annotations

from typing import Tuple

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


def _dtype_name(dtype: torch.dtype) -> str:
    """``float32`` for ``torch.float32``: how numpy and JAX spell a dtype."""
    return str(dtype).removeprefix("torch.")


def check_bgr_pair(
    left: torch.Tensor, right: torch.Tensor, num_disparities: int, what: str = "image"
) -> None:
    """(H, W, 3) uint8 BGR pair, D at most W; the JAX function's conditions
    and messages."""
    if left.dim() != 3 or left.shape[-1] != 3:
        raise ValueError(f"{what}: expected (H, W, 3) BGR arrays, got {tuple(left.shape)}")
    if left.shape != right.shape:
        raise ValueError(
            f"{what}: left/right shapes differ: {tuple(left.shape)} vs {tuple(right.shape)}"
        )
    if left.dtype != torch.uint8 or right.dtype != torch.uint8:
        raise TypeError(
            f"{what}: expected uint8 inputs, got "
            f"{_dtype_name(left.dtype)}/{_dtype_name(right.dtype)}"
        )
    if num_disparities > left.shape[1]:
        raise ValueError(
            f"{what}: max_disp_levels={num_disparities} exceeds width {left.shape[1]}"
        )


def check_maps(
    map_x: torch.Tensor, map_y: torch.Tensor, what: str = "rectification maps"
) -> Tuple[int, int]:
    """Equal-shape 2-D maps -> their (H, W); the JAX function's condition
    and message."""
    if map_x.shape != map_y.shape or map_x.dim() != 2:
        raise ValueError(
            f"{what}: map_x/map_y must be equal-shape 2-D, got "
            f"{tuple(map_x.shape)} vs {tuple(map_y.shape)}"
        )
    return tuple(map_x.shape)
