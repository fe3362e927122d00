"""Bilinear remap as a plain torch gather: the plain twin of the remap kernel
and of the rig's front end.

Same per-pixel formula as ``gpu_stereo_matching_tpu/ops/remap.py``: 0
whenever any of the four taps lies outside the source (strict, so the last
row and column give 0), and a round-half-even saturating uint8 cast. Each
float operation is its own torch op, so nothing is contracted into an FMA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gpu_stereo_matching_tpu_torch.ops.color import gray_blockmatching_bgr, round_sat_u8


def remap_bilinear_u8(
    src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor
) -> torch.Tensor:
    """Remap (..., Hs, Ws) uint8 through (Ho, Wo) float32 maps -> (..., Ho, Wo).

    Validity compares the floored maps as floats (``x0 <= Ws - 2`` is
    ``x0 + 1 <= Ws - 1`` for integers), which also keeps NaN and
    out-of-int32-range coordinates invalid.
    """
    h, w = src.shape[-2], src.shape[-1]
    x0f = torch.floor(map_x)
    y0f = torch.floor(map_y)
    valid = (x0f >= 0) & (y0f >= 0) & (x0f <= w - 2) & (y0f <= h - 2)
    # Invalid pixels gather at 0 (their result is 0), so NaN never becomes an index.
    x0 = torch.where(valid, x0f, 0.0).to(torch.int64)
    y0 = torch.where(valid, y0f, 0.0).to(torch.int64)
    flat = src.reshape(src.shape[:-2] + (h * w,)).to(torch.float32)
    base = y0 * w + x0

    q11 = flat[..., base]
    q12 = flat[..., base + 1]
    q21 = flat[..., base + w]
    q22 = flat[..., base + w + 1]

    fx = map_x - x0f
    fy = map_y - y0f
    top = (1.0 - fy) * ((1.0 - fx) * q11 + fx * q12)
    bot = fy * ((1.0 - fx) * q21 + fx * q22)
    out = torch.where(valid, top + bot, torch.zeros((), dtype=torch.float32, device=src.device))
    return round_sat_u8(out)


def rectify_gray_pair(
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    left_map_x: torch.Tensor,
    left_map_y: torch.Tensor,
    right_map_x: torch.Tensor,
    right_map_y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rig's front end, per view: the block-matching gray of the
    (..., H, W, 3) BGR frames, remapped through the view's maps."""
    return (
        remap_bilinear_u8(gray_blockmatching_bgr(left_bgr), left_map_x, left_map_y),
        remap_bilinear_u8(gray_blockmatching_bgr(right_bgr), right_map_x, right_map_y),
    )
