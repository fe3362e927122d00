"""Gray conversion of BGR uint8 images, bit-exact with the JAX package.

``gpu_stereo_matching_tpu/ops/color.py`` takes the weighted channel sum as
a float32 ``tensordot``, which XLA evaluates as the fused multiply-add
chain ``fma(c2, w2, fma(c1, w1, c0 * w0))``: each step rounds to float32
once. A plain float32 sum rounds twice per step and differs in a few
hundred to a few thousand of the 2**24 BGR triples. Here the chain is
emulated in float64: every uint8 x float32 product, and its sum with a
float32 partial, is exact in float64, so rounding each step to float32
rounds once, as the FMA does, on any device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def round_sat_u8(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even, saturate to [0, 255], cast to uint8."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _weighted_sum_fma_f32(img: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """float32 ``fma(c2, w2, fma(c1, w1, c0 * w0))`` over the last axis."""
    w = np.asarray(weights, dtype=np.float32).astype(np.float64)
    c = img.to(torch.float64)
    acc = (c[..., 0] * float(w[0])).to(torch.float32)
    for k in range(1, len(w)):
        acc = (c[..., k] * float(w[k]) + acc.to(torch.float64)).to(torch.float32)
    return acc


def grayscale_u8(
    img: torch.Tensor, weights: Sequence[float], rounding: str = "half_up"
) -> torch.Tensor:
    """Weighted channel sum of a (..., H, W, 3) uint8 image -> (..., H, W) uint8.

    ``rounding`` is ``"half_up"`` (add 0.5 and floor, in float32) or
    ``"half_even"`` (round to nearest even).
    """
    gray = _weighted_sum_fma_f32(img, weights)
    if rounding == "half_up":
        return torch.clamp(torch.floor(gray + 0.5), 0.0, 255.0).to(torch.uint8)
    if rounding == "half_even":
        return round_sat_u8(gray)
    raise ValueError(f"unknown rounding mode: {rounding!r}")


def gray_rec601_bgr(img_bgr: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma of a BGR uint8 image, rounded half up (ST convention)."""
    return grayscale_u8(img_bgr, (0.114, 0.587, 0.299), rounding="half_up")


def gray_blockmatching_bgr(img_bgr: torch.Tensor) -> torch.Tensor:
    """Block-matching gray: the Rec.601 weights applied to (B, G, R) in
    storage order, rounded half to even (the reference's swapped
    convention)."""
    return grayscale_u8(img_bgr, (0.299, 0.587, 0.114), rounding="half_even")


def gradient_x(gray_u8: torch.Tensor) -> torch.Tensor:
    """Horizontal gradient of a (..., H, W) uint8 gray image → float32.

    Interior: ``0.5 * (g[x+1] - g[x-1]) + 127.5``. Border columns: the
    one-sided full difference ``g[1] - g[0]`` and ``g[W-1] - g[W-2]``, plus
    127.5, as in ``StereoHelper.cpp:56-70`` (the border difference is *not*
    halved).
    """
    g = gray_u8.to(torch.float32)
    left = g[..., :, :-2]
    right = g[..., :, 2:]
    interior = 0.5 * (right - left) + 127.5
    first = (g[..., :, 1:2] - g[..., :, 0:1]) + 127.5
    last = (g[..., :, -1:] - g[..., :, -2:-1]) + 127.5
    return torch.cat([first, interior, last], dim=-1)
