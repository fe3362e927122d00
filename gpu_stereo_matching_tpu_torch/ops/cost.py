"""Matching-cost volumes, (D, H, W) layout as in the JAX package's
``ops/cost.py``: the absolute difference of a gray pair (block matching) and
the truncated color + gradient cost of a BGR pair (the segment tree,
``STMatching/StereoHelper.cpp:75-126``)."""

from __future__ import annotations

import torch

from gpu_stereo_matching_tpu_torch.core.config import CostConstants
from gpu_stereo_matching_tpu_torch.ops.color import gradient_x, gray_rec601_bgr


def _shifted_right(right: torch.Tensor, num_disparities: int) -> torch.Tensor:
    """``right[..., x - d]`` (clamped at the left edge) → (D, ..., W).

    The clamp is the reference's left-edge column replication
    (``StereoHelper.cpp:102-111``): one edge-replicating pad, then D slices.
    """
    w = right.shape[-1]
    if num_disparities == 1:
        return right[None]
    pad = right[..., :1].expand(*right.shape[:-1], num_disparities - 1)
    padded = torch.cat([pad, right], dim=-1)
    base = num_disparities - 1
    return torch.stack(
        [padded[..., base - d : base - d + w] for d in range(num_disparities)],
        dim=0,
    )


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


def color_gradient_cost_volume(
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    num_disparities: int,
    consts: CostConstants = CostConstants(),
) -> torch.Tensor:
    """Truncated color+gradient cost of two (H, W, 3) uint8 images → (D, H, W) f32.

    ``cost(d,y,x) = α·min(mean_c|ΔBGR|, τ_color) + (1-α)·min(|Δgrad|, τ_grad)``
    with the right image shifted by d using left-edge replication
    (``StereoHelper.cpp:102-126``). Gradients are the reference's offset
    x-gradients of the Rec.601 gray (``StereoHelper.cpp:39-73``).

    The channel mean is the sum of three integers (exact) times the float32
    reciprocal of 3, which is what XLA makes of the JAX function's mean;
    ``torch.mean`` multiplies so on a CUDA device but divides on the CPU.
    The blend is two products and a sum, each its own op, so the card and
    the CPU give the same bits.
    """
    gray_l = _rec601_gray(left_bgr)
    gray_r = _rec601_gray(right_bgr)
    grad_l = gradient_x(gray_l)  # (H, W) f32
    grad_r = gradient_x(gray_r)

    # Shift color channels: (H, W, 3) → channel-major (3, H, W).
    r_cmajor = right_bgr.to(torch.int16).movedim(-1, 0)
    r_shift = _shifted_right(r_cmajor, num_disparities)  # (D, 3, H, W)
    l_cmajor = left_bgr.to(torch.int16).movedim(-1, 0)
    color_ad = (l_cmajor[None] - r_shift).abs().to(torch.float32)
    cost_color = torch.clamp(color_ad.sum(dim=1) * (1.0 / color_ad.shape[1]),
                             max=consts.tau_color)

    grad_shift = _shifted_right(grad_r, num_disparities)  # (D, H, W)
    cost_grad = torch.clamp((grad_l[None] - grad_shift).abs(), max=consts.tau_gradient)

    alpha = consts.alpha
    return alpha * cost_color + (1.0 - alpha) * cost_grad


def _rec601_gray(img_bgr: torch.Tensor) -> torch.Tensor:
    return gray_rec601_bgr(img_bgr)


def right_cost_from_left(cost_left: torch.Tensor) -> torch.Tensor:
    """Derive the right-view cost volume from the left one, (D, H, W) → (D, H, W).

    ``right(d,y,x) = left(d,y,x+d)`` where ``x+d < W``; at the right edge the
    previous disparity plane is carried over (``StereoHelper.cpp:156-180``).
    The carried value of plane d at column x is plane ``d* = min(d, W-1-x)``'s,
    so the JAX function's scan over the planes is one gather here:
    ``right[d, y, x] = left[d*, y, x + d*]``. It only selects values, so it is
    exact on any device.
    """
    num_d, h, w = cost_left.shape
    dev = cost_left.device
    x = torch.arange(w, device=dev)
    d_star = torch.minimum(torch.arange(num_d, device=dev)[:, None], (w - 1) - x)  # (D, W)
    rows = torch.arange(h, device=dev)[None, :, None]
    return cost_left[d_star[:, None, :], rows, (x + d_star)[:, None, :]]
