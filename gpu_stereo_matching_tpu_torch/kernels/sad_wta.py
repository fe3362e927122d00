"""Fused SAD + WTA block matching: the CUDA kernel ``csrc/sad_wta.cu`` and
its plain torch twin.

Both reproduce the fused TPU kernel of
``gpu_stereo_matching_tpu/kernels/sad_wta.py``, whose invalid columns
(``x < d``) cost the full-window constant ``255 * (2r + 1)`` after the
vertical sum, even at the top and bottom ``r`` rows. The unfused ops path
(``models/block_matching.py``) charges ``255 *`` the clipped row count
there instead, so the two can pick different disparities within ``r`` rows
of the border; each side here is held to its own JAX counterpart.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.ops.aggregate import box_filter_sum

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

# The kernel's blocks are 128 or 256 threads wide, 2r + 32 of them at least.
MAX_RADIUS = 112


def fused_block_matching_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Plain torch twin of the kernel: (..., H, W) uint8 -> (..., H, W) int32."""
    w = left_gray.shape[-1]
    k = 2 * radius + 1
    li = left_gray.to(torch.int32)
    ri = right_gray.to(torch.int32)
    col = torch.arange(w, device=left_gray.device)
    best = torch.full(li.shape, torch.iinfo(torch.int32).max, dtype=torch.int32,
                      device=left_gray.device)
    best_d = torch.zeros(li.shape, dtype=torch.int32, device=left_gray.device)
    for d in range(num_disparities):
        diff = torch.zeros_like(li)
        diff[..., d:] = (li[..., d:] - ri[..., : w - d]).abs()
        v = box_filter_sum(diff, radius, dims=(-2,))
        v = torch.where(col < d, 255 * k, v)
        sad = box_filter_sum(v, radius, dims=(-1,))
        upd = sad < best
        best = torch.where(upd, sad, best)
        best_d = torch.where(upd, d, best_d)
    return best_d


def _launch(left: torch.Tensor, right: torch.Tensor, num_disparities: int,
            radius: int) -> torch.Tensor:
    global LAUNCHES
    _build.require_cuda(left, "fused block matching")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("fused block matching: inputs must be contiguous")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"fused block matching: radius {radius} not in [0, {MAX_RADIUS}]")
    lib = _build.load_library()
    b, h, w = left.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_sad_wta_u8(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            b, h, w, num_disparities, radius, stream,
        )
    _build.check(lib, err, "gsm_sad_wta_u8")
    LAUNCHES += 1
    return out


def fused_block_matching(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Disparity of a (H, W) uint8 pair -> (H, W) int32."""
    check_gray_pair(left_gray, right_gray, num_disparities, "fused_block_matching")
    if left_gray.dim() != 2:
        raise ValueError("fused_block_matching: expected (H, W); use the batched form")
    if left_gray.device.type == "cpu":
        return fused_block_matching_reference(left_gray, right_gray, num_disparities, radius)
    return _launch(left_gray[None], right_gray[None], num_disparities, radius)[0]


def fused_block_matching_batched(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Disparities of (B, H, W) uint8 pairs -> (B, H, W) int32, one launch."""
    check_gray_pair(left_gray, right_gray, num_disparities, "fused_block_matching_batched")
    if left_gray.dim() != 3:
        raise ValueError("fused_block_matching_batched: expected (B, H, W)")
    if left_gray.device.type == "cpu":
        return fused_block_matching_reference(left_gray, right_gray, num_disparities, radius)
    return _launch(left_gray, right_gray, num_disparities, radius)
