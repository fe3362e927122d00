"""Fused SAD + WTA block matching: the CUDA kernels ``csrc/sad_wta.cu``
(whole disparity range -> disparity) and ``csrc/sad_wta_key.cu`` (a partial
range -> packed keys, for a disparity-sharded mesh) and their plain torch
twins.

All reproduce the fused TPU kernel of
``gpu_stereo_matching_tpu/kernels/sad_wta.py``, whose invalid columns
(``x < d``) cost the full-window constant ``255 * (2r + 1)`` after the
vertical sum, even at the top and bottom ``r`` rows. The unfused ops path
(``models/block_matching.py``) charges ``255 *`` the clipped row count
there instead, so the two can pick different disparities within ``r`` rows
of the border; each side here is held to its own JAX counterpart.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises. Each kernel has two hand-written bodies: the strip body of
``csrc/sad_strips.cuh`` (radius 1..7), which both sources instantiate, and a
general body (every other radius up to 112). The choice is made in C, from
``(num_disparities, radius)`` alone for the whole-range kernel and from
``(count, total_disparities, radius)`` alone for the key kernel;
:func:`kernel_body` and :func:`launch_plan`, :func:`key_kernel_body` and
:func:`key_launch_plan` say which one a shape takes and how it is launched.
"""

from __future__ import annotations

import ctypes

import torch

from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.ops.aggregate import box_filter_sum

# Kernel launches since import (or since a caller reset them to 0): the
# whole-range kernel and the partial-range key kernel.
LAUNCHES = 0
KEY_LAUNCHES = 0

# The general bodies' blocks are 128 or 256 threads wide, 2r + 32 of them at
# least.
MAX_RADIUS = 112


def _fused_sad(li, ri, col, d: int, radius: int) -> torch.Tensor:
    """SAD map of one disparity by the fused formula, int32 in and out."""
    w = li.shape[-1]
    diff = torch.zeros_like(li)
    diff[..., d:] = (li[..., d:] - ri[..., : w - d]).abs()
    v = box_filter_sum(diff, radius, dims=(-2,))
    v = torch.where(col < d, 255 * (2 * radius + 1), v)
    return box_filter_sum(v, radius, dims=(-1,))


def fused_block_matching_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Plain torch twin of the kernel: (..., H, W) uint8 -> (..., H, W) int32."""
    li = left_gray.to(torch.int32)
    ri = right_gray.to(torch.int32)
    col = torch.arange(left_gray.shape[-1], device=left_gray.device)
    best = torch.full(li.shape, torch.iinfo(torch.int32).max, dtype=torch.int32,
                      device=left_gray.device)
    best_d = torch.zeros(li.shape, dtype=torch.int32, device=left_gray.device)
    for d in range(num_disparities):
        sad = _fused_sad(li, ri, col, d, radius)
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


BODIES = ("general", "strips")
_PLAN_FIELDS = ("tile_rows", "tile_cols", "threads", "blocks", "blocks_per_sm", "sms")


def kernel_body(num_disparities: int, radius: int) -> str:
    """Which body of the CUDA kernel ``(num_disparities, radius)`` runs:
    ``"strips"`` or ``"general"``. Builds the library; needs no card."""
    return BODIES[_build.load_library().gsm_sad_wta_body(num_disparities, radius)]


def _plan(entry: str, args, device, bodies=BODIES) -> dict:
    """The plan that C entry ``entry`` fills for ``args`` on ``device``;
    its first field indexes ``bodies``."""
    lib = _build.load_library()
    fields = (ctypes.c_int * (1 + len(_PLAN_FIELDS)))()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, fields)
    _build.check(lib, err, entry)
    plan = {"body": bodies[fields[0]], **dict(zip(_PLAN_FIELDS, fields[1:]))}
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan


def launch_plan(shape, num_disparities: int, radius: int, device="cuda") -> dict:
    """How the kernel launches for a ``(B, H, W)`` batch on ``device``: its
    body, tile, threads per block, blocks, and the blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) beside the SM count,
    from which ``waves`` = blocks / (blocks_per_sm * sms)."""
    return _plan("gsm_sad_wta_plan", (*shape, num_disparities, radius), device)


def key_kernel_body(count: int, total_disparities: int, radius: int) -> str:
    """Which body of the key kernel a range of ``count`` of
    ``total_disparities`` runs at ``radius``: ``"strips"`` or ``"general"``.
    Builds the library; needs no card."""
    return BODIES[_build.load_library().gsm_sad_key_body(count, total_disparities, radius)]


def key_launch_plan(shape, count: int, total_disparities: int, radius: int,
                    device="cuda") -> dict:
    """:func:`launch_plan` for the key kernel over a range of ``count`` of
    ``total_disparities`` (where the range starts does not change it): the
    strip body's shared memory shrinks with ``count``, so the blocks an SM
    holds are asked per ``count``."""
    return _plan("gsm_sad_key_plan", (*shape, count, total_disparities, radius), device)


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


def fused_block_matching_key_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    d_start: int,
    count: int,
    total_disparities: int,
    radius: int = 5,
) -> torch.Tensor:
    """Plain torch twin of the key kernel: (..., H, W) uint8 -> (..., H, W)
    int32, the minimum over ``d_start <= d < d_start + count`` of
    ``SAD(d) * total_disparities + d``."""
    li = left_gray.to(torch.int32)
    ri = right_gray.to(torch.int32)
    col = torch.arange(left_gray.shape[-1], device=left_gray.device)
    best = torch.full(li.shape, torch.iinfo(torch.int32).max, dtype=torch.int32,
                      device=left_gray.device)
    for d in range(d_start, d_start + count):
        sad = _fused_sad(li, ri, col, d, radius)
        best = torch.minimum(best, sad * total_disparities + d)
    return best


def _launch_key(left: torch.Tensor, right: torch.Tensor, d_start: int, count: int,
                total_disparities: int, radius: int) -> torch.Tensor:
    global KEY_LAUNCHES
    _build.require_cuda(left, "fused_block_matching_key")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("fused_block_matching_key: inputs must be contiguous")
    if radius > MAX_RADIUS:
        raise ValueError(
            f"fused_block_matching_key: the kernel takes radius <= {MAX_RADIUS}, got {radius}"
        )
    lib = _build.load_library()
    b, h, w = left.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_sad_key_u8(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            b, h, w, d_start, count, total_disparities, radius, stream,
        )
    _build.check(lib, err, "gsm_sad_key_u8")
    KEY_LAUNCHES += 1
    return out


def fused_block_matching_key(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    d_start: int,
    count: int,
    total_disparities: int,
    radius: int = 5,
) -> torch.Tensor:
    """Partial-range WTA of a (H, W) or (B, H, W) uint8 pair -> int32 keys of
    the same shape: the minimum over ``d_start <= d < d_start + count`` of
    ``SAD(d) * total_disparities + d``, SAD by the fused formula.

    It is what one shard of a disparity-sharded mesh computes: the
    elementwise minimum of the shards' keys, taken ``% total_disparities``,
    is the disparity over the whole range with ties to the smallest d. A
    batch is one launch. The image's top and bottom rows are its borders; a
    caller that passes a slab with halo rows crops them itself.

    ``d_start`` is a plain int. Raises ``ValueError`` when the range leaves
    ``[0, total_disparities)`` or when the largest key,
    ``255 * (2r + 1)**2 * total_disparities + total_disparities``, does not
    fit int32 (the JAX function checks neither and would wrap there).
    """
    what = "fused_block_matching_key"
    check_gray_pair(left_gray, right_gray, total_disparities, what)
    if radius < 0:
        raise ValueError(f"{what}: radius {radius} < 0")
    if count < 1 or d_start < 0 or d_start + count > total_disparities:
        raise ValueError(
            f"{what}: range [{d_start}, {d_start + count}) is empty or leaves "
            f"[0, {total_disparities})"
        )
    k = 2 * radius + 1
    if 255 * k * k * total_disparities + total_disparities >= 2**31:
        raise ValueError(
            f"{what}: a key of radius {radius} and {total_disparities} disparities "
            "does not fit int32"
        )
    if left_gray.device.type == "cpu":
        return fused_block_matching_key_reference(
            left_gray, right_gray, d_start, count, total_disparities, radius
        )
    if left_gray.dim() == 2:
        return _launch_key(left_gray[None], right_gray[None], d_start, count,
                           total_disparities, radius)[0]
    return _launch_key(left_gray, right_gray, d_start, count, total_disparities, radius)
