"""Split-phase block matching: the CUDA kernels of ``csrc/split_phase.cu``
(a materialized SAD volume, then an argmin over d) and their plain twins.

They replace ``gpu_stereo_matching_tpu/kernels/split_phase.py``'s
``sad_volume`` and ``wta_from_sad``. The volume follows the ops path's
formula: ``sad_volume_reference`` is
``aggregate_cost_volume(ad_cost_volume(...))``, whose invalid columns
(``x < d``) cost ``invalid_cost`` times the clipped row count. That differs
from the fused kernel (``kernels/sad_wta.py``) within ``r`` rows of the top
and bottom border, so ``split_phase_block_matching`` is bit-exact with the
ops path, not always with ``fused_block_matching``. The argmin's twin is
``ops/wta.py::wta_disparity`` (ties to the smallest d).

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises. The volume kernel has two hand-written bodies: the strip body of
``csrc/sad_strips.cuh`` (radius 1..7), which it shares with the fused
kernels, and a general body (every other radius up to 112). The choice is
made in C from ``(num_disparities, radius)`` alone;
:func:`volume_kernel_body` and :func:`volume_launch_plan` say which one a
shape takes and how it is launched.
"""

from __future__ import annotations

import torch

from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import BODIES, _plan
from gpu_stereo_matching_tpu_torch.ops.aggregate import aggregate_cost_volume
from gpu_stereo_matching_tpu_torch.ops.cost import ad_cost_volume
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"sad_volume": 0, "wta_from_sad": 0}

# The general body's blocks are 128 or 256 threads wide, 2r + 32 of them at least.
MAX_RADIUS = 112


def sad_volume_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
    invalid_cost: int = 255,
) -> torch.Tensor:
    """Plain twin of the volume kernel: (H, W) uint8 pair -> (D, H, W) int32
    (also at r = 0, where the ops path leaves the volume uint8)."""
    cost = ad_cost_volume(left_gray, right_gray, num_disparities, invalid_cost)
    return aggregate_cost_volume(cost, radius).to(torch.int32)


def volume_kernel_body(num_disparities: int, radius: int) -> str:
    """Which body of the volume kernel ``(num_disparities, radius)`` runs:
    ``"strips"`` or ``"general"``. Builds the library; needs no card."""
    return BODIES[_build.load_library().gsm_sad_volume_body(num_disparities, radius)]


def volume_launch_plan(shape, num_disparities: int, radius: int, device="cuda") -> dict:
    """How the volume kernel launches for an ``(H, W)`` pair on ``device``:
    the fields of :func:`kernels.sad_wta.launch_plan`, and
    ``disparity_parts``, the parts of the disparity range that separate
    blocks of one tile take (1 for the general body)."""
    h, w = shape
    plan = _plan("gsm_sad_volume_plan", (h, w, num_disparities, radius), device)
    tiles = -(-h // plan["tile_rows"]) * -(-w // plan["tile_cols"])
    plan["disparity_parts"] = plan["blocks"] // tiles
    return plan


def _launch_volume(left, right, num_disparities, radius, invalid_cost):
    _build.require_cuda(left, "sad_volume")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("sad_volume: inputs must be contiguous")
    if radius > MAX_RADIUS:
        raise ValueError(f"sad_volume: the kernel takes radius <= {MAX_RADIUS}, got {radius}")
    lib = _build.load_library()
    h, w = left.shape
    out = torch.empty((num_disparities, h, w), dtype=torch.int32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_sad_volume_u8(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            h, w, num_disparities, radius, invalid_cost, stream,
        )
    _build.check(lib, err, "gsm_sad_volume_u8")
    LAUNCHES["sad_volume"] += 1
    return out


def sad_volume(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
    invalid_cost: int = 255,
) -> torch.Tensor:
    """(H, W) uint8 pair -> (D, H, W) int32 clipped-window SAD volume."""
    check_gray_pair(left_gray, right_gray, num_disparities, "sad_volume")
    if left_gray.dim() != 2:
        raise ValueError(f"sad_volume: expected (H, W), got {tuple(left_gray.shape)}")
    if radius < 0:
        raise ValueError(f"sad_volume: radius {radius} < 0")
    if not 0 <= invalid_cost <= 255:
        raise ValueError(f"sad_volume: invalid_cost {invalid_cost} not in [0, 255]")
    if left_gray.device.type == "cpu":
        return sad_volume_reference(left_gray, right_gray, num_disparities, radius, invalid_cost)
    return _launch_volume(left_gray, right_gray, num_disparities, radius, invalid_cost)


def _launch_wta(sad: torch.Tensor) -> torch.Tensor:
    _build.require_cuda(sad, "wta_from_sad")
    if not sad.is_contiguous():
        raise ValueError("wta_from_sad: the volume must be contiguous")
    num_d, h, w = sad.shape
    if h * w >= 2**31:
        raise ValueError(f"wta_from_sad: {h * w} pixels do not fit an int32 index")
    lib = _build.load_library()
    out = torch.empty((h, w), dtype=torch.int32, device=sad.device)
    with torch.cuda.device(sad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_wta_i32(sad.data_ptr(), out.data_ptr(), num_d, h * w, stream)
    _build.check(lib, err, "gsm_wta_i32")
    LAUNCHES["wta_from_sad"] += 1
    return out


def wta_from_sad(sad: torch.Tensor) -> torch.Tensor:
    """(D, H, W) int32 SAD volume -> (H, W) int32 argmin over d, ties to the
    smallest d. Entries may be ``INT32_MAX`` (the right view's fill)."""
    if sad.dim() != 3 or sad.dtype != torch.int32 or min(sad.shape) < 1:
        raise ValueError(
            f"wta_from_sad: expected a non-empty (D, H, W) int32 volume, got "
            f"{tuple(sad.shape)} {sad.dtype}"
        )
    if sad.device.type == "cpu":
        return wta_disparity(sad)
    return _launch_wta(sad)


def split_phase_block_matching(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Disparity of a (H, W) uint8 pair through the materialized volume."""
    return wta_from_sad(sad_volume(left_gray, right_gray, num_disparities, radius))
