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

The argmin kernel has a second body, :func:`lr_check_from_sad`: the right
view's argmin read on the left volume's diagonal, then the left-right
consistency check of the left map against it, in one launch. Its twin is
the plain composition it replaces: the right-view volume
(:func:`_right_view_sad`), its argmin, ``ops/postprocess.py``'s
``lr_consistency_mask`` and the ``torch.where``.

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
from gpu_stereo_matching_tpu_torch.ops.postprocess import lr_consistency_mask
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity

# Kernel launches since import (or since a caller reset them to 0).
LAUNCHES = {"sad_volume": 0, "wta_from_sad": 0, "lr_check_from_sad": 0}

_INT32_MAX = torch.iinfo(torch.int32).max
# The right view's argmins of one row live in a block's shared memory.
MAX_LR_WIDTH = 232448 // 4

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


def _gather_wx(vol: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Gather ``vol[d, y, src[d, x]]`` -> (D, H, W)."""
    return torch.gather(vol, -1, src[:, None, :].expand(vol.shape))


def _right_view_sad(sad: torch.Tensor) -> torch.Tensor:
    """Right-view SAD from the left one: ``right(d, y, x) = left(d, y, x + d)``;
    where ``x + d`` is past the image the entry is ``INT32_MAX``, so WTA
    never picks it. The fill is in place on the gathered volume."""
    num_d, _, w = sad.shape
    src = torch.arange(w, device=sad.device)[None, :] + torch.arange(num_d, device=sad.device)[:, None]
    gathered = _gather_wx(sad, src.clamp(max=w - 1))
    return gathered.masked_fill_((src > w - 1)[:, None, :], _INT32_MAX)


def lr_check_from_sad_reference(
    sad: torch.Tensor, disp_left: torch.Tensor, max_diff: int = 1,
    out_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Plain twin of the right-view body: the right view's argmin and the LR
    check, as the bm+ path composed them in plain torch."""
    disp_right = wta_disparity(_right_view_sad(sad))
    mask = lr_consistency_mask(disp_left, disp_right, max_diff)
    return torch.where(mask, disp_left, 0).to(out_dtype)


def _launch_lr_check(sad, disp_left, max_diff, out_dtype):
    _build.require_cuda(sad, "lr_check_from_sad")
    if not (sad.is_contiguous() and disp_left.is_contiguous()):
        raise ValueError("lr_check_from_sad: the volume and the map must be contiguous")
    if disp_left.device != sad.device:
        raise ValueError(
            f"lr_check_from_sad: the map is on {disp_left.device}, the volume on {sad.device}")
    num_d, h, w = sad.shape
    if h * w >= 2**31:
        raise ValueError(f"lr_check_from_sad: {h * w} pixels do not fit an int32 index")
    if w > MAX_LR_WIDTH:
        raise ValueError(f"lr_check_from_sad: the kernel takes W <= {MAX_LR_WIDTH}, got {w}")
    lib = _build.load_library()
    out = torch.empty((h, w), dtype=out_dtype, device=sad.device)
    with torch.cuda.device(sad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_wta_lr_i32(
            sad.data_ptr(), disp_left.data_ptr(), out.data_ptr(), num_d, h, w, max_diff,
            int(out_dtype == torch.uint8), stream,
        )
    _build.check(lib, err, "gsm_wta_lr_i32")
    LAUNCHES["lr_check_from_sad"] += 1
    return out


def lr_check_from_sad(
    sad: torch.Tensor, disp_left: torch.Tensor, max_diff: int = 1,
    out_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """(D, H, W) int32 left SAD volume and its (H, W) int32 left map -> the
    (H, W) left map with 0 where the LR check fails: ``disp_left`` is kept
    where it is > 0, ``x - disp_left >= 0`` and it differs by at most
    ``max_diff`` from the right view's argmin at ``x - disp_left``. The
    right view's argmin reads ``sad(d, y, x + d)`` over ``x + d < W``, ties
    to the smallest d. ``out_dtype`` is int32 or uint8 (truncating, as
    ``.to(torch.uint8)``)."""
    if sad.dim() != 3 or sad.dtype != torch.int32 or min(sad.shape) < 1:
        raise ValueError(
            f"lr_check_from_sad: expected a non-empty (D, H, W) int32 volume, got "
            f"{tuple(sad.shape)} {sad.dtype}"
        )
    if disp_left.dtype != torch.int32 or tuple(disp_left.shape) != tuple(sad.shape[1:]):
        raise ValueError(
            f"lr_check_from_sad: expected an int32 {tuple(sad.shape[1:])} left map, got "
            f"{tuple(disp_left.shape)} {disp_left.dtype}"
        )
    if out_dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"lr_check_from_sad: out_dtype must be int32 or uint8, got {out_dtype}")
    if not -2**31 <= max_diff < 2**31:
        raise ValueError(f"lr_check_from_sad: max_diff {max_diff} does not fit an int32")
    if sad.device.type == "cpu":
        return lr_check_from_sad_reference(sad, disp_left, max_diff, out_dtype)
    return _launch_lr_check(sad, disp_left, max_diff, out_dtype)


def split_phase_block_matching(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Disparity of a (H, W) uint8 pair through the materialized volume."""
    return wta_from_sad(sad_volume(left_gray, right_gray, num_disparities, radius))
