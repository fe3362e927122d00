"""Bilinear uint8 remap and the rig's front end: the CUDA kernel ``csrc/remap.cu``.

The TPU kernel it replaces (``remap_bilinear_u8_planned``) sweeps a
host-built offset plan because the TPU cannot gather per pixel; the CUDA
kernel gathers its taps directly, so no plan exists here. One body serves
two entries:

- :func:`remap_bilinear_u8_direct`, the TPU kernel's contract: (H, W) or
  (B, H, W) uint8 through (Ho, Wo) float32 maps. Plain twin:
  :func:`gpu_stereo_matching_tpu_torch.ops.remap.remap_bilinear_u8`.
- :func:`rectify_gray_pair`, the rig's front end: both views' BGR frames to
  rectified gray in one launch, each tap turned into gray by the gray
  kernel's device function before the interpolation. Plain twin:
  :func:`gpu_stereo_matching_tpu_torch.ops.remap.rectify_gray_pair`.

A thread owns 8 output pixels in two groups of 4 adjacent ones, reads their
maps once and loops over the frames. The C entry takes the vector body (a
group's maps as 16-byte loads, its bytes as one 4-byte store a frame) where
Ho * Wo is a multiple of 4 and the maps and the output are aligned, else
the scalar body; :data:`BODY_LAUNCHES` counts the launches of each and
:func:`front_end_plan` says how a shape launches.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import _plan
from gpu_stereo_matching_tpu_torch.ops import remap as plain

# Kernel launches since import (or since a caller reset them to 0): the u8
# remap entry, the front-end entry, and both entries' launches by body.
LAUNCHES = 0
PAIR_LAUNCHES = 0
BODIES = ("scalar", "vector")
BODY_LAUNCHES = dict.fromkeys(BODIES, 0)
_PLAN_FIELDS = ("pixels_per_thread", "threads", "blocks", "blocks_per_sm", "sms",
                "pixels_per_group")


def _check_maps(what: str, map_x: torch.Tensor, map_y: torch.Tensor) -> None:
    if map_x.dim() != 2 or map_x.shape != map_y.shape:
        raise ValueError(
            f"{what}: maps must be equal-shape 2-D, got {tuple(map_x.shape)} "
            f"vs {tuple(map_y.shape)}"
        )
    if map_x.dtype != torch.float32 or map_y.dtype != torch.float32:
        raise TypeError(f"{what}: maps must be float32, got {map_x.dtype}/{map_y.dtype}")


def _check(src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> None:
    if src.dim() not in (2, 3) or src.dtype != torch.uint8:
        raise ValueError(
            f"remap: expected a (H, W) or (B, H, W) uint8 source, got "
            f"{tuple(src.shape)} {src.dtype}"
        )
    if src.shape[-2] < 2 or src.shape[-1] < 2:
        raise ValueError(f"remap: source {tuple(src.shape)} is smaller than 2x2")
    _check_maps("remap", map_x, map_y)
    if not (src.device == map_x.device == map_y.device):
        raise ValueError(
            f"remap: source on {src.device}, maps on {map_x.device}/{map_y.device}"
        )


def _launch(entry: str, tensors, out: torch.Tensor, shape) -> None:
    """Call C entry ``entry`` on the tensors' pointers and ``shape``, on the
    current stream of ``out``'s device, and count the body it ran."""
    lib = _build.load_library()
    body = ctypes.c_int(-1)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), out.data_ptr(), *shape,
                                  ctypes.byref(body), stream)
    _build.check(lib, err, entry)
    BODY_LAUNCHES[BODIES[body.value]] += 1


def remap_bilinear_u8_direct(
    src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor
) -> torch.Tensor:
    """Remap (H, W) or (B, H, W) uint8 through (Ho, Wo) float32 maps.

    A batch is one launch, which reads the maps once.
    """
    global LAUNCHES
    _check(src, map_x, map_y)
    if src.device.type == "cpu":
        return plain.remap_bilinear_u8(src, map_x, map_y)
    _build.require_cuda(src, "remap")
    if not (src.is_contiguous() and map_x.is_contiguous() and map_y.is_contiguous()):
        raise ValueError("remap: source and maps must be contiguous")
    batched = src if src.dim() == 3 else src[None]
    b, hs, ws = batched.shape
    ho, wo = map_x.shape
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=src.device)
    _launch("gsm_remap_bilinear_u8", (batched, map_x, map_y), out, (b, hs, ws, ho, wo))
    LAUNCHES += 1
    return out if src.dim() == 3 else out[0]


def rectify_gray_pair(
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    left_map_x: torch.Tensor,
    left_map_y: torch.Tensor,
    right_map_x: torch.Tensor,
    right_map_y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views' (H, W, 3) or (B, H, W, 3) uint8 BGR frames -> their
    block-matching gray, remapped through each view's (Ho, Wo) float32 maps:
    two (Ho, Wo) or (B, Ho, Wo) uint8 tensors, views of one output.

    On the card, one launch for both views and every frame.
    """
    global PAIR_LAUNCHES
    if (left_bgr.dim() not in (3, 4) or left_bgr.shape[-1] != 3
            or left_bgr.dtype != torch.uint8 or right_bgr.shape != left_bgr.shape
            or right_bgr.dtype != torch.uint8):
        raise ValueError(
            f"rectify_gray_pair: expected two equal (H, W, 3) or (B, H, W, 3) uint8 BGR "
            f"batches, got {tuple(left_bgr.shape)} {left_bgr.dtype} and "
            f"{tuple(right_bgr.shape)} {right_bgr.dtype}"
        )
    if left_bgr.shape[-3] < 2 or left_bgr.shape[-2] < 2:
        raise ValueError(f"rectify_gray_pair: frames {tuple(left_bgr.shape)} are smaller than 2x2")
    _check_maps("rectify_gray_pair", left_map_x, left_map_y)
    _check_maps("rectify_gray_pair", right_map_x, right_map_y)
    if left_map_x.shape != right_map_x.shape:
        raise ValueError(
            f"rectify_gray_pair: the views' maps differ in shape, {tuple(left_map_x.shape)} "
            f"vs {tuple(right_map_x.shape)}"
        )
    tensors = (left_bgr, right_bgr, left_map_x, left_map_y, right_map_x, right_map_y)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"rectify_gray_pair: tensors on several devices: {[str(t.device) for t in tensors]}"
        )
    if left_bgr.device.type == "cpu":
        return plain.rectify_gray_pair(*tensors)
    _build.require_cuda(left_bgr, "rectify_gray_pair")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rectify_gray_pair: frames and maps must be contiguous")
    b = left_bgr.shape[0] if left_bgr.dim() == 4 else 1
    hs, ws = left_bgr.shape[-3:-1]
    ho, wo = left_map_x.shape
    out = torch.empty((2, b, ho, wo), dtype=torch.uint8, device=left_bgr.device)
    _launch("gsm_rectify_gray_pair", tensors, out, (b, hs, ws, ho, wo))
    PAIR_LAUNCHES += 1
    if left_bgr.dim() == 3:
        return out[0, 0], out[1, 0]
    return out[0], out[1]


def front_end_plan(frame_hw, map_hw, batch: int = 1, views: int = 2, device="cuda") -> dict:
    """How a launch runs on ``device`` for (``batch``, *``frame_hw``)
    sources and ``map_hw`` maps, with aligned allocations: ``views=2`` the
    front end (BGR), ``views=1`` the u8 entry. Its body, the output pixels a
    thread owns, threads per block, blocks, blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the SMs, the
    adjacent pixels of a group and ``waves`` = blocks / (blocks_per_sm * sms)."""
    return _plan("gsm_remap_plan", (views, batch, *frame_hw, *map_hw), device, BODIES,
                 _PLAN_FIELDS)
