"""Bilinear uint8 remap: the CUDA kernel ``csrc/remap.cu``.

Its plain twin is :func:`gpu_stereo_matching_tpu_torch.ops.remap.remap_bilinear_u8`.
The TPU kernel it replaces (``remap_bilinear_u8_planned``) sweeps a
host-built offset plan because the TPU cannot gather per pixel; the CUDA
kernel gathers its four taps directly, so no plan exists here.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.ops.remap import remap_bilinear_u8

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0


def _check(src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> None:
    if src.dim() not in (2, 3) or src.dtype != torch.uint8:
        raise ValueError(
            f"remap: expected a (H, W) or (B, H, W) uint8 source, got "
            f"{tuple(src.shape)} {src.dtype}"
        )
    if src.shape[-2] < 2 or src.shape[-1] < 2:
        raise ValueError(f"remap: source {tuple(src.shape)} is smaller than 2x2")
    if map_x.dim() != 2 or map_x.shape != map_y.shape:
        raise ValueError(
            f"remap: maps must be equal-shape 2-D, got {tuple(map_x.shape)} "
            f"vs {tuple(map_y.shape)}"
        )
    if map_x.dtype != torch.float32 or map_y.dtype != torch.float32:
        raise TypeError(f"remap: maps must be float32, got {map_x.dtype}/{map_y.dtype}")
    if not (src.device == map_x.device == map_y.device):
        raise ValueError(
            f"remap: source on {src.device}, maps on {map_x.device}/{map_y.device}"
        )


def remap_bilinear_u8_direct(
    src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor
) -> torch.Tensor:
    """Remap (H, W) or (B, H, W) uint8 through (Ho, Wo) float32 maps.

    A batch is one launch.
    """
    global LAUNCHES
    _check(src, map_x, map_y)
    if src.device.type == "cpu":
        return remap_bilinear_u8(src, map_x, map_y)
    _build.require_cuda(src, "remap")
    if not (src.is_contiguous() and map_x.is_contiguous() and map_y.is_contiguous()):
        raise ValueError("remap: source and maps must be contiguous")
    batched = src if src.dim() == 3 else src[None]
    b, hs, ws = batched.shape
    ho, wo = map_x.shape
    lib = _build.load_library()
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_remap_bilinear_u8(
            batched.data_ptr(), map_x.data_ptr(), map_y.data_ptr(), out.data_ptr(),
            b, hs, ws, ho, wo, stream,
        )
    _build.check(lib, err, "gsm_remap_bilinear_u8")
    LAUNCHES += 1
    return out if src.dim() == 3 else out[0]
