"""Gray conversion of BGR uint8 images: the CUDA kernel ``csrc/gray.cu``.

No TPU kernel corresponds to it: the JAX package computes gray as an XLA
``tensordot`` (``gpu_stereo_matching_tpu/ops/color.py``). The kernel
evaluates the same float32 FMA chain that XLA does, one rounding a step,
through the device function of ``csrc/gray.cuh``, which the rig's front end
(``kernels/remap.py::rectify_gray_pair``) applies at every tap. Its plain
twin is :mod:`gpu_stereo_matching_tpu_torch.ops.color`, whose functions
these keep the signatures of.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.ops import color

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

ROUNDINGS = ("half_even", "half_up")
BODIES = ("scalar", "vector")


def gray_kernel_body(img: torch.Tensor, out: torch.Tensor) -> str:
    """Which body a launch on these tensors runs: ``"vector"`` (16-byte
    loads and stores; a tail of fewer than 16 pixels still scalar) when both
    bases are 16-byte aligned, else ``"scalar"``."""
    return BODIES[_build.load_library().gsm_gray_body(img.data_ptr(), out.data_ptr())]


def grayscale_u8(
    img: torch.Tensor, weights: Sequence[float], rounding: str = "half_up"
) -> torch.Tensor:
    """Weighted channel sum of a (..., H, W, 3) uint8 image -> (..., H, W) uint8.

    ``rounding`` is ``"half_up"`` (add 0.5 and floor, in float32) or
    ``"half_even"`` (round to nearest even). The weights are rounded to
    float32, as the plain twin rounds them.
    """
    global LAUNCHES
    if img.dim() < 1 or img.shape[-1] != 3 or img.dtype != torch.uint8:
        raise ValueError(
            f"gray: expected a (..., 3) uint8 image, got {tuple(img.shape)} {img.dtype}"
        )
    if len(weights) != 3:
        raise ValueError(f"gray: expected 3 weights, got {len(weights)}")
    if rounding not in ROUNDINGS:
        raise ValueError(f"unknown rounding mode: {rounding!r}")
    if img.device.type == "cpu":
        return color.grayscale_u8(img, weights, rounding)
    _build.require_cuda(img, "gray")
    src = img.contiguous()
    out = torch.empty(img.shape[:-1], dtype=torch.uint8, device=img.device)
    n = out.numel()
    if n == 0:
        return out
    w = [ctypes.c_float(float(v)) for v in np.asarray(weights, dtype=np.float32)]
    lib = _build.load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_gray_u8(src.data_ptr(), out.data_ptr(), n, *w,
                              ROUNDINGS.index(rounding), stream)
    _build.check(lib, err, "gsm_gray_u8")
    LAUNCHES += 1
    return out


def gray_rec601_bgr(img_bgr: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma of a BGR uint8 image, rounded half up (ST convention)."""
    return grayscale_u8(img_bgr, (0.114, 0.587, 0.299), rounding="half_up")


def gray_blockmatching_bgr(img_bgr: torch.Tensor) -> torch.Tensor:
    """Block-matching gray: the Rec.601 weights applied to (B, G, R) in
    storage order, rounded half to even (the reference's swapped
    convention)."""
    return grayscale_u8(img_bgr, (0.299, 0.587, 0.114), rounding="half_even")
