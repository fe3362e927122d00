"""Clipped-window uint8 median: the CUDA kernel ``csrc/ctmf_median.cu``.

It replaces ``gpu_stereo_matching_tpu/kernels/ctmf_median.py::ctmf_median_u8``
with the same contract: the ``(n//2 + 1)``-th smallest valid pixel of each
clipped (2r+1)**2 window, ``valid_mask`` pixels left out like pixels outside
the image, 255 for a window with none, ``radius <= 60``, and ``x`` itself
for ``radius <= 0``. Its plain twin is
``median_filter_u8(..., method="histogram")``.

The kernel itself takes any radius up to 127, where a window's count
(2r+1)**2 still fits its uint16 bins: ``median_u8`` is that entry, which
``median_filter_u8(method="auto")`` takes on a CUDA tensor, so the radii
that the JAX package sends past its CTMF kernel to the histogram path
(60 < r) still run on the card.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
(one launch over all leading dimensions) or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8

# Kernel launches since import (or since a caller reset it to 0).
LAUNCHES = 0

MAX_RADIUS = 60  # the contract of the JAX package's ctmf_median_u8
KERNEL_MAX_RADIUS = 127  # (2r+1)**2 <= 65535: counts fit the uint16 bins


def _launch(x: torch.Tensor, radius: int, valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
    global LAUNCHES
    _build.require_cuda(x, "ctmf_median_u8")
    h, w = x.shape[-2], x.shape[-1]
    frames = x.reshape(-1, h, w).contiguous()
    mask = None if valid_mask is None else valid_mask.to(torch.uint8).contiguous()
    lib = _build.load_library()
    out = torch.empty_like(frames)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_median_u8(
            frames.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            frames.shape[0], h, w, radius, stream,
        )
    _build.check(lib, err, "gsm_median_u8")
    LAUNCHES += 1
    return out.reshape(x.shape)


def median_u8(
    x: torch.Tensor, radius: int, valid_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Median of clipped (2r+1)**2 windows of a (..., H, W) uint8 image,
    ``radius <= 127``."""
    if radius <= 0:
        return x
    if radius > KERNEL_MAX_RADIUS:
        raise ValueError(f"the median kernel supports radius <= {KERNEL_MAX_RADIUS}")
    if x.dim() < 2 or x.dtype != torch.uint8:
        raise ValueError(
            f"ctmf_median_u8: expected a (..., H, W) uint8 image, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if valid_mask is not None and (
        valid_mask.dtype != torch.bool
        or tuple(valid_mask.shape) != tuple(x.shape[-2:])
        or valid_mask.device != x.device
    ):
        raise ValueError(
            f"ctmf_median_u8: valid_mask must be a (H, W) bool tensor on {x.device}, "
            f"got {tuple(valid_mask.shape)} {valid_mask.dtype} on {valid_mask.device}"
        )
    if x.device.type == "cpu":
        return median_filter_u8(x, radius, method="histogram", valid_mask=valid_mask)
    return _launch(x, radius, valid_mask)


def ctmf_median_u8(
    x: torch.Tensor, radius: int, valid_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``median_u8`` under the JAX kernel's contract, ``radius <= 60``."""
    if radius > MAX_RADIUS:
        raise ValueError(f"ctmf_median_u8 supports radius <= {MAX_RADIUS}")
    return median_u8(x, radius, valid_mask)
