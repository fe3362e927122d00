"""Post-processing: left-right consistency and the clipped-window median.

As ``gpu_stereo_matching_tpu/ops/postprocess.py``:

* a left pixel is consistent iff ``d > 0``, ``x - d >= 0`` and
  ``|d_L(x) - d_R(x - d)| <= max_diff``;
* the median of a clipped (2r+1)**2 window is its ``(n//2 + 1)``-th
  smallest pixel, ``n`` the number of pixels in the window; with a
  ``valid_mask``, invalid pixels are left out like pixels outside the image.
  A window with no valid pixel gives 255.

``"sort"`` and ``"histogram"`` are plain torch; ``"ctmf"`` is the CUDA
kernel of ``kernels/ctmf_median.py``, which on a CPU tensor runs the
histogram path. The three agree bit for bit. On a CUDA tensor ``"auto"``
launches that kernel for every radius up to 127 and raises beyond it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gpu_stereo_matching_tpu_torch.ops.aggregate import box_filter_sum, window_counts

_SENTINEL = 0x7FFF  # larger than any uint8 sample


def lr_consistency_mask(
    disp_left: torch.Tensor, disp_right: torch.Tensor, max_diff: int = 1
) -> torch.Tensor:
    """Stability mask of the left view (True = consistent, not occluded).

    ``disp_left``/``disp_right`` are (..., H, W) integer disparity maps; the
    right map is sampled at ``x - d_L(x)``.
    """
    w = disp_left.shape[-1]
    dl = disp_left.to(torch.int32)
    src = torch.arange(w, device=dl.device) - dl
    dr = torch.gather(disp_right.to(torch.int32), -1, src.clamp(0, w - 1))
    return (dl > 0) & (src >= 0) & ((dl - dr).abs() <= max_diff)


def _window_valid_counts(
    hw, radius: int, valid_mask: Optional[torch.Tensor], device
) -> torch.Tensor:
    if valid_mask is None:
        return window_counts(hw, radius, device)
    return box_filter_sum(valid_mask.to(torch.int32), radius)


def median_filter_u8(
    x: torch.Tensor,
    radius: int,
    method: str = "auto",
    valid_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Median of clipped (2r+1)**2 windows of a (..., H, W) uint8 image.

    ``method``: ``"sort"`` sorts the (2r+1)**2 shifted copies; ``"histogram"``
    counts, for each gray level v, the window's pixels ``<= v`` with a box
    sum and takes the number of levels whose count is still below the rank;
    ``"ctmf"`` launches the CUDA kernel (r <= 60, the JAX kernel's contract).
    ``"auto"`` launches the kernel for a CUDA tensor (r <= 127; the JAX
    package sends 60 < r to ``"histogram"``, which the port runs on the card
    only as the kernel's twin), and on the CPU picks as the JAX package does
    there: ``"sort"`` for windows of at most 49 pixels, else ``"histogram"``.

    ``valid_mask`` (optional, (H, W) bool) marks the pixels that exist.
    """
    if radius <= 0:
        return x
    if method == "auto":
        if x.device.type != "cpu":
            from gpu_stereo_matching_tpu_torch.kernels.ctmf_median import median_u8

            return median_u8(x, radius, valid_mask)
        if (2 * radius + 1) ** 2 <= 49:
            method = "sort"
        else:
            method = "histogram"
    if method == "ctmf":
        from gpu_stereo_matching_tpu_torch.kernels.ctmf_median import ctmf_median_u8

        return ctmf_median_u8(x, radius, valid_mask)
    if method == "histogram":
        return _median_u8_histogram(x, radius, valid_mask)
    if method != "sort":
        raise ValueError(f"median_filter_u8: unknown method {method!r}")
    h, w = x.shape[-2], x.shape[-1]
    k = 2 * radius + 1
    xi = x.to(torch.int16)
    if valid_mask is not None:
        xi = torch.where(valid_mask, xi, _SENTINEL)
    # All k**2 shifted copies on a new leading axis; out-of-image slots hold
    # the sentinel, so a clipped window sorts them last.
    xp = F.pad(xi, (radius, radius, radius, radius), value=_SENTINEL)
    stack = torch.stack(
        [xp[..., dy : dy + h, dx : dx + w] for dy in range(k) for dx in range(k)]
    )
    stack = torch.sort(stack, dim=0).values
    n = _window_valid_counts((h, w), radius, valid_mask, x.device)
    rank = (n // 2).to(torch.int64).expand(stack.shape[1:])[None]
    med = torch.gather(stack, 0, rank)[0]
    # An empty window picks the sentinel, whose low byte is 255.
    return (med & 0xFF).to(torch.uint8)


# Elements of the indicator stack a pass of the histogram median holds.
_HISTOGRAM_PASS_ELEMENTS = 1 << 25


def _median_u8_histogram(
    x: torch.Tensor, radius: int, valid_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Histogram-CDF median: 255 box sums of the indicator ``x <= v``, taken
    for as many levels at once as keep a pass's stack under
    ``_HISTOGRAM_PASS_ELEMENTS`` (one pass for a small image)."""
    h, w = x.shape[-2], x.shape[-1]
    n = _window_valid_counts((h, w), radius, valid_mask, x.device)
    valid_i = None if valid_mask is None else valid_mask.to(torch.int32)
    rank = n // 2 + 1
    med = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    step = max(1, min(255, _HISTOGRAM_PASS_ELEMENTS // max(x.numel(), 1)))
    for v0 in range(0, 255, step):
        levels = torch.arange(v0, min(v0 + step, 255), device=x.device)
        le = (x.unsqueeze(-3) <= levels[:, None, None]).to(torch.int32)  # (..., levels, H, W)
        if valid_i is not None:
            le = le * valid_i
        med += (box_filter_sum(le, radius) < rank).sum(-3, dtype=torch.int32)
    return med.to(torch.uint8)
