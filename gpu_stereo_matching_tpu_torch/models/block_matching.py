"""SAD block matching on the unfused path, with the optional post-filters:
SAD volume -> WTA -> [LR consistency] -> [median], as
``gpu_stereo_matching_tpu/models/block_matching.py``.

On a CUDA tensor the volume is the split-phase volume kernel, both argmins
the argmin kernel and the median the median kernel (``kernels/``); on the
CPU each runs its plain twin. ``block_matching_reference`` runs the plain
twins on any device, for comparing the kernels' path on a card.

Under a running ``torch.profiler`` each frame opens the spans ``bm.volume``,
``bm.argmin`` (one a volume), ``bm.right_view``, ``bm.lr_check`` and
``bm.median`` (``utils/profiling.py::span``).
"""

from __future__ import annotations

from typing import Callable

import torch

from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.kernels.split_phase import (
    sad_volume,
    sad_volume_reference,
    wta_from_sad,
)
from gpu_stereo_matching_tpu_torch.ops.postprocess import lr_consistency_mask, median_filter_u8
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity
from gpu_stereo_matching_tpu_torch.utils.profiling import span

_INT32_MAX = torch.iinfo(torch.int32).max


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


def _disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig,
    volume: Callable,
    wta: Callable,
    median_method: str,
) -> torch.Tensor:
    with span("bm.volume"):
        sad = volume(
            left_gray, right_gray, config.num_disparities, config.sad_radius,
            int(config.invalid_cost),
        )
    with span("bm.argmin"):
        disp = wta(sad)
    if config.lr_consistency:
        with span("bm.right_view"):
            sad_r = _right_view_sad(sad)
        del sad  # at most two volumes live at once
        with span("bm.argmin"):
            disp_r = wta(sad_r)
        del sad_r
        with span("bm.lr_check"):
            mask = lr_consistency_mask(disp, disp_r, config.lr_max_diff)
            disp = torch.where(mask, disp, 0)
    if config.median_radius > 0:
        with span("bm.median"):
            disp = median_filter_u8(
                disp.to(torch.uint8), config.median_radius, method=median_method
            ).to(torch.int32)
    return disp


def block_matching_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> torch.Tensor:
    """Disparity of a (H, W) uint8 gray pair -> (H, W) int32."""
    return _disparity(left_gray, right_gray, config, sad_volume, wta_from_sad, "auto")


def _frames(fn, left_gray, right_gray, config) -> torch.Tensor:
    check_gray_pair(left_gray, right_gray, config.num_disparities, "block_matching")
    if left_gray.dim() == 3:
        return torch.stack([fn(l, r, config) for l, r in zip(left_gray, right_gray)])
    return fn(left_gray, right_gray, config)


def block_matching_pipeline(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> torch.Tensor:
    """Checked (H, W) or (B, H, W) block matching -> int32 disparities; a
    batch runs frame by frame."""
    return _frames(block_matching_disparity, left_gray, right_gray, config)


def _reference_disparity(left_gray, right_gray, config):
    return _disparity(
        left_gray, right_gray, config, sad_volume_reference, wta_disparity, "histogram"
    )


def block_matching_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> torch.Tensor:
    """``block_matching_pipeline`` with every kernel replaced by its plain
    twin, on any device."""
    return _frames(_reference_disparity, left_gray, right_gray, config)
