"""SAD block matching on the unfused path, with the optional post-filters:
SAD volume -> WTA -> [LR consistency] -> [median], as
``gpu_stereo_matching_tpu/models/block_matching.py``.

On a CUDA tensor the volume is the split-phase volume kernel, the argmin the
argmin kernel, the LR check the argmin kernel's right-view body (the right
view's argmin read on the left volume's diagonal, then the check, in one
launch, ``kernels/split_phase.py::lr_check_from_sad``) and the median the
median kernel (``kernels/``); on the CPU each runs its plain twin.
``block_matching_reference`` runs the plain twins on any device, with the
right view as a second volume (``_right_view_sad``), for comparing the
kernels' path on a card.

Under a running ``torch.profiler`` each frame opens the spans ``bm.volume``,
``bm.argmin``, ``bm.lr_check`` and ``bm.median``
(``utils/profiling.py::span``); the reference opens ``bm.right_view`` and a
second ``bm.argmin`` inside its ``bm.lr_check``.
"""

from __future__ import annotations

from typing import Callable

import torch

from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.kernels.split_phase import (  # noqa: F401
    _gather_wx,
    _right_view_sad,
    lr_check_from_sad,
    sad_volume,
    sad_volume_reference,
    wta_from_sad,
)
from gpu_stereo_matching_tpu_torch.ops.postprocess import lr_consistency_mask, median_filter_u8
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity
from gpu_stereo_matching_tpu_torch.utils.profiling import span


def _plain_lr_check(sad, disp, max_diff, out_dtype):
    """The reference's LR check: the right view as a second volume, its
    argmin, the mask and the ``where``."""
    with span("bm.right_view"):
        sad_r = _right_view_sad(sad)
    with span("bm.argmin"):
        disp_r = wta_disparity(sad_r)
    del sad_r
    return torch.where(lr_consistency_mask(disp, disp_r, max_diff), disp, 0).to(out_dtype)


def _disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig,
    volume: Callable,
    wta: Callable,
    lr_check: Callable,
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
        # The median takes the checked map as uint8, with no cast between.
        out_dtype = torch.uint8 if config.median_radius > 0 else torch.int32
        with span("bm.lr_check"):
            disp = lr_check(sad, disp, config.lr_max_diff, out_dtype)
    del sad
    if config.median_radius > 0:
        with span("bm.median"):
            if disp.dtype != torch.uint8:
                disp = disp.to(torch.uint8)
            disp = median_filter_u8(disp, config.median_radius, method=median_method)
            disp = disp.to(torch.int32)
    return disp


def block_matching_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> torch.Tensor:
    """Disparity of a (H, W) uint8 gray pair -> (H, W) int32."""
    return _disparity(
        left_gray, right_gray, config, sad_volume, wta_from_sad, lr_check_from_sad, "auto"
    )


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
        left_gray, right_gray, config, sad_volume_reference, wta_disparity, _plain_lr_check,
        "histogram",
    )


def block_matching_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> torch.Tensor:
    """``block_matching_pipeline`` with every kernel replaced by its plain
    twin, on any device."""
    return _frames(_reference_disparity, left_gray, right_gray, config)
