"""Calibrated-rig streaming pipeline: BGR -> gray -> remap -> block matching.

The port of ``gpu_stereo_matching_tpu/models/streaming.py::StereoRig``. The
rectification maps are computed once per calibration on the host and held
as float32 buffers. Each call runs the front end, gray and remap of both
views in one launch (``kernels/remap.py::rectify_gray_pair``), and then
either the fused SAD + WTA kernel (``fused=True``, the JAX rig's
``use_pallas=True``; a batch is one launch over (B, H, W)) or the unfused
block matching of ``models/block_matching.py`` with its LR and median
post-filters (``fused=False``, the JAX rig's ``use_pallas=False``; a batch
runs frame by frame, as ``jax.lax.map``).

Under a running ``torch.profiler`` the rig opens spans (``utils/profiling.py::
span``): ``rig.process_batch`` around a batch call and, fused,
``rig.match`` around its matcher; ``rig.intake`` around both views' frames
and ``rig.front_end`` in every call; the unfused path's ``bm.*`` spans are
``models/block_matching.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from gpu_stereo_matching_tpu_torch.calib.rectify import rectification_maps_from_calibration
from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu_torch.io.calib_yaml import StereoCalibration
from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.kernels.remap import front_end_tiles, rectify_gray_pair
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import (
    fused_block_matching,
    fused_block_matching_batched,
)
from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu_torch.utils.cache import ArtifactCache, content_key
from gpu_stereo_matching_tpu_torch.utils.profiling import StageTimer, span

# Buffer names of the rig's state, in the order of the JAX rig's ``_maps``.
MAP_NAMES = ("left_map_x", "left_map_y", "right_map_x", "right_map_y")


class StereoRig(nn.Module):
    """Streaming disparity engine for one calibrated stereo rig.

    ``fused`` is the JAX rig's ``use_pallas``: True runs the fused kernel,
    which, as in JAX, ignores ``config.lr_consistency`` and
    ``config.median_radius``; False runs the unfused path, which honours
    them. The rig lives on ``device``: the card by default (it raises where
    there is none), the CPU and the plain torch versions with
    ``device="cpu"``.
    """

    def __init__(
        self,
        calib: StereoCalibration,
        image_size_hw: Tuple[int, int],
        config: BlockMatchingConfig = BlockMatchingConfig(),
        cache: Optional[ArtifactCache] = None,
        device: str | torch.device = "cuda",
        fused: bool = True,
    ) -> None:
        super().__init__()
        self.config = config
        self.fused = fused
        self.image_size_hw = tuple(image_size_hw)
        dev = resolve_device(device)
        cache = cache or ArtifactCache()
        key = content_key(
            "rectify-maps",
            calib.left_intrinsics, calib.left_distortion,
            calib.right_intrinsics, calib.right_distortion,
            calib.rotation, calib.translation, self.image_size_hw,
        )
        (lmx, lmy), (rmx, rmy) = cache.get_or_compute(
            key, lambda: rectification_maps_from_calibration(calib, self.image_size_hw)
        )
        # Copies: a buffer loaded in place must not write into the cache.
        for name, m in zip(MAP_NAMES, (lmx, lmy, rmx, rmy)):
            self.register_buffer(name, torch.tensor(np.asarray(m, np.float32), device=dev))
        # How the front end will run on these maps: its tiles that take the
        # staged path and those that gather (``kernels/remap.py::front_end_tiles``).
        self.front_end_tiles = front_end_tiles(
            self.image_size_hw, *(getattr(self, name) for name in MAP_NAMES))

    @property
    def device(self) -> torch.device:
        return self.left_map_x.device

    def _frames(self, bgr, ndim: int) -> torch.Tensor:
        t = torch.as_tensor(bgr, device=self.device)
        want = self.image_size_hw + (3,)
        if t.dim() != ndim or tuple(t.shape[-3:]) != want or t.dtype != torch.uint8:
            raise ValueError(
                f"StereoRig: expected {ndim}-D uint8 BGR frames ending in {want}, "
                f"got {tuple(t.shape)} {t.dtype}"
            )
        return t.contiguous()

    def _intake(self, left_bgr, right_bgr, ndim: int):
        with span("rig.intake"):
            return self._frames(left_bgr, ndim), self._frames(right_bgr, ndim)

    def _rectified_gray(self, left, right):
        with span("rig.front_end"):
            return rectify_gray_pair(left, right, self.left_map_x, self.left_map_y,
                                     self.right_map_x, self.right_map_y)

    def forward(self, left_bgr, right_bgr) -> torch.Tensor:
        """(B, H, W, 3) uint8 BGR batches -> (B, H, W) int32 disparities."""
        return self.process_batch(left_bgr, right_bgr)

    def process(self, left_bgr, right_bgr, timer: Optional[StageTimer] = None) -> torch.Tensor:
        """One (H, W, 3) uint8 BGR pair -> (H, W) int32 disparity. With a
        ``timer``, records the stage ``"frame"`` as the JAX rig does: the
        wait, after the frame's work is enqueued, until the device has done
        it."""
        rl, rr = self._rectified_gray(*self._intake(left_bgr, right_bgr, 3))
        if self.fused:
            out = fused_block_matching(
                rl, rr, self.config.num_disparities, self.config.sad_radius
            )
        else:
            out = block_matching_pipeline(rl, rr, self.config)
        if timer is not None:
            with timer.stage("frame", fence=out):
                pass
        return out

    def process_batch(self, left_bgr, right_bgr) -> torch.Tensor:
        """(B, H, W, 3) uint8 BGR batches -> (B, H, W) int32 disparities."""
        with span("rig.process_batch"):
            rl, rr = self._rectified_gray(*self._intake(left_bgr, right_bgr, 4))
            if not self.fused:
                return block_matching_pipeline(rl, rr, self.config)
            with span("rig.match"):
                return fused_block_matching_batched(
                    rl, rr, self.config.num_disparities, self.config.sad_radius
                )


def rig_from_yaml(
    path: str,
    image_size_hw: Tuple[int, int],
    config: BlockMatchingConfig = BlockMatchingConfig(),
    scale_intrinsics_from: Optional[Tuple[int, int]] = None,
    device: str | torch.device = "cuda",
) -> StereoRig:
    """Build a rig from an OpenCV calibration YAML.

    ``scale_intrinsics_from``: the calibration's own resolution (H, W) when
    the rig runs at another ``image_size_hw`` (intrinsics are rescaled).
    """
    from gpu_stereo_matching_tpu_torch.io.calib_yaml import load_opencv_stereo_yaml

    calib = load_opencv_stereo_yaml(path)
    if scale_intrinsics_from is not None:
        sy = image_size_hw[0] / scale_intrinsics_from[0]
        sx = image_size_hw[1] / scale_intrinsics_from[1]
        k1 = calib.left_intrinsics.copy()
        k2 = calib.right_intrinsics.copy()
        k1[0] *= sx
        k1[1] *= sy
        k2[0] *= sx
        k2[1] *= sy
        calib = dataclasses.replace(calib, left_intrinsics=k1, right_intrinsics=k2)
    return StereoRig(calib, image_size_hw, config, device=device)
