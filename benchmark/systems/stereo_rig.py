"""The calibrated rig as a system under test: the program's
``models/streaming.py::StereoRig.process_batch`` built from a configuration,
and the plain reference it is judged by."""

from __future__ import annotations

import numpy as np
import torch


def build(config: dict, device: torch.device):
    """The program's rig for ``config`` on ``device``; its entry is
    ``process_batch``."""
    from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.io.calib_yaml import StereoCalibration
    from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig

    calib = StereoCalibration(**{k: np.asarray(v, np.float64)
                                 for k, v in config["calibration"].items()})
    matcher = BlockMatchingConfig(
        num_disparities=config["num_disparities"],
        sad_radius=config["sad_radius"],
        invalid_cost=float(config["invalid_cost"]),
        lr_consistency=config["lr_consistency"],
        lr_max_diff=config["lr_max_diff"],
        median_radius=config["median_radius"],
    )
    return StereoRig(calib, tuple(config["image_hw"]), matcher, device=device,
                     fused=config["fused"])


def reference(config: dict, device: torch.device, control: bool = False):
    """``(left, right) -> disparities`` by the plain reference on ``device``,
    its maps worked out again from the calibration. ``control`` interpolates
    the front end in bfloat16, the precision below the configuration's."""
    from benchmark.reference import stereo_rig as ref

    maps = [torch.from_numpy(m).to(device) for m in ref.maps(config)]
    dtype = torch.bfloat16 if control else torch.float32
    return lambda left, right: ref.disparities(config, maps, left, right, dtype)
