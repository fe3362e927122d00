"""The calibrated rig as a system under test: the program's
``models/streaming.py::StereoRig.process_batch`` built from a configuration,
the plain reference it is judged by, and the configuration's stand-in at a
CPU test's size."""

from __future__ import annotations

import numpy as np
import torch

# The span that ``StereoRig.process_batch`` opens around a call.
CALL_SPAN = "rig.process_batch"


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


def tiny(config: dict) -> dict:
    """``config`` cut to 40x64 at 16 disparities and a half-window of 2,
    its rig's focal lengths and principal points scaled with it; named
    ``<variant>.tiny`` after the part of its name past the first ``-``."""
    config.update(name=config["name"].split("-", 1)[-1] + ".tiny", image_hw=[40, 64],
                  num_disparities=16, sad_radius=2)
    for key in ("left_intrinsics", "right_intrinsics"):
        k = config["calibration"][key]
        k[0][0] /= 20
        k[1][1] /= 20
        k[0][2], k[1][2] = 32.0, 20.0
    return config
