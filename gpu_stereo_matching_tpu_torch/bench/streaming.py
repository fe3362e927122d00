"""Calibrated-rig streaming throughput (BASELINE config 4), as
``gpu_stereo_matching_tpu/bench/streaming.py``.

End to end per frame: BGR -> gray -> bilinear remap through the rig's
rectification maps (the front end, one launch for both views of a batch)
-> fused block matching (kernel A, one launch a batch). ``num_frames``
random BGR pairs stay resident on the device, as in a double-buffered
capture pipeline; one run is ``reps`` calls of ``rig.process_batch``,
timed between CUDA events; the best of 3 runs after one warm run. On the
CPU (``device="cpu"``) the plain twins run, timed by the host clock.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.streaming --calib
calib.yml`` (an OpenCV stereo YAML calibrated at 800x1280, as the
reference's), or ``--synthetic`` for :func:`synthetic_calibration` (a 720p
rig) written to a temporary YAML.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

RUNS = 3
NUM_FRAMES = 16  # resident frames, one process_batch call's batch


def synthetic_calibration():
    """A 720p stereo pair: ~1000 px focal length, mild distortion, a 60 mm
    baseline and a slight relative rotation."""
    from gpu_stereo_matching_tpu_torch import StereoCalibration

    def rodrigues(v):
        v = np.asarray(v, np.float64)
        t = np.linalg.norm(v)
        k = v / t
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(t) * kx + (1 - np.cos(t)) * kx @ kx

    return StereoCalibration(
        left_intrinsics=np.array([[1002.5, 0, 641.3], [0, 1001.8, 358.9], [0, 0, 1.0]]),
        right_intrinsics=np.array([[998.7, 0, 636.2], [0, 998.1, 362.4], [0, 0, 1.0]]),
        left_distortion=np.array([-0.081, 0.024, 4e-4, -3e-4, 0.0]),
        right_distortion=np.array([-0.077, 0.019, -2e-4, 5e-4, 0.0]),
        rotation=rodrigues([0.0021, -0.0043, 0.0012]),
        translation=np.array([-60.2, 0.35, -0.8]),
    )


def run_streaming_benchmark(
    calib_path: str,
    height: int = 720,
    width: int = 1280,
    calib_size_hw=(800, 1280),
    num_frames: int = NUM_FRAMES,
    num_disparities: int = 64,
    radius: int = 5,
    reps: int = 4,
    device="cuda",
) -> float:
    """Frames a second of ``rig.process_batch`` on resident frames;
    ``reps`` x (1 + 3) calls in all."""
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, card
    from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.models.streaming import rig_from_yaml

    dev = resolve_device(device)
    rig = rig_from_yaml(
        calib_path,
        (height, width),
        BlockMatchingConfig(num_disparities=num_disparities, sad_radius=radius),
        scale_intrinsics_from=calib_size_hw,
        device=dev,
    )
    rng = np.random.default_rng(0)
    lb, rb = (torch.from_numpy(rng.integers(0, 256, (num_frames, height, width, 3),
                                            dtype=np.uint8)).to(dev) for _ in range(2))

    def run():
        for _ in range(reps):
            rig.process_batch(lb, rb)

    best = best_ms(run, RUNS, dev) * 1e-3
    fps = num_frames * reps / best
    line = {
        "metric": f"rig_streaming_{height}p_{num_disparities}disp_fps",
        "value": round(fps, 1),
        "unit": "frames/sec/chip",
    }
    if dev.type == "cuda":
        line["card"] = card()
    print(json.dumps(line), flush=True)
    return fps


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--calib", help="OpenCV stereo calibration YAML")
    src.add_argument("--synthetic", action="store_true",
                     help="the synthetic 720p calibration, written to a temporary YAML")
    args = ap.parse_args(argv)
    if args.calib:
        return run_streaming_benchmark(args.calib)
    from gpu_stereo_matching_tpu_torch.io.calib_yaml import save_opencv_stereo_yaml

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic_calib.yml")
        save_opencv_stereo_yaml(path, synthetic_calibration())
        return run_streaming_benchmark(path, calib_size_hw=(720, 1280))


if __name__ == "__main__":
    main()
