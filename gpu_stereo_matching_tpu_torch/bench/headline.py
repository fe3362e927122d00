"""Headline benchmark: fused block matching, 1080p, 64 disparities.

The port's counterpart of the top-level ``bench.py``. Prints one JSON line:
frames a second on one card against the 60 fps north-star target
(``BASELINE.md``). ``batch`` random u8 pairs stay resident on the device;
one run is ``reps`` calls of the batched fused kernel (kernel A, one launch
a call), timed between CUDA events; the best of 5 runs after one warm run.
On the CPU (``device="cpu"``, the tests' tiny sizes) the plain twin runs,
timed by the host clock.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.headline`` or
``python -m gpu_stereo_matching_tpu_torch.cli.main bench``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

BASELINE_FPS = 60.0  # north-star target (the reference publishes none)
RUNS = 5


def main(batch: int = 32, reps: int = 4, height: int = 1080, width: int = 1920,
         num_disp: int = 64, radius: int = 5, device="cuda") -> float:
    """Frames a second of the fused kernel over ``batch`` x ``reps`` frames;
    ``reps`` x (1 + 5) launches in all."""
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, card
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching_batched

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy(rng.integers(0, 256, (batch, height, width),
                                                 dtype=np.uint8)).to(dev) for _ in range(2))

    def run():
        for _ in range(reps):
            fused_block_matching_batched(left, right, num_disp, radius)

    best = best_ms(run, RUNS, dev) * 1e-3
    fps = batch * reps / best
    line = {
        "metric": f"block_matching_{height}p_{num_disp}disp_fps_per_chip",
        "value": round(fps, 1),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
    }
    if dev.type == "cuda":
        line["card"] = card()
    print(json.dumps(line), flush=True)
    return fps


if __name__ == "__main__":
    main()
