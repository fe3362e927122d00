"""Time the fused SAD + WTA kernel on the card, one JSON line per shape.

For each ``BxHxW`` shape: the kernel's launch plan (body, tile, blocks,
blocks per SM, waves), whether its result equals the plain twin's on the
batch's first frame, and the warmed median time between CUDA events, per
frame. Every line carries the card's name and power limit as ``nvidia-smi``
gives them. There is no CPU mode: without a card the run raises.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.fused_kernel``
(defaults: 1080x1920 at B=1 and B=32, 720x1280 at B=1 and B=8, D=64, r=5).
To compare two trees, run each tree's module in turns on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.kernels import sad_wta

DEFAULT_SHAPES = ("1x1080x1920", "32x1080x1920", "1x720x1280", "8x720x1280")


def card() -> str:
    """Name and power limit of the first card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after 2 warm-ups."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES), help="BxHxW")
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--radius", type=int, default=5)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda or cuda:N")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("fused_kernel: the kernel runs on a CUDA device only")
    rng = np.random.default_rng(args.seed)
    smi = card()
    for spec in args.shapes:
        shape = tuple(int(n) for n in spec.split("x"))
        left = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        right = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        run = lambda: sad_wta.fused_block_matching_batched(  # noqa: E731
            left, right, args.disparities, args.radius)
        want = sad_wta.fused_block_matching_reference(left[0], right[0], args.disparities,
                                                      args.radius)
        equals_twin = torch.equal(run()[0], want)
        ms = cuda_ms(run, args.reps)
        print(json.dumps({
            "kernel": "fused_block_matching_batched", "shape": list(shape),
            "disparities": args.disparities, "radius": args.radius,
            "plan": sad_wta.launch_plan(shape, args.disparities, args.radius, dev),
            "equals_twin_on_frame_0": equals_twin, "ms_per_frame": ms / shape[0],
            "card": smi,
        }), flush=True)
        if not equals_twin:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
