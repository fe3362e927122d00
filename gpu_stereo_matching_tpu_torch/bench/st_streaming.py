"""Segment-tree (ST-1) streaming-video throughput, as
``gpu_stereo_matching_tpu/bench/st_streaming.py``.

Every frame is jittered, so its trees differ: this runs the whole
pipelined path, the C++ host build (weights -> FH spanning tree -> stride
plan) on a pool of threads beside the enqueue of the previous group's
device work (cost -> stride filter -> WTA -> median kernel D), the plans of
a group converged to one layout.

Two numbers:

* ``st1_device_<H>x<W>_fps_per_chip``: one ``_st1_device_group`` call on
  resident data and plans, between CUDA events (best of 3 after one warm
  call), over the group size. The host's enqueue is inside it: the stride
  filter is still plain torch, thousands of launches a frame.
* ``st1_streaming_e2e_<H>x<W>_fps``: ``SegmentTreeBatchPipeline.process``
  over the whole stream, host included, by the host clock ended by a
  synchronize, after one warm pass over the stream (so that every layout
  the stream needs is in the registry).

On the CPU (``device="cpu"``) both run on the host clock.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.st_streaming --root
DIR [--scene Art]``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

NUM_FRAMES = 32  # frames of the stream


def run_st_streaming_benchmark(
    root: str,
    scene_name: str = "Art",
    num_frames: int = NUM_FRAMES,
    group_size: int = 8,
    workers: int = 4,
    device="cuda",
) -> float:
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, card
    from gpu_stereo_matching_tpu_torch.bench.st_profile import scene_frames
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.models.segment_tree import _st1_device_group
    from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import (
        SegmentTreeBatchPipeline,
        _st1_plan,
    )
    from gpu_stereo_matching_tpu_torch.tree.stride import converge_stride_plans

    dev = resolve_device(device)
    frames = scene_frames(root, scene_name, num_frames)
    pipe = SegmentTreeBatchPipeline(
        SegmentTreeConfig(), group_size=group_size, workers=workers, device=dev
    )
    for _ in pipe.process(frames):
        pass

    start = time.perf_counter()
    n_out = 0
    for _ in pipe.process(frames):
        n_out += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fps = n_out / (time.perf_counter() - start)
    h, w = frames[0][0].shape[:2]

    cfg = pipe.config
    group = frames[:group_size]
    plans = converge_stride_plans([lambda im=f[0]: _st1_plan(im, cfg) for f in group]).to(dev)
    jl = torch.from_numpy(np.stack([f[0] for f in group])).to(dev)
    jr = torch.from_numpy(np.stack([f[1] for f in group])).to(dev)
    best = best_ms(lambda: _st1_device_group(jl, jr, plans, cfg.max_disp_levels), 3, dev)
    dev_fps = len(group) / (best * 1e-3)

    extra = {"card": card()} if dev.type == "cuda" else {}
    print(json.dumps({
        "metric": f"st1_device_{h}x{w}_fps_per_chip",
        "value": round(dev_fps, 2),
        "unit": "frames/sec/chip (one group call on resident data by CUDA events, "
                "the host's enqueue included)",
        **extra,
    }), flush=True)
    print(json.dumps({
        "metric": f"st1_streaming_e2e_{h}x{w}_fps",
        "value": round(fps, 2),
        "unit": "frames/sec (host included)",
        **extra,
    }), flush=True)
    return dev_fps


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="directory of Middlebury scenes")
    ap.add_argument("--scene", default="Art")
    args = ap.parse_args(argv)
    return run_st_streaming_benchmark(args.root, args.scene)


if __name__ == "__main__":
    main()
