"""ST-2 (refined iteration) streaming-video throughput, as
``gpu_stereo_matching_tpu/bench/st2_streaming.py``.

ST-2 is the reference's flagship result (``STMatching/StereoDisparity.cpp:
91-159``): per-view sigma-1 trees, the LR consistency check, color+depth
re-segmentation. It costs three tree filters and two host tree-build
stages a frame. This bench measures the batched streaming path
(``models/segment_tree_stream.py::SegmentTreeST2BatchPipeline``), which
pays them once a group.

Two numbers:

* ``st2_device_<H>x<W>_fps_per_chip_<variant>``: phase 1 (two filters, the
  LR check, median kernel D three times a frame with phase 2) and phase 2
  (the rebuilt tree's filter) group calls on resident data and prebuilt
  plans, between CUDA events (best of 3 after one warm call), over the
  group size, the host's enqueue included. ``device_rate_lean=False``
  (``--resident``) builds the plans in the format that ships the inverse
  perm instead of inverting it on the device.
* ``st2_streaming_e2e_<H>x<W>_fps``: the pipeline over the stream, host
  included, by the host clock ended by a synchronize, after one warm pass.

On the CPU (``device="cpu"``) both run on the host clock.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.st2_streaming --root
DIR [--scene Art] [--resident]``.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import torch

NUM_FRAMES = 32  # frames of the stream


def run_st2_streaming_benchmark(
    root: str,
    scene_name: str = "Art",
    num_frames: int = NUM_FRAMES,
    group_size: int = 8,
    workers: int = 4,
    device_rate_lean: bool = True,
    device="cuda",
) -> float:
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, card
    from gpu_stereo_matching_tpu_torch.bench.st_profile import scene_frames
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.models.segment_tree import (
        _st1_device_group,
        _st2_phase1_group,
        _unpack_phase1,
    )
    from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import (
        SegmentTreeST2BatchPipeline,
    )

    dev = resolve_device(device)
    cfg = SegmentTreeConfig()
    frames = scene_frames(root, scene_name, num_frames)
    pipe = SegmentTreeST2BatchPipeline(cfg, group_size=group_size, workers=workers, device=dev)
    for _ in pipe.process(frames):
        pass

    start = time.perf_counter()
    n_out = 0
    for _ in pipe.process(frames):
        n_out += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    e2e_fps = n_out / (time.perf_counter() - start)
    h, w = frames[0][0].shape[:2]

    # Device rate: both group calls on resident data, the host's rebuild
    # between them done once beforehand.
    group = frames[:group_size]
    num_d, lr = cfg.max_disp_levels, cfg.lr_max_diff
    dev_pipe = SegmentTreeST2BatchPipeline(
        cfg, group_size=group_size, workers=workers, lean=device_rate_lean, device=dev
    )
    with ThreadPoolExecutor(max_workers=workers) as pool:
        lefts, rights, plans1, _n = dev_pipe._sigma1_group(group, pool)
        jl, jr = lefts.to(dev), rights.to(dev)
        p1 = plans1.to(dev)
        disp_l_b, mask_b = _unpack_phase1(_st2_phase1_group(jl, jr, p1, num_d, lr))
        p2 = dev_pipe._final_plans(lefts.numpy(), disp_l_b, mask_b, pool).to(dev)

    def dispatch():
        _st2_phase1_group(jl, jr, p1, num_d, lr)
        _st1_device_group(jl, jr, p2, num_d)

    best = best_ms(dispatch, 3, dev)
    dev_fps = group_size / (best * 1e-3)

    variant = "lean" if device_rate_lean else "resident"
    extra = {"card": card()} if dev.type == "cuda" else {}
    print(json.dumps({
        "metric": f"st2_device_{h}x{w}_fps_per_chip_{variant}",
        "value": round(dev_fps, 2),
        "unit": "frames/sec/chip (phase-1 and phase-2 group calls by CUDA events, the "
                f"host's enqueue included; {variant} plan format)",
        **extra,
    }), flush=True)
    print(json.dumps({
        "metric": f"st2_streaming_e2e_{h}x{w}_fps",
        "value": round(e2e_fps, 2),
        "unit": "frames/sec (host included)",
        **extra,
    }), flush=True)
    return dev_fps


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="directory of Middlebury scenes")
    ap.add_argument("--scene", default="Art")
    ap.add_argument("--resident", action="store_true",
                    help="device rate with plans that ship the inverse perm")
    args = ap.parse_args(argv)
    return run_st2_streaming_benchmark(args.root, args.scene, device_rate_lean=not args.resident)


if __name__ == "__main__":
    main()
