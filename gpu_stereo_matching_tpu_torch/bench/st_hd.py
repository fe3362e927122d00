"""ST-1 at HD (1280x720): the tree path at a camera's pixel count, as
``gpu_stereo_matching_tpu/bench/st_hd.py``.

The Middlebury scenes every other ST number uses hold about 170,000
pixels; a 720p tree holds 921,600 nodes. The input is a scene's pair
resized to ``size_hw`` with PIL's bilinear filter (as the JAX module does,
so that both see the same pixels) and jittered per frame so that every
tree differs: synthetic content, but the tree build, the plan emit, the
upload and the filter see the HD workload's shape.

One line for the global tree a frame: tree build and plan emit by the host
clock, the plan's size, the first group call, then the group call
(``_st1_device_group``: cost, stride filter, WTA, median kernel D a frame)
between CUDA events, best of ``reps``, the host's enqueue included. Then a
line for each band count of ``bands_list``: per-band trees
(``SegmentTreeBatchPipeline(bands=...)._host_build_group`` on ``workers``
threads, warm then timed), the banded group call
(``_st1_device_group_banded``, D once a band) the same way, its maps'
share more than 2 levels off the global tree's (``bad2_vs_global_pct``),
and whether the host keeps up with the device (``host_solvent``).
``host_cpus`` is this host's core count. JAX's ``compile_plus_first_s`` is
``first_call_s`` here: nothing compiles.

On the CPU (``device="cpu"``) every stage runs on the host clock.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.st_hd --root DIR
[--scene Art]``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def run_st_hd(
    root: str,
    scene_name: str = "Art",
    group_size: int = 4,
    reps: int = 3,
    bands_list=(4, 8),
    workers: int = 4,
    size_hw=(720, 1280),
    device="cuda",
) -> dict:
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, card
    from gpu_stereo_matching_tpu_torch.bench.st_profile import scene_frames
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.models.segment_tree import (
        _st1_device_group,
        _st1_device_group_banded,
    )
    from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import SegmentTreeBatchPipeline
    from gpu_stereo_matching_tpu_torch.tree.builder import build_segment_tree, color_edge_weights
    from gpu_stereo_matching_tpu_torch.tree.stride import converged_stride_batch

    dev = resolve_device(device)
    extra = {"card": card()} if dev.type == "cuda" else {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = SegmentTreeConfig()
    num_d = cfg.max_disp_levels
    frames = scene_frames(root, scene_name, group_size, size_hw)
    h, w = frames[0][0].shape[:2]
    out = {"shape": f"{h}x{w}x{num_d}d", "group": group_size}

    t0 = time.perf_counter()
    trees = [build_segment_tree(color_edge_weights(f[0]), h, w) for f in frames]
    out["tree_build_ms_per_frame"] = round((time.perf_counter() - t0) / group_size * 1e3, 1)
    t0 = time.perf_counter()
    stacked = converged_stride_batch(trees, cfg.sigma)
    out["plan_emit_ms_per_frame"] = round((time.perf_counter() - t0) / group_size * 1e3, 1)
    out["total_pos"] = stacked.total_pos
    out["pad_over_n"] = round(stacked.total_pos / (h * w), 3)
    out["plan_mb_per_frame"] = round(stacked.transport_nbytes / group_size / 1e6, 2)

    plans = stacked.to(dev)
    jl = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    jr = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    last = {}  # the latest call's maps

    def run_global():
        last["maps"] = _st1_device_group(jl, jr, plans, num_d)

    sync()
    t0 = time.perf_counter()
    run_global()
    sync()
    out["first_call_s"] = round(time.perf_counter() - t0, 1)
    best = best_ms(run_global, reps, dev, warmups=0) * 1e-3
    out["device_ms_per_frame"] = round(best / group_size * 1e3, 2)
    out["device_fps_per_chip"] = round(group_size / best, 2)
    global_out = last["maps"].cpu().numpy()
    print(json.dumps({**out, **extra}), flush=True)

    # Per-band trees: B independent trees a frame, built on a pool of
    # threads; the bad-2.0 of the banded maps against the global tree's.
    for bands in bands_list:
        ob = {"shape": out["shape"], "group": group_size, "bands": bands,
              "host_cpus": os.cpu_count()}
        pipe = SegmentTreeBatchPipeline(cfg, group_size=group_size, workers=workers,
                                        bands=bands, device=dev)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pipe._host_build_group(frames, pool)  # warm: the layouts these bands need
            t0 = time.perf_counter()
            _l, _r, stacked_b, _n = pipe._host_build_group(frames, pool)
            ob["host_ms_per_frame"] = round((time.perf_counter() - t0) / group_size * 1e3, 1)
        ob["plan_mb_per_frame"] = round(stacked_b.transport_nbytes / group_size / 1e6, 2)
        pb = stacked_b.to(dev)

        def run_banded(pb=pb, bands=bands):
            last["maps"] = _st1_device_group_banded(jl, jr, pb, num_d, bands)

        best = best_ms(run_banded, reps, dev) * 1e-3
        ob["device_ms_per_frame"] = round(best / group_size * 1e3, 2)
        ob["device_fps_per_chip"] = round(group_size / best, 2)
        resb = last["maps"].cpu().numpy()
        diff = np.abs(resb.astype(np.int32) - global_out.astype(np.int32))
        ob["bad2_vs_global_pct"] = round(float((diff > 2).mean() * 100), 3)
        ob["host_solvent"] = bool(ob["host_ms_per_frame"] <= ob["device_ms_per_frame"])
        print(json.dumps({**ob, **extra}), flush=True)
        out[f"bands{bands}"] = ob
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="directory of Middlebury scenes")
    ap.add_argument("--scene", default="Art")
    args = ap.parse_args(argv)
    return run_st_hd(args.root, args.scene)


if __name__ == "__main__":
    main()
