"""BASELINE config-3 scale: the segment-tree path at 128 disparities, as
``gpu_stereo_matching_tpu/bench/st_config3.py``.

Two numbers the correctness tests do not give:

* the ST-1 group rate at 128 disparity levels (the config-3 shape): one
  ``_st1_device_group`` call over ``group`` jittered frames on resident
  data and plans, between CUDA events, best of 3 after one warm call, the
  host's enqueue included;
* the per-band step at a band's height: one ``_st1_device`` call on the
  scene's top ``(H // 2) // 8 * 8`` rows with its own tree, the same way;
  what one card of an 8-band ``space`` deployment runs a frame (half this
  scene's height stands in for an eighth of a full-resolution capture).

On the CPU (``device="cpu"``) both run on the host clock.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.st_config3 --root DIR
[--scene Art]``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def run_config3(
    root: str,
    scene_name: str = "Art",
    num_disp: int = 128,
    group: int = 4,
    device="cuda",
) -> dict:
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, card
    from gpu_stereo_matching_tpu_torch.bench.st_profile import scene_frames
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.io.middlebury import load_middlebury_scene
    from gpu_stereo_matching_tpu_torch.models.segment_tree import _st1_device, _st1_device_group
    from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import _st1_plan
    from gpu_stereo_matching_tpu_torch.tree.stride import converge_stride_plans

    dev = resolve_device(device)
    extra = {"card": card()} if dev.type == "cuda" else {}
    cfg = SegmentTreeConfig(max_disp_levels=num_disp)
    frames = scene_frames(root, scene_name, group)
    h, w = frames[0][0].shape[:2]
    stacked = converge_stride_plans([lambda im=f[0]: _st1_plan(im, cfg) for f in frames]).to(dev)
    jl = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    jr = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)

    best = best_ms(lambda: _st1_device_group(jl, jr, stacked, num_disp), 3, dev) * 1e-3
    out = {
        "metric": f"st1_device_{h}x{w}_{num_disp}disp_fps_per_chip",
        "value": round(group / best, 2),
        "unit": "frames/sec/chip (one group call by CUDA events, the host's enqueue included)",
        "ms_per_frame": round(best / group * 1e3, 2),
    }
    print(json.dumps({**out, **extra}), flush=True)

    scene = load_middlebury_scene(root, scene_name)
    hb = (h // 2) // 8 * 8
    band_l, band_r = scene.left_bgr[:hb], scene.right_bgr[:hb]
    plan_b = _st1_plan(np.ascontiguousarray(band_l), cfg).to(dev)
    bl = torch.from_numpy(np.ascontiguousarray(band_l)).to(dev)
    br = torch.from_numpy(np.ascontiguousarray(band_r)).to(dev)
    best_b = best_ms(lambda: _st1_device(bl, br, plan_b, num_disp), 3, dev)
    out_b = {
        "metric": f"st1_band_step_{hb}x{w}_{num_disp}disp_ms",
        "value": round(best_b, 2),
        "unit": "ms/frame/shard (one call by CUDA events, the host's enqueue included)",
    }
    print(json.dumps({**out_b, **extra}), flush=True)
    return {"full": out, "band": out_b}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="directory of Middlebury scenes")
    ap.add_argument("--scene", default="Art")
    args = ap.parse_args(argv)
    return run_config3(args.root, args.scene)


if __name__ == "__main__":
    main()
