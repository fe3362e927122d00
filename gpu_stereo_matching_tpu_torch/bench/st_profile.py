"""Stage breakdown of the batched ST-1 streaming path, as
``gpu_stereo_matching_tpu/bench/st_profile.py``.

Separates the group pipeline's costs so that optimization targets the real
bottleneck (the reference's per-stage-timer pattern, ``Device.cu:204-292``):

* host build:   weights -> FH tree -> stride-bucket plan, per frame (C++),
  after one warm build; then the group's plans converged to one layout
  (``tree/stride.py::converge_stride_plans``) and stacked;
* plan upload:  the stacked plan host -> device, synchronized;
* image upload: the stacked frame pairs host -> device, synchronized;
* device:       one ``_st1_device_group`` call on resident data (cost,
  stride filter, WTA, median kernel D a frame) between CUDA events, the
  host's enqueue included: the filter is plain torch, thousands of
  launches a frame; and one frame's ``_st1_device`` the same way;
* fetch:        the group's disparities device -> host.

Each time is the best of ``reps`` after one warm call. The size keys
(``plan_*_mb``, ``images_mb``) are the JAX module's, byte for byte. On the
CPU (``device="cpu"``) every stage runs on the host clock.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.st_profile --root DIR
[--scene Art]`` (a directory of Middlebury scenes).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def scene_frames(root: str, scene_name: str, num_frames: int, size_hw=None) -> list:
    """``num_frames`` (left, right) BGR pairs of a Middlebury scene, each
    view jittered by its own +-6 levels of noise (seed 0) so that every
    frame has its own trees. ``size_hw`` first resizes both views with
    PIL's bilinear filter."""
    from gpu_stereo_matching_tpu_torch.io.middlebury import load_middlebury_scene

    scene = load_middlebury_scene(root, scene_name)
    left, right = scene.left_bgr, scene.right_bgr
    if size_hw is not None:
        from PIL import Image

        def up(img):
            return np.asarray(Image.fromarray(img).resize(size_hw[::-1], Image.BILINEAR))

        left, right = up(left), up(right)
    rng = np.random.default_rng(0)

    def jitter(img):
        noise = rng.integers(-6, 7, img.shape, dtype=np.int16)
        return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    return [(jitter(left), jitter(right)) for _ in range(num_frames)]


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def run_profile(
    root: str,
    scene_name: str = "Art",
    group_size: int = 8,
    reps: int = 3,
    device="cuda",
) -> dict:
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, card, wall_ms
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.models.segment_tree import _st1_device, _st1_device_group
    from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import _st1_plan
    from gpu_stereo_matching_tpu_torch.tree.stride import converge_stride_plans

    dev = resolve_device(device)
    cfg = SegmentTreeConfig()
    frames = scene_frames(root, scene_name, group_size)
    out = {}

    # Host build, per frame, after one warm call (the tree library loaded,
    # the layout registry grown by the first frame).
    _st1_plan(frames[0][0], cfg)
    t0 = time.perf_counter()
    for f in frames:
        _st1_plan(f[0], cfg)
    out["host_build_ms_per_frame"] = (time.perf_counter() - t0) / group_size * 1e3
    stacked = converge_stride_plans([lambda im=f[0]: _st1_plan(im, cfg) for f in frames])
    out["plan_ints_mb"] = _nbytes(stacked.ints) / 1e6
    out["plan_codes_mb"] = _nbytes(stacked.codes) / 1e6
    out["plan_res_mb"] = _nbytes(stacked.res) / 1e6
    out["plan_flg_mb"] = _nbytes(stacked.flg) / 1e6
    out["plan_total_mb_per_frame"] = stacked.transport_nbytes / group_size / 1e6

    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    out["images_mb"] = lefts.nbytes * 2 / 1e6

    out["plan_upload_ms"] = wall_ms(lambda: stacked.to(dev), reps, dev)
    out["image_upload_ms"] = wall_ms(
        lambda: (torch.tensor(lefts, device=dev), torch.tensor(rights, device=dev)), reps, dev)

    p = stacked.to(dev)
    jl, jr = torch.from_numpy(lefts).to(dev), torch.from_numpy(rights).to(dev)
    num_d = cfg.max_disp_levels
    best = best_ms(lambda: _st1_device_group(jl, jr, p, num_d), reps, dev)
    out["device_group_ms"] = best
    out["device_ms_per_frame"] = best / group_size

    # One frame's call for comparison.
    p1 = p.frame(0)
    out["device_single_ms"] = best_ms(lambda: _st1_device(jl[0], jr[0], p1, num_d), reps, dev)

    # Result fetch.
    res = _st1_device_group(jl, jr, p, num_d)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res.to("cpu", copy=True).numpy()
    out["fetch_ms"] = (time.perf_counter() - t0) * 1e3

    line = {k: round(v, 2) for k, v in out.items()}
    if dev.type == "cuda":
        line["card"] = card()
    print(json.dumps(line), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="directory of Middlebury scenes")
    ap.add_argument("--scene", default="Art")
    args = ap.parse_args(argv)
    return run_profile(args.root, args.scene)


if __name__ == "__main__":
    main()
