"""Roofline accounting on one NVIDIA H100: the least time the card could
take for a function, against the time it took.

The port of ``gpu_stereo_matching_tpu/bench/roofline.py``. The work is
counted for the *function*, whatever implements it: each input byte read
once, each output byte written once, and the operations of its plainest
formulation. The card's peaks are the data sheet's (H100 SXM): 3.35e12
bytes a second of HBM3, and 67e12 32-bit operations a second outside the
tensor cores (the float32 rate; the data sheet gives no separate integer
rate). A bound is the larger of bytes over the first and operations over
the second; a kernel that shows at least that time can be no faster.

Work counts (``chip_smoke.py``'s summary line reads the same functions):

* fused SAD + WTA (kernel A, :func:`fused_sad_work`): per pixel and
  disparity 2 operations for the absolute difference, 2 for the vertical
  and 2 for the horizontal running sum, 2 for the (min, argmin) update;
  per pixel 2 bytes in (the u8 pair) and 4 out (the int32 disparity);
* the remap kernel (B, :func:`remap_work`) and the gray kernel (G,
  :func:`gray_work`), itemized in their docstrings;
* the stride-bucket segment-tree filter (:func:`st_filter_roofline`): the
  row gathers and scan elements of its plan, which are a property of the
  plan, as the JAX module counts them; each row moves ``D`` float32
  values, and each scan element costs 6 operations a disparity, up and
  down.

JAX's keys are kept where they are not TPU units: ``vpu_*`` become
``ops_*``; the row-gather time model of the JAX module is not carried.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.roofline --root DIR``
measures kernel A through the headline (``bench/headline.py``, 1080p and
4K), the rig's front end on ``bench/streaming.py``'s shape, and the filter
by CUDA events on the plan of ``DIR/<scene>``'s left view; each of
``--sad-1080p-ms``, ``--sad-4k-ms``, ``--remap-ms`` and ``--st-ms`` replaces
its measurement with a given time. Without ``--root`` the filter's row says
it was skipped. A measurement needs a card; without one the run raises.
"""

from __future__ import annotations

import argparse
import json

import torch

from gpu_stereo_matching_tpu_torch.bench.streaming import NUM_FRAMES as STREAMING_FRAMES

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
PEAK_OPS_PER_S = 67e12      # 32-bit operations outside the tensor cores, data sheet
PEAK_INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core operations, data sheet


def bound(operations: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate, and which of them it is."""
    t_ops = operations / PEAK_OPS_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def fused_sad_work(height: int, width: int, num_disp: int, frames: int = 1) -> tuple:
    """(operations, bytes) of fused SAD + WTA over ``frames`` (H, W) pairs:
    8 operations per pixel and disparity; 2 bytes in and 4 out per pixel."""
    px = frames * height * width
    return 8 * num_disp * px, 6 * px


def remap_work(frames: int, n: int, views: int, bgr: bool) -> tuple:
    """(operations, bytes) of one launch of the remap kernel over ``views``
    views of ``frames`` frames of ``n`` output pixels. Per output pixel once
    a launch: the maps (8 bytes), two floors, four subtractions and four
    compares (10 operations). Per pixel and frame: 1 (gray) or 3 (BGR) bytes
    in and 1 out; the interpolation's 6 multiplies, 3 adds, the rounding and
    2 clamps (12); from BGR, each of the 4 taps turned into gray first, a
    multiply, two fused multiply-adds, the rounding and 2 clamps (8)."""
    per_frame = 12 + (4 * 8 if bgr else 0)
    return (views * (10 * n + frames * n * per_frame),
            views * (8 * n + frames * n * ((3 if bgr else 1) + 1)))


def gray_work(pixels: int) -> tuple:
    """(operations, bytes) of the gray kernel: per pixel a multiply, two
    fused multiply-adds, the rounding and 2 clamps (8 operations); 3 bytes in,
    1 out."""
    return 8 * pixels, 4 * pixels


def _row(kernel: str, shape: str, measured_ms: float, ops: float, nbytes: float) -> dict:
    t = measured_ms * 1e-3
    b = bound(ops, nbytes)
    return {
        "kernel": kernel,
        "shape": shape,
        "measured_ms": measured_ms,
        "ops": int(ops),
        "hbm_bytes": int(nbytes),
        "ops_util_pct": 100 * ops / t / PEAK_OPS_PER_S,
        "hbm_util_pct": 100 * nbytes / t / PEAK_BYTES_PER_S,
        "bound": b["bound_by"],
        "ops_bound_ms": ops / PEAK_OPS_PER_S * 1e3,
        "hbm_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "bound_ms": b["bound_ms"],
        "measured_over_bound": measured_ms / b["bound_ms"],
    }


def fused_sad_roofline(
    height: int, width: int, num_disp: int, radius: int, measured_ms: float
) -> dict:
    """Fused SAD + WTA on one (H, W) pair taking ``measured_ms``. The radius
    names the shape; the function's work does not grow with it (running
    sums)."""
    return _row("fused_sad_wta", f"{height}x{width}x{num_disp}d_r{radius}", measured_ms,
                *fused_sad_work(height, width, num_disp))


def remap_roofline(
    height: int, width: int, frames: int, measured_ms: float, views: int = 2, bgr: bool = True
) -> dict:
    """One launch of the remap kernel over ``views`` views of ``frames``
    frames at (H, W) taking ``measured_ms``: by default the rig's front end
    (BGR in, both views)."""
    name = "rectify_gray_pair" if bgr else "remap_bilinear_u8"
    return _row(name, f"{views}x{frames}x{height}x{width}", measured_ms,
                *remap_work(frames, height * width, views, bgr))


def st_filter_roofline(plan, num_disp: int, measured_ms: float) -> dict:
    """The stride-bucket filter over ``plan`` (a :class:`tree.stride.StridePlan`)
    at ``num_disp`` levels taking ``measured_ms``.

    Row gathers: the perm in (cost to plan order), one light pull a
    position, the head reorders and the down pass's parent pulls (twice the
    live rounds' head slots), and the inverse perm out. Scan elements: a
    bucket of ``P`` paths at stride ``2**e`` scans ``2**e * P`` positions in
    ``e`` steps; up and down, 6 operations a step and disparity."""
    total = plan.total_pos
    n = plan.num_nodes
    hp = [sum(p for _e, p in row) for row in plan.buckets]
    live = plan.n_real if plan.n_real >= 0 else len(plan.buckets)
    gather_rows = total + total + 2 * sum(hp[:live]) + n
    scan_elems = sum((1 << e) * p * e for row in plan.buckets[:live] for e, p in row)
    scan_ops = 2 * scan_elems * num_disp * 6
    gather_bytes = gather_rows * num_disp * 4
    b = bound(scan_ops, gather_bytes)
    return {
        "kernel": "st_stride_filter",
        "shape": f"N={n}_total={total}_D={num_disp}",
        "measured_ms": measured_ms,
        "gather_rows": int(gather_rows),
        "gather_bytes": int(gather_bytes),
        "gather_hbm_floor_ms": gather_bytes / PEAK_BYTES_PER_S * 1e3,
        "scan_elems": int(scan_elems),
        "scan_ops": int(scan_ops),
        "scan_ops_ms": scan_ops / PEAK_OPS_PER_S * 1e3,
        "bound": b["bound_by"],
        "bound_ms": b["bound_ms"],
        "measured_over_bound": measured_ms / b["bound_ms"],
    }


def front_end_ms(device="cuda", height: int = 720, width: int = 1280,
                 frames: int = STREAMING_FRAMES) -> float:
    """Least milliseconds of the rig's front end (one launch: both views of
    ``frames`` resident BGR frames) by CUDA events, on ``bench/streaming.py``'s
    rig and shape."""
    import numpy as np

    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms
    from gpu_stereo_matching_tpu_torch.bench.streaming import synthetic_calibration
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig

    dev = resolve_device(device)
    rig = StereoRig(synthetic_calibration(), (height, width), device=dev)
    rng = np.random.default_rng(0)
    lb, rb = (torch.from_numpy(rng.integers(0, 256, (frames, height, width, 3),
                                            dtype=np.uint8)).to(dev) for _ in range(2))
    return best_ms(lambda: rig._rectified_gray(lb, rb), 5, dev)


def filter_ms(plan, left_bgr, right_bgr, num_disp: int, device="cuda") -> float:
    """Least milliseconds of the stride filter over ``plan`` on the pair's
    cost volume, by CUDA events on a card."""
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.models.segment_tree import _to_nodes
    from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume
    from gpu_stereo_matching_tpu_torch.tree.stride import tree_filter_nodes_sb

    dev = resolve_device(device)
    cost = color_gradient_cost_volume(torch.from_numpy(left_bgr).to(dev),
                                      torch.from_numpy(right_bgr).to(dev), num_disp)
    nodes, plan_dev = _to_nodes(cost), plan.to(dev)
    return best_ms(lambda: tree_filter_nodes_sb(nodes, plan_dev), 3, dev)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sad-1080p-ms", type=float,
                    help="fused kernel ms a frame at 1080p, D=64 (default: the headline's)")
    ap.add_argument("--sad-4k-ms", type=float,
                    help="fused kernel ms a frame at 2160x3840, D=64 (default: measured)")
    ap.add_argument("--remap-ms", type=float,
                    help=f"the rig's front end ms a launch, {STREAMING_FRAMES} frames at 720p, "
                         "both views (default: measured)")
    ap.add_argument("--st-ms", type=float,
                    help="stride filter ms a frame on the scene's plan (default: measured)")
    ap.add_argument("--root", help="directory of Middlebury scenes, for the filter's plan")
    ap.add_argument("--scene", default="Art")
    args = ap.parse_args(argv)

    from gpu_stereo_matching_tpu_torch.bench import headline

    if args.sad_1080p_ms is None:
        args.sad_1080p_ms = 1000.0 / headline.main()
    if args.sad_4k_ms is None:
        args.sad_4k_ms = 1000.0 / headline.main(batch=8, height=2160, width=3840)
    if args.remap_ms is None:
        args.remap_ms = front_end_ms()
    out = [
        fused_sad_roofline(1080, 1920, 64, 5, args.sad_1080p_ms),
        fused_sad_roofline(2160, 3840, 64, 5, args.sad_4k_ms),
        remap_roofline(720, 1280, STREAMING_FRAMES, args.remap_ms),
    ]
    if args.root is None:
        out.append({"kernel": "st_stride_filter", "skipped": "no --root given"})
    else:
        from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
        from gpu_stereo_matching_tpu_torch.io.middlebury import load_middlebury_scene
        from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import _st1_plan

        cfg = SegmentTreeConfig()
        scene = load_middlebury_scene(args.root, args.scene)
        plan = _st1_plan(scene.left_bgr, cfg)
        if args.st_ms is None:
            args.st_ms = filter_ms(plan, scene.left_bgr, scene.right_bgr, cfg.max_disp_levels)
        out.append(st_filter_roofline(plan, cfg.max_disp_levels, args.st_ms))

    extra = {}
    if torch.cuda.is_available():
        from gpu_stereo_matching_tpu_torch.bench.fused_kernel import card

        extra["card"] = card()
    for row in out:
        print(json.dumps({**row, **extra}), flush=True)
    return out


if __name__ == "__main__":
    main()
