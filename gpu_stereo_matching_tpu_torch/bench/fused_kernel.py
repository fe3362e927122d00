"""Time a block-matching kernel on the card, one JSON line per shape: the
fused SAD + WTA kernel, the key kernel, the SAD-volume kernel, the median
kernel or the rig's front end.

For each ``BxHxW`` shape: the kernel's launch plan (body, tile, blocks,
blocks per SM, waves), whether its result equals the plain twin's on the
batch's first frame, and the warmed median time between CUDA events, per
frame. Every line carries the card's name and power limit as ``nvidia-smi``
gives them. There is no CPU mode: without a card the run raises.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.fused_kernel``
(defaults: 1080x1920 at B=1 and B=32, 720x1280 at B=1 and B=8, D=64, r=5).
With ``--key d_start,count,total`` it times the partial-range key kernel
over that range instead (``--disparities`` is then not read). With
``--volume`` it times the SAD-volume kernel of the bm+ path, which takes
one pair a launch: a ``BxHxW`` shape is then a ring of B pairs launched in
turn, so B=1 reruns one pair that stays in the L2 and a larger B does not.
With ``--median R`` it times the median kernel at radius R the same way, a
``BxHxW`` shape being a ring of B random u8 images launched one at a time,
as the bm+ path launches it once per frame; its line adds the kernel's
device time per launch under ``torch.profiler`` (a launch can take less
than the host's enqueue) and, for the rank-select body, the select loop's
instructions per pixel from the library's SASS.
With ``--front-end`` it times the rig's front end (``rectify_gray_pair``: a
``BxHxW`` shape is B BGR frames a view, both views in one launch, through
smooth maps of a rectification's kind; its plan gives the tiles that take
the staged path) beside the gray kernel over the same left frames and the
u8 remap entry over their gray, each with its device time under
``torch.profiler``.
To compare two trees, run each tree's module in turns on one card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.kernels import (
    _build,
    ctmf_median,
    gray,
    remap,
    sad_wta,
    split_phase,
)
from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8
from gpu_stereo_matching_tpu_torch.ops.remap import rectify_gray_pair

DEFAULT_SHAPES = ("1x1080x1920", "32x1080x1920", "1x720x1280", "8x720x1280")


def card() -> str:
    """Name and power limit of the first card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _sass(library: str) -> str:
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def select_instructions_per_pixel(radius: int, plan: dict) -> float:
    """The median's rank-select body at ``radius``, read from the built
    library's SASS (``cuobjdump -sass``): the instructions of its 8-pass
    select loop (the longest loop that holds no other branch), times 8, over
    the 4 x rows-per-thread pixels a thread selects. Staging, the ranks and
    the store are left out."""
    body = re.split(r"\n\s*Function : ", _sass(str(_build.build())))
    body = next(b for b in body if b.startswith("_") and f"rank_select_kernelILi{radius}E" in
                b.split("\n", 1)[0])
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    at = {int(a, 16): i for i, (a, _) in enumerate(ins)}
    loop = 0
    for i, (_, op) in enumerate(ins):
        target = re.search(r"BRA.*?0x([0-9a-f]+)", op)
        start = at.get(int(target.group(1), 16), i) if target else i
        if start < i and not any("BRA" in o for _, o in ins[start:i]):
            loop = max(loop, i - start + 1)
    rows_per_thread = plan["tile_rows"] // (plan["threads"] // 32)
    return loop * 8 / (4 * rows_per_thread)


def device_ms(fn, reps: int):
    """Mean device time of the kernels that ``reps`` calls of ``fn()`` launch,
    under ``torch.profiler`` after a warm-up; None when the profiler sees no
    device time. The mean is over the kernels the profiler reports, which in
    a short window can be fewer than were launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    return sum(kernels) / len(kernels) / 1e3 if kernels else None


def cuda_ms(fn, reps: int, warmups: int = 2, pick=statistics.median) -> float:
    """``pick`` (the median by default) of the milliseconds of ``reps`` calls
    of ``fn()`` between CUDA events, after ``warmups`` calls."""
    for _ in range(warmups):
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
    return pick(times)


def best_ms(fn, reps: int, device: torch.device, warmups: int = 1) -> float:
    """Least milliseconds of ``reps`` calls of ``fn()`` after ``warmups``:
    between CUDA events on a card (the device's work, and any gap that the
    host's enqueue leaves in the stream), by the host clock on the CPU."""
    if device.type == "cuda":
        return cuda_ms(fn, reps, warmups, min)
    return wall_ms(fn, reps, device, warmups)


def wall_ms(fn, reps: int, device: torch.device, warmups: int = 1, pick=min) -> float:
    """``pick`` (the least by default) of the milliseconds of ``reps`` calls
    of ``fn()`` after ``warmups``, by the host clock, each call ended by a
    synchronize on a card: work that holds the host (copies, tree builds, a
    pipeline)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmups):
        fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return pick(times)


def smooth_maps(h: int, w: int, shift: float = 0.0):
    """float32 maps of a rectification's kind for an (h, w) view: a few
    pixels of smooth warp, mildly scaled, a band near the border outside."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    mx = 0.995 * xx + 3.1 * np.sin(yy / 97.0) + 2.3 + shift
    my = 0.998 * yy + 1.7 * np.cos(xx / 131.0) + 0.6
    return mx.astype(np.float32), my.astype(np.float32)


def time_front_end(rng, dev, shape, reps: int) -> dict:
    """The front end over a (B, H, W) shape, both views, beside the gray
    kernel and the u8 remap: ms by CUDA events and device ms, a launch."""
    b, h, w = shape
    left, right = (torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
                   for _ in range(2))
    maps = [torch.from_numpy(m).to(dev) for s in (0.0, -17.5) for m in smooth_maps(h, w, s)]
    gray_left = gray.gray_blockmatching_bgr(left)
    runs = {
        "rectify_gray_pair": lambda: remap.rectify_gray_pair(left, right, *maps),
        "gray_u8": lambda: gray.gray_blockmatching_bgr(left),
        "remap_bilinear_u8": lambda: remap.remap_bilinear_u8_direct(gray_left, *maps[:2]),
    }
    got = runs["rectify_gray_pair"]()
    want = rectify_gray_pair(left, right, *maps)
    equals = all(torch.equal(g, x) for g, x in zip(got, want))
    times = {name: {"ms": cuda_ms(run, reps), "device_ms": device_ms(run, reps)}
             for name, run in runs.items()}
    return {"kernel": "rectify_gray_pair", "shape": list(shape), "times_per_launch": times,
            "plan": remap.front_end_plan((h, w), (h, w), b, device=dev, maps=maps),
            "equals_twin": equals}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", default=list(DEFAULT_SHAPES), help="BxHxW")
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--key", metavar="D_START,COUNT,TOTAL",
                   help="time the key kernel over this range, not the whole-range kernel")
    p.add_argument("--volume", action="store_true",
                   help="time the SAD-volume kernel, one launch per pair of the batch")
    p.add_argument("--median", type=int, metavar="R",
                   help="time the median kernel at radius R, one launch per image of the batch")
    p.add_argument("--front-end", action="store_true",
                   help="time the rig's front end, the gray kernel and the u8 remap")
    p.add_argument("--radius", type=int, default=5)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda or cuda:N")
    args = p.parse_args(argv)
    if sum(bool(a) for a in (args.key, args.volume, args.median, args.front_end)) > 1:
        p.error("--key, --volume, --median and --front-end exclude each other")
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("fused_kernel: the kernel runs on a CUDA device only")
    rng = np.random.default_rng(args.seed)
    smi = card()
    for spec in args.shapes:
        shape = tuple(int(n) for n in spec.split("x"))
        if args.front_end:
            line = time_front_end(rng, dev, shape, args.reps)
            print(json.dumps({**line, "card": smi}), flush=True)
            if not line["equals_twin"]:
                return 1
            continue
        left = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        right = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        if args.median:
            name, what = "ctmf_median_u8", {}
            run = lambda: [ctmf_median.median_u8(x, args.median) for x in left]  # noqa: E731
            want = median_filter_u8(left[0], args.median, "histogram")
            plan = ctmf_median.median_launch_plan(shape[1:], args.median, dev)
            if plan["body"] == "rank_select":
                what["select_instructions_per_pixel"] = select_instructions_per_pixel(
                    args.median, plan)
        elif args.key:
            d_start, count, total = (int(n) for n in args.key.split(","))
            name, what = "fused_block_matching_key", {"range": [d_start, count, total]}
            run = lambda: sad_wta.fused_block_matching_key(  # noqa: E731
                left, right, d_start, count, total, args.radius)
            want = sad_wta.fused_block_matching_key_reference(
                left[0], right[0], d_start, count, total, args.radius)
            plan = sad_wta.key_launch_plan(shape, count, total, args.radius, dev)
        elif args.volume:
            name, what = "sad_volume", {"disparities": args.disparities}
            run = lambda: [split_phase.sad_volume(l, r, args.disparities, args.radius)  # noqa: E731
                           for l, r in zip(left, right)]
            want = split_phase.sad_volume_reference(left[0], right[0], args.disparities,
                                                    args.radius)
            plan = split_phase.volume_launch_plan(shape[1:], args.disparities, args.radius, dev)
        else:
            name, what = "fused_block_matching_batched", {"disparities": args.disparities}
            run = lambda: sad_wta.fused_block_matching_batched(  # noqa: E731
                left, right, args.disparities, args.radius)
            want = sad_wta.fused_block_matching_reference(left[0], right[0], args.disparities,
                                                          args.radius)
            plan = sad_wta.launch_plan(shape, args.disparities, args.radius, dev)
        equals_twin = torch.equal(run()[0], want)
        ms = cuda_ms(run, args.reps)
        if args.median:
            # A launch can take less than its enqueue: the device's own time.
            what["device_ms_per_frame"] = device_ms(run, args.reps)
        print(json.dumps({
            "kernel": name, "shape": list(shape), **what,
            "radius": args.median or args.radius,
            "plan": plan,
            "equals_twin_on_frame_0": equals_twin, "ms_per_frame": ms / shape[0],
            "card": smi,
        }), flush=True)
        if not equals_twin:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
