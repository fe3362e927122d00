"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, time.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.

Phases, each printing its own line:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``gpu_stereo_matching_tpu_torch/kernels/csrc``;
3. fused SAD + WTA kernel vs its plain twin on the card, bit-exact, on edge
   shapes and at 1080x1920 D=64 r=5 with B=1 and B=4, then on structured
   inputs (constant images, two-level images, 255 against 0, a shifted
   pair) at shapes that leave ragged tiles and strips, with odd D, D = W
   and B = 3; the line counts the cases each of the kernel's two bodies
   ran, and the phase fails if a body ran none or if (D, r) = (64, 5) does
   not take the strip body;
4. remap kernel vs its plain twin at 720x1280 through a rig's maps;
5. gray conversion on the card vs on the CPU over all 2**24 BGR triples;
6. the main path: a 720x1280, D=64, r=5 StereoRig from a synthetic
   calibration runs ``process`` on 3 pairs (with a ``StageTimer``, which
   must hold one fenced ``"frame"`` span per pair) and ``process_batch`` on
   8; results bit-exact against the plain path on the card, and both
   kernels' launch counters must have risen during this phase;
7. CUDA-event timings (warmed, median of several runs) of each kernel beside
   its plain twin and of the rig, printed as JSON lines, with the fused
   kernel's launch plan (body, tile, blocks, blocks per SM, waves); then 10
   batches of the rig under ``torch.profiler``: device time per call by
   part (fused kernel, remap, gray and the rest) and the idle share;
8. split-phase SAD volume and argmin kernels vs their plain twins on the
   card, bit-exact, on the edge shapes and at 1080x1920 D=64 r=5; the
   argmin also on right-view volumes, which hold INT32_MAX. Then the volume
   kernel on the structured inputs of phase 3 at shapes that leave ragged
   tiles (W = 128k + 1, H = 32k + 1), with H < r, odd D, D = W, widths that
   are no multiple of 4, every r of 1..7 and ``invalid_cost`` in {0, 1, 128,
   255}; the line counts the cases each of the kernel's two bodies ran, and
   the phase fails if a body ran none or if (D, r) = (64, 5) does not take
   the strip body;
9. median kernel vs its plain twin, bit-exact, on both of its bodies:
   random images at r in {1, 3, 4, 7, 9, 60} and at 1080x1920 with r=3, 5,
   then structured images (constant 0 and 255, a 0/255 checkerboard, two
   levels, a disparity-like map of 0..63 with LR-hole zeros, one odd pixel
   in a constant field) at shapes that leave ragged tiles (W = 128k + 1, a
   1-row last tile), W < 4, H < 2r + 1, H = 1, W = 1 and a (2, H, W) batch,
   every r of the rank-select body, the next r and 60 and 127 on the
   histogram body; each with no mask, a random valid mask and a mask with
   all-invalid windows; and r=127 through ``median_filter_u8(method="auto")``.
   The line counts the cases each body ran, and the phase fails if a body
   ran none or if r=3 at 1080x1920 does not take the rank-select body;
10. the bm+ path (D=64, r=5, LR check, median r=3): ``block_matching_pipeline``
   on two 1080x1920 pairs, a ``fused=False`` rig at 720x1280 (``process`` on
   3 pairs, ``process_batch`` on 4), and the ``bm`` CLI on a 1080p PNG pair;
   each bit-exact against the same path with every kernel replaced by its
   plain twin; the counters are set to 0 before each entry point and must
   read its exact launches just after it;
11. CUDA-event timings at 1080p of the three bm+ kernels beside their twins
   (the volume kernel with its launch plan, on one pair that stays in the
   L2 and over a ring of 8 pairs that do not, beside a plain fill of the
   volume's bytes; the median kernel at r = 1, 3, 5 and 7, at 1080p and
   720p, on a random image and on the bm+ masked disparity map, one image
   and per image over a ring of 8, with its launch plan and its select
   loop's instructions per pixel from the SASS) and of the bm+ frame beside
   its all-plain run, and the bm+ frame's time by stage;
12. the partial-range key kernel vs its plain twin, bit-exact: edge shapes
   (ragged tiles, B = 1 and 3) with ranges that start at 0, at an odd d and
   end at the total, r in {0, 1, 5, 7}; the structured inputs of phase 3 at
   its ragged-tile shapes over the same ranges and, at D = 65 and 129, over
   odd counts from odd and even starts; and the four ranges of D=64 at
   1080x1920. The line counts the cases each of the kernel's two bodies ran,
   and the phase fails if a body ran none or if (count, total, r) = (16, 64,
   5) or (64, 64, 5) does not take the strip body. Then, for D=64 split into
   1, 2, 4 and 8 ranges, the minimum of the ranges' keys mod 64 equals the
   fused kernel at every pixel;
13. the sharded step at full width (1080x1920, D=64, r=5, B=8) on virtual
   meshes on the card of shapes (1,1,1), (1,1,4), (1,4,1), (2,2,2), (1,2,4):
   each equals the fused kernel on the whole frames and the same step
   without the kernel; the key kernel's counter is set to 0 before each
   step and must read data x space x disp after it;
14. the sharded config-2 step (LR check, median r=3) at B=2 on (1,1,1),
   (1,2,2), (1,4,1): the meshes agree at every pixel; the line counts the
   pixels that differ from the single-device bm+ pipeline;
15. ``parallel/launch.py::main`` in-process (``--data 2 --space 2 --disp 2
   --frames 8 --device cuda``), then timings: the key kernel beside the
   fused kernel and its twin at B=1 and per frame at B=8, its launch plan
   for the slabs each mesh of phase 13 hands it, the sharded step per frame
   on each of those meshes beside the fused kernel at B=8, and the step by
   part on (1,1,4) and (1,4,1); and 5 steps on (1,1,4) and (2,2,2) under
   ``torch.profiler``: device time per step by part and the idle share. On
   one card a virtual mesh measures what sharding costs (halo rows computed
   twice, one launch per disparity part plus the minimum, copies), not what
   it gains.

Each kernel's entry of the summary line carries its bound: the least time
the card could take, the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its operations over 67e12 32-bit
operations per second (the float32 rate outside the tensor cores; the data
sheet gives no separate integer rate). Operations are counted from the
separable running-sum form: per pixel and disparity 2 for the absolute
difference, 2 for the vertical and 2 for the horizontal running sum, plus
2 for the (min, argmin) update or 3 for the packed key and its minimum.

Then one JSON line with the kernels' summary, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
TIME_REPS = 7
EDGE_CASES = [  # (B, H, W, D, r): ragged tiles, odd D, r = 0, D = W, r = 6
    (1, 21, 33, 8, 2), (1, 13, 17, 4, 1), (1, 9, 130, 4, 1), (2, 40, 64, 16, 3),
    (1, 16, 257, 12, 4), (1, 24, 40, 7, 2), (1, 24, 40, 8, 6), (1, 30, 120, 63, 5),
    (1, 30, 120, 64, 5), (1, 33, 64, 64, 0), (1, 37, 300, 64, 5), (3, 70, 250, 33, 3),
]
STRUCTURED_CASES = [  # (B, H, W, D, r): W = 128k + 1 and H = 32k + 1 leave a 1-wide tile and a 1-row tile
    (3, 33, 257, 64, 5), (1, 65, 129, 129, 7), (1, 17, 385, 65, 1), (2, 40, 130, 63, 3),
    (3, 33, 257, 63, 0), (1, 40, 130, 64, 8), (1, 65, 129, 129, 9),
]
VOLUME_CASES = [  # (H, W, D, r): ragged tiles, H < r, odd D, D = W, W % 4 != 0, every r of 0..9
    (33, 257, 64, 5), (65, 129, 129, 7), (17, 385, 65, 1), (40, 130, 63, 3), (4, 140, 64, 5),
    (70, 256, 33, 2), (36, 132, 64, 4), (40, 128, 64, 6), (33, 257, 63, 0), (40, 130, 64, 8),
    (65, 129, 129, 9),
]
KEY_RANGES = [  # (d_start, count, total)
    (0, 8, 8), (3, 5, 8), (5, 3, 16), (16, 16, 64), (48, 16, 64), (33, 31, 64), (0, 64, 64),
]
ODD_KEY_RANGES = {  # total -> (d_start, count): odd counts from odd and even starts
    65: [(17, 15), (33, 31), (48, 17)], 129: [(17, 15), (97, 31), (112, 17)],
}
KEY_SHAPES = [(1, 21, 33), (1, 9, 130), (3, 70, 250), (1, 37, 300), (1, 16, 257), (3, 40, 64)]
MESH_SHAPES = [(1, 1, 1), (1, 1, 4), (1, 4, 1), (2, 2, 2), (1, 2, 4)]
# W = 128k + 1 and H = 32k + 1 (also 64k + 1) leave a 1-wide and a 1-row last
# tile; W < 4 and H < 2r + 1; H = 1; W = 1; a batch of 2 that shares its mask.
MEDIAN_SHAPES = [(65, 257), (5, 3), (1, 300), (300, 1), (2, 33, 129)]
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
PEAK_OPS_PER_S = 67e12      # 32-bit operations outside the tensor cores, data sheet


def bound(operations: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate, and which of them it is."""
    t_ops = operations / PEAK_OPS_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def cuda_ms(fn, reps: int = TIME_REPS) -> float:
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


def shifted_pair(rng, dev, shape, shift: int):
    """A random left view and a right view whose content sits ``shift``
    pixels to the left, with +-2 levels of noise: disparity ``shift``."""
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.integers(-2, 3, shape)
    right = np.clip(np.roll(left, -shift, axis=1) + noise, 0, 255).astype(np.uint8)
    return torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)


def median_images(rng, dev, shape):
    """(kind, image) inputs on which a median's faults show: constant 0 and
    255, a 0/255 checkerboard, two levels, a disparity-like map (0..63 in
    runs of 5 columns, a fifth of it LR-hole zeros), one odd pixel in a
    constant field."""
    h, w = shape[-2:]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(dev)

    yield "zeros", put(np.zeros(shape))
    yield "full", put(np.full(shape, 255))
    yield "checkerboard", put(np.broadcast_to(np.add.outer(np.arange(h), np.arange(w)) % 2 * 255,
                                              shape))
    yield "two-level", put(np.where(rng.random(shape) < 0.5, 37, 200))
    runs = np.repeat(rng.integers(0, 64, (*shape[:-1], -(-w // 5))), 5, axis=-1)[..., :w]
    yield "disparity", put(np.where(rng.random(shape) < 0.2, 0, runs))
    odd = np.full(shape, 90)
    odd[..., h // 2, w // 2] = 7
    yield "odd-pixel", put(odd)


def median_masks(rng, dev, hw, r):
    """No mask, a random valid mask, and one with a band of columns that no
    window inside sees."""
    hole = torch.ones(hw, dtype=torch.bool, device=dev)
    hole[:, 5:5 + 2 * min(r, 8) + 3] = False
    return [None, torch.from_numpy(rng.random(hw) > 0.3).to(dev), hole]


def structured_pairs(rng, dev, shape):
    """(kind, left, right) inputs on which a matcher's faults show: every d
    ties (constant: the answer is 0), ties almost everywhere (two levels),
    the largest SAD the radius allows (255 against 0), a known shift."""
    def full(value):
        return torch.full(shape, value, dtype=torch.uint8, device=dev)

    def levels():
        return torch.from_numpy(rng.integers(0, 2, shape, dtype=np.uint8)).to(dev)

    yield "constant", full(77), full(77)
    yield "two-level", levels(), levels()
    yield "255-against-0", full(255), full(0)
    yield ("shifted-pair", *shifted_pair(rng, dev, shape, 9))


def device_profile(run, repeats: int, part_of) -> dict:
    """Device time of ``repeats`` calls of ``run()`` under ``torch.profiler``:
    per call by part (``part_of`` maps a device kernel's name to its part),
    the busy time and the idle share of the window from the first kernel's
    start to the last one's end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    parts = {}
    for e in kernels:
        part = part_of(e.name)
        parts[part] = parts.get(part, 0.0) + e.time_range.end - e.time_range.start
    busy = sum(parts.values())
    if not kernels or busy == 0:
        return {"device_time_seen": False}
    window = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    return {"device_time_seen": True, "calls": repeats, "device_kernels": len(kernels),
            "ms_per_call_by_part": {k: v / repeats / 1e3 for k, v in parts.items()},
            "share_by_part": {k: v / busy for k, v in parts.items()},
            "busy_ms": busy / 1e3, "window_ms": window / 1e3, "idle_share": 1 - busy / window}


def rig_part(name: str) -> str:
    """The part of a rig batch that a device kernel belongs to."""
    if "strip_kernel" in name or "sad_wta_kernel" in name:
        return "fused_sad_wta"
    return "remap" if "remap" in name else "gray_and_rest"


def step_part(name: str) -> str:
    """The part of a sharded step that a device kernel belongs to."""
    if "strip_kernel" in name or "sad_key_kernel" in name:
        return "key_kernel"
    return "copies_minimum_and_rest"


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms, shape):
    """One kernel's entry of the summary line."""
    return {"name": name, "route": "cuda",
            "source": f"gpu_stereo_matching_tpu_torch/kernels/csrc/{source}",
            "replaces": f"gpu_stereo_matching_tpu/kernels/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bnd, "library_ms": library_ms, "shape": shape}


def run_bm_plus_phases(dev, u8, calib) -> list:
    """Phases 8-11: the split-phase and median kernels vs their twins, the
    bm+ path through its three entry points, and the timings. Returns the
    three kernels' entries of the summary line."""
    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from PIL import Image
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import (
        device_ms,
        select_instructions_per_pixel,
    )
    from gpu_stereo_matching_tpu_torch.cli.main import main as cli_main
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median, remap, split_phase
    from gpu_stereo_matching_tpu_torch.models.block_matching import (
        _right_view_sad,
        block_matching_pipeline,
        block_matching_reference,
    )
    from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig
    from gpu_stereo_matching_tpu_torch.ops.color import gray_blockmatching_bgr
    from gpu_stereo_matching_tpu_torch.ops.postprocess import lr_consistency_mask, median_filter_u8
    from gpu_stereo_matching_tpu_torch.ops.remap import remap_bilinear_u8
    from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity

    int32_max = torch.iinfo(torch.int32).max
    rng = np.random.default_rng(SEED + 1)

    def differ(got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            err = int((got.long() - want.long()).abs().max()) if got.shape == want.shape else -1
            raise AssertionError(f"{what}: kernel differs from its twin (max abs err {err})")
        return 0

    # 8. Split-phase kernels vs their twins.
    err_e1 = err_e2 = 0
    right_views = 0
    bodies = {"strips": 0, "general": 0}
    for _, h, w, d, r in EDGE_CASES + [(1, 1080, 1920, 64, 5)]:
        left, right = u8((h, w)), u8((h, w))
        vol = split_phase.sad_volume(left, right, d, r)
        want = split_phase.sad_volume_reference(left, right, d, r)
        err_e1 = max(err_e1, differ(vol, want, f"sad_volume {(h, w, d, r)}"))
        bodies[split_phase.volume_kernel_body(d, r)] += 1
        err_e2 = max(err_e2, differ(split_phase.wta_from_sad(vol), wta_disparity(want),
                                    f"wta_from_sad {(h, w, d, r)}"))
        del want
        vol_r = _right_view_sad(vol)
        if d > 1:
            if int(vol_r.max()) != int32_max:
                raise AssertionError("right-view volume holds no INT32_MAX")
            right_views += 1
        err_e2 = max(err_e2, differ(split_phase.wta_from_sad(vol_r), wta_disparity(vol_r),
                                    f"wta_from_sad right view {(h, w, d, r)}"))
        del vol, vol_r
    torch.cuda.empty_cache()
    structured = 0
    for h, w, d, r in VOLUME_CASES:
        for kind, left, right in structured_pairs(rng, dev, (h, w)):
            for invalid in (0, 1, 128, 255):
                err_e1 = max(err_e1, differ(
                    split_phase.sad_volume(left, right, d, r, invalid),
                    split_phase.sad_volume_reference(left, right, d, r, invalid),
                    f"sad_volume {(h, w, d, r)} invalid_cost={invalid} ({kind})"))
                bodies[split_phase.volume_kernel_body(d, r)] += 1
                structured += 1
    if not all(bodies.values()) or split_phase.volume_kernel_body(64, 5) != "strips":
        raise AssertionError(f"phase 8 must cover both bodies, (64, 5) on strips: {bodies}")
    log("8-split-phase-vs-twin", cases=len(EDGE_CASES) + 1 + structured,
        structured_cases=structured, cases_by_body=bodies,
        body_of_64_5=split_phase.volume_kernel_body(64, 5),
        right_views_with_int32_max=right_views,
        max_abs_err_sad_volume=err_e1, max_abs_err_wta=err_e2, ok=True)

    # 9. Median kernel vs its twin, both bodies.
    err_d = 0
    cases = 0
    bodies = {"rank_select": 0, "histogram": 0}

    def check_d(x, r, m, what):
        nonlocal err_d, cases
        got = ctmf_median.median_u8(x, r, m)
        err_d = max(err_d, differ(got, median_filter_u8(x, r, "histogram", m),
                                  f"median {tuple(x.shape)} r={r} ({what})"))
        bodies[ctmf_median.median_kernel_body(r)] += 1
        cases += 1
        return got

    for shape, r in [((70, 250), 1), ((70, 250), 3), ((70, 250), 4), ((70, 250), 7),
                     ((70, 250), 9), ((150, 260), 60), ((2, 33, 150), 3),
                     ((1080, 1920), 3), ((1080, 1920), 5)]:
        x = u8(shape)
        mask = torch.from_numpy(rng.random(shape[-2:]) > 0.3).to(dev)
        hole = torch.ones(shape[-2:], dtype=torch.bool, device=dev)
        hole[5:30, 10:150] = False  # windows inside see no valid pixel
        for m in (None, mask, hole):
            got = check_d(x, r, m, "random")
            if m is hole and r <= 4 and not bool((got[..., 5 + r:30 - r, 10 + r:150 - r] == 255).all()):
                raise AssertionError("an all-invalid window did not give 255")
    small = max(r for r in range(1, 128) if ctmf_median.median_kernel_body(r) == "rank_select")
    structured = 0
    for shape in MEDIAN_SHAPES:
        for r in [*range(1, small + 1), small + 1, 60, 127]:
            for m in median_masks(rng, dev, shape[-2:], r):
                for kind, x in median_images(rng, dev, shape):
                    check_d(x, r, m, kind)
                    structured += 1
    for value in (0, 255):
        x = torch.full((70, 250), value, dtype=torch.uint8, device=dev)
        for r in (3, 60):
            err_d = max(err_d, differ(ctmf_median.ctmf_median_u8(x, r), x, f"median constant {value}"))
            bodies[ctmf_median.median_kernel_body(r)] += 1
            cases += 1
    # Past the JAX kernel's r <= 60, "auto" takes the kernel up to r = 127.
    x = u8((150, 300))
    before = ctmf_median.LAUNCHES
    got = median_filter_u8(x, 127)
    if ctmf_median.LAUNCHES != before + 1:
        raise AssertionError("median_filter_u8(auto) at r=127 did not launch the kernel")
    err_d = max(err_d, differ(got, median_filter_u8(x, 127, "histogram"), "median r=127"))
    bodies["histogram"] += 1
    cases += 1
    plan_1080_r3 = ctmf_median.median_launch_plan((1080, 1920), 3, dev)
    if not all(bodies.values()) or plan_1080_r3["body"] != "rank_select":
        raise AssertionError(f"phase 9 must cover both bodies, r=3 at 1080p on rank select: "
                             f"{bodies}, {plan_1080_r3}")
    log("9-median-vs-twin", cases=cases, structured_cases=structured, cases_by_body=bodies,
        rank_select_radii=[1, small], body_of_1080p_r3=plan_1080_r3["body"], max_abs_err=err_d,
        ok=True)

    # 10. The bm+ path through its three entry points, counters from 0.
    cfg = BlockMatchingConfig(num_disparities=64, sad_radius=5, lr_consistency=True,
                              lr_max_diff=1, median_radius=3)
    shifts = (9, 23)
    pairs = [shifted_pair(rng, dev, (1080, 1920), s) for s in shifts]
    left2 = torch.stack([p[0] for p in pairs])
    right2 = torch.stack([p[1] for p in pairs])
    rig_hw = (720, 1280)
    rig = StereoRig(calib, rig_hw, cfg, device=dev, fused=False)
    rig_pairs = [(u8((*rig_hw, 3)), u8((*rig_hw, 3))) for _ in range(3)]
    rig_lb, rig_rb = u8((4, *rig_hw, 3)), u8((4, *rig_hw, 3))
    tmp = tempfile.TemporaryDirectory()
    lp, rp, op = (os.path.join(tmp.name, n) for n in ("l.png", "r.png", "d.png"))
    cli_left, cli_right = shifted_pair(rng, dev, (1080, 1920, 3), 17)
    for path, bgr in ((lp, cli_left), (rp, cli_right)):
        Image.fromarray(bgr.cpu().numpy()[..., ::-1].copy()).save(path)  # BGR -> RGB file
    torch.cuda.synchronize()

    def counted(what, want, run):
        """Run one entry point with every counter at 0; its launches must be
        exactly ``want``: E1 once, E2 twice and D once per frame, remap once
        per view and call."""
        split_phase.LAUNCHES.update(sad_volume=0, wta_from_sad=0)
        ctmf_median.LAUNCHES = 0
        remap.LAUNCHES = 0
        out = run()
        torch.cuda.synchronize()
        got = {**split_phase.LAUNCHES, "ctmf_median": ctmf_median.LAUNCHES,
               "remap": remap.LAUNCHES}
        if got != want:
            raise AssertionError(f"{what} launched {got}, not {want}")
        return out, got

    def per_frame(frames, remaps):
        return {"sad_volume": frames, "wta_from_sad": 2 * frames, "ctmf_median": frames,
                "remap": remaps}

    disp2, n_pipeline = counted("block_matching_pipeline", per_frame(2, 0),
                                lambda: block_matching_pipeline(left2, right2, cfg))
    (rig_singles, rig_batch), n_rig = counted(
        "fused=False rig", per_frame(3 + 4, 2 * 3 + 2),
        lambda: ([rig.process(l, r) for l, r in rig_pairs], rig.process_batch(rig_lb, rig_rb)))
    cli_rc, n_cli = counted(
        "bm CLI", per_frame(1, 0),
        lambda: cli_main(["bm", lp, rp, op, "--lr-check", "--median-radius", "3",
                          "--device", "cuda"]))
    if cli_rc != 0:
        raise AssertionError("bm CLI failed")
    launches = {k: n_pipeline[k] + n_rig[k] + n_cli[k] for k in n_pipeline}

    differ(disp2, block_matching_reference(left2, right2, cfg), "bm+ pipeline at 1080p")
    hits = [float((disp2[i][:, 64:] == s).float().mean()) for i, s in enumerate(shifts)]
    if disp2.shape != (2, 1080, 1920) or min(hits) < 0.9:
        raise AssertionError(f"bm+ at 1080p found the true disparity on only {hits}")

    def rig_plain(left_bgr, right_bgr):
        rl = remap_bilinear_u8(gray_blockmatching_bgr(left_bgr), rig.left_map_x, rig.left_map_y)
        rr = remap_bilinear_u8(gray_blockmatching_bgr(right_bgr), rig.right_map_x, rig.right_map_y)
        return block_matching_reference(rl, rr, cfg)

    for (l, r), got in zip(rig_pairs, rig_singles):
        differ(got, rig_plain(l, r), "fused=False rig.process")
    differ(rig_batch, rig_plain(rig_lb, rig_rb), "fused=False rig.process_batch")
    if rig_batch.shape != (4, *rig_hw) or int(rig_batch.min()) < 0 or int(rig_batch.max()) >= 64:
        raise AssertionError("rig disparities outside [0, D)")

    def read_png(path, mode):
        with Image.open(path) as im:
            return np.asarray(im.convert(mode))

    def load_gray(path):
        bgr = read_png(path, "RGB")[..., ::-1].copy()
        return gray_blockmatching_bgr(torch.from_numpy(bgr).to(dev))

    cli_disp = block_matching_reference(load_gray(lp), load_gray(rp), cfg)
    cli_png = torch.tensor(read_png(op, "L"), device=dev)
    differ(cli_png, (cli_disp * 4).clamp(0, 255).to(torch.uint8), "bm CLI output")
    cli_hit = float((cli_disp[:, 64:] == 17).float().mean())
    if cli_hit < 0.9:
        raise AssertionError(f"bm CLI found the true disparity on only {cli_hit}")
    tmp.cleanup()
    log("10-bm-plus-path", config=[64, 5, "lr", 1, "median", 3], pipeline_pairs=[2, 1080, 1920],
        true_disparity_share=hits, rig=[*rig_hw], rig_process_pairs=3, rig_batch=4,
        cli=[1080, 1920], cli_true_disparity_share=cli_hit, launches_pipeline=n_pipeline,
        launches_rig=n_rig, launches_cli=n_cli, ok=True)
    del disp2, left2, right2, rig, rig_pairs, rig_singles, rig_lb, rig_rb, rig_batch, cli_disp
    torch.cuda.empty_cache()

    # 11. Timings at 1080p.
    l1, r1 = pairs[0]
    vol = split_phase.sad_volume(l1, r1, 64, 5)
    t_e1 = cuda_ms(lambda: split_phase.sad_volume(l1, r1, 64, 5))
    p_e1 = cuda_ms(lambda: split_phase.sad_volume_reference(l1, r1, 64, 5), reps=3)
    ring = [(u8((1080, 1920)), u8((1080, 1920))) for _ in range(8)]

    def volumes_of_ring():
        for left, right in ring:
            split_phase.sad_volume(left, right, 64, 5)

    t_e1_ring = cuda_ms(volumes_of_ring) / len(ring)
    del ring
    # What the card takes to write the volume's bytes at all: a plain fill.
    scratch = torch.empty_like(vol)
    t_fill = cuda_ms(lambda: scratch.fill_(1))
    del scratch
    t_e2 = cuda_ms(lambda: split_phase.wta_from_sad(vol))
    p_e2 = cuda_ms(lambda: wta_disparity(vol))
    lib_e2 = cuda_ms(lambda: torch.argmin(vol, dim=0))  # the yardstick, used nowhere in the port
    img = u8((1080, 1920))
    p_d = {r: cuda_ms(lambda: median_filter_u8(img, r, "histogram"), reps=3) for r in (3, 7)}
    log("11-time", kernel="sad_volume", shape=[1080, 1920, 64, 5], ms=t_e1, plain_ms=p_e1,
        ms_per_pair_over_a_ring_of_8=t_e1_ring, fill_of_the_same_bytes_ms=t_fill,
        plan=split_phase.volume_launch_plan((1080, 1920), 64, 5, dev),
        general_body_plan_at_r_8=split_phase.volume_launch_plan((1080, 1920), 64, 8, dev))
    log("11-time", kernel="wta_from_sad", shape=[1080, 1920, 64, 5], ms=t_e2, plain_ms=p_e2)
    t_bm = cuda_ms(lambda: block_matching_pipeline(l1, r1, cfg))
    p_bm = cuda_ms(lambda: block_matching_reference(l1, r1, cfg), reps=3)
    log("11-time", path="bm+", shape=[1080, 1920, 64, 5], median_radius=3, ms_per_frame=t_bm,
        fps=1e3 / t_bm, plain_ms_per_frame=p_bm, plain_fps=1e3 / p_bm)
    disp = split_phase.wta_from_sad(vol)
    vol_r = _right_view_sad(vol)
    disp_r = split_phase.wta_from_sad(vol_r)
    del vol_r
    masked = torch.where(lr_consistency_mask(disp, disp_r, 1), disp, 0)
    stages = {
        "sad_volume": t_e1,
        "right_view_gather": cuda_ms(lambda: _right_view_sad(vol)),
        "wta_from_sad_x2": 2 * t_e2,
        "lr_mask": cuda_ms(lambda: torch.where(lr_consistency_mask(disp, disp_r, 1), disp, 0)),
        "median_r3": cuda_ms(lambda: ctmf_median.ctmf_median_u8(masked.to(torch.uint8), 3)),
    }
    log("11-time", path="bm+ by stage", shape=[1080, 1920, 64, 5], stages_ms=stages,
        sum_ms=sum(stages.values()), frame_ms=t_bm)
    del vol, disp, disp_r
    torch.cuda.empty_cache()

    # The median kernel alone: random images and the bm+ masked disparity
    # map, one image (which stays in the L2) and per image over a ring of 8
    # (the map's ring: the map rolled along its rows by 8 offsets).
    def masked_map(left, right):
        v = split_phase.sad_volume(left, right, 64, 5)
        d = split_phase.wta_from_sad(v)
        d_r = split_phase.wta_from_sad(_right_view_sad(v))
        return torch.where(lr_consistency_mask(d, d_r, 1), d, 0).to(torch.uint8)

    maps = {(1080, 1920): masked.to(torch.uint8),
            (720, 1280): masked_map(*shifted_pair(rng, dev, (720, 1280), 9))}
    del masked
    torch.cuda.empty_cache()
    t_d, dev_d = {}, {}
    instructions = {}
    for hw, bm_map in maps.items():
        inputs = {"random": [u8(hw) for _ in range(8)],
                  "bm_plus_map": [torch.roll(bm_map, 97 * k, dims=1) for k in range(8)]}
        for r in (1, 3, 5, 7):
            ms = {}
            for kind, ring in inputs.items():
                def run_ring():
                    return [ctmf_median.ctmf_median_u8(x, r) for x in ring]

                ms[kind] = {
                    "one_image": cuda_ms(lambda: ctmf_median.ctmf_median_u8(ring[0], r)),
                    "per_image_over_a_ring_of_8": cuda_ms(run_ring) / len(ring),
                    # A launch can take less than its enqueue: the device's own time.
                    "device_per_image": device_ms(run_ring, 5)}
            plan = ctmf_median.median_launch_plan(hw, r, dev)
            if plan["body"] == "rank_select":
                instructions[r] = select_instructions_per_pixel(r, plan)
            if hw == (1080, 1920):
                t_d[r] = ms["random"]["one_image"]
                dev_d[r] = ms["random"]["device_per_image"]
            log("11-time", kernel="ctmf_median", shape=[*hw], radius=r, ms=ms,
                plain_ms=p_d.get(r) if hw == (1080, 1920) else None, plan=plan,
                select_instructions_per_pixel=instructions.get(r))
    del maps, inputs
    torch.cuda.empty_cache()

    px = 1080 * 1920
    return [
        # 6 operations per pixel and disparity; 2 bytes in, 4 * D out per pixel.
        kernel_entry("sad_volume", "split_phase.cu", "split_phase.py:92", launches["sad_volume"],
                     err_e1, t_e1, p_e1, bound(6 * 64 * px, (2 + 4 * 64) * px), None,
                     [1080, 1920, 64, 5]),
        # Compare and select per element; the volume in, the disparities out.
        kernel_entry("wta_from_sad", "split_phase.cu", "split_phase.py:159",
                     launches["wta_from_sad"], err_e2, t_e2, p_e2,
                     bound(2 * 64 * px, (4 * 64 + 4) * px), lib_e2, [64, 1080, 1920]),
        # Huang's form at r=3: 2 (2r + 1) histogram updates and a 32-bin scan
        # per pixel; 1 byte in, 1 out. The least work of the function, so the
        # entry stays comparable with earlier runs; the rank-select body's own count
        # is its select loop's SASS. One launch can take less than its
        # enqueue, so the entry adds the device time under the profiler.
        {**kernel_entry("ctmf_median_u8", "ctmf_median.cu", "ctmf_median.py:169",
                        launches["ctmf_median"], err_d, t_d[3], p_d[3],
                        bound((2 * 7 + 32) * px, 2 * px), None, [1080, 1920, 3]),
         "device_ms": dev_d[3], "select_instructions_per_pixel": instructions.get(3)},
    ]


def run_sharded_phases(dev, u8, t_fused_b1: float) -> dict:
    """Phases 12-15: the key kernel vs its twin, the sharded steps on
    virtual meshes on the card, the launcher, and the timings. Returns the
    key kernel's entry of the summary line."""
    import contextlib
    import io

    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.core.config import MeshConfig
    from gpu_stereo_matching_tpu_torch.kernels import sad_wta
    from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
    from gpu_stereo_matching_tpu_torch.parallel import launch
    from gpu_stereo_matching_tpu_torch.parallel.halo import extend_with_row_halos
    from gpu_stereo_matching_tpu_torch.parallel.mesh import virtual_mesh
    from gpu_stereo_matching_tpu_torch.parallel.stereo import (
        make_sharded_block_matching,
        make_sharded_block_matching_full,
        shard_batch,
        unshard,
    )

    key = sad_wta.fused_block_matching_key
    key_twin = sad_wta.fused_block_matching_key_reference
    hw, num_d, radius = (1080, 1920), 64, 5

    def same(got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{what}: results differ")

    # 12. Kernel C vs its twin (both bodies, random and structured inputs),
    # and the identity that ties it to kernel A.
    cases = structured = 0
    bodies = {"strips": 0, "general": 0}

    def check_c(left, right, d_start, count, total, r, what):
        nonlocal cases
        same(key(left, right, d_start, count, total, r),
             key_twin(left, right, d_start, count, total, r),
             f"key kernel {tuple(left.shape)} {(d_start, count, total)} r={r} ({what})")
        bodies[sad_wta.key_kernel_body(count, total, r)] += 1
        cases += 1

    for shape in KEY_SHAPES:
        for d_start, count, total in KEY_RANGES:
            if total > shape[-1]:
                continue
            for r in (0, 1, 5, 7):
                check_c(u8(shape), u8(shape), d_start, count, total, r, "random")
    rng = np.random.default_rng(SEED + 3)
    for b, h, w, d, r in STRUCTURED_CASES:
        ranges = [rg for rg in KEY_RANGES if rg[2] <= w]
        ranges += [(d_start, count, d) for d_start, count in ODD_KEY_RANGES.get(d, [])]
        for kind, left, right in structured_pairs(rng, dev, (b, h, w)):
            for d_start, count, total in ranges:
                check_c(left, right, d_start, count, total, r, kind)
                structured += 1
    on_strips = [sad_wta.key_kernel_body(count, 64, 5) for count in (16, 64)]
    if not all(bodies.values()) or on_strips != ["strips", "strips"]:
        raise AssertionError(
            f"phase 12 must cover both bodies, (16, 64, 5) and (64, 64, 5) on strips: "
            f"{bodies}, {on_strips}")
    left2, right2 = u8((2, *hw)), u8((2, *hw))
    fused2 = sad_wta.fused_block_matching_batched(left2, right2, num_d, radius)
    splits = []
    for parts in (1, 2, 4, 8):
        count = num_d // parts
        keys = None
        for k in range(parts):
            part = key(left2, right2, k * count, count, num_d, radius)
            if parts == 4:
                same(part, key_twin(left2, right2, k * count, count, num_d, radius),
                     f"key kernel at 1080p, range {k} of 4")
                bodies[sad_wta.key_kernel_body(count, num_d, radius)] += 1
                cases += 1
            keys = part if keys is None else torch.minimum(keys, part)
        same(keys % num_d, fused2, f"minimum over {parts} ranges vs the fused kernel")
        splits.append(parts)
    del left2, right2, fused2, keys, part
    log("12-key-kernel-vs-twin", cases=cases, structured_cases=structured, cases_by_body=bodies,
        body_of_16_64_5=on_strips[0], body_of_64_64_5=on_strips[1], max_abs_err=0,
        splits_equal_fused=splits, ok=True)

    # 13. The sharded step at full width on virtual meshes on the card.
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=radius)
    left8, right8 = u8((8, *hw)), u8((8, *hw))
    fused8 = sad_wta.fused_block_matching_batched(left8, right8, num_d, radius)
    steps = {}
    step_launches = {}
    for shape in MESH_SHAPES:
        mesh = virtual_mesh(MeshConfig(*shape), dev)
        sl, sr = shard_batch(mesh, left8, right8)
        step = make_sharded_block_matching(mesh, cfg)
        torch.cuda.synchronize()
        sad_wta.KEY_LAUNCHES = 0
        got = unshard(step(sl, sr))
        torch.cuda.synchronize()
        step_launches[str(shape)] = sad_wta.KEY_LAUNCHES
        if sad_wta.KEY_LAUNCHES != shape[0] * shape[1] * shape[2]:
            raise AssertionError(
                f"sharded step on {shape} launched the key kernel {sad_wta.KEY_LAUNCHES} times")
        same(got, fused8, f"sharded step on {shape} vs the fused kernel")
        plain = unshard(make_sharded_block_matching(mesh, cfg, use_kernel=False)(sl, sr))
        same(got, plain, f"sharded step on {shape} vs the step without the kernel")
        if sad_wta.KEY_LAUNCHES != step_launches[str(shape)]:
            raise AssertionError("the step without the kernel launched the key kernel")
        steps[shape] = (step, sl, sr)
        del got, plain
    torch.cuda.empty_cache()
    log("13-sharded-step", shape=[8, *hw, num_d, radius], meshes=MESH_SHAPES,
        key_kernel_launches=step_launches, equals_fused_kernel=True,
        equals_step_without_kernel=True, ok=True)

    # 14. The sharded config-2 step.
    cfg2 = BlockMatchingConfig(num_disparities=num_d, sad_radius=radius, lr_consistency=True,
                               lr_max_diff=1, median_radius=3)
    rng = np.random.default_rng(SEED + 2)
    pairs = [shifted_pair(rng, dev, hw, s) for s in (9, 23)]
    left_b = torch.stack([p[0] for p in pairs])
    right_b = torch.stack([p[1] for p in pairs])
    full = {}
    for shape in [(1, 1, 1), (1, 2, 2), (1, 4, 1)]:
        mesh = virtual_mesh(MeshConfig(*shape), dev)
        sl, sr = shard_batch(mesh, left_b, right_b)
        full[shape] = unshard(make_sharded_block_matching_full(mesh, cfg2)(sl, sr))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for shape in [(1, 2, 2), (1, 4, 1)]:
        same(full[shape], full[(1, 1, 1)], f"sharded config-2 step on {shape} vs (1, 1, 1)")
    single = block_matching_pipeline(left_b, right_b, cfg2)
    differ = int((single != full[(1, 1, 1)]).sum())
    hits = [float((full[(1, 1, 1)][i][:, 64:] == s).float().mean()) for i, s in enumerate((9, 23))]
    if min(hits) < 0.9:
        raise AssertionError(f"sharded config-2 step found the true disparity on only {hits}")
    log("14-sharded-config-2", shape=[2, *hw, num_d, radius], median_radius=3,
        meshes=[[1, 1, 1], [1, 2, 2], [1, 4, 1]], meshes_agree=True,
        pixels_differing_from_bm_plus_pipeline=differ, true_disparity_share=hits, ok=True)
    del full, single, left_b, right_b, pairs
    torch.cuda.empty_cache()

    # 15. The launcher, then the timings.
    sad_wta.KEY_LAUNCHES = 0
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        rc = launch.main(["--data", "2", "--space", "2", "--disp", "2", "--frames", "8",
                          "--device", "cuda"])
    torch.cuda.synchronize()
    points = [json.loads(line) for line in captured.getvalue().splitlines()]
    # Two points, (1,2,2) and (2,2,2): 4 and 8 launches a step, 1 warm-up + 3 timed steps each.
    if rc != 0 or [p["devices"] for p in points] != [4, 8] or sad_wta.KEY_LAUNCHES != 48:
        raise AssertionError(f"launch.main: rc {rc}, points {points}, "
                             f"{sad_wta.KEY_LAUNCHES} launches")
    log("15-launch-main", argv="--data 2 --space 2 --disp 2 --frames 8 --device cuda",
        points=points, key_kernel_launches=sad_wta.KEY_LAUNCHES,
        note="virtual mesh on one card: what sharding costs there, not what it gains", ok=True)

    l1, r1 = left8[:1], right8[:1]
    t_c = cuda_ms(lambda: key(l1, r1, 0, 64, 64, 5))
    t_a = cuda_ms(lambda: sad_wta.fused_block_matching_batched(l1, r1, 64, 5))
    p_c = cuda_ms(lambda: key_twin(l1, r1, 0, 64, 64, 5), reps=3)
    t_c16 = cuda_ms(lambda: key(l1, r1, 16, 16, 64, 5))
    p_c16 = cuda_ms(lambda: key_twin(l1, r1, 16, 16, 64, 5), reps=3)
    log("15-time", kernel="sad_wta_key", shape=[1, *hw, 5], range=[0, 64, 64], ms=t_c,
        plain_ms=p_c, fused_kernel_ms=t_a, fused_kernel_ms_phase_7=t_fused_b1,
        plan=sad_wta.key_launch_plan((1, *hw), 64, 64, 5, dev))
    log("15-time", kernel="sad_wta_key", shape=[1, *hw, 5], range=[16, 16, 64], ms=t_c16,
        plain_ms=p_c16, plan=sad_wta.key_launch_plan((1, *hw), 16, 64, 5, dev))
    t_a8 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(left8, right8, 64, 5))
    t_c8 = cuda_ms(lambda: key(left8, right8, 0, 64, 64, 5))
    t_c8_16 = cuda_ms(lambda: key(left8, right8, 16, 16, 64, 5))
    log("15-time", kernel="sad_wta_key", shape=[8, *hw, 5],
        ms_per_frame={"[0, 64, 64]": t_c8 / 8, "[16, 16, 64]": t_c8_16 / 8},
        fused_kernel_ms_per_frame=t_a8 / 8)
    # The slabs a step hands the kernel: the mesh's share of the 8 frames, of
    # the rows (with r halo rows above and below) and of the disparities.
    slab_plans = {}
    for n_data, n_space, n_disp in MESH_SHAPES:
        slab = (left8.shape[0] // n_data, hw[0] // n_space + 2 * radius, hw[1])
        slab_plans[str((n_data, n_space, n_disp))] = {
            "slab": list(slab), "count": num_d // n_disp,
            **sad_wta.key_launch_plan(slab, num_d // n_disp, num_d, radius, dev)}
    log("15-time", kernel="sad_wta_key", launch_plans_of_the_sharded_steps=slab_plans)
    per_frame = {str(shape): cuda_ms(lambda: step(sl, sr)) / 8
                 for shape, (step, sl, sr) in steps.items()}
    log("15-time", path="sharded step, virtual mesh on one card", shape=[8, *hw, num_d, radius],
        ms_per_frame=per_frame, fused_kernel_ms_per_frame=t_a8 / 8,
        note="what sharding costs on one card (halo rows computed twice, one launch per "
             "disparity part plus the minimum, copies), not what it gains")

    # Where a step's time goes between the card and the host that enqueues it.
    for shape in [(1, 1, 4), (2, 2, 2)]:
        step, sl, sr = steps[shape]
        log("15-profile", path="sharded step", mesh=list(shape), batch=8,
            **device_profile(lambda: step(sl, sr), 5, step_part))

    def crop(x):
        return x[..., radius:-radius, :]

    for shape in [(1, 1, 4), (1, 4, 1)]:
        _, n_space, n_disp = shape
        step, sl, sr = steps[shape]
        count = num_d // n_disp

        def halos():
            return [(extend_with_row_halos([sl.pieces[0][j][k] for j in range(n_space)], radius),
                     extend_with_row_halos([sr.pieces[0][j][k] for j in range(n_space)], radius))
                    for k in range(n_disp)]

        slabs = halos()

        def kernels():
            return [[key(slabs[k][0][j], slabs[k][1][j], k * count, count, num_d, radius)
                     for k in range(n_disp)] for j in range(n_space)]

        keys = kernels()

        def minimum():
            out = []
            for parts in keys:
                best = crop(parts[0])
                for part in parts[1:]:
                    best = torch.minimum(best, crop(part))
                out.append(best)
            return out

        reduced = minimum()
        parts_ms = {
            "halo_slabs": cuda_ms(halos),
            "key_kernel_launches": cuda_ms(kernels),
            "crop_and_minimum_over_disp": cuda_ms(minimum),
            "mod_and_cast": cuda_ms(lambda: [(k % num_d).to(torch.int32) for k in reduced]),
        }
        log("15-time", path="sharded step by part", mesh=list(shape), batch=8,
            parts_ms=parts_ms, sum_ms=sum(parts_ms.values()), step_ms=per_frame[str(shape)] * 8)
        del slabs, keys, reduced
    del steps, left8, right8, fused8
    torch.cuda.empty_cache()

    px = hw[0] * hw[1]
    # 9 operations per pixel and disparity; 2 bytes in, 4 of keys out per pixel.
    return kernel_entry("fused_block_matching_key", "sad_wta_key.cu", "sad_wta.py:527",
                        sum(step_launches.values()), 0, t_c, p_c,
                        bound(9 * 64 * px, 6 * px), None, [1, *hw, 5, [0, 64, 64]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    # Before any output: without the package beside it the script prints nothing.
    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.kernels import _build, remap, sad_wta
    from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig
    from gpu_stereo_matching_tpu_torch.ops.color import gray_blockmatching_bgr, gray_rec601_bgr
    from gpu_stereo_matching_tpu_torch.ops.remap import remap_bilinear_u8
    from gpu_stereo_matching_tpu_torch.utils.profiling import StageTimer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    log("1-device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log("2-build", seconds=time.perf_counter() - t0, library=lib_path.name,
        sources=len(list(_build.CSRC.glob("*.cu"))))

    rng = np.random.default_rng(SEED)

    def u8(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    # 3. Kernel A vs its plain twin: both bodies, random and structured inputs.
    err_a = 0
    bodies = {"strips": 0, "general": 0}

    def check_a(left, right, d, r, what):
        nonlocal err_a
        got = sad_wta.fused_block_matching_batched(left, right, d, r)
        want = sad_wta.fused_block_matching_reference(left, right, d, r)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        err_a = max(err_a, err)
        if err != 0:
            raise AssertionError(
                f"fused kernel differs from its twin at {(*left.shape, d, r)} ({what}): {err}")
        bodies[sad_wta.kernel_body(d, r)] += 1
        return got

    for b, h, w, d, r in EDGE_CASES + [(1, 1080, 1920, 64, 5), (4, 1080, 1920, 64, 5)]:
        check_a(u8((b, h, w)), u8((b, h, w)), d, r, "random")
    structured = 0
    for b, h, w, d, r in STRUCTURED_CASES:
        for kind, left, right in structured_pairs(rng, dev, (b, h, w)):
            got = check_a(left, right, d, r, kind)
            if kind == "constant" and bool(got.any()):
                raise AssertionError("constant images: every d ties, the answer is 0")
            structured += 1
    if not all(bodies.values()) or sad_wta.kernel_body(64, 5) != "strips":
        raise AssertionError(f"phase 3 must cover both bodies, (64, 5) on strips: {bodies}")
    log("3-fused-kernel-vs-twin", cases=len(EDGE_CASES) + 2 + structured,
        structured_cases=structured, cases_by_body=bodies, body_of_64_5=sad_wta.kernel_body(64, 5),
        max_abs_err=err_a, ok=True)

    # 4. Kernel B vs its plain twin, through a real-size rig's maps.
    size_hw, num_d, radius = (720, 1280), 64, 5
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=radius)
    rig = StereoRig(synthetic_calibration(), size_hw, cfg, device=dev)
    err_b = 0
    src = u8((3, *size_hw))
    for mx, my in ((rig.left_map_x, rig.left_map_y), (rig.right_map_x, rig.right_map_y)):
        got = remap.remap_bilinear_u8_direct(src, mx, my)
        want = remap_bilinear_u8(src, mx, my)
        torch.cuda.synchronize()
        err_b = max(err_b, int((got.int() - want.int()).abs().max()))
    valid_share = float((remap_bilinear_u8(torch.full(size_hw, 255, dtype=torch.uint8, device=dev),
                                           rig.left_map_x, rig.left_map_y) > 0).float().mean())
    if err_b != 0:
        raise AssertionError(f"remap kernel differs from its twin: {err_b}")
    if valid_share < 0.8:
        raise AssertionError(f"rectification maps keep only {valid_share:.3f} of the frame")
    log("4-remap-kernel-vs-twin", shape=[3, *size_hw], max_abs_err=err_b,
        valid_share=valid_share, ok=True)

    # 5. Gray on the card vs on the CPU over all 2**24 BGR triples.
    v = np.arange(1 << 24, dtype=np.uint32)
    triples = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=-1)
    triples = torch.from_numpy(triples.astype(np.uint8).reshape(4096, 4096, 3))
    for fn in (gray_blockmatching_bgr, gray_rec601_bgr):
        if not torch.equal(fn(triples.to(dev)).cpu(), fn(triples)):
            raise AssertionError(f"{fn.__name__} differs between the card and the CPU")
    log("5-gray-card-vs-cpu", triples=1 << 24, ok=True)

    # 6. The main path.
    pairs = [(u8((*size_hw, 3)), u8((*size_hw, 3))) for _ in range(3)]
    lb, rb = u8((8, *size_hw, 3)), u8((8, *size_hw, 3))
    torch.cuda.synchronize()
    sad_wta.LAUNCHES = 0
    remap.LAUNCHES = 0
    timer = StageTimer()
    singles = [rig.process(l, r, timer=timer) for l, r in pairs]
    launches = {"sad_wta_single": sad_wta.LAUNCHES}
    if [s.name for s in timer.spans] != ["frame"] * 3:
        raise AssertionError(f"rig.process recorded {timer.spans}, not one frame span per pair")
    batch = rig.process_batch(lb, rb)
    torch.cuda.synchronize()
    launches.update(sad_wta_batched=sad_wta.LAUNCHES - launches["sad_wta_single"],
                    remap=remap.LAUNCHES)
    if launches != {"sad_wta_single": 3, "sad_wta_batched": 1, "remap": 8}:
        raise AssertionError(f"main path did not launch every kernel as expected: {launches}")

    def plain_path(left_bgr, right_bgr):
        rl = remap_bilinear_u8(gray_blockmatching_bgr(left_bgr), rig.left_map_x, rig.left_map_y)
        rr = remap_bilinear_u8(gray_blockmatching_bgr(right_bgr), rig.right_map_x, rig.right_map_y)
        return sad_wta.fused_block_matching_reference(rl, rr, num_d, radius)

    for (l, r), got in zip(pairs, singles):
        if tuple(got.shape) != size_hw or not torch.equal(got, plain_path(l, r)):
            raise AssertionError("rig.process differs from the plain path")
    if tuple(batch.shape) != (8, *size_hw) or not torch.equal(batch, plain_path(lb, rb)):
        raise AssertionError("rig.process_batch differs from the plain path")
    if int(batch.min()) < 0 or int(batch.max()) >= num_d:
        raise AssertionError("disparities outside [0, D)")
    torch.cuda.synchronize()
    log("6-main-path", rig=[*size_hw, num_d, radius], process_pairs=3, batch=8,
        launches=launches, timer_frame_wait_ms=[s.seconds * 1e3 for s in timer.spans], ok=True)

    # 7. Timings.
    a1 = (u8((1, 1080, 1920)), u8((1, 1080, 1920)))
    a32 = (u8((32, 1080, 1920)), u8((32, 1080, 1920)))
    t_a1 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(*a1, 64, 5))
    p_a1 = cuda_ms(lambda: sad_wta.fused_block_matching_reference(*a1, 64, 5))
    t_a32 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(*a32, 64, 5))
    p_a32 = cuda_ms(lambda: sad_wta.fused_block_matching_reference(*a32, 64, 5), reps=3)
    del a32
    log("7-time", kernel="sad_wta", shape=[1, 1080, 1920, 64, 5], ms_per_frame=t_a1,
        plain_ms_per_frame=p_a1, plan=sad_wta.launch_plan((1, 1080, 1920), 64, 5, dev))
    log("7-time", kernel="sad_wta", shape=[32, 1080, 1920, 64, 5], ms_per_frame=t_a32 / 32,
        plain_ms_per_frame=p_a32 / 32, plan=sad_wta.launch_plan((32, 1080, 1920), 64, 5, dev))
    log("7-time", kernel="sad_wta", general_body_plan_at_r_8=sad_wta.launch_plan(
        (1, 1080, 1920), 64, 8, dev))
    g1 = u8((1, *size_hw))
    g8 = u8((8, *size_hw))
    mx, my = rig.left_map_x, rig.left_map_y
    t_b1 = cuda_ms(lambda: remap.remap_bilinear_u8_direct(g1, mx, my))
    p_b1 = cuda_ms(lambda: remap_bilinear_u8(g1, mx, my))
    t_b8 = cuda_ms(lambda: remap.remap_bilinear_u8_direct(g8, mx, my))
    p_b8 = cuda_ms(lambda: remap_bilinear_u8(g8, mx, my))
    log("7-time", kernel="remap", shape=[1, *size_hw], ms_per_frame=t_b1, plain_ms_per_frame=p_b1)
    log("7-time", kernel="remap", shape=[8, *size_hw], ms_per_frame=t_b8 / 8,
        plain_ms_per_frame=p_b8 / 8)
    t_rig = cuda_ms(lambda: rig.process_batch(lb, rb))
    t_plain_rig = cuda_ms(lambda: plain_path(lb, rb), reps=3)
    t_one = cuda_ms(lambda: rig.process(*pairs[0]))
    log("7-time", rig=[*size_hw, num_d, radius], batch=8, ms=t_rig, fps=8e3 / t_rig,
        plain_ms=t_plain_rig, plain_fps=8e3 / t_plain_rig, process_ms=t_one,
        process_fps=1e3 / t_one)
    log("7-profile", rig=[*size_hw, num_d, radius], batch=8,
        **device_profile(lambda: rig.process_batch(lb, rb), 10, rig_part))
    del a1, g1, g8, lb, rb, pairs, singles, batch, triples
    torch.cuda.empty_cache()

    bm_plus = run_bm_plus_phases(dev, u8, synthetic_calibration())
    key_kernel = run_sharded_phases(dev, u8, t_a1)

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "gpu_stereo_matching_tpu")]
    if bad:
        raise AssertionError(f"jax or the JAX package was imported: {bad}")
    px = 1080 * 1920
    print(json.dumps({"kernels": [
        # 8 operations per pixel and disparity; 2 bytes in, 4 out per pixel.
        kernel_entry("fused_block_matching", "sad_wta.cu", "sad_wta.py:398",
                     launches["sad_wta_single"], err_a, t_a1, p_a1,
                     bound(8 * 64 * px, 6 * px), None, [1, 1080, 1920, 64, 5]),
        kernel_entry("fused_block_matching_batched", "sad_wta.cu", "sad_wta.py:727",
                     launches["sad_wta_batched"], err_a, t_a32, p_a32,
                     bound(32 * 8 * 64 * px, 32 * 6 * px), None, [32, 1080, 1920, 64, 5]),
        # About 16 float operations per pixel (two floors, the weights, four
        # taps); per frame 1 byte in and 1 out per pixel, the two maps once.
        kernel_entry("remap_bilinear_u8", "remap.cu", "remap.py:457", launches["remap"], err_b,
                     t_b1, p_b1, bound(16 * 720 * 1280, (2 + 8) * 720 * 1280), None,
                     [1, *size_hw]),
        key_kernel,
        *bm_plus,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
