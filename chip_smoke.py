"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, time.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.

Phases, each printing its own line:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``gpu_stereo_matching_tpu_torch/kernels/csrc``,
   and beside them (g++) the host tree builder of ``tree/csrc``;
3. fused SAD + WTA kernel vs its plain twin on the card, bit-exact, on edge
   shapes and at 1080x1920 D=64 r=5 with B=1 and B=4, then on structured
   inputs (constant images, two-level images, 255 against 0, a shifted
   pair) at shapes that leave ragged tiles and strips, with odd D, D = W
   and B = 3; the line counts the cases each of the kernel's two bodies
   ran, and the phase fails if a body ran none or if (D, r) = (64, 5) does
   not take the strip body;
4. the remap kernel's two entries vs their plain twins, bit-exact: the u8
   entry and the rig's front end (BGR -> gray -> remap of both views in one
   launch) through both views' maps of a 720x1280 rig at B = 1, 3 and 8,
   then on ragged shapes (Ho * Wo no multiple of 4, odd widths, Ho != Hs,
   B = 3, a source base 1-3 bytes off word alignment, a map off its 16-byte
   alignment) through maps with NaN, coordinates past int32, exact last-row
   and last-column coordinates and negative fractions; the line counts the
   cases each of the two bodies ran, and the phase fails if a body ran none
   or if 720p does not take the vector body;
5. the gray kernel vs the plain twin on the CPU over all 2**24 BGR triples in
   both conventions, and on ragged lengths and unaligned bases (both of its
   bodies); and the plain twin on the card vs on the CPU;
6. the main path: a 720x1280, D=64, r=5 StereoRig from a synthetic
   calibration runs ``process`` on 3 pairs (with a ``StageTimer``, which
   must hold one fenced ``"frame"`` span per pair) and ``process_batch`` on
   8; results bit-exact against the plain path on the card; the counters,
   set to 0 just before, must read one front-end launch and one fused-kernel
   launch per call and no gray or u8-remap launch;
7. CUDA-event timings (warmed, median of several runs) of each kernel beside
   its plain twin and of the rig, printed as JSON lines, with the fused
   kernel's and the front end's launch plans (body, tile or pixels a thread,
   blocks, blocks per SM, waves); the gray kernel, the u8 remap and the
   front end also as device time under ``torch.profiler``, the front end
   beside the composition it replaces (the plain gray on the card, then a u8
   remap launch per view); then 10 batches of the rig under
   ``torch.profiler``: device time per call by part (fused kernel, front
   end, the rest) and the idle share;
8. split-phase SAD volume and argmin kernels vs their plain twins on the
   card, bit-exact, on the edge shapes, at 1080x1920 D=64 r=5 and at the
   ``middlebury`` command's bm shapes of phase 18 (360x640 and 720x1280,
   D=80 r=5); the
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
   read its exact launches just after it (the rig's front end once a call,
   the CLI's gray kernel once an image);
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
   it gains;
16. ST-1 (``models/segment_tree.py::st1_disparity``, ``SegmentTreeConfig()``:
   D=60, sigma 0.1, median r=3, scale 4) on the art view scaled up, against
   a right view shifted by a known disparity of 0-40 by row: at 360x640 the
   card's cost volume, filtered (N, D) volume and WTA map equal the port's
   CPU run bit for bit (else the line prints the largest difference and the
   share of equal disparities, and the phase fails), and so do the maps of
   the whole call; kernel D on the ST maps equals its twin; then the main
   path at 720x1280, ``st1_disparity`` twice and the ``st`` CLI once with
   every counter at 0 just before: D once a frame, no other kernel; the
   share of pixels within 1 level of the true shift away from the left 60
   columns; then timings at 720x1280 and 1080x1920 (left out past 700 s):
   the host's edge weights, tree build and plan emit, the plan's bytes and
   upload, the device stages by CUDA events (cost, filter, WTA, D), the
   whole call, and under ``torch.profiler`` the filter's and the
   frame's kernel count, busy time and idle share;
17. ST-2 (``st2_disparity``) and the streaming pipelines
   (``models/segment_tree_stream.py``) on the same scene: at 360x640
   ``right_cost_from_left``, the phase-1 packed map and the whole call on
   the card equal the port's CPU run bit for bit (else the line prints the
   shares of equal pixels and the phase fails), and kernel D equals its twin
   on ST-2's three median inputs; the main path at 720x1280,
   ``st2_disparity`` twice and ``st --method st2`` once with every counter
   at 0 just before: D 9 times, no other kernel; then the video, batch and
   ST-2 batch pipelines (group 4) over 8 frames, each with its own trees:
   every map equal to the per-frame call's and D launched once a frame (3
   times for ST-2); their frames per second beside the per-frame calls over
   the same frames, timed before and after the pipelines (the first run
   pays the layout registry's growth for the frames' new trees); then ST-2
   by stage at
   720x1280 and 1080x1920 (left out past 700 s): the host's sigma-1 and
   final weights, trees and plans, phase 1 and phase 2 by CUDA events, the
   phase-1 fetch, the whole call, and its busy time and idle share under
   ``torch.profiler``;
18. the per-band ST entries on the same scene (``models/segment_tree_tiled.py``,
   ``parallel/segment_tree.py``, ``SegmentTreeBatchPipeline(bands > 1)``) and
   the ``middlebury`` command: at 360x640 ``st1_disparity_tiled`` with 4, 3
   (unequal bands) and 1 band, ``st2_disparity_tiled`` with 4, the sharded
   ST-1 and ST-2 on a virtual ``(1, 4, 1)`` mesh and the banded pipeline
   (4 bands, 5 frames, group 2) on the card equal the port's CPU run bit for
   bit, each with every counter at 0 just before: D once a band of an ST-1
   frame, three times a band of an ST-2 frame, once a band of every frame
   the pipeline runs (its padded one included), no other kernel; on the
   card sharded equals tiled, the pipeline equals tiled frame by frame and 1
   band equals ``st1_disparity``. Then at 720x1280 tiled ST-1 with 1, 4 and
   8 bands: one call with its stages probed through the entry's own calls
   (the host's weights, trees and plan emits summed over bands; the cost by
   the host clock; the filter's and D's calls replayed on their own inputs
   by events, the filter's also under ``torch.profiler`` for its launches a
   frame), then the frame, so warmed, by the host clock; the sharded ST-1
   on ``(1, 4, 1)`` and ``(1, 8, 1)`` equal to tiled; ``st2_disparity``
   warmed and timed, the sharded ST-2 on ``(1, 4, 1)`` run once with its
   stages probed, then tiled ST-2 with 4 bands timed and equal to it;
   each band count's share within 2 levels of the global tree's map and
   within 1 level of the true shift; the banded pipeline with 1, 4 and 8
   bands over 8 frames (group 4, 4 workers) beside the per-frame ST-1. Last
   ``middlebury --pipelines bm,bm+,st1,st2`` on a synthetic scene
   (``view1.png``, ``view5.png``, ground truth of 3 x the shift) at
   360x640: the card launches G 4 times, E1 twice, E2 3 times and D 5
   times and prints the CPU's bad-2.0 lines; then the harness's bm and bm+
   maps (D = 80) on the card equal the CPU's bit for bit.
   To run it alone: ``run_tiled_phase(torch.device("cuda:0"),
   time.perf_counter())`` after the build of phase 2.

Each kernel's entry of the summary line carries its bound: the least time
the card could take, the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its operations over 67e12 32-bit
operations per second (the float32 rate outside the tensor cores; the data
sheet gives no separate integer rate). Operations are counted from the
separable running-sum form: per pixel and disparity 2 for the absolute
difference, 2 for the vertical and 2 for the horizontal running sum, plus
2 for the (min, argmin) update or 3 for the packed key and its minimum.
For the gray and remap kernels a fused multiply-add counts 2.

Then one JSON line with the kernels' summary, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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
# (B, H, W, D, r): the middlebury command's bm and bm+ on phase 18's scenes
# (the harness's D = 80, BlockMatchingConfig's r = 5).
MIDDLEBURY_BM_CASES = [(1, 360, 640, 80, 5), (1, 720, 1280, 80, 5)]
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
# (Hs, Ws, Ho, Wo, B, source byte offset, map aligned): Ho * Wo % 4 != 0 with
# odd widths; whole threads with an odd source width and Ho != Hs; B = 1; a
# map one float off its 16-byte alignment (the scalar body on a shape the
# vector body takes); several blocks, ragged.
REMAP_CASES = [
    (23, 31, 13, 37, 3, 1, True), (20, 33, 16, 24, 3, 3, True), (9, 10, 8, 8, 1, 0, True),
    (24, 32, 24, 32, 3, 2, False), (70, 45, 61, 67, 2, 0, True), (33, 257, 35, 129, 3, 1, True),
]
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
PEAK_OPS_PER_S = 67e12      # 32-bit operations outside the tensor cores, data sheet


def bound(operations: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate, and which of them it is."""
    t_ops = operations / PEAK_OPS_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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


def device_ms_per_call(fn, repeats: int = 10):
    """Device time per call of ``fn()`` under ``torch.profiler`` (all the
    kernels it launches), with the kernels the profiler saw a call."""
    prof = device_profile(fn, repeats, lambda name: "all")
    if not prof["device_time_seen"]:
        return None, 0
    return prof["busy_ms"] / repeats, prof["device_kernels"] / repeats


def ratio(x, k):
    """x / k, or None where x was not measured."""
    return None if x is None else x / k


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


def wild_maps(rng, hs, ws, ho, wo):
    """(Ho, Wo) float32 maps over and past a (Hs, Ws) source, with NaN,
    coordinates past int32, exact last-row and last-column coordinates,
    negative fractions and integer coordinates."""
    mx = rng.uniform(-2.5, ws + 1.5, (ho, wo)).astype(np.float32)
    my = rng.uniform(-2.5, hs + 1.5, (ho, wo)).astype(np.float32)
    special = [(np.nan, 1.5), (1.5, np.nan), (3e9, 1.5), (1.5, -3e9), (2.0**31, 2.5),
               (ws - 1, 1.5), (1.25, hs - 1), (ws - 2, hs - 2), (-0.25, 2.5), (2.75, -0.5),
               (3.0, 4.0)]
    for k, (x, y) in enumerate(special):
        mx.flat[k], my.flat[k] = x, y
    return mx, my


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
    if "front_end_kernel" in name:
        return "front_end"
    return "rest"


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
    three kernels' entries of the summary line and the launches of phase 10
    by kernel."""
    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from PIL import Image
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import (
        device_ms,
        select_instructions_per_pixel,
    )
    from gpu_stereo_matching_tpu_torch.cli.main import main as cli_main
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median, gray, remap, split_phase
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
    for _, h, w, d, r in EDGE_CASES + [(1, 1080, 1920, 64, 5)] + MIDDLEBURY_BM_CASES:
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
    log("8-split-phase-vs-twin", cases=len(EDGE_CASES) + 1 + len(MIDDLEBURY_BM_CASES) + structured,
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
        exactly ``want``: E1 once, E2 twice and D once per frame, the front
        end once per rig call, the gray kernel once per image loaded, the u8
        remap never."""
        split_phase.LAUNCHES.update(sad_volume=0, wta_from_sad=0)
        ctmf_median.LAUNCHES = remap.LAUNCHES = remap.PAIR_LAUNCHES = gray.LAUNCHES = 0
        out = run()
        torch.cuda.synchronize()
        got = {**split_phase.LAUNCHES, "ctmf_median": ctmf_median.LAUNCHES,
               "front_end": remap.PAIR_LAUNCHES, "gray": gray.LAUNCHES, "remap_u8": remap.LAUNCHES}
        if got != want:
            raise AssertionError(f"{what} launched {got}, not {want}")
        return out, got

    def per_frame(frames, front_ends=0, grays=0):
        return {"sad_volume": frames, "wta_from_sad": 2 * frames, "ctmf_median": frames,
                "front_end": front_ends, "gray": grays, "remap_u8": 0}

    disp2, n_pipeline = counted("block_matching_pipeline", per_frame(2),
                                lambda: block_matching_pipeline(left2, right2, cfg))
    (rig_singles, rig_batch), n_rig = counted(
        "fused=False rig", per_frame(3 + 4, front_ends=3 + 1),
        lambda: ([rig.process(l, r) for l, r in rig_pairs], rig.process_batch(rig_lb, rig_rb)))
    cli_rc, n_cli = counted(
        "bm CLI", per_frame(1, grays=2),
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
    return launches, [
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


ST_HW = (720, 1280)      # ST-1's main path and its timings
ST_CHECK_HW = (360, 640)  # the card against the port's CPU run, bit for bit
ST_HD_HW = (1080, 1920)   # timed too while the run stays well inside its limit
ST_HD_BEFORE_S = 700      # seconds since the start after which 1080p is left out
ST_MAX_SHIFT = 40


def st_pair(hw):
    """The art view (``examples/art_left.png``) scaled to ``hw`` as the left
    image; the right view is the left shifted left by a known disparity that
    grows with the row from 0 to 40 (``right[y, x] = left[y, x + d(y)]``, its
    last column repeated). Returns (left, right, d per row)."""
    from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr, resize_bilinear_u8

    h, w = hw
    here = os.path.dirname(os.path.abspath(__file__))
    left = resize_bilinear_u8(load_image_bgr(os.path.join(here, "examples", "art_left.png")), hw)
    truth = ST_MAX_SHIFT * np.arange(h) // (h - 1)
    return left, st_right(left, truth), truth


def st_right(left, truth):
    """``right[y, x] = left[y, x + truth[y]]``, the last column repeated."""
    h, w = left.shape[:2]
    cols = np.minimum(np.arange(w)[None, :] + truth[:, None], w - 1)
    return np.ascontiguousarray(left[np.arange(h)[:, None], cols])


def st_frames(hw, n: int):
    """``n`` frames of ``st_pair``'s scene, frame k's left view the art view
    rolled by its own offset of 24 k columns, so that each frame has its own
    trees; its right view shifted as ``st_pair`` shifts it."""
    left, _right, truth = st_pair(hw)
    lefts = [np.ascontiguousarray(np.roll(left, 24 * k, axis=1)) for k in range(n)]
    return [(lf, st_right(lf, truth)) for lf in lefts], truth


def within_one(scaled, truth, cfg) -> float:
    """Share of a scaled ST map's pixels past the left D columns within 1
    level of the true shift."""
    levels = scaled.cpu().numpy().astype(np.int64) // cfg.disparity_scale
    return float(np.mean(np.abs(levels - truth[:, None])[:, cfg.max_disp_levels:] <= 1))


def median_against_twin(disp_u8, radius: int, what: str):
    """Kernel D on an ST map against its histogram twin; the kernel's map."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median
    from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8

    got = ctmf_median.median_u8(disp_u8, radius)
    want = median_filter_u8(disp_u8, radius, method="histogram")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"kernel D differs from its twin on the ST map ({what})")
    return got


def zero_launches() -> None:
    """Every kernel's launch counter to 0."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median, gray, remap, sad_wta, split_phase

    split_phase.LAUNCHES.update(sad_volume=0, wta_from_sad=0)
    ctmf_median.LAUNCHES = remap.LAUNCHES = remap.PAIR_LAUNCHES = gray.LAUNCHES = 0
    sad_wta.LAUNCHES = sad_wta.KEY_LAUNCHES = 0


def all_launches() -> dict:
    """Every kernel's launch counter."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median, gray, remap, sad_wta, split_phase

    return {**split_phase.LAUNCHES, "ctmf_median": ctmf_median.LAUNCHES,
            "sad_wta": sad_wta.LAUNCHES, "sad_wta_key": sad_wta.KEY_LAUNCHES,
            "front_end": remap.PAIR_LAUNCHES, "remap_u8": remap.LAUNCHES, "gray": gray.LAUNCHES}


def st_part(name: str) -> str:
    """The part of an ST-1 frame that a device kernel belongs to."""
    if "rank_select_kernel" in name or "histogram_kernel" in name:
        return "median_kernel_D"
    return "torch_ops"


def wall_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn()`` ended by a synchronize, after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_st1_phase(dev, started: float) -> dict:
    """Phase 16: ST-1 (``st1_disparity``): the card against the port's CPU
    run at 360x640, kernel D on the ST maps against its twin, the main path
    with its launches, then timings by stage. Returns D's ST-1 launches and
    the numbers of the phase."""
    from PIL import Image

    from gpu_stereo_matching_tpu_torch.cli.main import main as cli_main
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median
    from gpu_stereo_matching_tpu_torch.models import segment_tree as st
    from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume
    from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity
    from gpu_stereo_matching_tpu_torch.tree.builder import build_segment_tree, color_edge_weights
    from gpu_stereo_matching_tpu_torch.tree.stride import (
        StridePlan,
        build_stride_plan,
        tree_filter_nodes_sb,
    )

    cfg = SegmentTreeConfig()  # D=60, sigma 0.1, tau 1200, min size 50, penalty 5, r=3, x4
    num_d = cfg.max_disp_levels
    cpu = torch.device("cpu")

    def host_plan(left, hw):
        tree = build_segment_tree(color_edge_weights(left), *hw, tau=cfg.tau,
                                  min_size=cfg.min_size_seg, penalty=cfg.penalty_cross_seg)
        return StridePlan.from_tree(tree, cfg.sigma)

    def filtered_and_map(left, right, plan, device):
        cost = color_gradient_cost_volume(torch.from_numpy(left).to(device),
                                          torch.from_numpy(right).to(device), num_d)
        filtered = tree_filter_nodes_sb(st._to_nodes(cost), plan.to(device))
        disp = wta_disparity(filtered, dim=1).reshape(cost.shape[1:]).to(torch.uint8)
        return cost, filtered, disp

    def d_against_twin(disp_u8, what):
        return median_against_twin(disp_u8, cfg.median_radius, f"ST-1, {what}")

    # The card against the port's CPU run, stage by stage, at 360x640.
    left, right, truth = st_pair(ST_CHECK_HW)
    plan = host_plan(left, ST_CHECK_HW)
    on_cpu = filtered_and_map(left, right, plan, cpu)
    on_card = filtered_and_map(left, right, plan, dev)
    torch.cuda.synchronize()
    equal = {}
    for name, a, b in zip(("cost", "filtered", "wta_map"), on_card, on_cpu):
        equal[name] = bool(torch.equal(a.cpu(), b))
    if not all(equal.values()):
        diff = float((on_card[1].cpu() - on_cpu[1]).abs().max())
        share = float((on_card[2].cpu() == on_cpu[2]).float().mean())
        log("16-st1-card-vs-cpu", shape=[*ST_CHECK_HW, num_d], equal=equal,
            filtered_max_abs_diff=diff, equal_disparity_share=share, ok=False)
        raise AssertionError(f"ST-1 on the card differs from the CPU run: {equal}")
    d_against_twin(on_card[2], f"{ST_CHECK_HW}")
    full_card = st.st1_disparity(left, right, cfg, device=dev)
    full_cpu = st.st1_disparity(left, right, cfg, device="cpu")
    if not torch.equal(full_card.cpu(), full_cpu):
        share = float((full_card.cpu() == full_cpu).float().mean())
        raise AssertionError(f"st1_disparity on the card differs from the CPU run ({share})")
    check_accuracy = within_one(full_card, truth, cfg)
    log("16-st1-card-vs-cpu", shape=[*ST_CHECK_HW, num_d], equal=equal,
        st1_disparity_equal=True, filtered_max_abs_diff=0.0, plan_total_pos=plan.total_pos,
        within_one_level_share=check_accuracy, ok=True)
    del on_cpu, on_card, full_card, full_cpu

    # The main path: st1_disparity and the st CLI on the card at 720x1280,
    # every counter at 0 just before; D once a frame, no other kernel.
    left, right, truth = st_pair(ST_HW)
    tmp = tempfile.TemporaryDirectory()
    lp, rp, op = (os.path.join(tmp.name, n) for n in ("l.png", "r.png", "d.png"))
    for path, bgr in ((lp, left), (rp, right)):
        Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(path)
    torch.cuda.synchronize()
    zero_launches()
    maps = [st.st1_disparity(left, right, cfg) for _ in range(2)]
    cli_rc = cli_main(["st", lp, rp, op])
    torch.cuda.synchronize()
    launches = all_launches()
    want = dict.fromkeys(launches, 0)
    want["ctmf_median"] = 3
    if launches != want or cli_rc != 0:
        raise AssertionError(f"ST-1 launched {launches}, not {want} (CLI rc {cli_rc})")
    with Image.open(op) as im:
        cli_map = torch.from_numpy(np.array(im)).to(dev)
    for m in maps[1:] + [cli_map]:
        if not torch.equal(m, maps[0]):
            raise AssertionError("ST-1 frames of one pair differ")
    if maps[0].shape != ST_HW or maps[0].dtype != torch.uint8:
        raise AssertionError(f"ST-1 map of shape {tuple(maps[0].shape)} {maps[0].dtype}")
    accuracy = within_one(maps[0], truth, cfg)
    tmp.cleanup()
    log("16-st1-main-path", shape=[*ST_HW, num_d], frames=2, cli_calls=1, launches=launches,
        within_one_level_share=accuracy, ok=True)
    del maps, cli_map

    # Timings by stage, 720p and (while the run stays well inside its
    # limit) 1080p.
    times = {}
    for hw in (ST_HW, ST_HD_HW):
        if hw == ST_HD_HW and time.perf_counter() - started > ST_HD_BEFORE_S:
            log("16-st1-time", shape=[*hw, num_d], left_out="the run is past "
                f"{ST_HD_BEFORE_S} s")
            continue
        reps = 5 if hw == ST_HW else 3
        left, right, truth = st_pair(hw)
        weights = color_edge_weights(left)
        tree = build_segment_tree(weights, *hw, tau=cfg.tau, min_size=cfg.min_size_seg,
                                  penalty=cfg.penalty_cross_seg)
        plan = build_stride_plan(tree, cfg.sigma)
        host = {
            "edge_weights": wall_ms(lambda: color_edge_weights(left), reps),
            "tree_build": wall_ms(lambda: build_segment_tree(
                weights, *hw, tau=cfg.tau, min_size=cfg.min_size_seg,
                penalty=cfg.penalty_cross_seg), reps),
            "plan_emit": wall_ms(lambda: build_stride_plan(tree, cfg.sigma), reps),
        }
        upload = cuda_ms(lambda: plan.to(dev), reps)
        plan_dev = plan.to(dev)
        l_dev, r_dev = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
        cost = color_gradient_cost_volume(l_dev, r_dev, num_d)
        nodes = st._to_nodes(cost)
        filtered = tree_filter_nodes_sb(nodes, plan_dev)
        disp = wta_disparity(filtered, dim=1).reshape(hw).to(torch.uint8)
        d_against_twin(disp, f"{hw}")
        device = {
            "cost_volume": cuda_ms(lambda: color_gradient_cost_volume(l_dev, r_dev, num_d), reps),
            "filter": cuda_ms(lambda: tree_filter_nodes_sb(nodes, plan_dev), reps),
            "wta": cuda_ms(lambda: wta_disparity(filtered, dim=1), reps),
            "median_D": cuda_ms(lambda: ctmf_median.median_u8(disp, cfg.median_radius), reps),
        }
        whole = wall_ms(lambda: st.st1_disparity(left, right, cfg), reps)
        filter_prof = device_profile(lambda: tree_filter_nodes_sb(nodes, plan_dev), 2,
                                     lambda name: "filter")
        frame_prof = device_profile(lambda: st.st1_disparity(left, right, cfg), 2, st_part)
        n_rounds = min(plan.n_real, len(plan.buckets))
        times[f"{hw[0]}x{hw[1]}"] = device["median_D"]
        log("16-st1-time", shape=[*hw, num_d], nodes=hw[0] * hw[1],
            host_ms=host, host_ms_sum=sum(host.values()),
            plan={"transport_nbytes": plan.transport_nbytes, "total_pos": plan.total_pos,
                  "rounds": n_rounds, "buckets": sum(len(r) for r in plan.buckets[:n_rounds]),
                  "scan_steps": sum(e for r in plan.buckets[:n_rounds] for e, _p in r)},
            upload_ms=upload, device_ms_by_events=device,
            device_stages_sum_ms=sum(device.values()), st1_disparity_ms=whole,
            filter_profile=filter_prof, frame_profile=frame_prof,
            within_one_level_share=within_one(st.st1_disparity(left, right, cfg), truth, cfg))
        del cost, nodes, filtered, disp, plan_dev, l_dev, r_dev
        torch.cuda.empty_cache()
    return {"launches": launches["ctmf_median"], "median_ms": times}


ST_PIPELINE_FRAMES = 8   # frames each pipeline streams at 720x1280
ST_GROUP = 4             # frames per group of the batch pipelines


def run_st2_phase(dev, started: float) -> dict:
    """Phase 17: ST-2 (``st2_disparity``) and the streaming pipelines: the
    card against the port's CPU run at 360x640, kernel D on ST-2's three
    median inputs against its twin, the main path at 720x1280 with its
    launches, each pipeline against its per-frame call with its launches,
    then ST-2 by stage and each pipeline's frames per second beside the
    per-frame calls over the same frames. Returns D's launches and the
    numbers of the phase."""
    from PIL import Image

    from gpu_stereo_matching_tpu_torch.cli.main import main as cli_main
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median
    from gpu_stereo_matching_tpu_torch.models import segment_tree as st
    from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import (
        SegmentTreeBatchPipeline,
        SegmentTreeST2BatchPipeline,
        SegmentTreeVideoPipeline,
    )
    from gpu_stereo_matching_tpu_torch.ops.cost import (
        color_gradient_cost_volume,
        right_cost_from_left,
    )
    from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity
    from gpu_stereo_matching_tpu_torch.tree.builder import (
        build_segment_tree,
        color_depth_edge_weights,
        color_edge_weights,
    )
    from gpu_stereo_matching_tpu_torch.tree.stride import (
        build_stride_plan,
        converged_stride_batch,
        tree_filter_nodes_sb,
    )

    cfg = SegmentTreeConfig()  # D=60, sigma 0.1, sigma_1 0.08, LR max diff 1, r=3, x4
    num_d, lr = cfg.max_disp_levels, cfg.lr_max_diff
    cpu = torch.device("cpu")

    def phase1_inputs(left, right, device):
        """(left, right) as (1, H, W, 3) on ``device``, the sigma-1 plans."""
        plans = converged_stride_batch([st._sigma1_tree(left, cfg), st._sigma1_tree(right, cfg)],
                                       cfg.sigma_one)
        return (torch.from_numpy(left).to(device)[None], torch.from_numpy(right).to(device)[None],
                plans)

    def wta_map(cost, plan):
        filtered = tree_filter_nodes_sb(st._to_nodes(cost), plan)
        return wta_disparity(filtered, dim=1).reshape(cost.shape[1:]).to(torch.uint8)

    def share(a, b):
        return float((a.cpu() == b.cpu()).float().mean())

    # The card against the port's CPU run at 360x640, bit for bit.
    t_phase = time.perf_counter()
    left, right, truth = st_pair(ST_CHECK_HW)
    lb, rb, plans1 = phase1_inputs(left, right, cpu)
    cost_cpu = color_gradient_cost_volume(lb[0], rb[0], num_d)
    cost_card = color_gradient_cost_volume(lb[0].to(dev), rb[0].to(dev), num_d)
    right_cpu, right_card = right_cost_from_left(cost_cpu), right_cost_from_left(cost_card)
    packed_cpu = st._st2_phase1_group(lb, rb, plans1, num_d, lr)
    packed_card = st._st2_phase1_group(lb.to(dev), rb.to(dev), plans1.to(dev), num_d, lr)
    full_card = st.st2_disparity(left, right, cfg, device=dev)
    full_cpu = st.st2_disparity(left, right, cfg, device="cpu")
    torch.cuda.synchronize()
    equal = {"right_cost_from_left": bool(torch.equal(right_card.cpu(), right_cpu)),
             "phase1_packed": bool(torch.equal(packed_card.cpu(), packed_cpu)),
             "st2_disparity": bool(torch.equal(full_card.cpu(), full_cpu))}
    if not all(equal.values()):
        log("17-st2-card-vs-cpu", shape=[*ST_CHECK_HW, num_d], equal=equal,
            phase1_equal_share=share(packed_card, packed_cpu),
            st2_equal_share=share(full_card, full_cpu), ok=False)
        raise AssertionError(f"ST-2 on the card differs from the CPU run: {equal}")
    # Kernel D on each of ST-2's three median inputs: both views' sigma-1
    # WTA maps, and the WTA map of the tree rebuilt from color and depth.
    disp_l, mask = st._unpack_phase1(packed_card)
    plan2 = converged_stride_batch([st._final_tree(left, disp_l[0], mask[0], cfg)], cfg.sigma)
    for what, cost, plan in (("left view", cost_card, plans1.frame(0)),
                             ("right view", right_card, plans1.frame(1)),
                             ("final tree", cost_card, plan2.frame(0))):
        median_against_twin(wta_map(cost, plan.to(dev)), cfg.median_radius,
                            f"ST-2 {what}, {ST_CHECK_HW}")
    log("17-st2-card-vs-cpu", shape=[*ST_CHECK_HW, num_d], equal=equal,
        median_inputs_checked=3, stable_share=float(mask.mean()),
        within_one_level_share=within_one(full_card, truth, cfg),
        seconds=time.perf_counter() - t_phase, ok=True)
    del cost_cpu, cost_card, right_cpu, right_card, full_card, full_cpu

    # The main path: st2_disparity twice and `st --method st2` once at
    # 720x1280, every counter at 0 just before; D three times a frame.
    t_phase = time.perf_counter()
    left, right, truth = st_pair(ST_HW)
    tmp = tempfile.TemporaryDirectory()
    lp, rp, op = (os.path.join(tmp.name, n) for n in ("l.png", "r.png", "d.png"))
    for path, bgr in ((lp, left), (rp, right)):
        Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(path)
    torch.cuda.synchronize()
    zero_launches()
    maps = [st.st2_disparity(left, right, cfg) for _ in range(2)]
    cli_rc = cli_main(["st", lp, rp, op, "--method", "st2"])
    torch.cuda.synchronize()
    launches = all_launches()
    want = dict.fromkeys(launches, 0)
    want["ctmf_median"] = 9
    if launches != want or cli_rc != 0:
        raise AssertionError(f"ST-2 launched {launches}, not {want} (CLI rc {cli_rc})")
    with Image.open(op) as im:
        cli_map = torch.from_numpy(np.array(im)).to(dev)
    for m in maps[1:] + [cli_map]:
        if not torch.equal(m, maps[0]):
            raise AssertionError("ST-2 frames of one pair differ")
    if maps[0].shape != ST_HW or maps[0].dtype != torch.uint8:
        raise AssertionError(f"ST-2 map of shape {tuple(maps[0].shape)} {maps[0].dtype}")
    tmp.cleanup()
    log("17-st2-main-path", shape=[*ST_HW, num_d], frames=2, cli_calls=1, launches=launches,
        within_one_level_share=within_one(maps[0], truth, cfg),
        seconds=time.perf_counter() - t_phase, ok=True)
    del maps, cli_map

    # The pipelines at 720x1280 over frames of their own trees: each map
    # equal to the per-frame call's, D launched once a frame run (three
    # times for ST-2), every other kernel never; frames per second beside
    # the per-frame calls over the same frames, run before and after.
    frames, truth = st_frames(ST_HW, ST_PIPELINE_FRAMES)

    def timed(run):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        maps = list(run())
        torch.cuda.synchronize()
        return maps, time.perf_counter() - t0, all_launches()

    def per_frame(fn):
        return lambda: (fn(lf, rt, cfg) for lf, rt in frames)

    pipelines = {}
    pipeline_launches = 0
    t_phase = time.perf_counter()
    # The per-frame calls run before and after the pipelines: the first run
    # pays the layout registry's growth for the frames' new trees.
    for method, fn, per, pipes in (
            ("st1", st.st1_disparity, 1, (
                ("video", SegmentTreeVideoPipeline(cfg, device=dev)),
                ("batch", SegmentTreeBatchPipeline(cfg, group_size=ST_GROUP, device=dev)))),
            ("st2", st.st2_disparity, 3, (
                ("st2_batch", SegmentTreeST2BatchPipeline(cfg, group_size=ST_GROUP, device=dev)),))):
        refs, seconds, _ = timed(per_frame(fn))
        seq_seconds = [seconds]
        runs = {}
        for name, pipe in pipes:
            maps, seconds, launched = timed(lambda pipe=pipe: pipe.process(frames))
            want = dict.fromkeys(launched, 0)
            # A batch pipeline pads a short last group to the group size.
            run = len(frames) if name == "video" else -(-len(frames) // ST_GROUP) * ST_GROUP
            want["ctmf_median"] = per * run
            if launched != want:
                raise AssertionError(f"pipeline {name} launched {launched}, not {want}")
            pipeline_launches += launched["ctmf_median"]
            runs[name] = maps
            pipelines[name] = {"fps": len(frames) / seconds, "seconds": seconds,
                               "launches": launched["ctmf_median"]}
        _, seconds, _ = timed(per_frame(fn))
        seq_seconds.append(seconds)
        for name, maps in runs.items():
            same = [bool(torch.equal(m, r)) for m, r in zip(maps, refs)]
            if len(maps) != len(frames) or not all(same):
                raise AssertionError(f"pipeline {name} differs from per-frame {method}: {same}")
            pipelines[name]["gain_over_sequential"] = (
                pipelines[name]["fps"] * statistics.mean(seq_seconds) / len(frames))
        shares = [within_one(r, truth, cfg) for r in refs]
        pipelines[f"sequential_{method}"] = {
            "fps": [len(frames) / t for t in seq_seconds], "seconds": seq_seconds,
            "within_one_level_share": [min(shares), max(shares)]}
        del refs, runs
    log("17-pipelines", shape=[*ST_HW, num_d], frames=len(frames), group=ST_GROUP,
        workers={"batch": 2, "st2_batch": 4}, pipelines=pipelines,
        seconds=time.perf_counter() - t_phase, ok=True)

    # ST-2 by stage at 720x1280 and (while the run stays well inside its
    # limit) 1080x1920.
    times = {}
    for hw in (ST_HW, ST_HD_HW):
        if hw == ST_HD_HW and time.perf_counter() - started > ST_HD_BEFORE_S:
            log("17-st2-time", shape=[*hw, num_d], left_out="the run is past "
                f"{ST_HD_BEFORE_S} s")
            continue
        t_stage = time.perf_counter()
        hd = hw == ST_HD_HW
        reps = 1 if hd else 2
        left, right, truth = st_pair(hw)
        w_l, w_r = color_edge_weights(left), color_edge_weights(right)
        tree_args = dict(tau=cfg.tau, min_size=cfg.min_size_seg, penalty=cfg.penalty_cross_seg)
        t_l = build_segment_tree(w_l, *hw, **tree_args)
        t_r = build_segment_tree(w_r, *hw, **tree_args)
        lb, rb, plans1 = phase1_inputs(left, right, dev)
        plans1_dev = plans1.to(dev)
        packed = st._st2_phase1_group(lb, rb, plans1_dev, num_d, lr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disp_l, mask = st._unpack_phase1(packed)
        fetch_ms = (time.perf_counter() - t0) * 1e3
        w_f = color_depth_edge_weights(left, disp_l[0], mask[0], num_d, cfg.alpha_dep_seg)
        t_f = build_segment_tree(w_f, *hw, **tree_args, weight_scale=255.0)
        plan2_dev = converged_stride_batch([t_f], cfg.sigma).to(dev)
        host = {
            "sigma1_weights_both_views": wall_ms(lambda: (color_edge_weights(left),
                                                          color_edge_weights(right)), reps),
            "sigma1_trees_both_views": wall_ms(lambda: (build_segment_tree(w_l, *hw, **tree_args),
                                                        build_segment_tree(w_r, *hw, **tree_args)),
                                               reps),
            "sigma1_plans_both_views": wall_ms(lambda: (build_stride_plan(t_l, cfg.sigma_one),
                                                        build_stride_plan(t_r, cfg.sigma_one)),
                                               reps),
            "final_weights": wall_ms(lambda: color_depth_edge_weights(
                left, disp_l[0], mask[0], num_d, cfg.alpha_dep_seg), reps),
            "final_tree": wall_ms(lambda: build_segment_tree(w_f, *hw, **tree_args,
                                                             weight_scale=255.0), reps),
            "final_plan": wall_ms(lambda: build_stride_plan(t_f, cfg.sigma), reps),
        }
        device = {
            "phase1": cuda_ms(lambda: st._st2_phase1_group(lb, rb, plans1_dev, num_d, lr), reps),
            "phase2": cuda_ms(lambda: st._st1_device_group(lb, rb, plan2_dev, num_d), reps),
        }
        cost = color_gradient_cost_volume(lb[0], rb[0], num_d)
        device["right_cost_from_left"] = cuda_ms(lambda: right_cost_from_left(cost), reps)
        final_map = wta_map(cost, plan2_dev.frame(0))
        median_against_twin(final_map, cfg.median_radius, f"ST-2 final tree, {hw}")
        device["median_D_final_map"] = cuda_ms(
            lambda: ctmf_median.median_u8(final_map, cfg.median_radius), reps)
        # The stages above built this pair's trees and plans, so the layout
        # registry has grown for them: one call at 1080p, 2 after a warm-up
        # at 720p (the main path's line has its accuracy), where the
        # profiler then traces one more.
        if hd:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accuracy = within_one(st.st2_disparity(left, right, cfg), truth, cfg)
            whole = (time.perf_counter() - t0) * 1e3
        else:
            accuracy = None
            whole = wall_ms(lambda: st.st2_disparity(left, right, cfg), reps)
        frame_prof = (None if hd else
                      device_profile(lambda: st.st2_disparity(left, right, cfg), 1, st_part))
        times[f"{hw[0]}x{hw[1]}"] = {"median_D_final_map": device["median_D_final_map"]}
        log("17-st2-time", shape=[*hw, num_d], host_ms=host, host_ms_sum=sum(host.values()),
            device_ms_by_events=device, phase1_fetch_ms=fetch_ms,
            stable_share=float(mask.mean()), st2_disparity_ms=whole, frame_profile=frame_prof,
            within_one_level_share=accuracy, seconds=time.perf_counter() - t_stage)
        del lb, rb, plans1_dev, plan2_dev, packed, cost, final_map
        torch.cuda.empty_cache()
    return {"launches": launches["ctmf_median"], "pipeline_launches": pipeline_launches,
            "median_ms": times, "pipelines": pipelines}


TILED_CHECK_FRAMES = 5   # frames of the banded pipeline's check at 360x640, group 2
TILED_BANDS = (1, 4, 8)  # band counts timed at 720x1280
MIDDLEBURY_PIPELINES = "bm,bm+,st1,st2"
# Launches of one `middlebury` run over one scene with MIDDLEBURY_PIPELINES
# on the card: bm and bm+ convert both views with G, bm runs E1 and E2 once,
# bm+ E1 once, E2 twice and D once; ST-1 runs D once, ST-2 three times.
MIDDLEBURY_LAUNCHES = {"gray": 4, "sad_volume": 2, "wta_from_sad": 3, "ctmf_median": 5}


def middlebury_scene(root: str, hw) -> str:
    """A Middlebury-style scene folder ``Synth`` under ``root``: ``st_pair``'s
    views as ``view1.png`` and ``view5.png``, and 3 x the true shift (the
    third-size ground truth's scale) as ``disp1.png`` and ``disp5.png``;
    row 0, shifted by 0, is unknown ground truth (0)."""
    from gpu_stereo_matching_tpu_torch.io.images import save_image

    left, right, truth = st_pair(hw)
    folder = os.path.join(root, "Synth")
    os.makedirs(folder)
    save_image(os.path.join(folder, "view1.png"), left)
    save_image(os.path.join(folder, "view5.png"), right)
    gt = np.repeat((3 * truth).astype(np.uint8)[:, None], hw[1], axis=1)
    for name in ("disp1.png", "disp5.png"):
        save_image(os.path.join(folder, name), gt)
    return root


def middlebury_lines(root: str, device: str):
    """The ``middlebury`` command's printed lines over ``root``, and its
    lines without the times."""
    import io

    from gpu_stereo_matching_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["middlebury", "--root", root, "--pipelines", MIDDLEBURY_PIPELINES,
                       "--device", device])
    if rc != 0:
        raise AssertionError(f"middlebury --device {device} returned {rc}")
    lines = buf.getvalue().splitlines()
    return lines, [x.rsplit(" ", 2)[0].rstrip() if x.endswith(" ms") else x for x in lines]


def host_timed(fn):
    """One call of ``fn()`` timed by the host clock, after a synchronize and
    ended by one: (milliseconds, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def warm_then_timed(fn):
    """One warm-up call of ``fn()``, then one timed by :func:`host_timed`."""
    fn()
    return host_timed(fn)


def events_ms(fn) -> float:
    """Milliseconds of one call of ``fn()`` between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


@contextlib.contextmanager
def probed(owner, *names):
    """Within the block, every call of ``owner.<name>`` (a module's function
    or a class's classmethod) for each of ``names`` is recorded in
    ``calls[name]`` as (host milliseconds, positional arguments, result).
    The span opens and closes with a synchronize, so it holds the call's own
    work and nothing enqueued before it. An entry point is so timed by
    stage through its own code. The originals are restored on exit."""
    calls = {name: [] for name in names}
    originals = {name: vars(owner)[name] for name in names}

    def probe(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls[name].append(((time.perf_counter() - t0) * 1e3, args, out))
            return out
        return call

    for name in names:
        setattr(owner, name, probe(name, getattr(owner, name)))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(owner, name, fn)


def run_tiled_phase(dev, started: float) -> dict:
    """Phase 18: the per-band segment-tree entries (tiled, sharded over
    ``space``, the banded batch pipeline) and the ``middlebury`` command.
    At 360x640 each entry on the card equals the port's CPU run bit for bit
    with its launches asserted; then timings at 720x1280 by stage and band
    count, the pipelines' frames per second, and the ``middlebury`` command
    on a synthetic scene on the card against the CPU. Returns the launches
    of the phase's asserted windows and its numbers."""
    from gpu_stereo_matching_tpu_torch.bench.middlebury import BM_CONFIG, pipeline_disparity
    from gpu_stereo_matching_tpu_torch.core.config import MeshConfig, SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.io.middlebury import MiddleburyScene
    from gpu_stereo_matching_tpu_torch.models import segment_tree as st
    from gpu_stereo_matching_tpu_torch.models import segment_tree_tiled as tiled_module
    from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import SegmentTreeBatchPipeline
    from gpu_stereo_matching_tpu_torch.models.segment_tree_tiled import (
        st1_disparity_tiled,
        st2_disparity_tiled,
    )
    from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8
    from gpu_stereo_matching_tpu_torch.parallel import segment_tree as pst
    from gpu_stereo_matching_tpu_torch.parallel.mesh import virtual_mesh
    from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan, tree_filter_nodes_sb

    cfg = SegmentTreeConfig()  # D=60, sigma 0.1, sigma_1 0.08, tau 1200, min size 50, r=3, x4
    num_d = cfg.max_disp_levels
    cpu = torch.device("cpu")
    totals = dict.fromkeys(("ctmf_median", "sad_volume", "wta_from_sad", "gray"), 0)

    def mesh(space, device=dev):
        return virtual_mesh(MeshConfig(1, space, 1), device)

    def launched(run, what, **want_nonzero):
        """``run()`` with every counter at 0 just before; the counters must
        read ``want_nonzero`` just after and every other kernel 0."""
        torch.cuda.synchronize()
        zero_launches()
        out = run()
        torch.cuda.synchronize()
        got = all_launches()
        want = {**dict.fromkeys(got, 0), **want_nonzero}
        if got != want:
            raise AssertionError(f"{what} launched {got}, not {want}")
        for k, v in want_nonzero.items():
            totals[k] += v
        return out

    def share(a, b):
        return float((a.cpu() == b.cpu()).float().mean())

    # 1-2. The card against the port's CPU run at 360x640, bit for bit, each
    # entry point's launches asserted: D once a band of an ST-1 frame, three
    # times a band of an ST-2 frame.
    t_phase = time.perf_counter()
    left, right, _truth = st_pair(ST_CHECK_HW)
    entries = {
        "st1_tiled_4": (lambda d: st1_disparity_tiled(left, right, 4, cfg, device=d), 4),
        "st1_tiled_3": (lambda d: st1_disparity_tiled(left, right, 3, cfg, device=d), 3),
        "st1_tiled_1": (lambda d: st1_disparity_tiled(left, right, 1, cfg, device=d), 1),
        "st2_tiled_4": (lambda d: st2_disparity_tiled(left, right, 4, cfg, device=d), 12),
        "st1_sharded_1x4x1": (lambda d: pst.st1_disparity_sharded(left, right, mesh(4, d), cfg), 4),
        "st2_sharded_1x4x1": (lambda d: pst.st2_disparity_sharded(left, right, mesh(4, d), cfg), 12),
    }
    card, equal = {}, {}
    for name, (run, d_per_frame) in entries.items():
        card[name] = launched(lambda run=run: run(dev), name, ctmf_median=d_per_frame)
        if card[name].device != dev or tuple(card[name].shape) != ST_CHECK_HW:
            raise AssertionError(f"{name} gave {tuple(card[name].shape)} on {card[name].device}")
        equal[name] = share(card[name], run(cpu))
    frames, _ = st_frames(ST_CHECK_HW, TILED_CHECK_FRAMES)
    frames_run = -(-len(frames) // 2) * 2  # the short last group is padded

    def banded(device):
        pipe = SegmentTreeBatchPipeline(cfg, group_size=2, workers=2, bands=4, device=device)
        return list(pipe.process(frames))

    pipe_card = launched(lambda: banded(dev), "banded pipeline", ctmf_median=4 * frames_run)
    pipe_cpu = banded(cpu)
    equal["pipeline_bands_4"] = min(share(a, b) for a, b in zip(pipe_card, pipe_cpu))
    tiled_frames = [st1_disparity_tiled(lf, rt, 4, cfg, device=dev) for lf, rt in frames]
    relations = {
        "st1_sharded_equals_tiled": share(card["st1_sharded_1x4x1"], card["st1_tiled_4"]),
        "st2_sharded_equals_tiled": share(card["st2_sharded_1x4x1"], card["st2_tiled_4"]),
        "pipeline_equals_tiled": min(share(a, b) for a, b in zip(pipe_card, tiled_frames)),
        "tiled_1_equals_st1": share(card["st1_tiled_1"], st.st1_disparity(left, right, cfg)),
    }
    ok = (all(v == 1.0 for v in (*equal.values(), *relations.values()))
          and len(pipe_card) == len(frames))
    log("18-tiled-card-vs-cpu", shape=[*ST_CHECK_HW, num_d], equal_share_card_vs_cpu=equal,
        equal_share_on_the_card=relations, pipeline={"frames": len(frames), "group": 2,
                                                     "bands": 4, "frames_run": frames_run},
        launches_d=dict(totals), seconds=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        raise AssertionError("the per-band ST entries differ between the card and the CPU or "
                             "from each other")
    del card, pipe_card, pipe_cpu, tiled_frames

    # 3. Timings at 720x1280, warmed. Each tiled ST-1 band count: one call
    # with its stages probed (the host stages by the host clock, summed over
    # bands), whose filter and median calls are replayed on their own inputs
    # by events and under the profiler; it is also the warm-up of the frame
    # then timed by the host clock, and the sharded ST-1 on (1, bands, 1)
    # must equal that frame. Then ST-2, the pipelines, and the accuracy of
    # each band count.
    t_phase = time.perf_counter()
    left, right, truth = st_pair(ST_HW)
    global_map = st.st1_disparity(left, right, cfg)

    def accuracy(m, reference):
        diff = (m.to(torch.int32) - reference.to(torch.int32)).abs()
        return {"within_two_levels_of_global_tree": float(
                    (diff <= 2 * cfg.disparity_scale).float().mean()),
                "within_one_level_of_truth": within_one(m, truth, cfg)}

    def host_ms(calls, *names):
        return sum(ms for name in names for ms, _args, _out in calls[name])

    st1_tiled = {}
    for bands in TILED_BANDS:
        with probed(tiled_module, "color_gradient_cost_volume") as cost_calls, \
                probed(st, "color_edge_weights", "build_segment_tree", "tree_filter_nodes_sb",
                       "median_filter_u8") as calls, \
                probed(StridePlan, "from_tree") as emits:
            probed_map = st1_disparity_tiled(left, right, bands, cfg)
        calls.update(cost_calls, **emits)
        frame, tiled_map = host_timed(lambda: st1_disparity_tiled(left, right, bands, cfg))
        seen = {name: len(v) for name, v in calls.items()}
        if (seen != {**dict.fromkeys(calls, bands), "color_gradient_cost_volume": 1}
                or not torch.equal(probed_map, tiled_map)):
            raise AssertionError(f"tiled ST-1 with {bands} bands: probes saw {seen} calls")
        filter_args = [args for _ms, args, _out in calls["tree_filter_nodes_sb"]]
        median_args = [args for _ms, args, _out in calls["median_filter_u8"]]

        def filters():
            return [tree_filter_nodes_sb(*args) for args in filter_args]

        prof = device_profile(filters, 1, lambda name: "filter")
        st1_tiled[bands] = {
            "host_ms": {"edge_weights": host_ms(calls, "color_edge_weights"),
                        "tree_build": host_ms(calls, "build_segment_tree"),
                        "plan_emit_and_upload": host_ms(calls, "from_tree")},
            "host_ms_sum": host_ms(calls, "color_edge_weights", "build_segment_tree",
                                   "from_tree"),
            "device_ms": {"cost_volume_by_host_clock": host_ms(calls, "color_gradient_cost_volume"),
                          "filter_by_events": events_ms(filters),
                          "median_D_by_events": cuda_ms(lambda: [median_filter_u8(*args)
                                                                 for args in median_args], 3)},
            "filter_launches_per_frame": prof.get("device_kernels"),
            "filter_busy_ms": prof.get("busy_ms"), "filter_idle_share": prof.get("idle_share"),
            "frame_ms": frame,
            "rounds_by_band": [min(p.n_real, len(p.buckets)) for _nodes, p in filter_args],
            **accuracy(tiled_map, global_map)}
        if bands > 1 and not torch.equal(
                pst.st1_disparity_sharded(left, right, mesh(bands), cfg), tiled_map):
            raise AssertionError(f"sharded ST-1 on (1,{bands},1) differs from tiled")
        log("18-st1-tiled-time", shape=[*ST_HW, num_d], bands=bands,
            rows_by_band=[nodes.shape[0] // ST_HW[1] for nodes, _p in filter_args],
            sharded_equals_tiled=True if bands > 1 else None, **st1_tiled[bands])
        del calls, filter_args, median_args, probed_map
    torch.cuda.empty_cache()

    # ST-2 with 4 bands: st2_disparity warmed and timed; the sharded entry
    # run once with its stages probed, which also grows the band layouts;
    # then tiled timed, equal to sharded.
    st2, maps2 = {}, {}
    st2["st2_disparity_frame_ms"], maps2["st2_disparity"] = warm_then_timed(
        lambda: st.st2_disparity(left, right, cfg))
    with probed(pst, "_band_trees", "converged_stride_batch", "_st2_phase_a",
                "color_depth_edge_weights", "_st1_bands") as calls:
        sharded_ms, sharded = host_timed(lambda: pst.st2_disparity_sharded(left, right, mesh(4),
                                                                           cfg))
    st2["tiled_frame_ms"], maps2["tiled"] = host_timed(
        lambda: st2_disparity_tiled(left, right, 4, cfg))
    if not torch.equal(sharded, maps2["tiled"]):
        raise AssertionError("sharded ST-2 on (1,4,1) differs from tiled")
    trees, emits = ([ms for ms, _a, _o in calls[n]] for n in ("_band_trees",
                                                              "converged_stride_batch"))
    st2.update(
        sharded_probed_frame_ms=sharded_ms,
        sharded_host_ms={"sigma1_trees_both_views": sum(trees[:2]),
                         "sigma1_plan_emits_both_views": sum(emits[:2]),
                         "final_color_depth_weights": host_ms(calls, "color_depth_edge_weights"),
                         "final_trees": sum(trees[2:]), "final_plan_emit": sum(emits[2:])},
        sharded_phase_a_ms_with_fetch=host_ms(calls, "_st2_phase_a"),
        sharded_phase_b_ms_by_host_clock=host_ms(calls, "_st1_bands"),
        stable_share=float(calls["_st2_phase_a"][0][2][1].mean()),
        **accuracy(maps2["tiled"], maps2["st2_disparity"]))
    log("18-st2-tiled-time", shape=[*ST_HW, num_d], bands=4, mesh=[1, 4, 1],
        sharded_equals_tiled=True, **st2)
    del maps2, sharded, calls

    # The banded pipeline over 8 frames of their own trees, group 4, 4
    # workers, beside the per-frame ST-1 over the same frames; each band
    # count runs the first group once to grow the layout registry, then the
    # 8 frames timed.
    frames, _ = st_frames(ST_HW, ST_PIPELINE_FRAMES)

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(run())
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    per_frame, seq_s = timed(lambda: (st.st1_disparity(lf, rt, cfg) for lf, rt in frames))
    pipelines = {"sequential_st1_disparity": {"fps": len(frames) / seq_s, "seconds": seq_s}}
    for bands in TILED_BANDS:
        pipe = SegmentTreeBatchPipeline(cfg, group_size=ST_GROUP, workers=4, bands=bands,
                                        device=dev)
        timed(lambda: pipe.process(frames[:ST_GROUP]))
        maps, seconds = timed(lambda: pipe.process(frames))
        if bands == 1 and not all(torch.equal(a, b) for a, b in zip(maps, per_frame)):
            raise AssertionError("the batch pipeline with 1 band differs from st1_disparity")
        shares = [accuracy(a, b) for a, b in zip(maps, per_frame)]
        pipelines[f"bands_{bands}"] = {
            "fps": len(frames) / seconds, "seconds": seconds, "gain_over_sequential": seq_s / seconds,
            "within_two_levels_of_global_tree": [
                min(s["within_two_levels_of_global_tree"] for s in shares),
                max(s["within_two_levels_of_global_tree"] for s in shares)]}
    log("18-pipelines", shape=[*ST_HW, num_d], frames=len(frames), group=ST_GROUP, workers=4,
        cpu_count=os.cpu_count(), pipelines=pipelines)
    del per_frame, maps

    log("18-timings", seconds=time.perf_counter() - t_phase)

    # 4. The middlebury command on a synthetic scene at 360x640: its launches
    # asserted, its bad-2.0 lines on the card equal to the CPU's. Then bm's
    # and bm+'s maps, where E1 and E2 run at the harness's D = 80, on the
    # card equal to the CPU's bit for bit (phase 8 holds E1 and E2 to their
    # twins at this shape and at 720x1280).
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        middlebury_scene(root, ST_CHECK_HW)
        lines_card, bare_card = launched(lambda: middlebury_lines(root, "cuda"),
                                         "middlebury", **MIDDLEBURY_LAUNCHES)
        _lines_cpu, bare_cpu = middlebury_lines(root, "cpu")
    if bare_card != bare_cpu or len(bare_card) != len(MIDDLEBURY_PIPELINES.split(",")) + 1:
        raise AssertionError(f"middlebury on the card printed {bare_card}, on the CPU {bare_cpu}")
    left, right, _truth = st_pair(ST_CHECK_HW)
    scene = MiddleburyScene("Synth", left, right, None, None)
    bm_maps_equal = []
    for pipeline in ("bm", "bm+"):
        got = pipeline_disparity(scene, pipeline, device=dev)[0]
        want = pipeline_disparity(scene, pipeline, device="cpu")[0]
        if not np.array_equal(got, want):
            raise AssertionError(f"middlebury {pipeline}: the card's map differs from the CPU's "
                                 f"(max abs err {int(np.abs(got.astype(np.int64) - want).max())})")
        bm_maps_equal.append(pipeline)
    log("18-middlebury", shape=[*ST_CHECK_HW], pipelines=MIDDLEBURY_PIPELINES,
        card_lines=lines_card, equals_cpu=True, num_disparities=BM_CONFIG.num_disparities,
        bm_maps_equal_to_cpu=bm_maps_equal, seconds=time.perf_counter() - t_phase,
        seconds_since_start=time.perf_counter() - started, ok=True)
    return {"launches": totals, "st1_tiled": st1_tiled, "st2": st2, "pipelines": pipelines}

def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    # Before any output: without the package beside it the script prints nothing.
    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.kernels import _build, gray, remap, sad_wta
    from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig
    from gpu_stereo_matching_tpu_torch.ops import color
    from gpu_stereo_matching_tpu_torch.ops.remap import remap_bilinear_u8
    from gpu_stereo_matching_tpu_torch.ops.remap import rectify_gray_pair as plain_front_end
    from gpu_stereo_matching_tpu_torch.tree import builder as tree_builder
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
    # The tree library's g++ runs beside the kernels' nvcc processes.
    with ThreadPoolExecutor(1) as pool:
        tree_lib = pool.submit(tree_builder._compile_library)
        lib_path = _build.build()
        _build.load_library()
        tree_lib_path = tree_lib.result()
    log("2-build", seconds=time.perf_counter() - t0, library=lib_path.name,
        sources=len(list(_build.CSRC.glob("*.cu"))),
        tree_library=os.path.relpath(tree_lib_path))

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

    # 4. Kernel B's two entries vs their twins: the rig's maps at 720p, then
    # ragged shapes through wild maps; cases counted per body.
    size_hw, num_d, radius = (720, 1280), 64, 5
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=radius)
    rig = StereoRig(synthetic_calibration(), size_hw, cfg, device=dev)
    rig_maps = (rig.left_map_x, rig.left_map_y, rig.right_map_x, rig.right_map_y)
    remap_bodies = {entry: dict.fromkeys(remap.BODIES, 0) for entry in ("u8", "front_end")}

    def check_b(entry, frames, maps, what):
        """One launch of ``entry`` against its twin; returns the body it ran."""
        before = dict(remap.BODY_LAUNCHES)
        if entry == "u8":
            got, want = [remap.remap_bilinear_u8_direct(frames[0], *maps[:2])], \
                [remap_bilinear_u8(frames[0], *maps[:2])]
        else:
            got = remap.rectify_gray_pair(frames[0], frames[1], *maps)
            want = plain_front_end(frames[0], frames[1], *maps)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"remap {entry} differs from its twin ({what})")
        body = next(k for k in remap.BODIES if remap.BODY_LAUNCHES[k] == before[k] + 1)
        remap_bodies[entry][body] += 1
        return body

    rig_bodies = set()
    for b in (1, 3, 8):
        src = u8((b, *size_hw))
        for view in (0, 1):
            rig_bodies.add(check_b("u8", [src], rig_maps[2 * view:2 * view + 2],
                                   f"rig view {view}, B={b}"))
        rig_bodies.add(check_b("front_end", [u8((b, *size_hw, 3)), u8((b, *size_hw, 3))], rig_maps,
                               f"rig, B={b}"))
    rng_b = np.random.default_rng(SEED + 4)
    for hs, ws, ho, wo, b, offset, aligned in REMAP_CASES:
        maps = []
        for _ in range(2):
            for m in wild_maps(rng_b, hs, ws, ho, wo):
                t = torch.from_numpy(m).to(dev)
                if not aligned:  # the same map one float off its 16-byte alignment
                    t = torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(ho, wo)
                maps.append(t)
        for channels, entry in ((None, "u8"), (3, "front_end")):
            shape = (b, hs, ws) if channels is None else (b, hs, ws, channels)
            frames = [u8(offset + int(np.prod(shape)))[offset:].view(shape) for _ in range(2)]
            for view in (0, 1) if entry == "u8" else (0,):
                check_b(entry, frames[view:], maps[2 * view:] if entry == "u8" else maps,
                        f"{(hs, ws, ho, wo, b, offset, aligned)}")
    valid_share = float((remap_bilinear_u8(torch.full(size_hw, 255, dtype=torch.uint8, device=dev),
                                           rig.left_map_x, rig.left_map_y) > 0).float().mean())
    if not all(all(v.values()) for v in remap_bodies.values()) or rig_bodies != {"vector"}:
        raise AssertionError(f"phase 4 must cover both bodies of each entry and take the vector "
                             f"body at 720p: {remap_bodies}, {rig_bodies}")
    if valid_share < 0.8:
        raise AssertionError(f"rectification maps keep only {valid_share:.3f} of the frame")
    log("4-remap-kernel-vs-twin", rig=[*size_hw], batches=[1, 3, 8],
        ragged_cases=len(REMAP_CASES), cases_by_entry_and_body=remap_bodies,
        body_at_720p=rig_bodies.pop(), max_abs_err=0, valid_share=valid_share, ok=True)

    # 5. Kernel G vs the twin on the CPU over all 2**24 BGR triples, then on
    # ragged lengths and unaligned bases; the twin on the card vs the CPU.
    v = np.arange(1 << 24, dtype=np.uint32)
    triples = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], axis=-1)
    triples = torch.from_numpy(triples.astype(np.uint8).reshape(4096, 4096, 3))
    gray_bodies = dict.fromkeys(gray.BODIES, 0)
    for name in ("gray_blockmatching_bgr", "gray_rec601_bgr"):
        want = getattr(color, name)(triples)
        on_card = triples.to(dev)
        if not torch.equal(getattr(gray, name)(on_card).cpu(), want):
            raise AssertionError(f"gray kernel {name} differs from its twin")
        if not torch.equal(getattr(color, name)(on_card).cpu(), want):
            raise AssertionError(f"{name} differs between the card and the CPU")
        gray_bodies[gray.gray_kernel_body(on_card, torch.empty_like(on_card[..., 0]))] += 1
        flat = on_card.reshape(-1)
        for n in (1, 15, 16, 17, 4099, 1 << 20):
            for offset in (0, 1, 3, 16):
                img = flat[offset:offset + 3 * n].view(n, 3)
                out = torch.empty(n, dtype=torch.uint8, device=dev)
                gray_bodies[gray.gray_kernel_body(img, out)] += 1
                if not torch.equal(getattr(gray, name)(img).cpu(), getattr(color, name)(img.cpu())):
                    raise AssertionError(f"gray kernel {name} differs at n={n}, offset {offset}")
        del on_card, flat
    if not all(gray_bodies.values()):
        raise AssertionError(f"phase 5 must cover both bodies of the gray kernel: {gray_bodies}")
    log("5-gray-kernel-vs-twin", triples=1 << 24, conventions=2, cases_by_body=gray_bodies,
        max_abs_err=0, twin_card_equals_cpu=True, ok=True)

    # 6. The main path.
    pairs = [(u8((*size_hw, 3)), u8((*size_hw, 3))) for _ in range(3)]
    lb, rb = u8((8, *size_hw, 3)), u8((8, *size_hw, 3))
    torch.cuda.synchronize()
    sad_wta.LAUNCHES = remap.LAUNCHES = remap.PAIR_LAUNCHES = gray.LAUNCHES = 0
    timer = StageTimer()
    singles = [rig.process(l, r, timer=timer) for l, r in pairs]
    launches = {"sad_wta_single": sad_wta.LAUNCHES, "front_end_single": remap.PAIR_LAUNCHES}
    if [s.name for s in timer.spans] != ["frame"] * 3:
        raise AssertionError(f"rig.process recorded {timer.spans}, not one frame span per pair")
    batch = rig.process_batch(lb, rb)
    torch.cuda.synchronize()
    launches.update(sad_wta_batched=sad_wta.LAUNCHES - launches["sad_wta_single"],
                    front_end_batched=remap.PAIR_LAUNCHES - launches["front_end_single"],
                    remap_u8=remap.LAUNCHES, gray=gray.LAUNCHES)
    if launches != {"sad_wta_single": 3, "front_end_single": 3, "sad_wta_batched": 1,
                    "front_end_batched": 1, "remap_u8": 0, "gray": 0}:
        raise AssertionError(f"main path did not launch every kernel as expected: {launches}")

    def plain_path(left_bgr, right_bgr):
        rl, rr = plain_front_end(left_bgr, right_bgr, *rig_maps)
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
    # Kernel G: one 1080p image, and per image over a 720p batch of 8.
    img_1080, bgr_8 = u8((1080, 1920, 3)), u8((8, *size_hw, 3))
    times_g = {}
    for what, img, count in (("1080p_one_image", img_1080, 1), ("720p_batch_of_8", bgr_8, 8)):
        run = lambda img=img: gray.gray_blockmatching_bgr(img)  # noqa: E731
        times_g[what] = {
            "ms_per_image": cuda_ms(run) / count,
            "device_ms_per_image": ratio(device_ms_per_call(run)[0], count),
            "plain_ms_per_image": cuda_ms(lambda img=img: color.gray_blockmatching_bgr(img),
                                          reps=3) / count,
            "bound_ms_per_image": bound(*gray_work(img.numel() // 3 // count))["bound_ms"]}
    log("7-time", kernel="gray_u8", convention="block matching", times=times_g)
    # Kernel B's u8 entry, at 720p through the left view's maps.
    n_720 = size_hw[0] * size_hw[1]
    mx, my = rig.left_map_x, rig.left_map_y
    times_b = {}
    for b in (1, 8):
        g = u8((b, *size_hw))
        run = lambda g=g: remap.remap_bilinear_u8_direct(g, mx, my)  # noqa: E731
        times_b[b] = {
            "ms_per_frame": cuda_ms(run) / b,
            "device_ms_per_frame": ratio(device_ms_per_call(run)[0], b),
            "plain_ms_per_frame": cuda_ms(lambda g=g: remap_bilinear_u8(g, mx, my)) / b,
            "bound_ms_per_frame": bound(*remap_work(b, n_720, 1, False))["bound_ms"] / b}
    log("7-time", kernel="remap", shape=[*size_hw], by_batch=times_b,
        plan=remap.front_end_plan(size_hw, size_hw, 8, views=1, device=dev))

    # The front end, B = 1 and 8, beside the composition it replaces (the
    # plain gray on the card, then a u8 remap launch per view) and the twin.
    def composition(left_bgr, right_bgr):
        return tuple(remap.remap_bilinear_u8_direct(color.gray_blockmatching_bgr(bgr), mx_, my_)
                     for bgr, mx_, my_ in ((left_bgr, *rig_maps[:2]), (right_bgr, *rig_maps[2:])))

    times_f = {}
    for b, (left_bgr, right_bgr) in ((1, pairs[0]), (8, (lb, rb))):
        run = lambda l=left_bgr, r=right_bgr: remap.rectify_gray_pair(l, r, *rig_maps)  # noqa: E731
        comp = lambda l=left_bgr, r=right_bgr: composition(l, r)  # noqa: E731
        device, kernels = device_ms_per_call(run)
        comp_device, comp_kernels = device_ms_per_call(comp)
        times_f[b] = {
            "ms": cuda_ms(run), "device_ms": device, "kernels_seen_per_call": kernels,
            "composition_ms": cuda_ms(comp), "composition_device_ms": comp_device,
            "composition_kernels_seen_per_call": comp_kernels,
            "plain_ms": cuda_ms(lambda l=left_bgr, r=right_bgr: plain_front_end(l, r, *rig_maps),
                                reps=3),
            **bound(*remap_work(b, n_720, 2, True))}
    log("7-time", kernel="rectify_gray_pair", shape=[*size_hw], views=2, by_batch=times_f,
        plan=remap.front_end_plan(size_hw, size_hw, 8, device=dev))
    t_rig = cuda_ms(lambda: rig.process_batch(lb, rb))
    t_plain_rig = cuda_ms(lambda: plain_path(lb, rb), reps=3)
    t_one = cuda_ms(lambda: rig.process(*pairs[0]))
    log("7-time", rig=[*size_hw, num_d, radius], batch=8, ms=t_rig, fps=8e3 / t_rig,
        plain_ms=t_plain_rig, plain_fps=8e3 / t_plain_rig, process_ms=t_one,
        process_fps=1e3 / t_one)
    log("7-profile", rig=[*size_hw, num_d, radius], batch=8,
        **device_profile(lambda: rig.process_batch(lb, rb), 10, rig_part))
    del a1, img_1080, bgr_8, lb, rb, pairs, singles, batch, triples
    torch.cuda.empty_cache()

    bm_launches, bm_plus = run_bm_plus_phases(dev, u8, synthetic_calibration())
    key_kernel = run_sharded_phases(dev, u8, t_a1)
    st1 = run_st1_phase(dev, started)
    st2 = run_st2_phase(dev, started)
    tiled = run_tiled_phase(dev, started)
    tiled_launches = tiled["launches"]

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
        # remap_work: 10 operations a pixel once a launch, 12 a pixel and
        # frame; the maps once, 1 byte in and 1 out a pixel and frame. No path
        # runs this entry since the rig's front end replaced it (phase 6).
        {**kernel_entry("remap_bilinear_u8", "remap.cu", "remap.py:457", launches["remap_u8"],
                        0, times_b[1]["ms_per_frame"], times_b[1]["plain_ms_per_frame"],
                        bound(*remap_work(1, n_720, 1, False)), None, [1, *size_hw]),
         "device_ms": times_b[1]["device_ms_per_frame"],
         "b8_ms_per_frame": times_b[8]["ms_per_frame"],
         "b8_device_ms_per_frame": times_b[8]["device_ms_per_frame"],
         "b8_bound_ms_per_frame": times_b[8]["bound_ms_per_frame"]},
        # remap_work from BGR: 10 operations a pixel once a launch, 44 a pixel
        # and frame; per view the maps once, 3 bytes in and 1 out a pixel and
        # frame. The rig's batch of 8 at 720p, both views.
        {**kernel_entry("rectify_gray_pair", "remap.cu", "remap.py:457",
                        launches["front_end_single"] + launches["front_end_batched"], 0,
                        times_f[8]["ms"], times_f[8]["plain_ms"],
                        bound(*remap_work(8, n_720, 2, True)), None, [2, 8, *size_hw, 3]),
         "device_ms": times_f[8]["device_ms"], "composition_ms": times_f[8]["composition_ms"],
         "b1_ms": times_f[1]["ms"], "b1_device_ms": times_f[1]["device_ms"]},
        # gray_work: 8 operations a pixel; 3 bytes in, 1 out. No TPU kernel:
        # the JAX package's gray is an XLA tensordot. Launches: the bm CLI's
        # two images (phase 10) and the middlebury command's bm and bm+
        # (phase 18).
        {**kernel_entry("gray_u8", "gray.cu", "", bm_launches["gray"] + tiled_launches["gray"], 0,
                        times_g["1080p_one_image"]["ms_per_image"],
                        times_g["1080p_one_image"]["plain_ms_per_image"], bound(*gray_work(px)),
                        None, [1080, 1920, 3]),
         "replaces": "gpu_stereo_matching_tpu/ops/color.py:33 (an XLA tensordot, no TPU kernel)",
         "device_ms": times_g["1080p_one_image"]["device_ms_per_image"],
         "launches_by_path": {"bm_cli": bm_launches["gray"], "middlebury": tiled_launches["gray"]}},
        key_kernel,
        # E1 and E2 run on bm+ (phase 10) and through the middlebury command's
        # bm and bm+ (phase 18).
        *({**entry, "launches": entry["launches"] + tiled_launches[name],
           "launches_by_path": {"bm+": entry["launches"], "middlebury": tiled_launches[name]}}
          for entry, name in zip(bm_plus[:2], ("sad_volume", "wta_from_sad"))),
        # Kernel D runs on every path with a median: once a bm+ frame (phase
        # 10), once an ST-1 frame (phase 16), three times an ST-2 frame (phase
        # 17) and so in the streaming pipelines (phase 17), once a band of a
        # tiled, sharded or banded ST-1 frame and three times a band of an
        # ST-2 one, and through the middlebury command (phase 18);
        # ``launches`` is their sum.
        {**bm_plus[2], "launches": (bm_plus[2]["launches"] + st1["launches"] + st2["launches"]
                                    + st2["pipeline_launches"] + tiled_launches["ctmf_median"]),
         "launches_by_path": {"bm+": bm_plus[2]["launches"], "st1": st1["launches"],
                              "st2": st2["launches"], "st_pipelines": st2["pipeline_launches"],
                              "per_band_st_and_middlebury": tiled_launches["ctmf_median"]},
         "st1_map_ms_by_shape": st1["median_ms"], "st2_map_ms_by_shape": st2["median_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
