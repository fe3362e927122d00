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
   time.perf_counter())`` after the build of phase 2;
19. the sharded step across processes and the rig's calibration workflow:
   (a) two gloo ranks on ``cuda:0``, each this script re-run as
   ``chip_smoke.py --rank RANK PORT DIR``, run the step (1080x1920, B=8,
   D=64, r=5) with ``space`` across the ranks on (1, 2, 1) and ``disp``
   across them on (1, 1, 2): each rank launches the key kernel once a step,
   its pieces equal the single-controller step and the fused kernel bit
   for bit, and the line prints the step's time (its slowest rank's, by
   CUDA events; a rehearsal, since gloo stages halos and keys through host
   memory) beside the single-controller step's; a rank that exits non-zero
   fails the phase; (b) one NCCL rank in this process runs the step on
   (1, 2, 2) with ``disp`` reduced by ``all_reduce(MIN)`` on the card's keys:
   4 launches, equal to the fused kernel and the single-controller step;
   (c) where there are two or more cards, ``parallel/launch.py`` with one
   NCCL rank a card and the single-controller launcher over the same cards,
   fps per ``data``, else a line saying it did not run; (d) ``calibrate``
   on four board poses rendered through a pinhole rig (1000 px focal
   length, 60 mm baseline) at 720x1280, which must recover the focal length
   and the baseline within 5%, then ``rectify`` at 720x1280 and with
   ``--size 640x360`` on the card (one front-end launch a call, no other
   kernel) and on the CPU, PNGs equal, then ``bm --gray`` on the rectified
   pair, the card's PNG equal to the CPU's. To run it alone:
   ``run_process_phase(torch.device("cuda:0"), time.perf_counter())`` after
   ``_build.build()``; (c) alone: ``run_multi_card()``;
20. the benches (``gpu_stereo_matching_tpu_torch/bench/``), each through
   its entry point on the card, with every counter at 0 just before and its
   exact launches just after (``bench_launches``), each JSON line it prints
   echoed under the phase and required to carry the card's name and power
   limit: the headline (B=32, 1080x1920, D=64, r=5; A2), ``micro`` at
   1080p (G, B's u8 entry, A1, E1, E2, D; the histogram median in plain
   torch), ``streaming`` on the synthetic calibration at 720x1280 (the
   front end and A2 once a batch), ``st_profile``, ``st_streaming``,
   ``st2_streaming``, ``st_hd`` and ``st_config3`` on a ``Synth`` scene of
   Art's own size, 370x463 (D once a frame or band, three times an ST-2
   frame), the roofline measured live (A through the headline at 1080p and
   4K, the front end, the filter on the scene's plan) and the scaling
   prediction (the headline's ms a frame as its compute). After each bench,
   the first launch of every kernel at each signature (shapes, types and
   other arguments) is held bit for bit against the kernel's plain twin on
   that launch's own inputs (``TwinRecorder``), so every shape the benches
   give a kernel is checked. The ST streaming benches' frames, cut for time
   to ``ST_STREAM_FRAMES``, are printed with their default in their bench's
   line. To run it alone: ``run_bench_phase(torch.device("cuda:0"), time.perf_counter())``
   after ``_build.build()``, ``_build.load_library()`` and
   ``tree.builder._compile_library()``;
21. the heavy-path, plan-order and coded tree filters of ``tree/hpd.py``
   and ST-1's device paths over them, on phase 16's scene: at 180x320 each
   formulation's filtered volume and map (HPD, plan-order, coded with the
   doubling and with the associative scan) on the card equal the port's
   CPU run bit for bit, and the coded filter with the associative scan
   equals the plan-order one; at 720x1280 on one tree, each plan's native
   build by the host clock and its bytes, each filter by CUDA events with
   its launches a call, busy time and idle share under ``torch.profiler``
   beside the stride filter on the same tree (the JAX tool
   ``tools/bench_stride.py``'s A/B), and each map's share equal to the
   stride map and within 1 level of the truth; then over 4 of phase 17's
   frames ``_st1_device_group`` with stacked plan-order and coded plans,
   ``_st1_device_batched`` and ``_st1_device_merged``, each with every
   counter at 0 just before and its exact launches of D just after, equal
   to its per-frame ``_st1_device`` calls bit for bit, and timed a frame
   by events with its launches a call. Every launch of D in the phase is
   counted against its loop counts and held, at each new signature, to
   its twin. To run it alone: ``run_hpd_phase(torch.device("cuda:0"),
   time.perf_counter())`` after the builds of phase 20;
22. kernel A1's ``mxu=True`` entry, the tensor-core body of
   ``csrc/sad_wta_mma.cu`` (both window sums on the tensor cores): on the
   packed-pair cases of ``EDGE_CASES`` and ``STRUCTURED_CASES`` at B = 1,
   ``MMA_EXTRA_CASES`` (D = W, D = 256, W = 9)
   and 1080x1920 D=64 r=5, random and structured, each launch equal bit for
   bit to its plain twin and to the strip body and counted; the entry once
   at 1080p with every counter at 0 just before and only its own launch
   after; timed by events in turns with the strip body (mma, strip, strip,
   mma), a lone call and a call of a burst of 20, both by device time under
   ``torch.profiler``, and at r = 1, 3, 5, with the launch plan; per
   radius ptxas's registers, spills and stack (from the build's report)
   and the dynamic shared memory at D=64; per radius from the SASS the
   IMMA, barrier and cp.async (LDGSTS) instructions of the body and, for
   each loop that holds an IMMA (the disparity loops), its instructions,
   IMMA, barriers, shared stores and local loads and stores (the phase
   fails if such a loop holds a barrier or a shared store, or a body no
   cp.async); the tensor-core share (the operations its products issue,
   band zeros included, over 1,979e12 a second, in the burst's time a
   call); and the first tensor-core body's figures (``MMA_PR16``) beside
   them. To run it alone: ``run_mma_phase(torch.device("cuda:0"), u8)``
   after ``_build.load_library()``, ``u8(shape)`` giving random uint8
   tensors on the card (about 30 s, 45 s with the build).

A ``seconds-by-phase`` line gives each phase's seconds, from the end of the
one before.

Each kernel's entry of the summary line carries its bound
(``bench/roofline.py``): the least time the card could take, the larger of
its bytes (each input read once, each output written once) over 3.35 TB/s
and its operations over 67e12 32-bit operations per second (the float32
rate outside the tensor cores; the data sheet gives no separate integer
rate). Operations are counted from the
separable running-sum form: per pixel and disparity 2 for the absolute
difference, 2 for the vertical and 2 for the horizontal running sum, plus
2 for the (min, argmin) update or 3 for the packed key and its minimum.
For the gray and remap kernels a fused multiply-add counts 2.

Then one JSON line with the kernels' summary, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.bench.fused_kernel import cuda_ms, wall_ms
from gpu_stereo_matching_tpu_torch.bench.roofline import (
    bound,
    fused_sad_work,
    gray_work,
    remap_work,
)
from gpu_stereo_matching_tpu_torch.bench.streaming import synthetic_calibration

SEED = 0
TIME_REPS = 7
# Host milliseconds ended by a synchronize, the median of the calls.
median_wall_ms = functools.partial(wall_ms, pick=statistics.median)
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
    launches of phase 10 by kernel and the entries of the summary line of
    E1, E2, D and E2's right-view body."""
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
    from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8
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
    t_phase = time.perf_counter()
    err_e1 = err_e2 = err_lr = 0
    right_views = 0
    bodies = {"strips": 0, "general": 0}
    for _, h, w, d, r in EDGE_CASES + [(1, 1080, 1920, 64, 5)] + MIDDLEBURY_BM_CASES:
        left, right = u8((h, w)), u8((h, w))
        vol = split_phase.sad_volume(left, right, d, r)
        want = split_phase.sad_volume_reference(left, right, d, r)
        err_e1 = max(err_e1, differ(vol, want, f"sad_volume {(h, w, d, r)}"))
        bodies[split_phase.volume_kernel_body(d, r)] += 1
        disp = split_phase.wta_from_sad(vol)
        err_e2 = max(err_e2, differ(disp, wta_disparity(want), f"wta_from_sad {(h, w, d, r)}"))
        del want
        for max_diff, dtype in ((1, torch.uint8), (0, torch.int32)):
            err_lr = max(err_lr, differ(
                split_phase.lr_check_from_sad(vol, disp, max_diff, dtype),
                split_phase.lr_check_from_sad_reference(vol, disp, max_diff, dtype),
                f"lr_check_from_sad {(h, w, d, r)} max_diff={max_diff} {dtype}"))
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
    log("8-split-phase-vs-twin", seconds=time.perf_counter() - t_phase,
        cases=len(EDGE_CASES) + 1 + len(MIDDLEBURY_BM_CASES) + structured,
        structured_cases=structured, cases_by_body=bodies,
        body_of_64_5=split_phase.volume_kernel_body(64, 5),
        right_views_with_int32_max=right_views,
        max_abs_err_sad_volume=err_e1, max_abs_err_wta=err_e2, max_abs_err_lr_check=err_lr,
        ok=True)

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
    log("9-median-vs-twin", seconds=time.perf_counter() - t_phase,
        cases=cases, structured_cases=structured, cases_by_body=bodies,
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
        exactly ``want``: E1, E2, E2's right-view body and D once per frame, the front
        end once per rig call, the gray kernel once per image loaded, the u8
        remap never."""
        split_phase.LAUNCHES.update(dict.fromkeys(split_phase.LAUNCHES, 0))
        ctmf_median.LAUNCHES = remap.LAUNCHES = remap.PAIR_LAUNCHES = gray.LAUNCHES = 0
        out = run()
        torch.cuda.synchronize()
        got = {**split_phase.LAUNCHES, "ctmf_median": ctmf_median.LAUNCHES,
               "front_end": remap.PAIR_LAUNCHES, "gray": gray.LAUNCHES, "remap_u8": remap.LAUNCHES}
        if got != want:
            raise AssertionError(f"{what} launched {got}, not {want}")
        return out, got

    def per_frame(frames, front_ends=0, grays=0):
        return {"sad_volume": frames, "wta_from_sad": frames, "lr_check_from_sad": frames,
                "ctmf_median": frames, "front_end": front_ends, "gray": grays, "remap_u8": 0}

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
    log("10-bm-plus-path", seconds=time.perf_counter() - t_phase,
        config=[64, 5, "lr", 1, "median", 3], pipeline_pairs=[2, 1080, 1920],
        true_disparity_share=hits, rig=[*rig_hw], rig_process_pairs=3, rig_batch=4,
        cli=[1080, 1920], cli_true_disparity_share=cli_hit, launches_pipeline=n_pipeline,
        launches_rig=n_rig, launches_cli=n_cli, ok=True)
    del disp2, left2, right2, rig, rig_pairs, rig_singles, rig_lb, rig_rb, rig_batch, cli_disp
    torch.cuda.empty_cache()

    # 11. Timings at 1080p.
    l1, r1 = pairs[0]
    vol = split_phase.sad_volume(l1, r1, 64, 5)
    t_e1 = cuda_ms(lambda: split_phase.sad_volume(l1, r1, 64, 5), TIME_REPS)
    p_e1 = cuda_ms(lambda: split_phase.sad_volume_reference(l1, r1, 64, 5), reps=3)
    ring = [(u8((1080, 1920)), u8((1080, 1920))) for _ in range(8)]

    def volumes_of_ring():
        for left, right in ring:
            split_phase.sad_volume(left, right, 64, 5)

    t_e1_ring = cuda_ms(volumes_of_ring, TIME_REPS) / len(ring)
    del ring
    # What the card takes to write the volume's bytes at all: a plain fill.
    scratch = torch.empty_like(vol)
    t_fill = cuda_ms(lambda: scratch.fill_(1), TIME_REPS)
    del scratch
    t_e2 = cuda_ms(lambda: split_phase.wta_from_sad(vol), TIME_REPS)
    p_e2 = cuda_ms(lambda: wta_disparity(vol), TIME_REPS)
    # The yardstick, used nowhere in the port.
    lib_e2 = cuda_ms(lambda: torch.argmin(vol, dim=0), TIME_REPS)
    img = u8((1080, 1920))
    p_d = {r: cuda_ms(lambda: median_filter_u8(img, r, "histogram"), reps=3) for r in (3, 7)}
    log("11-time", kernel="sad_volume", shape=[1080, 1920, 64, 5], ms=t_e1, plain_ms=p_e1,
        ms_per_pair_over_a_ring_of_8=t_e1_ring, fill_of_the_same_bytes_ms=t_fill,
        plan=split_phase.volume_launch_plan((1080, 1920), 64, 5, dev),
        general_body_plan_at_r_8=split_phase.volume_launch_plan((1080, 1920), 64, 8, dev))
    log("11-time", kernel="wta_from_sad", shape=[1080, 1920, 64, 5], ms=t_e2, plain_ms=p_e2)
    t_bm = cuda_ms(lambda: block_matching_pipeline(l1, r1, cfg), TIME_REPS)
    p_bm = cuda_ms(lambda: block_matching_reference(l1, r1, cfg), reps=3)
    log("11-time", path="bm+", shape=[1080, 1920, 64, 5], median_radius=3, ms_per_frame=t_bm,
        fps=1e3 / t_bm, plain_ms_per_frame=p_bm, plain_fps=1e3 / p_bm)
    disp = split_phase.wta_from_sad(vol)
    t_lr = cuda_ms(lambda: split_phase.lr_check_from_sad(vol, disp, 1, torch.uint8), TIME_REPS)
    p_lr = cuda_ms(lambda: split_phase.lr_check_from_sad_reference(vol, disp, 1, torch.uint8),
                   TIME_REPS)
    log("11-time", kernel="lr_check_from_sad", shape=[1080, 1920, 64, 5], ms=t_lr, plain_ms=p_lr)
    masked = split_phase.lr_check_from_sad(vol, disp, 1, torch.uint8)
    stages = {
        "sad_volume": t_e1,
        "wta_from_sad": t_e2,
        "lr_check_from_sad": t_lr,
        "median_r3": cuda_ms(lambda: ctmf_median.ctmf_median_u8(masked, 3), TIME_REPS),
    }
    log("11-time", path="bm+ by stage", shape=[1080, 1920, 64, 5], stages_ms=stages,
        sum_ms=sum(stages.values()), frame_ms=t_bm)
    del vol, disp
    torch.cuda.empty_cache()

    # The median kernel alone: random images and the bm+ masked disparity
    # map, one image (which stays in the L2) and per image over a ring of 8
    # (the map's ring: the map rolled along its rows by 8 offsets).
    def masked_map(left, right):
        v = split_phase.sad_volume(left, right, 64, 5)
        return split_phase.lr_check_from_sad(v, split_phase.wta_from_sad(v), 1, torch.uint8)

    maps = {(1080, 1920): masked,
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
                    "one_image": cuda_ms(lambda: ctmf_median.ctmf_median_u8(ring[0], r), TIME_REPS),
                    "per_image_over_a_ring_of_8": cuda_ms(run_ring, TIME_REPS) / len(ring),
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
        # E2's right-view body: a compare and select per element of the
        # volume, read on its diagonal, and the check per pixel; the volume
        # and the left map in, the uint8 map out.
        {**kernel_entry("lr_check_from_sad", "split_phase.cu", "", launches["lr_check_from_sad"],
                        err_lr, t_lr, p_lr, bound(2 * 64 * px, (4 * 64 + 4 + 1) * px), None,
                        [64, 1080, 1920]),
         "replaces": "gpu_stereo_matching_tpu/models/block_matching.py:66-70 (_right_view_sad, "
                     "its wta_disparity, lr_consistency_mask, where: XLA, no TPU kernel)"},
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
    t_c = cuda_ms(lambda: key(l1, r1, 0, 64, 64, 5), TIME_REPS)
    t_a = cuda_ms(lambda: sad_wta.fused_block_matching_batched(l1, r1, 64, 5), TIME_REPS)
    p_c = cuda_ms(lambda: key_twin(l1, r1, 0, 64, 64, 5), reps=3)
    t_c16 = cuda_ms(lambda: key(l1, r1, 16, 16, 64, 5), TIME_REPS)
    p_c16 = cuda_ms(lambda: key_twin(l1, r1, 16, 16, 64, 5), reps=3)
    log("15-time", kernel="sad_wta_key", shape=[1, *hw, 5], range=[0, 64, 64], ms=t_c,
        plain_ms=p_c, fused_kernel_ms=t_a, fused_kernel_ms_phase_7=t_fused_b1,
        plan=sad_wta.key_launch_plan((1, *hw), 64, 64, 5, dev))
    log("15-time", kernel="sad_wta_key", shape=[1, *hw, 5], range=[16, 16, 64], ms=t_c16,
        plain_ms=p_c16, plan=sad_wta.key_launch_plan((1, *hw), 16, 64, 5, dev))
    t_a8 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(left8, right8, 64, 5), TIME_REPS)
    t_c8 = cuda_ms(lambda: key(left8, right8, 0, 64, 64, 5), TIME_REPS)
    t_c8_16 = cuda_ms(lambda: key(left8, right8, 16, 16, 64, 5), TIME_REPS)
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
    per_frame = {str(shape): cuda_ms(lambda: step(sl, sr), TIME_REPS) / 8
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
            "halo_slabs": cuda_ms(halos, TIME_REPS),
            "key_kernel_launches": cuda_ms(kernels, TIME_REPS),
            "crop_and_minimum_over_disp": cuda_ms(minimum, TIME_REPS),
            "mod_and_cast": cuda_ms(lambda: [(k % num_d).to(torch.int32) for k in reduced],
                                    TIME_REPS),
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
# Timed calls a stage at 720p in phases 16 and 17, cut for time from 5 and 2.
ST1_TIME_REPS, ST2_TIME_REPS = 3, 1
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

    split_phase.LAUNCHES.update(dict.fromkeys(split_phase.LAUNCHES, 0))
    ctmf_median.LAUNCHES = remap.LAUNCHES = remap.PAIR_LAUNCHES = gray.LAUNCHES = 0
    sad_wta.LAUNCHES = sad_wta.KEY_LAUNCHES = sad_wta.MMA_LAUNCHES = 0


def all_launches() -> dict:
    """Every kernel's launch counter."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median, gray, remap, sad_wta, split_phase

    return {**split_phase.LAUNCHES, "ctmf_median": ctmf_median.LAUNCHES,
            "sad_wta": sad_wta.LAUNCHES, "sad_wta_key": sad_wta.KEY_LAUNCHES,
            "sad_wta_mma": sad_wta.MMA_LAUNCHES,
            "front_end": remap.PAIR_LAUNCHES, "remap_u8": remap.LAUNCHES, "gray": gray.LAUNCHES}


def st_part(name: str) -> str:
    """The part of an ST-1 frame that a device kernel belongs to."""
    if "rank_select_kernel" in name or "histogram_kernel" in name:
        return "median_kernel_D"
    return "torch_ops"


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
        reps = ST1_TIME_REPS if hw == ST_HW else 3
        left, right, truth = st_pair(hw)
        weights = color_edge_weights(left)
        tree = build_segment_tree(weights, *hw, tau=cfg.tau, min_size=cfg.min_size_seg,
                                  penalty=cfg.penalty_cross_seg)
        plan = build_stride_plan(tree, cfg.sigma)
        host = {
            "edge_weights": median_wall_ms(lambda: color_edge_weights(left), reps, dev),
            "tree_build": median_wall_ms(lambda: build_segment_tree(
                weights, *hw, tau=cfg.tau, min_size=cfg.min_size_seg,
                penalty=cfg.penalty_cross_seg), reps, dev),
            "plan_emit": median_wall_ms(lambda: build_stride_plan(tree, cfg.sigma), reps, dev),
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
        whole = median_wall_ms(lambda: st.st1_disparity(left, right, cfg), reps, dev)
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
            within_one_level_share=within_one(st.st1_disparity(left, right, cfg), truth, cfg),
            **({"cut_for_time": {"reps": {"default": 5, "ran": reps}}} if hw == ST_HW else {}))
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
        reps = 1 if hd else ST2_TIME_REPS
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
            "sigma1_weights_both_views": median_wall_ms(
                lambda: (color_edge_weights(left), color_edge_weights(right)), reps, dev),
            "sigma1_trees_both_views": median_wall_ms(
                lambda: (build_segment_tree(w_l, *hw, **tree_args),
                         build_segment_tree(w_r, *hw, **tree_args)), reps, dev),
            "sigma1_plans_both_views": median_wall_ms(
                lambda: (build_stride_plan(t_l, cfg.sigma_one),
                         build_stride_plan(t_r, cfg.sigma_one)), reps, dev),
            "final_weights": median_wall_ms(lambda: color_depth_edge_weights(
                left, disp_l[0], mask[0], num_d, cfg.alpha_dep_seg), reps, dev),
            "final_tree": median_wall_ms(
                lambda: build_segment_tree(w_f, *hw, **tree_args, weight_scale=255.0), reps, dev),
            "final_plan": median_wall_ms(lambda: build_stride_plan(t_f, cfg.sigma), reps, dev),
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
        # registry has grown for them: one call at 1080p, ST2_TIME_REPS
        # after a warm-up at 720p (the main path's line has its accuracy),
        # where the profiler then traces one more.
        if hd:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accuracy = within_one(st.st2_disparity(left, right, cfg), truth, cfg)
            whole = (time.perf_counter() - t0) * 1e3
        else:
            accuracy = None
            whole = median_wall_ms(lambda: st.st2_disparity(left, right, cfg), reps, dev)
        frame_prof = (None if hd else
                      device_profile(lambda: st.st2_disparity(left, right, cfg), 1, st_part))
        times[f"{hw[0]}x{hw[1]}"] = {"median_D_final_map": device["median_D_final_map"]}
        log("17-st2-time", shape=[*hw, num_d], host_ms=host, host_ms_sum=sum(host.values()),
            device_ms_by_events=device, phase1_fetch_ms=fetch_ms,
            stable_share=float(mask.mean()), st2_disparity_ms=whole, frame_profile=frame_prof,
            within_one_level_share=accuracy, seconds=time.perf_counter() - t_stage,
            **({} if hd else {"cut_for_time": {"reps": {"default": 2, "ran": reps}}}))
        del lb, rb, plans1_dev, plan2_dev, packed, cost, final_map
        torch.cuda.empty_cache()
    return {"launches": launches["ctmf_median"], "pipeline_launches": pipeline_launches,
            "median_ms": times, "pipelines": pipelines}


TILED_CHECK_FRAMES = 5   # frames of the banded pipeline's check at 360x640, group 2
TILED_BANDS = (1, 4, 8)  # band counts timed at 720x1280
MIDDLEBURY_PIPELINES = "bm,bm+,st1,st2"
# Launches of one `middlebury` run over one scene with MIDDLEBURY_PIPELINES
# on the card: bm and bm+ convert both views with G, bm runs E1 and E2 once,
# bm+ E1, E2, E2's right-view body and D once each; ST-1 runs D once, ST-2
# three times.
MIDDLEBURY_LAUNCHES = {"gray": 4, "sad_volume": 2, "wta_from_sad": 2, "lr_check_from_sad": 1,
                       "ctmf_median": 5}


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
    totals = dict.fromkeys(("ctmf_median", "sad_volume", "wta_from_sad", "lr_check_from_sad",
                            "gray"), 0)

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

PROCESS_HW = (1080, 1920)    # the multi-process steps' frames, B = 8
RANK_TIMEOUT_S = 300
MULTI_CARD_FRAMES = (8, 64)  # batches of the launchers' data sweeps across cards
RIG_HW = (720, 1280)         # the rendered captures of the calibrate, rectify, bm flow
BOARD = (6, 6, 40.0)         # inner corners per row and column, square size in mm


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argvs, what: str):
    """Run one process per argv (this interpreter, from the repository
    root); kill them all past ``RANK_TIMEOUT_S``; fail if any exits non-zero.
    Returns their outputs."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, *argv], cwd=root, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{what}: a process outlived {RANK_TIMEOUT_S} s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: process {i} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def process_batch():
    """The rehearsal's 8 frame pairs, alike on every rank."""
    rng = np.random.default_rng(SEED + 19)
    return tuple(torch.from_numpy(rng.integers(0, 256, (8, *PROCESS_HW), dtype=np.uint8))
                 for _ in range(2))


def process_layouts(world: int) -> dict:
    """The axis laid across ``world`` ranks -> the mesh: one coordinate a rank."""
    return {"data": (world, 1, 1), "space": (1, world, 1), "disp": (1, 1, world)}


def rank_worker(argv) -> int:
    """One rank of phase 19, ``chip_smoke.py --rank RANK WORLD PORT DIR
    BACKEND``: under gloo every rank on ``cuda:0``, under NCCL rank r on
    ``cuda:r``. For each layout of :func:`process_layouts`: the step across
    the ranks with the key kernel's counter from 0, this rank's pieces
    against the single-controller step and the fused kernel on its card,
    the step's time (its slowest rank's, by CUDA events), two of its parts
    alone on this rank (the key kernel on a slab of its share,
    ``all_reduce(MIN)`` of keys of its share over its group) and, on rank 0
    while the others wait, the single-controller step's on its card.
    Writes ``DIR/rank<RANK>.json``."""
    rank, world, port, out_dir, backend = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.bench.scaling import time_step
    from gpu_stereo_matching_tpu_torch.core.config import MeshConfig
    from gpu_stereo_matching_tpu_torch.kernels import _build, sad_wta
    import torch.distributed as dist

    from gpu_stereo_matching_tpu_torch.parallel.collectives import all_reduce, barrier
    from gpu_stereo_matching_tpu_torch.parallel.launch import initialize_distributed
    from gpu_stereo_matching_tpu_torch.parallel.mesh import process_mesh, virtual_mesh
    from gpu_stereo_matching_tpu_torch.parallel.stereo import (
        make_sharded_block_matching,
        own_pieces,
        shard_batch,
        unshard,
    )

    dev = initialize_distributed(f"localhost:{port}", world, rank, backend=backend,
                                 device="cuda:0" if backend == "gloo" else f"cuda:{rank}",
                                 timeout=RANK_TIMEOUT_S)
    _build.load_library()
    cfg = BlockMatchingConfig(num_disparities=64, sad_radius=5)
    left, right = process_batch()
    fused = sad_wta.fused_block_matching_batched(left.to(dev), right.to(dev), 64, 5)
    found = {}
    for across, shape in process_layouts(world).items():
        mesh = process_mesh(MeshConfig(*shape), [dev], across=across)
        step = make_sharded_block_matching(mesh, cfg)
        sl, sr = shard_batch(mesh, left, right)
        torch.cuda.synchronize()
        sad_wta.KEY_LAUNCHES = 0
        pieces = own_pieces(step(sl, sr))
        torch.cuda.synchronize()
        launches = sad_wta.KEY_LAUNCHES
        one = virtual_mesh(MeshConfig(*shape), dev)
        single_step = make_sharded_block_matching(one, cfg)
        sl1, sr1 = shard_batch(one, left, right)
        single = unshard(single_step(sl1, sr1))
        frames, rows, count = 8 // shape[0], PROCESS_HW[0] // shape[1], 64 // shape[2]
        equal = {"single_controller": True, "fused_kernel": True}
        for (i, j), piece in pieces.items():
            block = (slice(i * frames, (i + 1) * frames), slice(j * rows, (j + 1) * rows))
            equal["single_controller"] &= torch.equal(piece, single[block])
            equal["fused_kernel"] &= torch.equal(piece, fused[block])
        step_ms = time_step(mesh, lambda: step(sl, sr), reps=5) * 1e3
        slab = torch.randint(0, 256, (frames, rows + 10, PROCESS_HW[1]), dtype=torch.uint8,
                             device=dev)
        keys = torch.zeros((frames, rows, PROCESS_HW[1]), dtype=torch.int32, device=dev)
        group = mesh.disp_groups[next(iter(pieces))]
        parts_ms = {
            "key_kernel": cuda_ms(lambda: sad_wta.fused_block_matching_key(
                slab, slab, 0, count, 64, 5), TIME_REPS),
            "all_reduce_min": cuda_ms(lambda: all_reduce(keys, dist.ReduceOp.MIN, group),
                                      TIME_REPS)}
        single_ms = time_step(one, lambda: single_step(sl1, sr1), reps=5) * 1e3 if rank == 0 \
            else None
        barrier()
        found[across] = {"mesh": list(shape), "pieces": sorted(pieces), "equal": equal,
                         "key_kernel_launches": launches, "step_ms": step_ms,
                         "parts_ms": parts_ms, "single_controller_step_ms": single_ms}
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    return 0


def render_board(h_mat, hw, cols: int, rows: int, square: float):
    """A chessboard of ``cols`` x ``rows`` inner corners, ``square`` units a
    square, seen through homography ``h_mat`` (board units -> pixels), white
    beyond it, at 2x2 supersampling and a slight blur: (H, W) uint8."""
    from scipy.ndimage import gaussian_filter

    ss = 2
    yy, xx = (np.mgrid[0:hw[0] * ss, 0:hw[1] * ss] + 0.5) / ss - 0.5
    src = np.linalg.inv(h_mat) @ np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size)])
    bx, by = src[0] / src[2] + square, src[1] / src[2] + square  # board origin at a corner
    inside = (bx >= 0) & (bx < (cols + 1) * square) & (by >= 0) & (by < (rows + 1) * square)
    dark = inside & ((np.floor(bx / square) + np.floor(by / square)) % 2 == 0)
    img = np.where(dark, 40.0, 215.0).reshape(hw[0], ss, hw[1], ss).mean((1, 3))
    return np.clip(gaussian_filter(img, 0.8), 0, 255).astype(np.uint8)


def rig_views(hw, square: float):
    """Homographies of four board poses seen by a left camera and by a
    right camera 60 mm beside it (a pinhole rig: K [r1 r2 t], board units
    in mm, the first inner corner at the origin), and the rig's truth."""
    def rodrigues(v):
        t = np.linalg.norm(v)
        k = np.asarray(v) / t
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(t) * kx + (1 - np.cos(t)) * kx @ kx

    k_left = np.array([[1000.0, 0, hw[1] / 2], [0, 1000.0, hw[0] / 2], [0, 0, 1]])
    k_right = np.array([[1004.0, 0, hw[1] / 2 + 3], [0, 1003.0, hw[0] / 2 - 2], [0, 0, 1]])
    r_rel, t_rel = rodrigues([0.002, -0.01, 0.001]), np.array([-60.0, 0.4, 0.5])
    centre = np.array([2.5 * square, 2.5 * square, 0])
    views = []
    for rv in ([0.35, 0.1, 0.02], [-0.3, 0.25, -0.03], [0.05, -0.4, 0.04], [0.2, 0.3, 0.1]):
        r = rodrigues(rv)
        t = np.array([20.0, -10.0, 700.0]) - r @ centre
        pair = []
        for k, rr, tt in ((k_left, r, t), (k_right, r_rel @ r, r_rel @ t + t_rel)):
            pair.append(k @ np.stack([rr[:, 0], rr[:, 1], tt], axis=1))
        views.append(pair)
    return views, k_left, np.linalg.norm(t_rel)


def run_ranks(world: int, backend: str) -> dict:
    """Phase 19's step across ``world`` ranks of ``rank_worker``: each rank's
    pieces must equal the single-controller step and the fused kernel, and
    each rank must launch the key kernel once a step. Logs the layouts and
    returns the launches."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        spawn([[os.path.abspath(__file__), "--rank", str(r), str(world), str(port), tmp, backend]
               for r in range(world)], f"{backend} ranks")
        ranks = [json.loads(open(os.path.join(tmp, f"rank{r}.json")).read())
                 for r in range(world)]
    layouts = {}
    for across in process_layouts(world):
        for r, found in enumerate(ranks):
            got = found[across]
            if got["equal"] != {"single_controller": True, "fused_kernel": True} or \
                    got["key_kernel_launches"] != 1 or not got["pieces"]:
                raise AssertionError(f"{backend} rank {r}, {across} across the ranks: {got}")
        layouts[across] = {
            "mesh": ranks[0][across]["mesh"],
            "pieces_by_rank": [found[across]["pieces"] for found in ranks],
            "key_kernel_launches_by_rank": [found[across]["key_kernel_launches"]
                                            for found in ranks],
            "step_ms_slowest_rank": ranks[0][across]["step_ms"],
            "parts_ms_by_rank": [found[across]["parts_ms"] for found in ranks],
            "single_controller_step_ms_rank_0_card": ranks[0][across]["single_controller_step_ms"]}
    log(f"19-multi-process-{backend}", shape=[8, *PROCESS_HW, 64, 5], ranks=world,
        backend=backend, devices="cuda:0 for every rank" if backend == "gloo" else "cuda:RANK",
        layouts=layouts, equals_single_controller_and_fused_kernel=True,
        note="two ranks share one card and stage halos and keys through host memory (gloo): a "
             "rehearsal, not a scaling result" if backend == "gloo" else "one rank a card",
        seconds=time.perf_counter() - t_phase, ok=True)
    by_rank = {across: v["key_kernel_launches_by_rank"] for across, v in layouts.items()}
    return {"launches": sum(sum(v) for v in by_rank.values()), "launches_by_rank": by_rank,
            "layouts": layouts}


def run_process_phase(dev, started: float) -> dict:
    """Phase 19: the sharded step across processes (two gloo ranks on this
    card, then one NCCL rank, then NCCL over every card where there are
    several) and the rig's calibrate, rectify, bm flow through the command
    line on rendered captures. Returns the key kernel's and the front end's
    launches and the phase's numbers."""
    import io

    import torch.distributed as dist
    from PIL import Image

    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.bench.scaling import time_step
    from gpu_stereo_matching_tpu_torch.cli.main import main as cli_main
    from gpu_stereo_matching_tpu_torch.core.config import MeshConfig
    from gpu_stereo_matching_tpu_torch.io.calib_yaml import load_opencv_stereo_yaml
    from gpu_stereo_matching_tpu_torch.kernels import sad_wta
    from gpu_stereo_matching_tpu_torch.parallel.launch import initialize_distributed
    from gpu_stereo_matching_tpu_torch.parallel.mesh import process_mesh, virtual_mesh
    from gpu_stereo_matching_tpu_torch.parallel.stereo import (
        make_sharded_block_matching,
        shard_batch,
        unshard,
    )

    # (a) Two gloo ranks on this card, each a process of this script.
    gloo = run_ranks(2, "gloo")

    # (b) One NCCL rank in this process: NCCL's set-up and all_reduce(MIN)
    # on the card's keys, four disp parts on (1, 2, 2).
    t_phase = time.perf_counter()
    initialize_distributed(f"localhost:{free_port()}", 1, 0, device=dev, timeout=RANK_TIMEOUT_S)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"one-rank group on {dev} runs {dist.get_backend()}, not nccl")
        cfg = BlockMatchingConfig(num_disparities=64, sad_radius=5)
        left, right = process_batch()
        mesh = process_mesh(MeshConfig(1, 2, 2), [dev] * 4, across="disp")
        step = make_sharded_block_matching(mesh, cfg)
        sl, sr = shard_batch(mesh, left, right)
        torch.cuda.synchronize()
        sad_wta.KEY_LAUNCHES = 0
        got = unshard(step(sl, sr), dev)
        torch.cuda.synchronize()
        nccl_launches = sad_wta.KEY_LAUNCHES
        one = virtual_mesh(MeshConfig(1, 2, 2), dev)
        single_step = make_sharded_block_matching(one, cfg)
        sl1, sr1 = shard_batch(one, left, right)
        fused = sad_wta.fused_block_matching_batched(left.to(dev), right.to(dev), 64, 5)
        if nccl_launches != 4 or not torch.equal(got, fused) or \
                not torch.equal(got, unshard(single_step(sl1, sr1))):
            raise AssertionError(f"one NCCL rank: {nccl_launches} key launches, or the result "
                                 "differs from the fused kernel or the single-controller step")
        nccl_ms = time_step(mesh, lambda: step(sl, sr), reps=5) * 1e3
        single_ms = time_step(one, lambda: single_step(sl1, sr1), reps=5) * 1e3
    finally:
        dist.destroy_process_group()
    log("19-multi-process-nccl-one-rank", mesh=[1, 2, 2], shape=[8, *PROCESS_HW, 64, 5],
        key_kernel_launches=nccl_launches, step_ms=nccl_ms, single_controller_step_ms=single_ms,
        equals_single_controller_and_fused_kernel=True,
        seconds=time.perf_counter() - t_phase, ok=True)
    del got, fused, sl, sr, sl1, sr1
    torch.cuda.empty_cache()

    # (c) NCCL across the cards, where there are several.
    multi_card = run_multi_card() if torch.cuda.device_count() >= 2 else None
    if multi_card is None:
        log("19-multi-process-nccl-cards", ran=False,
            note=f"not run: {torch.cuda.device_count()} card(s) visible, it needs 2 or more")

    # (d) calibrate, rectify, bm through the command line on rendered captures.
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    cols, rows, square = BOARD
    views, k_true, baseline = rig_views(RIG_HW, square)
    for i, pair in enumerate(views):
        for side, h_mat in zip(("Left", "Right"), pair):
            Image.fromarray(render_board(h_mat, RIG_HW, cols, rows, square)).save(
                os.path.join(tmp.name, f"{side}_{i}.png"))
    t_render = time.perf_counter() - t_phase
    path = {n: os.path.join(tmp.name, n) for n in ("calib.yml", "Left_0.png", "Right_0.png")}
    printed = io.StringIO()

    def cli(argv, what):
        with contextlib.redirect_stdout(printed):
            rc = cli_main(argv)
        if rc != 0:
            raise AssertionError(f"{what} returned {rc}:\n{printed.getvalue()[-2000:]}")

    t0 = time.perf_counter()
    cli(["calibrate", os.path.join(tmp.name, "Left_*.png"), os.path.join(tmp.name, "Right_*.png"),
         path["calib.yml"], "--cols", str(cols), "--rows", str(rows), "--square-size",
         str(square)], "calibrate")
    t_calibrate = time.perf_counter() - t0
    calib = load_opencv_stereo_yaml(path["calib.yml"])
    fx_err = abs(calib.left_intrinsics[0, 0] / k_true[0, 0] - 1)
    t_err = abs(np.linalg.norm(calib.translation) / baseline - 1)
    if not (np.isfinite(calib.rotation).all() and fx_err < 0.05 and t_err < 0.05):
        raise AssertionError(f"calibrate: fx off by {fx_err:.3f}, |T| off by {t_err:.3f}")

    def read(name):
        with Image.open(os.path.join(tmp.name, name)) as im:
            return np.asarray(im)

    rectify_launches, rectify_ms = 0, {}
    for tag, extra in (("720p", []), ("size_640x360", ["--size", "640x360"])):
        args = ["rectify", "--calib", path["calib.yml"], "--left", path["Left_0.png"],
                "--right", path["Right_0.png"], *extra]
        for device in ("cuda", "cpu"):
            zero_launches()
            ms, _ = host_timed(lambda: cli([*args, "--out-prefix",
                                            os.path.join(tmp.name, f"{tag}_{device}"),
                                            "--device", device], "rectify"))
            counts = {k: v for k, v in all_launches().items() if v}
            want = {"front_end": 1} if device == "cuda" else {}
            if counts != want:
                raise AssertionError(f"rectify {tag} --device {device} launched {counts}")
            rectify_ms[f"{tag}_{device}"] = ms
        rectify_launches += 1
        for view in ("left", "right"):
            card, cpu = read(f"{tag}_cuda_{view}.png"), read(f"{tag}_cpu_{view}.png")
            if card.shape != cpu.shape or not np.array_equal(card, cpu):
                raise AssertionError(f"rectify {tag}: the card's {view} PNG differs from the CPU's")
    valid = float((read("720p_cuda_left.png") > 0).mean())
    if read("720p_cuda_left.png").shape != RIG_HW or valid < 0.8:
        raise AssertionError(f"rectify: {valid:.3f} of the rectified view is valid")
    bm_args = ["bm", os.path.join(tmp.name, "720p_cuda_left.png"),
               os.path.join(tmp.name, "720p_cuda_right.png")]
    for device in ("cuda", "cpu"):
        cli([*bm_args, os.path.join(tmp.name, f"bm_{device}.png"), "--gray", "--device",
             device], "bm")
    if not np.array_equal(read("bm_cuda.png"), read("bm_cpu.png")):
        raise AssertionError("bm on the rectified pair: the card's PNG differs from the CPU's")
    tmp.cleanup()
    log("19-rectify-cli", captures=len(views), board=[cols, rows, square], hw=[*RIG_HW],
        calibrate_fx_rel_err=fx_err, calibrate_baseline_rel_err=t_err,
        rectify_front_end_launches=rectify_launches, rectify_ms_host_clock=rectify_ms,
        rectified_valid_share=valid, rectify_png_card_equals_cpu=True,
        bm_png_card_equals_cpu=True, render_s=t_render, calibrate_s=t_calibrate,
        seconds=time.perf_counter() - t_phase, ok=True)
    return {"key_launches": gloo["launches"] + nccl_launches
            + (multi_card["key_launches"] if multi_card else 0),
            "gloo_key_launches": gloo["launches_by_rank"],
            "nccl_key_launches": nccl_launches, "rectify_launches": rectify_launches,
            "multi_card": multi_card}


def run_multi_card() -> dict:
    """Phase 19 (c): the step with one NCCL rank a card, ``space`` and then
    ``disp`` across every card (:func:`run_ranks`); then, for each batch of
    ``MULTI_CARD_FRAMES``, the launcher with one NCCL rank a card (the
    ``data`` sweep) and the single-controller launcher over the same cards
    in this process, each point's fps."""
    import io

    from gpu_stereo_matching_tpu_torch.parallel import launch

    n = torch.cuda.device_count()
    steps = run_ranks(n, "nccl")
    t_phase = time.perf_counter()
    found = {"cards": n, "key_launches": steps["launches"]}
    for frames in MULTI_CARD_FRAMES:
        port = free_port()
        outs = spawn([["-m", "gpu_stereo_matching_tpu_torch.parallel.launch", "--coordinator",
                       f"localhost:{port}", "--num-processes", str(n), "--process-id", str(r),
                       "--device", f"cuda:{r}", "--frames", str(frames)] for r in range(n)],
                     "NCCL ranks")
        ranked = [json.loads(s) for s in outs[0].splitlines() if s.startswith("{")]
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            launch.main(["--frames", str(frames), "--device", "cuda"])
        single = [json.loads(s) for s in captured.getvalue().splitlines()]
        if [p["processes"] for p in ranked] != [p["devices"] for p in ranked] or \
                [p["distinct_devices"] for p in single] != [p["devices"] for p in single]:
            raise AssertionError(f"NCCL launch: {ranked}, single controller: {single}")
        found[f"frames_{frames}"] = {
            "fps_by_data": {"ranks": {p["mesh"]["data"]: p["fps"] for p in ranked},
                            "single_controller": {p["mesh"]["data"]: p["fps"] for p in single}},
            "efficiency_by_data": {
                "ranks": {p["mesh"]["data"]: p["efficiency"] for p in ranked},
                "single_controller": {p["mesh"]["data"]: p["efficiency"] for p in single}}}
    log("19-multi-process-nccl-cards", shape=[1080, 1920, 64, 5], **found,
        seconds=time.perf_counter() - t_phase, ok=True)
    found["layouts"] = steps["layouts"]
    return found


BENCH_ST_HW = (370, 463)  # the ST benches' scene: Art's own size
ST_STREAM_FRAMES = 16     # st_streaming's and st2_streaming's frames, cut from 32 for time


def _signature(v):
    """What selects a kernel's launch: shapes and types of tensors, the
    values of other arguments."""
    if isinstance(v, torch.Tensor):
        return ("tensor", tuple(v.shape), str(v.dtype))
    if isinstance(v, (tuple, list)):
        return tuple(_signature(x) for x in v)
    return v


def _copy(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (tuple, list)):
        return tuple(_copy(x) for x in v)
    return v


class TwinRecorder:
    """Inside ``with``, every kernel's launch function is wrapped: the first
    CUDA launch of each signature keeps copies of its inputs and of its
    output. ``hold()`` then holds each kept output against the kernel's plain
    twin on the kept inputs, bit for bit, so that every shape a caller gives a
    kernel is checked once, on the caller's own data."""

    def __init__(self):
        from gpu_stereo_matching_tpu_torch.kernels import (
            ctmf_median, gray, remap, sad_wta, split_phase)
        from gpu_stereo_matching_tpu_torch.ops import color
        from gpu_stereo_matching_tpu_torch.ops import remap as plain_remap
        from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8
        from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity

        def remap_twin(entry, tensors, out, shape):
            if entry == "gsm_remap_bilinear_u8":
                return plain_remap.remap_bilinear_u8(*tensors)
            return torch.stack(plain_remap.rectify_gray_pair(*tensors)).reshape(out.shape)

        # (module, launch function, kernel (its counter's name, or a function
        # of the arguments giving it), twin, output of a launch, on the card)
        self.specs = [
            (sad_wta, "_launch", "sad_wta",
             lambda l, r, d, rad: sad_wta.fused_block_matching_reference(l, r, d, rad),
             lambda args, out: out, lambda args: True),
            (remap, "_launch",
             lambda args: "remap_u8" if args[0] == "gsm_remap_bilinear_u8" else "front_end",
             remap_twin,
             lambda args, out: args[2], lambda args: True),
            (gray, "grayscale_u8", "gray", color.grayscale_u8,
             lambda args, out: out, lambda args: args[0].is_cuda),
            (split_phase, "_launch_volume", "sad_volume", split_phase.sad_volume_reference,
             lambda args, out: out, lambda args: True),
            (split_phase, "_launch_wta", "wta_from_sad", wta_disparity,
             lambda args, out: out, lambda args: True),
            (split_phase, "_launch_lr_check", "lr_check_from_sad",
             split_phase.lr_check_from_sad_reference, lambda args, out: out, lambda args: True),
            (ctmf_median, "_launch", "ctmf_median",
             lambda x, r, m: median_filter_u8(x, r, "histogram", m),
             lambda args, out: out, lambda args: True),
        ]
        self.seen = set()
        self.kept = []
        self.held = {}

    def _wrap(self, fn, kernel, twin, output, on_card):
        def wrapped(*args, **kwargs):
            result = fn(*args, **kwargs)
            name = kernel if isinstance(kernel, str) else kernel(args)
            key = (name, _signature(args), _signature(sorted(kwargs.items())))
            if on_card(args) and key not in self.seen:
                self.seen.add(key)
                self.kept.append((name, key, _copy(args), kwargs,
                                  _copy(output(args, result)), twin))
            return result
        return wrapped

    def __enter__(self):
        self.originals = [(mod, attr, getattr(mod, attr)) for mod, attr, *_ in self.specs]
        for (mod, attr, kernel, twin, output, on_card), (_, _, fn) in zip(self.specs,
                                                                          self.originals):
            setattr(mod, attr, self._wrap(fn, kernel, twin, output, on_card))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.originals:
            setattr(mod, attr, fn)

    def hold(self) -> dict:
        """Each launch kept since the last call against its twin; raises on a
        difference. Returns the signatures held, by kernel."""
        held = {}
        for kernel, key, args, kwargs, got, twin in self.kept:
            want = twin(*args, **kwargs)
            if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
                err = (int((got.long() - want.long()).abs().max())
                       if got.shape == want.shape else -1)
                raise AssertionError(f"{kernel} differs from its twin at {key} "
                                     f"(max abs err {err})")
            held[kernel] = held.get(kernel, 0) + 1
            self.held[kernel] = self.held.get(kernel, 0) + 1
        self.kept = []
        torch.cuda.empty_cache()
        return held


def bench_launches() -> dict:
    """Every bench's exact launches a kernel, from its own loop counts: a
    timed run is warm-ups plus repeats, each call launching what its path
    launches (kernel D once a frame or band, three times an ST-2 frame)."""
    from gpu_stereo_matching_tpu_torch.bench import micro

    n, m, k = micro.ITERS, max(micro.ITERS // 10, 1), max(micro.ITERS // 20, 1)
    st_frames = st2_frames = ST_STREAM_FRAMES
    return {
        # 4 calls a run, one warm run and 5 timed.
        "headline": {"sad_wta": 4 * (1 + 5)},
        # Each stage one warm call and its iterations: G, B's u8 entry and
        # the gradient n, the median r=3, A1, E1 and E2 m, D at r=5 and r=7
        # k each (the histogram rows are plain torch).
        "micro": {"gray": 1 + n, "remap_u8": 1 + n, "sad_wta": 1 + m, "sad_volume": 1 + m,
                  "wta_from_sad": 1 + m, "ctmf_median": (1 + m) + 2 * (1 + k)},
        # 4 process_batch calls a run, one warm run and 3 timed.
        "streaming": {"sad_wta": 4 * (1 + 3), "front_end": 4 * (1 + 3)},
        # Groups of 8: 4 timed group calls and the fetch's, 4 one-frame calls.
        "st_profile": {"ctmf_median": 8 * (1 + 3) + (1 + 3) + 8},
        # Two passes of the pipeline, then 4 group calls of 8.
        "st_streaming": {"ctmf_median": 2 * st_frames + 8 * (1 + 3)},
        # Two passes (3 a frame), phase 1 once to rebuild the trees, then 4
        # calls of phase 1 (2 a frame) and phase 2 (1 a frame), groups of 8.
        "st2_streaming": {"ctmf_median": 2 * st2_frames * 3 + 2 * 8 + (1 + 3) * 8 * 3},
        # Groups of 4: the global tree 1 + 3 calls, each band count 1 + 3.
        "st_hd": {"ctmf_median": 4 * (1 + 3) * (1 + 4 + 8)},
        # 4 group calls of 4 frames, 4 band steps.
        "st_config3": {"ctmf_median": 4 * (1 + 3) + (1 + 3)},
        # The headline at 1080p and at 4K (B = 8), the front end 1 + 5 times.
        "roofline": {"sad_wta": 2 * 4 * (1 + 5), "front_end": 1 + 5},
        # The headline, for the compute time a frame.
        "scaling": {"sad_wta": 4 * (1 + 5)},
    }


def run_bench_phase(dev, started: float) -> dict:
    """Phase 20: the port's benches (``gpu_stereo_matching_tpu_torch/bench/``)
    on the card, each at its defaults but for ``ST_STREAM_FRAMES``, with
    every counter at 0 just before and its exact launches just after
    (``bench_launches``); every JSON line a bench prints carries the card.
    After each bench, every kernel launch of a signature not seen before is
    held bit for bit against its plain twin on that launch's own inputs
    (``TwinRecorder``). Returns the launches by kernel, A's split into A1
    (micro's one-pair calls) and A2."""
    import io

    from gpu_stereo_matching_tpu_torch.bench import (
        headline,
        micro,
        roofline,
        scaling,
        st2_streaming,
        st_config3,
        st_hd,
        st_profile,
        st_streaming,
        streaming,
    )
    from gpu_stereo_matching_tpu_torch.io.calib_yaml import save_opencv_stereo_yaml

    want = bench_launches()
    totals = {}
    t_phase = time.perf_counter()
    twins = TwinRecorder()

    def bench(name, run, echo=lambda result: {}, frames=None):
        zero_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), twins:
            result = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: v for k, v in all_launches().items() if v}
        if got != want[name]:
            raise AssertionError(f"bench {name} launched {got}, not {want[name]}")
        t0 = time.perf_counter()
        held = twins.hold()
        twin_s = time.perf_counter() - t0
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        if any("card" not in x for x in lines):
            raise AssertionError(f"bench {name} printed a line without the card: {lines}")
        for kernel, count in got.items():
            kernel = "sad_wta_single" if (kernel, name) == ("sad_wta", "micro") else kernel
            totals[kernel] = totals.get(kernel, 0) + count
        cut = {"num_frames": {"default": frames, "ran": ST_STREAM_FRAMES}} if frames else {}
        log("20-bench", bench=name, seconds=seconds, launches=got, lines=lines, **echo(result),
            held_to_twins={"new_signatures": held, "seconds": twin_s},
            **({"cut_for_time": cut} if cut else {}), ok=True)
        return result, buf.getvalue()

    fps, _ = bench("headline", lambda: headline.main(device=dev))
    stages, table = bench("micro", lambda: micro.run_micro_benchmarks(device=dev),
                          lambda r: {"ms": {k: v * 1e3 for k, v in r.items()}})
    if not table.startswith("card: ") or not all(v > 0 for v in stages.values()):
        raise AssertionError(f"micro printed no card or a time <= 0: {table}")
    with tempfile.TemporaryDirectory() as tmp:
        calib = os.path.join(tmp, "synthetic_calib.yml")
        save_opencv_stereo_yaml(calib, synthetic_calibration())
        rig_fps, _ = bench("streaming", lambda: streaming.run_streaming_benchmark(
            calib, calib_size_hw=(720, 1280), device=dev))
        root = middlebury_scene(tmp, BENCH_ST_HW)
        profile, _ = bench("st_profile", lambda: st_profile.run_profile(root, "Synth", device=dev))
        bench("st_streaming", lambda: st_streaming.run_st_streaming_benchmark(
            root, "Synth", num_frames=ST_STREAM_FRAMES, device=dev),
            frames=st_streaming.NUM_FRAMES)
        bench("st2_streaming", lambda: st2_streaming.run_st2_streaming_benchmark(
            root, "Synth", num_frames=ST_STREAM_FRAMES, device=dev),
            frames=st2_streaming.NUM_FRAMES)
        hd, _ = bench("st_hd", lambda: st_hd.run_st_hd(root, "Synth", device=dev))
        bench("st_config3", lambda: st_config3.run_config3(root, "Synth", device=dev))
        rows, _ = bench("roofline", lambda: roofline.main(["--root", root, "--scene", "Synth"]))
    bench("scaling", lambda: scaling.main([]))
    if not (fps > 0 and rig_fps > 0 and profile["device_group_ms"] > 0):
        raise AssertionError("a bench measured no time")
    if any("skipped" in r or not r["measured_ms"] > 0 for r in rows):
        raise AssertionError(f"the roofline skipped or measured nothing: {rows}")
    if not all(0 <= v["bad2_vs_global_pct"] < 50 for k, v in hd.items() if k.startswith("bands")):
        raise AssertionError(f"per-band maps far from the global tree's: {hd}")
    if set(twins.held) != {"sad_wta" if k == "sad_wta_single" else k for k in totals}:
        raise AssertionError(f"a kernel the benches launched was not held to its twin: "
                             f"{twins.held}, {totals}")
    totals["sad_wta_batched"] = totals.pop("sad_wta")
    log("20-benches", seconds=time.perf_counter() - t_phase, launches=totals,
        signatures_held_to_twins=twins.held,
        since_start_s=time.perf_counter() - started, ok=True)
    return totals


HPD_CHECK_HW = (180, 320)  # the card against the port's CPU run, bit for bit
HPD_FRAMES = 4             # frames of the group paths at 720x1280
HPD_BUILD_REPS = 1         # timed builds of each plan after a warm-up, cut for time from 3
# Filter formulations on one tree: the stride filter of the main path, then
# tree/hpd.py's heavy-path, plan-order and coded filters (the coded one
# with both of its scans).
HPD_KINDS = ("stride", "hpd", "po", "coded", "coded_assoc")


def hpd_plans(tree, sigma, dev) -> dict:
    """Each formulation's plan of ``tree`` on ``dev``, built by the native
    emitters (the two coded runs share one plan)."""
    from gpu_stereo_matching_tpu_torch.tree.hpd import CodedPlan, HeavyPathPlan, PlanOrderPlan
    from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan

    plans = {"stride": StridePlan.from_tree(tree, sigma, device=dev),
             "hpd": HeavyPathPlan.from_tree(tree, sigma, device=dev),
             "po": PlanOrderPlan.from_tree(tree, sigma, device=dev),
             "coded": CodedPlan.from_tree(tree, sigma, device=dev)}
    plans["coded_assoc"] = plans["coded"]
    return plans


def hpd_filter(kind, nodes, plan):
    """The (N, D) volume of one formulation."""
    from gpu_stereo_matching_tpu_torch.models import segment_tree as st
    from gpu_stereo_matching_tpu_torch.tree.hpd import tree_filter_nodes_po_coded

    if kind == "coded_assoc":
        return tree_filter_nodes_po_coded(nodes, plan, assoc_scan=True)
    return st._filter(nodes, plan)


def run_hpd_phase(dev, started: float) -> dict:
    """Phase 21: the heavy-path, plan-order and coded filters of
    ``tree/hpd.py`` and ST-1's group paths over them. At 180x320 each
    formulation's filtered volume and map on the card equal the port's CPU
    run bit for bit; at 720x1280 on one tree the native plan builds by the
    host clock, the plans' bytes, each filter by CUDA events with its
    launches a call, busy time and idle share under ``torch.profiler``
    beside the stride filter, and each map's share equal to the stride
    map's and within 1 level of the truth; then over 4 frames of their own
    trees ``_st1_device_group`` with stacked plan-order and coded plans,
    ``_st1_device_batched`` and ``_st1_device_merged``, each with every
    counter at 0 just before and its exact launches just after, each equal
    to its per-frame ``_st1_device`` calls bit for bit, timed a frame by
    events with its launches a call. Every launch of kernel D in the phase
    is counted against its loop counts, and D's first launch at each new
    signature is held to its twin (``TwinRecorder``). Returns D's launches."""
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.models import segment_tree as st
    from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume
    from gpu_stereo_matching_tpu_torch.tree.builder import build_segment_tree, color_edge_weights
    from gpu_stereo_matching_tpu_torch.tree.hpd import (
        CodedPlan,
        HeavyPathPlan,
        PlanOrderPlan,
        converged_coded_batch,
        converged_plan_batch,
        merge_plans,
    )
    from gpu_stereo_matching_tpu_torch.tree.stride import build_stride_plan

    cfg = SegmentTreeConfig()  # D=60, sigma 0.1, median r=3, scale 4
    num_d, sigma = cfg.max_disp_levels, cfg.sigma
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    twins = TwinRecorder()
    d_want = 0  # kernel D's launches this phase, from its loop counts
    seen: dict = {}  # the launches counted, summed over the phase's windows

    def take_launches():
        """Add the counters' launches since they were last zeroed to
        ``seen``, then zero them."""
        for k, v in all_launches().items():
            seen[k] = seen.get(k, 0) + v
        zero_launches()

    def tree_of(left):
        return build_segment_tree(color_edge_weights(left), *left.shape[:2], tau=cfg.tau,
                                  min_size=cfg.min_size_seg, penalty=cfg.penalty_cross_seg)

    def map_of(kind, left_t, right_t, plan):
        """One formulation's median-filtered map (one launch of D on a card)."""
        if kind == "coded_assoc":
            cost = color_gradient_cost_volume(left_t, right_t, num_d)
            return st._wta_median(hpd_filter(kind, st._to_nodes(cost), plan), cost.shape[1:])
        return st._st1_device(left_t, right_t, plan, num_d)

    zero_launches()
    with twins:
        # The card against the port's CPU run at 180x320, bit for bit.
        left, right, _truth = st_pair(HPD_CHECK_HW)
        plans = hpd_plans(tree_of(left), sigma, cpu)
        lt, rt = torch.from_numpy(left), torch.from_numpy(right)
        nodes_cpu = st._to_nodes(color_gradient_cost_volume(lt, rt, num_d))
        nodes_card = nodes_cpu.to(dev)
        equal = {}
        for kind in HPD_KINDS[1:]:
            plan_card = plans[kind].to(dev)
            on_cpu = hpd_filter(kind, nodes_cpu, plans[kind])
            on_card = hpd_filter(kind, nodes_card, plan_card)
            map_cpu = map_of(kind, lt, rt, plans[kind])
            map_card = map_of(kind, lt.to(dev), rt.to(dev), plan_card)
            d_want += 1
            equal[kind] = {"filtered": bool(torch.equal(on_card.cpu(), on_cpu)),
                           "map": bool(torch.equal(map_card.cpu(), map_cpu))}
            if not all(equal[kind].values()):
                log("21-hpd-card-vs-cpu", shape=[*HPD_CHECK_HW, num_d], kind=kind,
                    equal=equal[kind], ok=False,
                    filtered_max_abs_diff=float((on_card.cpu() - on_cpu).abs().max()),
                    map_equal_share=float((map_card.cpu() == map_cpu).float().mean()))
                raise AssertionError(f"{kind} on the card differs from the CPU run")
            if kind == "coded_assoc" and not torch.equal(on_card, hpd_filter(
                    "po", nodes_card, plans["po"].to(dev))):
                raise AssertionError("coded with the associative scan differs from plan-order")
        log("21-hpd-card-vs-cpu", shape=[*HPD_CHECK_HW, num_d], equal=equal,
            coded_assoc_equals_po=True, seconds=time.perf_counter() - t_phase, ok=True)
        del nodes_cpu, nodes_card

        # One 720x1280 frame: the native builds by the host clock, each
        # filter by events and under the profiler, beside the stride filter.
        t_stage = time.perf_counter()
        left, right, truth = st_pair(ST_HW)
        tree = tree_of(left)
        builds = {
            "stride": lambda: build_stride_plan(tree, sigma),
            "hpd": lambda: HeavyPathPlan.from_tree(tree, sigma),
            "po": lambda: PlanOrderPlan.from_tree(tree, sigma),
            "coded": lambda: CodedPlan.from_tree(tree, sigma),
        }
        build_ms = {k: median_wall_ms(fn, HPD_BUILD_REPS, cpu) for k, fn in builds.items()}
        plans = hpd_plans(tree, sigma, dev)
        l_dev, r_dev = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
        nodes = st._to_nodes(color_gradient_cost_volume(l_dev, r_dev, num_d))
        maps, rows = {}, {}
        for kind in HPD_KINDS:
            run = lambda kind=kind: hpd_filter(kind, nodes, plans[kind])  # noqa: E731
            prof = device_profile(run, 2, lambda name: "filter")
            maps[kind] = map_of(kind, l_dev, r_dev, plans[kind])
            d_want += 1
            rows[kind] = {
                "plan_build_ms": build_ms["coded" if kind == "coded_assoc" else kind],
                "plan_nbytes": plans[kind].transport_nbytes,
                "filter_ms_by_events": cuda_ms(run, 3, warmups=1),
                "launches_per_call": ratio(prof.get("device_kernels"), prof.get("calls", 1)),
                "busy_ms_per_call": ratio(prof.get("busy_ms"), prof.get("calls", 1)),
                "idle_share": prof.get("idle_share"),
                "map_equal_to_stride_share": float((maps[kind] == maps["stride"]).float().mean()),
                "within_one_level_share": within_one(
                    st._scale_u8(maps[kind], cfg.disparity_scale), truth, cfg),
            }
        if any(r["map_equal_to_stride_share"] < 0.99 or r["within_one_level_share"] < 0.5
               for r in rows.values()):
            raise AssertionError(f"a formulation's map is far from the stride map: {rows}")
        log("21-hpd-filters", shape=[*ST_HW, num_d], nodes=ST_HW[0] * ST_HW[1],
            positions={k: (plans[k].total_pos if hasattr(plans[k], "total_pos") else
                           sum(r.num_nodes for r in plans[k].rounds_meta)) for k in HPD_KINDS},
            rounds={k: (len(plans[k].buckets) if k == "stride" else len(plans[k].rounds_meta))
                    for k in HPD_KINDS},
            by_formulation=rows, seconds=time.perf_counter() - t_stage,
            cut_for_time={"plan_build_reps": {"default": 3, "ran": HPD_BUILD_REPS}}, ok=True)
        del nodes, plans, maps, l_dev, r_dev
        torch.cuda.empty_cache()

        # The group paths at 720x1280 over frames of their own trees.
        t_stage = time.perf_counter()
        frames, truth = st_frames(ST_HW, HPD_FRAMES)
        trees = [tree_of(lf) for lf, _ in frames]
        t0 = time.perf_counter()
        po = converged_plan_batch(trees, sigma)
        coded = converged_coded_batch(trees, sigma)
        merged = merge_plans([po.frame(g) for g in range(HPD_FRAMES)])
        host_ms = (time.perf_counter() - t0) * 1e3
        lb = torch.from_numpy(np.stack([lf for lf, _ in frames])).to(dev)
        rb = torch.from_numpy(np.stack([r for _, r in frames])).to(dev)
        po, coded, merged = po.to(dev), coded.to(dev), merged.to(dev)
        refs = {name: torch.stack([st._st1_device(lb[g], rb[g], plans.frame(g), num_d)
                                   for g in range(HPD_FRAMES)])
                for name, plans in (("po", po), ("coded", coded))}
        d_want += 2 * HPD_FRAMES
        paths = {  # name: (call, per-frame maps it must give, D launches a call)
            "group_po": (lambda: st._st1_device_group(lb, rb, po, num_d), "po", HPD_FRAMES),
            "group_coded": (lambda: st._st1_device_group(lb, rb, coded, num_d), "coded",
                            HPD_FRAMES),
            "batched": (lambda: st._st1_device_batched(lb, rb, po, num_d), "po", 1),
            "merged": (lambda: st._st1_device_merged(lb, rb, merged, num_d), "po", 1),
        }
        group_rows = {}
        for name, (call, ref, per_call) in paths.items():
            torch.cuda.synchronize()
            take_launches()
            got = call()
            torch.cuda.synchronize()
            launched = all_launches()
            if launched != dict(dict.fromkeys(launched, 0), ctmf_median=per_call):
                raise AssertionError(f"{name} launched {launched}, not D {per_call} times")
            take_launches()
            if not torch.equal(got, refs[ref]):
                share = float((got == refs[ref]).float().mean())
                raise AssertionError(f"{name} differs from its per-frame calls ({share})")
            prof = device_profile(call, 1, lambda n: "path")
            group_rows[name] = {
                "equal_to_per_frame": True, "launches_of_D_per_call": per_call,
                "ms_per_frame_by_events": cuda_ms(call, 2, warmups=1) / HPD_FRAMES,
                "launches_per_call": prof.get("device_kernels"),
                "busy_ms_per_frame": ratio(prof.get("busy_ms"), HPD_FRAMES),
                "idle_share": prof.get("idle_share")}
            d_want += per_call * (1 + 2 + 3)  # the check, the profile, the timing
        shares = [within_one(st._scale_u8(m, cfg.disparity_scale), truth, cfg)
                  for m in refs["po"]]
        log("21-hpd-group-paths", shape=[HPD_FRAMES, *ST_HW, num_d],
            host_plan_ms={"converge_po_and_coded_and_merge": host_ms},
            plan_nbytes={"po_stacked": po.transport_nbytes,
                         "coded_stacked": coded.transport_nbytes,
                         "merged": merged.transport_nbytes},
            paths=group_rows, within_one_level_share=[min(shares), max(shares)],
            seconds=time.perf_counter() - t_stage, ok=True)
        del lb, rb, po, coded, merged, refs
    torch.cuda.synchronize()
    take_launches()
    if seen != dict(dict.fromkeys(seen, 0), ctmf_median=d_want):
        raise AssertionError(f"phase 21 launched {seen}, not D {d_want} times")
    held = twins.hold()
    if "ctmf_median" not in held:
        raise AssertionError("no launch of D in phase 21 was held to its twin")
    log("21-hpd-phase", launches=seen, signatures_held_to_twins=held,
        seconds=time.perf_counter() - t_phase,
        since_start_s=time.perf_counter() - started, ok=True)
    return {"launches": seen["ctmf_median"]}


# (H, W, D, r) of the tensor-core body beside the packed-pair cases of
# EDGE_CASES and STRUCTURED_CASES: D = W (at the last d every column but the
# last is invalid, inside every n-tile), D = W = 256 (the largest D), a
# 9-wide image (W off 8, one n-tile of the image).
MMA_EXTRA_CASES = [(33, 64, 64, 5), (65, 256, 256, 3), (17, 9, 2, 1)]
MMA_TIMED_RADII = (1, 3, 5)  # 1080p D=64, bursts: the tensor-core body beside the strip body
# The first tensor-core body's figures at 1080p D=64 r=5 B=1 (its ms, the
# lowest and highest of its runs on an H100 80GB HBM3 at 700 W), printed
# beside this body's as the earlier figure.
MMA_PR16 = {"device_ms": [0.0810, 0.0834], "burst_ms": [0.0856, 0.0878],
            "tensor_core_share": 0.056, "imma_per_body": 16, "registers": 96,
            "shared_bytes_at_d64": 52688, "threads": 160}


def mma_sass_report() -> dict:
    """Each radius's body of ``csrc/sad_wta_mma.cu`` in the built library's
    SASS (``cuobjdump -sass``): its IMMA, barrier (``BAR.``) and cp.async
    (``LDGSTS``) instructions, and each loop that holds an IMMA (a backward
    branch and its range: the disparity loops, with and without the column
    checks) with its instructions, IMMA, barriers, shared stores and
    local-memory (spill) loads and stores."""
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import _sass
    from gpu_stereo_matching_tpu_torch.kernels import _build

    def count(pattern, ops):
        return sum(bool(re.search(pattern, op)) for op in ops)

    report = {}
    for body in re.split(r"\n\s*Function : ", _sass(str(_build.build()))):
        name = re.search(r"sad_wta_mma_kernelILi(\d+)E", body.split("\n", 1)[0])
        if not name:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
        ops = [op for _, op in ins]
        at = {int(a, 16): i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, op in enumerate(ops):
            target = re.search(r"BRA.*?0x([0-9a-f]+)", op)
            start = at.get(int(target.group(1), 16), i) if target else i
            if start < i and count(r"\bIMMA", ops[start:i + 1]):
                loops.append({"instructions": i - start + 1,
                              "imma": count(r"\bIMMA", ops[start:i + 1]),
                              "barriers": count(r"\bBAR\.", ops[start:i + 1]),
                              "shared_stores": count(r"\bSTS\b", ops[start:i + 1]),
                              "local_loads_and_stores": count(r"\b(LDL|STL)\b",
                                                              ops[start:i + 1])})
        report[int(name.group(1))] = {"imma": count(r"\bIMMA", ops),
                                      "barriers": count(r"\bBAR\.", ops),
                                      "ldgsts": count(r"\bLDGSTS\b", ops), "loops": loops}
    return report


def run_mma_phase(dev, u8) -> dict:
    """Phase 22: ``fused_block_matching(..., mxu=True)``, the tensor-core
    body of ``csrc/sad_wta_mma.cu``, held bit for bit to its plain twin and
    to the strip body on every case, its launches exact; the entry driven
    once at 1080p with every counter at 0 just before; timed beside the
    strip body by events and under ``torch.profiler``, with its plan and
    its tensor-core share. Returns its entry of the summary line."""
    from gpu_stereo_matching_tpu_torch.bench.roofline import PEAK_INT8_TENSOR_OPS_PER_S
    from gpu_stereo_matching_tpu_torch.kernels import _build, sad_wta

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    fbm = sad_wta.fused_block_matching

    def check(left, right, d, r, what):
        before = (sad_wta.MMA_LAUNCHES, sad_wta.LAUNCHES)
        got = fbm(left, right, d, r, mxu=True)
        torch.cuda.synchronize()
        if (sad_wta.MMA_LAUNCHES, sad_wta.LAUNCHES) != (before[0] + 1, before[1]):
            raise AssertionError(f"mxu=True at {(*left.shape, d, r)} did not launch the "
                                 f"tensor-core body once and nothing else")
        for name, want in (("plain twin", sad_wta.fused_block_matching_mma_reference(
                left, right, d, r)), ("strip body", fbm(left, right, d, r))):
            if not torch.equal(got, want):
                err = int((got - want).abs().max())
                raise AssertionError(f"tensor-core body differs from the {name} at "
                                     f"{(*left.shape, d, r)} ({what}): {err}")
        return got

    def packed(cases):
        return [(h, w, d, r) for _, h, w, d, r in cases if sad_wta._packed_pair_supported(d, r)]

    random_cases = packed(EDGE_CASES) + MMA_EXTRA_CASES + [(1080, 1920, 64, 5)]
    structured_cases = packed(STRUCTURED_CASES) + [(1080, 1920, 64, 5)]
    launches_before = sad_wta.MMA_LAUNCHES
    for h, w, d, r in random_cases:
        check(u8((h, w)), u8((h, w)), d, r, "random")
    structured = 0
    for h, w, d, r in structured_cases:
        for kind, left, right in structured_pairs(rng, dev, (h, w)):
            got = check(left, right, d, r, kind)
            if kind == "constant" and bool(got.any()):
                raise AssertionError("constant images: every d ties, the answer is 0")
            structured += 1
    checked = sad_wta.MMA_LAUNCHES - launches_before
    if checked != len(random_cases) + structured:
        raise AssertionError(f"phase 22 launched the tensor-core body {checked} times")
    log("22-mma-vs-twins", cases=len(random_cases) + structured, structured_cases=structured,
        shapes=[list(c) for c in random_cases + structured_cases], max_abs_err=0, ok=True)

    # The entry a user calls, at the flagship shape: the tensor-core body
    # once, no other kernel.
    left, right = u8((1080, 1920)), u8((1080, 1920))
    torch.cuda.synchronize()
    zero_launches()
    disp = fbm(left, right, 64, 5, mxu=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    if launches != {"sad_wta_mma": 1}:
        raise AssertionError(f"fused_block_matching(mxu=True) launched {launches}")
    if tuple(disp.shape) != (1080, 1920) or int(disp.min()) < 0 or int(disp.max()) >= 64:
        raise AssertionError("mxu=True: disparities of the wrong shape or outside [0, D)")
    if not torch.equal(disp, sad_wta.fused_block_matching_mma_reference(left, right, 64, 5)):
        raise AssertionError("mxu=True at 1080p differs from its plain twin")
    log("22-mma-main-path", shape=[1080, 1920, 64, 5], launches=launches, ok=True)

    # Timings, the two bodies in turns (mma, strip, strip, mma).
    def mma():
        return fbm(left, right, 64, 5, mxu=True)

    def strips():
        return fbm(left, right, 64, 5)

    # In the same turns: a lone call, and a call of a burst of 20 back to
    # back (the enqueue hidden behind the kernels before it), by events;
    # device time under the profiler, which late in a long run at times sees
    # none or only some of a window's launches: a turn takes the first of
    # up to 3 windows that saw one kernel a call, else None.
    ms = {"mma": [], "strips": []}
    burst = {"mma": [], "strips": []}
    device_turns = {"mma": [], "strips": []}
    for name in ("mma", "strips", "strips", "mma"):
        fn = mma if name == "mma" else strips
        ms[name].append(cuda_ms(fn, TIME_REPS))
        burst[name].append(cuda_ms(lambda fn=fn: [fn() for _ in range(20)], TIME_REPS) / 20)
        seen = None
        for _ in range(3):
            busy, kernels = device_ms_per_call(fn)
            if kernels == 1:
                seen = busy
                break
        device_turns[name].append(seen)
    device = {k: min((t for t in v if t is not None), default=None)
              for k, v in device_turns.items()}
    plain_ms = cuda_ms(lambda: sad_wta.fused_block_matching_mma_reference(left, right, 64, 5),
                       reps=3)
    ops = sad_wta.mma_tensor_ops((1, 1080, 1920), 64, 5)
    t_mma = statistics.median(ms["mma"])
    share = ops / PEAK_INT8_TENSOR_OPS_PER_S * 1e3 / statistics.median(burst["mma"])
    by_radius = {}  # ms a call in a burst of 20
    for r in MMA_TIMED_RADII:
        by_radius[r] = {
            "mma_ms": cuda_ms(lambda r=r: [fbm(left, right, 64, r, mxu=True) for _ in range(20)],
                              TIME_REPS) / 20,
            "strips_ms": cuda_ms(lambda r=r: [fbm(left, right, 64, r) for _ in range(20)],
                                 TIME_REPS) / 20}
    plan = sad_wta.mma_launch_plan((1, 1080, 1920), 64, 5, dev)
    # The built library's SASS and ptxas's report, per radius: both sums on
    # the tensor cores (IMMA inside the disparity loops), cp.async staging
    # (LDGSTS), no barrier and no shared store inside those loops.
    sass = mma_sass_report()
    if sorted(sass) != [1, 2, 3, 4, 5] or not all(
            b["loops"] and b["ldgsts"] and all(
                loop["imma"] and not loop["barriers"] and not loop["shared_stores"]
                for loop in b["loops"]) for b in sass.values()):
        raise AssertionError(f"the tensor-core bodies' SASS breaks the design: {sass}")
    ptxas = {int(re.search(r"sad_wta_mma_kernelILi(\d+)E", k).group(1)): v
             for k, v in _build.ptxas_usage("sad_wta_mma_kernel").items()}
    for r, usage in ptxas.items():
        usage["dynamic_smem_at_d64"] = sad_wta.mma_launch_plan(
            (1, 1080, 1920), 64, r, dev)["shared_bytes"]
    log("22-mma-time", shape=[1, 1080, 1920, 64, 5], ms_by_turn=ms,
        ms_per_call_in_a_burst_of_20_by_turn=burst,
        device_ms_by_turn=device_turns, device_ms=device,
        plain_ms=plain_ms, plan=plan, strip_plan=sad_wta.launch_plan((1, 1080, 1920), 64, 5, dev),
        tensor_ops=ops, tensor_core_share=share, by_radius=by_radius,
        sass_by_radius=sass, ptxas_by_radius=ptxas, earlier=MMA_PR16,
        seconds=time.perf_counter() - t_phase)
    # fused_sad_work: the same function as kernel A1, so the same bound.
    return {**kernel_entry("fused_block_matching_mxu", "sad_wta_mma.cu", "sad_wta.py:146",
                           launches["sad_wta_mma"], 0, t_mma, plain_ms,
                           bound(*fused_sad_work(1080, 1920, 64)), None, [1, 1080, 1920, 64, 5]),
            "launches_by_path": {"mxu_entry": launches["sad_wta_mma"]},
            "device_ms": device["mma"], "strip_body_ms": statistics.median(ms["strips"]),
            "strip_body_device_ms": device["strips"],
            "burst_ms": statistics.median(burst["mma"]),
            "strip_body_burst_ms": statistics.median(burst["strips"]), "tensor_ops": ops,
            "tensor_core_share": share, "plan": plan}


def main() -> int:
    started = time.perf_counter()
    seconds = {}  # phase -> seconds, each from the end of the one before
    last = [started]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        seconds[phase] = now - last[0]
        last[0] = now
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
    lap("1-2")

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
    lap("3")

    # 4. Kernel B's two entries vs their twins: the rig's maps at 720p, then
    # ragged shapes through wild maps; the u8 entry's cases counted per
    # body, the front end's tiles per path (front_end_tiles, the kernel's rule).
    size_hw, num_d, radius = (720, 1280), 64, 5
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=radius)
    rig = StereoRig(synthetic_calibration(), size_hw, cfg, device=dev)
    rig_maps = (rig.left_map_x, rig.left_map_y, rig.right_map_x, rig.right_map_y)
    remap_bodies = dict.fromkeys(remap.BODIES, 0)
    front_end_paths = {"staged": 0, "gathered": 0}

    def check_b(entry, frames, maps, what):
        """One launch of ``entry`` against its twin; returns the u8 entry's
        body, or the front end's tiles by path."""
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
        if entry != "u8":
            tiles = remap.front_end_tiles(frames[0].shape[1:3], *maps)
            for k in front_end_paths:
                front_end_paths[k] += tiles[k]
            return tiles
        body = next(k for k in remap.BODIES if remap.BODY_LAUNCHES[k] == before[k] + 1)
        remap_bodies[body] += 1
        return body

    rig_bodies, rig_share = set(), set()
    for b in (1, 3, 8):
        src = u8((b, *size_hw))
        for view in (0, 1):
            rig_bodies.add(check_b("u8", [src], rig_maps[2 * view:2 * view + 2],
                                   f"rig view {view}, B={b}"))
        rig_share.add(check_b("front_end", [u8((b, *size_hw, 3)), u8((b, *size_hw, 3))],
                              rig_maps, f"rig, B={b}")["staged_share"])
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
    if (not all(remap_bodies.values()) or rig_bodies != {"vector"}
            or not all(front_end_paths.values()) or rig_share != {100.0}
            or rig.front_end_tiles["staged_share"] != 100.0):
        raise AssertionError(
            f"phase 4 must cover both bodies of the u8 entry (the vector body at 720p) and both "
            f"paths of the front end (the rig's tiles all staged): {remap_bodies}, {rig_bodies}, "
            f"{front_end_paths}, {rig_share}, {rig.front_end_tiles}")
    if valid_share < 0.8:
        raise AssertionError(f"rectification maps keep only {valid_share:.3f} of the frame")
    log("4-remap-kernel-vs-twin", rig=[*size_hw], batches=[1, 3, 8],
        ragged_cases=len(REMAP_CASES), u8_cases_by_body=remap_bodies,
        front_end_tiles_by_path=front_end_paths, body_at_720p=rig_bodies.pop(),
        rig_staged_share=rig.front_end_tiles["staged_share"], max_abs_err=0,
        valid_share=valid_share, ok=True)
    lap("4")

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
    lap("5")

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
    lap("6")

    # 7. Timings.
    a1 = (u8((1, 1080, 1920)), u8((1, 1080, 1920)))
    a32 = (u8((32, 1080, 1920)), u8((32, 1080, 1920)))
    t_a1 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(*a1, 64, 5), TIME_REPS)
    p_a1 = cuda_ms(lambda: sad_wta.fused_block_matching_reference(*a1, 64, 5), TIME_REPS)
    t_a32 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(*a32, 64, 5), TIME_REPS)
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
            "ms_per_image": cuda_ms(run, TIME_REPS) / count,
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
            "ms_per_frame": cuda_ms(run, TIME_REPS) / b,
            "device_ms_per_frame": ratio(device_ms_per_call(run)[0], b),
            "plain_ms_per_frame": cuda_ms(lambda g=g: remap_bilinear_u8(g, mx, my), TIME_REPS) / b,
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
            "ms": cuda_ms(run, TIME_REPS), "device_ms": device, "kernels_seen_per_call": kernels,
            "composition_ms": cuda_ms(comp, TIME_REPS), "composition_device_ms": comp_device,
            "composition_kernels_seen_per_call": comp_kernels,
            "plain_ms": cuda_ms(lambda l=left_bgr, r=right_bgr: plain_front_end(l, r, *rig_maps),
                                reps=3),
            **bound(*remap_work(b, n_720, 2, True))}
    log("7-time", kernel="rectify_gray_pair", shape=[*size_hw], views=2, by_batch=times_f,
        staged_share=rig.front_end_tiles["staged_share"],
        plan=remap.front_end_plan(size_hw, size_hw, 8, device=dev, maps=rig_maps))
    t_rig = cuda_ms(lambda: rig.process_batch(lb, rb), TIME_REPS)
    t_plain_rig = cuda_ms(lambda: plain_path(lb, rb), reps=3)
    t_one = cuda_ms(lambda: rig.process(*pairs[0]), TIME_REPS)
    log("7-time", rig=[*size_hw, num_d, radius], batch=8, ms=t_rig, fps=8e3 / t_rig,
        plain_ms=t_plain_rig, plain_fps=8e3 / t_plain_rig, process_ms=t_one,
        process_fps=1e3 / t_one)
    log("7-profile", rig=[*size_hw, num_d, radius], batch=8,
        **device_profile(lambda: rig.process_batch(lb, rb), 10, rig_part))
    del a1, img_1080, bgr_8, lb, rb, pairs, singles, batch, triples
    torch.cuda.empty_cache()
    lap("7")

    bm_launches, bm_plus = run_bm_plus_phases(dev, u8, synthetic_calibration())
    lap("8-11")
    key_kernel = run_sharded_phases(dev, u8, t_a1)
    lap("12-15")
    st1 = run_st1_phase(dev, started)
    lap("16")
    st2 = run_st2_phase(dev, started)
    lap("17")
    tiled = run_tiled_phase(dev, started)
    tiled_launches = tiled["launches"]
    lap("18")
    processes = run_process_phase(dev, started)
    lap("19")
    benches = run_bench_phase(dev, started)
    lap("20")
    hpd = run_hpd_phase(dev, started)
    lap("21")
    mma = run_mma_phase(dev, u8)
    lap("22")
    log("seconds-by-phase", seconds=seconds, total=time.perf_counter() - started)

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "gpu_stereo_matching_tpu")]
    if bad:
        raise AssertionError(f"jax or the JAX package was imported: {bad}")
    px = 1080 * 1920
    print(json.dumps({"kernels": [
        # fused_sad_work: 8 operations per pixel and disparity; 2 bytes in, 4
        # out per pixel. A1: the rig's process (phase 6) and micro's one-pair
        # calls (phase 20); A2: the rig's batches and the benches' batches.
        {**kernel_entry("fused_block_matching", "sad_wta.cu", "sad_wta.py:398",
                        launches["sad_wta_single"] + benches["sad_wta_single"], err_a, t_a1,
                        p_a1, bound(*fused_sad_work(1080, 1920, 64)), None,
                        [1, 1080, 1920, 64, 5]),
         "launches_by_path": {"rig": launches["sad_wta_single"],
                              "benches": benches["sad_wta_single"]}},
        {**kernel_entry("fused_block_matching_batched", "sad_wta.cu", "sad_wta.py:727",
                        launches["sad_wta_batched"] + benches["sad_wta_batched"], err_a, t_a32,
                        p_a32, bound(*fused_sad_work(1080, 1920, 64, frames=32)), None,
                        [32, 1080, 1920, 64, 5]),
         "launches_by_path": {"rig": launches["sad_wta_batched"],
                              "benches": benches["sad_wta_batched"]}},
        # remap_work: 10 operations a pixel once a launch, 12 a pixel and
        # frame; the maps once, 1 byte in and 1 out a pixel and frame. Since
        # the rig's front end replaced it (phase 6) only micro runs this entry.
        {**kernel_entry("remap_bilinear_u8", "remap.cu", "remap.py:457",
                        launches["remap_u8"] + benches["remap_u8"], 0,
                        times_b[1]["ms_per_frame"], times_b[1]["plain_ms_per_frame"],
                        bound(*remap_work(1, n_720, 1, False)), None, [1, *size_hw]),
         "launches_by_path": {"rig": launches["remap_u8"], "benches": benches["remap_u8"]},
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
         "b1_ms": times_f[1]["ms"], "b1_device_ms": times_f[1]["device_ms"],
         "launches": (launches["front_end_single"] + launches["front_end_batched"]
                      + processes["rectify_launches"] + benches["front_end"]),
         "launches_by_path": {"rig": launches["front_end_single"] + launches["front_end_batched"],
                              "rectify_cli": processes["rectify_launches"],
                              "benches": benches["front_end"]}},
        # gray_work: 8 operations a pixel; 3 bytes in, 1 out. No TPU kernel:
        # the JAX package's gray is an XLA tensordot. Launches: the bm CLI's
        # two images (phase 10), the middlebury command's bm and bm+ (phase
        # 18) and micro (phase 20).
        {**kernel_entry("gray_u8", "gray.cu", "",
                        bm_launches["gray"] + tiled_launches["gray"] + benches["gray"], 0,
                        times_g["1080p_one_image"]["ms_per_image"],
                        times_g["1080p_one_image"]["plain_ms_per_image"], bound(*gray_work(px)),
                        None, [1080, 1920, 3]),
         "replaces": "gpu_stereo_matching_tpu/ops/color.py:33 (an XLA tensordot, no TPU kernel)",
         "device_ms": times_g["1080p_one_image"]["device_ms_per_image"],
         "launches_by_path": {"bm_cli": bm_launches["gray"], "middlebury": tiled_launches["gray"],
                              "benches": benches["gray"]}},
        # Kernel C on the sharded steps of one controller (phase 13) and of
        # the ranks of phase 19 (two gloo ranks, one NCCL rank).
        {**key_kernel, "launches": key_kernel["launches"] + processes["key_launches"],
         "launches_by_path": {"sharded_single_controller": key_kernel["launches"],
                              "multi_process": processes["key_launches"]}},
        # E1 and E2 run on bm+ (phase 10), through the middlebury command's
        # bm and bm+ (phase 18) and in micro's split-phase row (phase 20).
        *({**entry, "launches": entry["launches"] + tiled_launches[name] + benches[name],
           "launches_by_path": {"bm+": entry["launches"], "middlebury": tiled_launches[name],
                                "benches": benches[name]}}
          for entry, name in zip(bm_plus[:2], ("sad_volume", "wta_from_sad"))),
        # E2's right-view body runs on bm+ (phase 10) and through the
        # middlebury command's bm+ (phase 18).
        {**bm_plus[3],
         "launches": bm_plus[3]["launches"] + tiled_launches["lr_check_from_sad"],
         "launches_by_path": {"bm+": bm_plus[3]["launches"],
                              "middlebury": tiled_launches["lr_check_from_sad"]}},
        # Kernel D runs on every path with a median: once a bm+ frame (phase
        # 10), once an ST-1 frame (phase 16), three times an ST-2 frame (phase
        # 17) and so in the streaming pipelines (phase 17), once a band of a
        # tiled, sharded or banded ST-1 frame and three times a band of an
        # ST-2 one, and through the middlebury command (phase 18), and in
        # micro and every ST bench (phase 20), and on ST-1's paths over the
        # heavy-path, plan-order and coded plans (phase 21); ``launches`` is
        # their sum.
        {**bm_plus[2], "launches": (bm_plus[2]["launches"] + st1["launches"] + st2["launches"]
                                    + st2["pipeline_launches"] + tiled_launches["ctmf_median"]
                                    + benches["ctmf_median"] + hpd["launches"]),
         "launches_by_path": {"bm+": bm_plus[2]["launches"], "st1": st1["launches"],
                              "st2": st2["launches"], "st_pipelines": st2["pipeline_launches"],
                              "per_band_st_and_middlebury": tiled_launches["ctmf_median"],
                              "benches": benches["ctmf_median"],
                              "hpd_po_coded_st1_paths": hpd["launches"]},
         "st1_map_ms_by_shape": st1["median_ms"], "st2_map_ms_by_shape": st2["median_ms"]},
        # A1's mxu=True entry (phase 22): the tensor-core body.
        mma,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_worker(sys.argv[2:]) if sys.argv[1:2] == ["--rank"] else main())
