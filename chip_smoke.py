"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, time.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.

Phases, each printing its own line:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``gpu_stereo_matching_tpu_torch/kernels/csrc``;
3. fused SAD + WTA kernel vs its plain twin on the card, bit-exact, on edge
   shapes and at 1080x1920 D=64 r=5 with B=1 and B=4;
4. remap kernel vs its plain twin at 720x1280 through a rig's maps;
5. gray conversion on the card vs on the CPU over all 2**24 BGR triples;
6. the main path: a 720x1280, D=64, r=5 StereoRig from a synthetic
   calibration runs ``process`` on 3 pairs and ``process_batch`` on 8;
   results bit-exact against the plain path on the card, and both kernels'
   launch counters must have risen during this phase;
7. CUDA-event timings (warmed, median of several runs) of each kernel beside
   its plain twin and of the rig, printed as JSON lines.

Then one JSON line with the kernels' summary, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    log("1-device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    from gpu_stereo_matching_tpu_torch import BlockMatchingConfig
    from gpu_stereo_matching_tpu_torch.kernels import _build, remap, sad_wta
    from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig
    from gpu_stereo_matching_tpu_torch.ops.color import gray_blockmatching_bgr, gray_rec601_bgr
    from gpu_stereo_matching_tpu_torch.ops.remap import remap_bilinear_u8

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log("2-build", seconds=time.perf_counter() - t0, library=lib_path.name)

    rng = np.random.default_rng(SEED)

    def u8(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    # 3. Kernel A vs its plain twin.
    err_a = 0
    for b, h, w, d, r in EDGE_CASES + [(1, 1080, 1920, 64, 5), (4, 1080, 1920, 64, 5)]:
        left, right = u8((b, h, w)), u8((b, h, w))
        got = sad_wta.fused_block_matching_batched(left, right, d, r)
        want = sad_wta.fused_block_matching_reference(left, right, d, r)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        err_a = max(err_a, err)
        if err != 0:
            raise AssertionError(f"fused kernel differs from its twin at {(b, h, w, d, r)}: {err}")
    log("3-fused-kernel-vs-twin", cases=len(EDGE_CASES) + 2, max_abs_err=err_a, ok=True)

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
    singles = [rig.process(l, r) for l, r in pairs]
    batch = rig.process_batch(lb, rb)
    torch.cuda.synchronize()
    launches = {"sad_wta": sad_wta.LAUNCHES, "remap": remap.LAUNCHES}
    if launches["sad_wta"] < 1 or launches["remap"] < 1:
        raise AssertionError(f"main path did not launch every kernel: {launches}")

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
        launches=launches, ok=True)

    # 7. Timings.
    a1 = (u8((1, 1080, 1920)), u8((1, 1080, 1920)))
    a32 = (u8((32, 1080, 1920)), u8((32, 1080, 1920)))
    t_a1 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(*a1, 64, 5))
    p_a1 = cuda_ms(lambda: sad_wta.fused_block_matching_reference(*a1, 64, 5))
    t_a32 = cuda_ms(lambda: sad_wta.fused_block_matching_batched(*a32, 64, 5))
    p_a32 = cuda_ms(lambda: sad_wta.fused_block_matching_reference(*a32, 64, 5), reps=3)
    del a32
    log("7-time", kernel="sad_wta", shape=[1, 1080, 1920, 64, 5], ms_per_frame=t_a1,
        plain_ms_per_frame=p_a1)
    log("7-time", kernel="sad_wta", shape=[32, 1080, 1920, 64, 5], ms_per_frame=t_a32 / 32,
        plain_ms_per_frame=p_a32 / 32)
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

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [
        {"name": "fused_sad_wta", "route": "cuda",
         "source": "gpu_stereo_matching_tpu_torch/kernels/csrc/sad_wta.cu",
         "replaces": "gpu_stereo_matching_tpu/kernels/sad_wta.py:398",
         "launches": launches["sad_wta"], "max_abs_err": err_a,
         "ms": t_a1, "plain_ms": p_a1, "shape": [1, 1080, 1920, 64, 5]},
        {"name": "remap_bilinear_u8", "route": "cuda",
         "source": "gpu_stereo_matching_tpu_torch/kernels/csrc/remap.cu",
         "replaces": "gpu_stereo_matching_tpu/kernels/remap.py:457",
         "launches": launches["remap"], "max_abs_err": err_b,
         "ms": t_b1, "plain_ms": p_b1, "shape": [1, *size_hw]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
