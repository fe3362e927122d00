"""Micro-benchmarks of single stages (the reference's pattern), as
``gpu_stereo_matching_tpu/bench/micro.py``.

Mirrors ``cvtColorTest``, the 1000-iteration CPU against device timing of
the gray conversion (``BlockMatching/Caller.cpp:76-112``), and the timed
remap, upload and download stages of ``blockMatching_gpu``
(``Device.cu:204-292``), with the fused against split-phase matcher and
the large-radius medians. Keys and the printed table are the JAX module's,
``_tpu`` read as ``_device``. On a card each stage is its kernel:

* ``gray_device``: the gray kernel (``kernels/gray.py``, G);
* ``gradient_device``: ``ops/color.py::gradient_x`` (plain torch);
* ``remap_device``: the u8 remap entry (``kernels/remap.py``, B) through
  random maps;
* ``median7x7_device`` and ``median_r{5,7}_ctmf_kernel``: the median
  kernel (``kernels/ctmf_median.py``, D);
* ``median_r{5,7}_cdf255``: the 255-level histogram median in plain torch,
  the comparison row the JAX module keeps;
* ``bm_fused``: the fused kernel on one pair (A); ``bm_split_phase``: the
  SAD volume then its argmin (E1, E2);
* ``gray_cpu_numpy``, ``h2d_upload``, ``d2h_download``: host work, by the
  host clock, each copy synchronized.

A value is the mean seconds of one call over ``iters`` calls (fewer for
the slow stages, as in JAX) after one warm call: between CUDA events on a
card, by the host clock on the CPU (``device="cpu"``, where the plain
twins run).

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.micro``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

ITERS = 100  # calls timed a stage (fewer for the slow stages)


def _time(fn: Callable[[], object], iters: int, dev: torch.device, host: bool = False) -> float:
    """Mean seconds of one of ``iters`` calls of ``fn()`` after one warm
    call: by CUDA events on a card, or by the host clock where ``host``
    (each call synchronizing itself) or on the CPU."""
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import best_ms, wall_ms

    def loop():
        for _ in range(iters):
            fn()

    fn()
    timer = wall_ms if host else best_ms
    return timer(loop, 1, dev, warmups=0) * 1e-3 / iters


def run_micro_benchmarks(
    height: int = 1080, width: int = 1920, iters: int = ITERS, device="cuda"
) -> Dict[str, float]:
    """Seconds per stage; printed as ms, under the card's name and power
    limit."""
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import card
    from gpu_stereo_matching_tpu_torch.device import resolve_device
    from gpu_stereo_matching_tpu_torch.kernels.ctmf_median import ctmf_median_u8
    from gpu_stereo_matching_tpu_torch.kernels.gray import gray_blockmatching_bgr
    from gpu_stereo_matching_tpu_torch.kernels.remap import remap_bilinear_u8_direct
    from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching
    from gpu_stereo_matching_tpu_torch.kernels.split_phase import split_phase_block_matching
    from gpu_stereo_matching_tpu_torch.ops.color import gradient_x
    from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    img_bgr = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (height, width), dtype=np.uint8)
    map_x = (rng.random((height, width)) * width).astype(np.float32)
    map_y = (rng.random((height, width)) * height).astype(np.float32)

    t_bgr = torch.from_numpy(img_bgr).to(dev)
    t_gray = torch.from_numpy(gray).to(dev)
    t_mx, t_my = torch.from_numpy(map_x).to(dev), torch.from_numpy(map_y).to(dev)

    def upload():
        torch.tensor(gray, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    weights = np.array([0.299, 0.587, 0.114], np.float32)
    results = {
        "gray_cpu_numpy": _time(
            lambda: np.clip(np.rint(img_bgr.astype(np.float32) @ weights), 0, 255).astype(np.uint8),
            max(iters // 10, 1), dev, host=True,
        ),
        "gray_device": _time(lambda: gray_blockmatching_bgr(t_bgr), iters, dev),
        "gradient_device": _time(lambda: gradient_x(t_gray), iters, dev),
        "remap_device": _time(lambda: remap_bilinear_u8_direct(t_gray, t_mx, t_my), iters, dev),
        "median7x7_device": _time(lambda: median_filter_u8(t_gray, 3), max(iters // 10, 1), dev),
        "h2d_upload": _time(upload, iters, dev, host=True),
        "d2h_download": _time(lambda: t_gray.to("cpu", copy=True), iters, dev, host=True),
    }

    # Fused against split-phase block matching (the reference's finished
    # and unfinished kernel pair, Device.cu:34-64 against 67-125): the cost
    # of materializing the SAD volume.
    t_right = torch.from_numpy(rng.integers(0, 256, (height, width), dtype=np.uint8)).to(dev)
    num_disp = min(64, width)  # tiny test shapes can't cover 64 disparities
    results["bm_fused"] = _time(
        lambda: fused_block_matching(t_gray, t_right, num_disp, 5), max(iters // 10, 1), dev)
    results["bm_split_phase"] = _time(
        lambda: split_phase_block_matching(t_gray, t_right, num_disp, 5), max(iters // 10, 1),
        dev)
    # Large-radius median: the 255-level histogram in plain torch against
    # the median kernel (the CTMF analog, ctmf.c:98-339).
    for r in (5, 7):
        if min(height, width) <= 2 * r:
            continue
        results[f"median_r{r}_cdf255"] = _time(
            lambda r=r: median_filter_u8(t_gray, r, method="histogram"), max(iters // 20, 1), dev)
        results[f"median_r{r}_ctmf_kernel"] = _time(
            lambda r=r: ctmf_median_u8(t_gray, r), max(iters // 20, 1), dev)

    print(f"card: {card()}" if dev.type == "cuda" else "device: cpu (plain twins)")
    for name, secs in results.items():
        print(f"{name:24s} {secs * 1e3:9.3f} ms")
    return results


if __name__ == "__main__":
    run_micro_benchmarks()
