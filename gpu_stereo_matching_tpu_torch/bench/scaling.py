"""Scaling harness: frames per second of the sharded block-matching step
over mesh sizes.

The port of ``gpu_stereo_matching_tpu/bench/scaling.py::run_scaling_benchmark``:
a sweep along the ``data`` axis at a fixed ``(space, disp)``, one JSON line
per point. The caller names the devices, one per mesh coordinate. On CUDA
devices the warmed step is timed between CUDA events, with one synchronize
per device of the mesh; on the CPU (the tests' tiny sizes) with the host
clock, and the line says which device it was. On a virtual mesh (one device
named for every coordinate) the sweep measures what sharding costs there
(halo rows computed twice, one launch per ``disp`` part plus the minimum,
copies), not what it gains; a line's ``distinct_devices`` then falls short
of its ``devices``.

With ``distributed=True`` the sweep spans the ranks of the process group
(``parallel/mesh.py::process_mesh``): every rank calls it with its own
devices, a point whose mesh is smaller than the world leaves the last ranks
idle at the barriers, a step's time is its slowest rank's, and rank 0
prints the lines.

:func:`predict_scaling_efficiency` puts arithmetic behind the multi-card
target where it cannot be measured: the bytes each sharding strategy moves
a frame (the JAX module's strategies and byte counts), over link rates
from data sheets, against a measured compute time a frame. Collectives
are assumed fully exposed (no overlap with compute), ring schedules cost
2(p-1)/p of the array, and the rates are arguments, so a deployment can
re-run it with its own.

Run: ``python -m gpu_stereo_matching_tpu_torch.bench.scaling`` prints the
prediction, the compute time a frame measured on the card by the headline
(``bench/headline.py``); ``--measure`` then also sweeps the ``data`` axis
on the card.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig, MeshConfig
from gpu_stereo_matching_tpu_torch.parallel.collectives import all_reduce, barrier
from gpu_stereo_matching_tpu_torch.parallel.mesh import DeviceMesh, build_mesh, process_mesh
from gpu_stereo_matching_tpu_torch.parallel.stereo import (
    make_sharded_block_matching,
    shard_batch,
)


@dataclasses.dataclass
class ScalingPoint:
    mesh: dict
    devices: int
    fps: float
    efficiency: Optional[float]  # vs the 1-device point, per device
    device: str  # what the mesh ran on (rank 0's)
    distinct_devices: int  # cards (or the CPU) the mesh ran on, hosts told apart
    processes: int  # ranks that drove the mesh


def time_step(mesh: DeviceMesh, fn, reps: int = 3) -> float:
    """Best time in seconds of ``fn()`` over ``reps`` runs, after one
    warm-up, on the devices of ``mesh``. On a mesh that spans processes
    every rank calls this; each run starts at a barrier, and its time is
    the slowest rank's."""
    devices = mesh.unique_devices()
    on_cuda = bool(devices) and all(d.type == "cuda" for d in devices)
    spans = mesh.ranks is not None

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    fn()
    sync()
    times = []
    for _ in range(reps):
        if spans:
            barrier()
        if on_cuda:
            with torch.cuda.device(devices[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                sync()
                end.record()
                end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
    if spans:
        times = all_reduce(torch.tensor(times, dtype=torch.float64), dist.ReduceOp.MAX).tolist()
    return min(times)


def _measure(mesh: DeviceMesh, bm: BlockMatchingConfig, num_frames, h, w) -> float:
    step = make_sharded_block_matching(mesh, bm)
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.integers(0, 256, (num_frames, h, w), dtype=np.uint8))
    right = torch.from_numpy(rng.integers(0, 256, (num_frames, h, w), dtype=np.uint8))
    sl, sr = shard_batch(mesh, left, right)
    return num_frames / time_step(mesh, lambda: step(sl, sr))


def _distinct_devices(mesh: DeviceMesh) -> tuple:
    """How many distinct devices, and ranks, drive ``mesh``."""
    mine = [(socket.gethostname(), str(d)) for d in mesh.unique_devices()]
    if mesh.ranks is None:
        return len(mine), 1
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return len({d for part in everyone for d in part}), len(set(mesh.ranks.flat))


def run_scaling_benchmark(
    full_mesh: MeshConfig,
    devices: Sequence[str | torch.device],
    bm: BlockMatchingConfig = BlockMatchingConfig(),
    num_frames: int = 16,
    height: int = 1080,
    width: int = 1920,
    distributed: bool = False,
) -> List[ScalingPoint]:
    """Sweep ``data`` = 1, 2, 4, ... up to ``full_mesh.data``; print one
    JSON line per point.

    ``devices``: at least ``full_mesh.num_devices`` devices; each point's
    mesh takes the first it needs. They may repeat (a virtual mesh). With
    ``distributed``, ``devices`` are this rank's own, every rank calls
    this, each point's mesh takes the ranks in order (``process_mesh``),
    and only rank 0 prints.
    """
    points: List[ScalingPoint] = []
    base_fps = None
    data = 1
    while data <= full_mesh.data:
        cfg = MeshConfig(data=data, space=full_mesh.space, disp=full_mesh.disp)
        frames = max(num_frames, cfg.num_devices)
        frames -= frames % cfg.num_devices
        mesh = process_mesh(cfg, devices) if distributed else build_mesh(cfg, devices)
        fps = _measure(mesh, bm, max(frames, cfg.data), height, width)
        distinct, processes = _distinct_devices(mesh)
        eff = None
        if base_fps is None:
            base_fps = fps / cfg.num_devices
        else:
            eff = fps / (cfg.num_devices * base_fps)
        first = next(iter(mesh.unique_devices()), torch.device("cpu"))
        pt = ScalingPoint(
            mesh=dict(zip(cfg.axis_names, cfg.shape)),
            devices=cfg.num_devices,
            fps=round(fps, 2),
            efficiency=None if eff is None else round(eff, 3),
            device=torch.cuda.get_device_name(first) if first.type == "cuda" else "cpu",
            distinct_devices=distinct,
            processes=processes,
        )
        points.append(pt)
        if not distributed or dist.get_rank() == 0:
            print(json.dumps(dataclasses.asdict(pt)), flush=True)
        data *= 2
    return points


# ---------------------------------------------------------------------------
# Predicted scaling efficiency from communication volume.
# ---------------------------------------------------------------------------

# Data sheets, one direction: NVLink 4 on an H100 SXM (900 GB/s both ways);
# across hosts, one 400 Gb/s InfiniBand NDR port.
NVLINK4_BYTES_PER_S = 4.5e11
NDR400_BYTES_PER_S = 5.0e10
# The keys' all_reduce(MIN) of a `disp`-across-cards step, 1080x1920, B=8
# (66 MB of int32 keys) over 4 H100s, measured by chip_smoke.py phase 19
# (PERF.md section 5): the least and the most of its ranks, ms.
MEASURED_KEY_ALLREDUCE_MS = (0.425, 0.449)


def predict_scaling_efficiency(
    h: int = 1080,
    w: int = 1920,
    sad_radius: int = 5,
    median_radius: int = 3,
    n_chips: int = 8,
    n_hosts: int = 2,
    *,
    compute_ms_per_frame: float,
    link_bytes_per_s: float = NVLINK4_BYTES_PER_S,
    host_link_bytes_per_s: float = NDR400_BYTES_PER_S,
) -> List[dict]:
    """Predict each strategy's scaling efficiency for BASELINE config 5 on
    ``n_chips`` cards (``n_hosts`` hosts).

    ``eff = t_compute / (t_compute + t_comm)``, ``t_compute`` the measured
    ``compute_ms_per_frame`` split evenly over the cards and ``t_comm`` the
    fully exposed transfer time of the strategy's collectives a frame, over
    ``link_bytes_per_s`` within a host (NVLink) or ``host_link_bytes_per_s``
    across hosts. Byte counts follow ``parallel/stereo.py``,
    ``parallel/halo.py`` and ``parallel/segment_tree.py``.
    """
    t_comp = compute_ms_per_frame / n_chips * 1e-3  # seconds, per card

    rows: List[dict] = []

    def add(strategy, link, bw, bytes_per_frame, note):
        t_comm = bytes_per_frame / bw
        eff = t_comp / (t_comp + t_comm)
        rows.append({
            "strategy": strategy,
            "link": link,
            "comm_bytes_per_frame": int(bytes_per_frame),
            "t_compute_us": round(t_comp * 1e6, 1),
            "t_comm_us": round(t_comm * 1e6, 2),
            "predicted_efficiency": round(eff, 4),
            "meets_85pct": bool(eff >= 0.85),
            "note": note,
        })

    # Data parallel over frames: no collective a frame.
    add("data_parallel", "none", link_bytes_per_s, 0,
        "frame sharding, parallel/stereo.py shard_batch; no collective")

    # Space (H-band) sharding: `halo` rows of W bytes of both u8 images to
    # each neighbor (parallel/halo.py), per card and frame.
    halo = sad_radius
    add("space_bm", "NVLink", link_bytes_per_s, 2 * 2 * halo * w,
        f"halo={halo} rows x W={w} u8, 2 images, 2 directions")
    halo2 = sad_radius + median_radius  # the config-2 chain (LR + median)
    add("space_bm_config2", "NVLink", link_bytes_per_s, 2 * 2 * halo2 * w,
        f"chained-window halo={halo2} (SAD + median)")

    # Disparity sharding: the packed keys' minimum over the disp axis, a
    # ring all-reduce of an (H, W) int32 array. The memory lever for
    # volumes that exceed one card, not a throughput strategy: at full
    # height the reduction alone outweighs a card's compute.
    key_bytes = h * w * 4
    ar = 2 * (n_chips - 1) / n_chips
    add("disp_wta_allreduce (memory lever, not prescribed)", "NVLink", link_bytes_per_s,
        ar * key_bytes,
        "packed-key all_reduce(MIN) of (H,W) i32; comm-bound at full H")
    add("disp2_x_space4 (memory lever, not prescribed)", "NVLink", link_bytes_per_s,
        (2 * (2 - 1) / 2) * (h // 4) * w * 4 + 2 * 2 * halo * w,
        "2-way key all-reduce on a 1/4-height band + band halos")

    # Segment trees: independent per-band trees move nothing across cards;
    # their cost is accuracy (the share off the global tree's map).
    add("st_per_band_trees", "none", link_bytes_per_s, 0,
        "independent band trees: no halo, no reduce; the cost is accuracy")

    # Across hosts: frames across hosts ship nothing a frame; a band
    # boundary across hosts is the worst reasonable layout.
    add("hosts_data_parallel", "NDR", host_link_bytes_per_s, 0,
        f"{n_hosts} hosts, frame sharding across hosts; no collective")
    add("hosts_space_split", "NDR", host_link_bytes_per_s, 2 * 2 * halo * w,
        "band boundary across hosts; still small")
    return rows


def print_scaling_prediction(extra: Optional[dict] = None, **kw) -> List[dict]:
    """Print :func:`predict_scaling_efficiency`'s rows, then the worst
    prescribed strategy against the 85% target; ``extra`` (the card that
    measured the compute time) is added to every line."""
    extra = extra or {}
    rows = predict_scaling_efficiency(**kw)
    for r in rows:
        print(json.dumps({**r, **extra}))
    worst_relevant = min(
        r["predicted_efficiency"] for r in rows if "not prescribed" not in r["strategy"]
    )
    print(json.dumps({
        "metric": "predicted_scaling_efficiency_config5",
        "value": worst_relevant,
        "unit": f"fraction at {kw.get('n_chips', 8)} cards "
                "(worst prescribed strategy, fully exposed comm)",
        "target": 0.85,
        "pass": bool(worst_relevant >= 0.85),
        **extra,
    }), flush=True)
    return rows


def key_allreduce_model_ms(frames: int = 8, h: int = 1080, w: int = 1920, n_chips: int = 4,
                           link_bytes_per_s: float = NVLINK4_BYTES_PER_S) -> float:
    """The model's time of the keys' ring all-reduce of ``frames`` (H, W)
    int32 arrays over ``n_chips`` cards, ms."""
    return 2 * (n_chips - 1) / n_chips * frames * h * w * 4 / link_bytes_per_s * 1e3


def main(argv=None) -> None:
    import argparse

    from gpu_stereo_matching_tpu_torch.bench import headline
    from gpu_stereo_matching_tpu_torch.bench.fused_kernel import card

    ap = argparse.ArgumentParser(description="scaling prediction; --measure sweeps data")
    ap.add_argument("--measure", action="store_true",
                    help="also sweep data = 1, 2, 4, 8 on the card (a virtual mesh on one card)")
    args = ap.parse_args(argv)
    compute_ms = 1000.0 / headline.main()
    extra = {"card": card()}
    print_scaling_prediction(extra, compute_ms_per_frame=compute_ms)
    print(json.dumps({
        "metric": "key_allreduce_4_cards_66mb_ms",
        "model_ms": key_allreduce_model_ms(),
        "measured_ms": list(MEASURED_KEY_ALLREDUCE_MS),
        "unit": "ms (model: ring all-reduce over NVLink 4 at the data sheet's rate; "
                "measured: chip_smoke.py phase 19)",
        **extra,
    }), flush=True)
    if args.measure:
        n = torch.cuda.device_count()
        run_scaling_benchmark(MeshConfig(data=8, space=1, disp=1),
                              [f"cuda:{i % n}" for i in range(8)])


if __name__ == "__main__":
    main()
