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

The JAX module's communication model (``predict_scaling_efficiency``) rests
on TPU link rates and is not carried over.
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
