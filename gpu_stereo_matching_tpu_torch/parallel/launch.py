"""Launch the scaling sweep of the sharded block matcher from a shell.

One process for the whole mesh:

    python -m gpu_stereo_matching_tpu_torch.parallel.launch --disp 4 --frames 8

With ``--device cuda`` and at least ``data * space * disp`` visible cards
the mesh takes ``cuda:0`` onwards, one card per coordinate; otherwise every
coordinate runs on the named device (a virtual mesh), and the JSON lines'
``distinct_devices`` say so.

One process a card, as JAX's launcher runs one process a host: the same
command on every rank, under ``torchrun``

    torchrun --nproc-per-node 4 -m gpu_stereo_matching_tpu_torch.parallel.launch

or with the rank's coordinates named

    python -m gpu_stereo_matching_tpu_torch.parallel.launch \\
        --coordinator 10.0.0.1:29500 --num-processes 4 --process-id $ID

Each rank drives one card (``cuda:$LOCAL_RANK``, or the one ``--device``
names), the sweep runs ``data`` = 1, 2, 4, ... over the ranks
(``bench/scaling.py``), and rank 0 prints the lines. A mesh that needs
more cards than the ranks own is an error. ``--backend gloo`` lets two
ranks share one card (NCCL refuses that), staging halos and keys through
host memory.
"""

from __future__ import annotations

import argparse
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.parallel.collectives import barrier

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str | torch.device | None = None,
    timeout: float = 300.0,
) -> torch.device:
    """Join this process to a ``torch.distributed`` process group; return
    the device the rank drives.

    ``coordinator_address`` ("host:port", where rank 0 serves the group's
    store) with ``num_processes`` and ``process_id`` joins through
    ``tcp://``; with none of them, through ``env://`` when ``torchrun``'s
    ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` are set (the counterpart of
    JAX's auto-detection on a pod), else it raises. The rank's device is
    ``device``, where ``cuda`` without an index means ``cuda:$LOCAL_RANK``
    (the default; 0 without ``LOCAL_RANK``). The backend is NCCL on a card
    and gloo on the CPU unless ``backend`` names one. Collectives wait at
    most ``timeout`` seconds, so a lost peer raises instead of hanging.
    """
    named = (coordinator_address, num_processes, process_id)
    if all(v is not None for v in named):
        join = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
    elif any(v is not None for v in named):
        raise ValueError("initialize_distributed: coordinator_address, num_processes and "
                         "process_id go together")
    elif all(os.environ.get(v) for v in _TORCHRUN_VARS):
        join = dict(init_method="env://")
    else:
        raise ValueError("initialize_distributed: name the coordinator, the number of "
                         f"processes and this process's id, or set {', '.join(_TORCHRUN_VARS)} "
                         "(torchrun does)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            timeout=datetime.timedelta(seconds=timeout), **join)
    barrier()  # every rank is up before the first point-to-point exchange
    return dev


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu_stereo_matching_tpu_torch.parallel.launch")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0, with --num-processes and --process-id")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="of the process group (default: nccl on a card, gloo on the CPU)")
    p.add_argument("--data", type=int, default=None,
                   help="mesh data axis (default: as many as the cards or ranks allow)")
    p.add_argument("--space", type=int, default=1)
    p.add_argument("--disp", type=int, default=1)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--device", default="cuda",
                   help="cpu, cuda or cuda:N (with ranks, cuda is cuda:$LOCAL_RANK)")
    args = p.parse_args(argv)
    named = (args.coordinator, args.num_processes, args.process_id)
    if any(v is not None for v in named) and not all(v is not None for v in named):
        p.error("--coordinator, --num-processes and --process-id go together")
    ranked = args.coordinator is not None or all(os.environ.get(v) for v in _TORCHRUN_VARS)
    if args.backend and not ranked:
        p.error("--backend needs the multi-process launch")

    from gpu_stereo_matching_tpu_torch.bench.scaling import run_scaling_benchmark
    from gpu_stereo_matching_tpu_torch.core.config import MeshConfig

    sweep = dict(num_frames=args.frames, height=args.height, width=args.width)
    per_point = args.space * args.disp
    if not ranked:
        device = resolve_device(args.device)
        n_dev = torch.cuda.device_count() if device == torch.device("cuda") else 1
        cfg = MeshConfig(data=args.data or max(1, n_dev // per_point), space=args.space,
                         disp=args.disp)
        if 1 < cfg.num_devices <= n_dev:
            devices = [f"cuda:{i}" for i in range(cfg.num_devices)]
        else:
            devices = [device] * cfg.num_devices
        run_scaling_benchmark(cfg, devices, **sweep)
        return 0

    device = initialize_distributed(*named, backend=args.backend, device=args.device)
    try:
        world = dist.get_world_size()
        cfg = MeshConfig(data=args.data or max(1, world // per_point), space=args.space,
                         disp=args.disp)
        if cfg.num_devices > world:
            raise ValueError(f"mesh {cfg.shape} needs {cfg.num_devices} cards, the {world} "
                             f"ranks own {world}")
        run_scaling_benchmark(cfg, [device], distributed=True, **sweep)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
