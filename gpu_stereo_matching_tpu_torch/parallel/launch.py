"""Launch the scaling sweep of the sharded block matcher from a shell.

    python -m gpu_stereo_matching_tpu_torch.parallel.launch --disp 4 --frames 8

One process drives the whole mesh. With ``--device cuda`` and at least
``data * space * disp`` visible cards the mesh takes ``cuda:0`` onwards, one
card per coordinate; otherwise every coordinate runs on the named device
(a virtual mesh). The multi-process flags of the JAX launcher
(``--coordinator``, ``--num-processes``, ``--process-id``) are not taken.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu_stereo_matching_tpu_torch.parallel.launch")
    p.add_argument("--data", type=int, default=None,
                   help="mesh data axis (default: as many as the visible cards allow)")
    p.add_argument("--space", type=int, default=1)
    p.add_argument("--disp", type=int, default=1)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--device", default="cuda", help="cpu, cuda or cuda:N")
    args = p.parse_args(argv)

    import torch

    from gpu_stereo_matching_tpu_torch.bench.scaling import run_scaling_benchmark
    from gpu_stereo_matching_tpu_torch.core.config import MeshConfig
    from gpu_stereo_matching_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if device == torch.device("cuda") else 1
    data = args.data or max(1, n_dev // (args.space * args.disp))
    cfg = MeshConfig(data=data, space=args.space, disp=args.disp)
    if 1 < cfg.num_devices <= n_dev:
        devices = [f"cuda:{i}" for i in range(cfg.num_devices)]
    else:
        devices = [device] * cfg.num_devices
    run_scaling_benchmark(
        cfg, devices, num_frames=args.frames, height=args.height, width=args.width
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
