"""One rank of the port's multi-process sharded step, on the CPU.

Usage: ``python tests/torch_dist_worker.py RANK WORLD PORT SPEC OUT``, with
the repository on ``PYTHONPATH``. ``SPEC`` is a JSON file naming the input
batch (``.npz`` with ``left`` and ``right``) and the layouts to run; each
layout names its mesh, the axis its ranks are laid across, the step and the
JAX package's result for it (``.npy``, written by the parent test, since no
rank imports JAX). The rank joins a gloo group of ``WORLD`` ranks at
``localhost:PORT``, runs every layout on its share of the mesh, holds each
of its pieces to the JAX result, to the single-process port step and to
the single-device function, gathers the batch to rank 0, tries a mesh
larger than the ranks' devices, and writes what it found to
``OUT/rank<RANK>.json``. Spawned by ``tests/test_torch_distributed.py``.
"""

import json
import os
import sys


def main() -> int:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    spec = json.loads(open(sys.argv[4]).read())
    out_dir = sys.argv[5]

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig, MeshConfig
    from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching_batched
    from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
    from gpu_stereo_matching_tpu_torch.parallel.launch import initialize_distributed
    from gpu_stereo_matching_tpu_torch.parallel.mesh import process_mesh, virtual_mesh
    from gpu_stereo_matching_tpu_torch.parallel.stereo import (
        make_sharded_block_matching,
        make_sharded_block_matching_full,
        own_pieces,
        shard_batch,
        unshard,
    )

    initialize_distributed(f"localhost:{port}", world, rank, device="cpu", timeout=60)
    batch = np.load(spec["inputs"])
    left, right = torch.from_numpy(batch["left"]), torch.from_numpy(batch["right"])
    found = {"layouts": {}}
    for layout in spec["layouts"]:
        mesh_cfg = MeshConfig(*layout["mesh"])
        cfg = BlockMatchingConfig(**layout["config"])
        if layout["full"]:
            def make(mesh):
                return make_sharded_block_matching_full(mesh, cfg)
            single_device = block_matching_pipeline(left, right, cfg)
        else:
            def make(mesh):
                return make_sharded_block_matching(mesh, cfg, use_kernel=layout["use_kernel"])
            single_device = fused_block_matching_batched(
                left, right, cfg.num_disparities, cfg.sad_radius)
        mesh = process_mesh(mesh_cfg, ["cpu"] * (mesh_cfg.num_devices // world),
                            across=layout["across"])
        result = make(mesh)(*shard_batch(mesh, left, right))
        one = virtual_mesh(mesh_cfg, "cpu")
        single_process = unshard(make(one)(*shard_batch(one, left, right)))
        jax_step = torch.from_numpy(np.load(layout["jax"]))
        n_data, n_space, _ = mesh_cfg.shape
        rows, frames = left.shape[1] // n_space, left.shape[0] // n_data
        checks = {"jax": jax_step, "single_process": single_process,
                  "single_device": single_device}
        equal = dict.fromkeys(checks, True)
        pieces = own_pieces(result)
        for (i, j), piece in pieces.items():
            for name, whole in checks.items():
                part = whole[i * frames:(i + 1) * frames, j * rows:(j + 1) * rows]
                equal[name] &= piece.dtype == torch.int32 and torch.equal(piece, part)
        gathered = unshard(result)
        found["layouts"][layout["name"]] = {
            "pieces": sorted(pieces), "equal": equal,
            "gathered": None if gathered is None else bool(torch.equal(gathered, jax_step)),
        }
    try:
        process_mesh(MeshConfig(4, 2, 2), ["cpu"] * 4)
        found["too_large"] = None
    except ValueError as e:
        found["too_large"] = str(e)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
