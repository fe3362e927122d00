"""Block matching sharded over a ``(data, space, disp)`` mesh.

As ``gpu_stereo_matching_tpu/parallel/stereo.py``:

* ``data``  - frames of the batch are independent;
* ``space`` - the image's H axis is cut in bands; a band takes ``radius``
  halo rows from each neighbour, zeros at the global top and bottom;
* ``disp``  - each shard evaluates a contiguous disparity range, and the
  WTA argmin is the elementwise minimum of the shards' packed keys
  (``key = SAD * D + d``, so ties still go to the smallest global d).

On a mesh one process drives (``parallel/mesh.py``) the step runs every
coordinate's work on its device in turn and moves halo rows and keys
between devices as tensor copies. On a mesh that spans processes
(``process_mesh``) every rank calls the step with the same arguments and
runs its own coordinates: halo rows between ranks move point to point, and
each ``(data, space)`` group reduces its keys with
``all_reduce(MIN)`` over its ranks' subgroup, a group of one rank
included, so one path serves every layout. The minimum of int32 keys is
exact, so the bits do not depend on the transport.

The zero halo rows at the global border are real rows of the slab, so an
invalid column (``x < d``) is charged ``255 * (2r + 1)`` there, the fused
formula (``kernels/sad_wta.py``), with the kernel and without it. The plain
step therefore equals ``fused_block_matching`` at every pixel and can
differ from the unfused ``block_matching_pipeline`` within ``r`` rows of the
top and bottom at large D, exactly as the JAX step does.

One deviation: at ``sad_radius = 0`` the JAX plain step
(``use_pallas=False``) packs its key from the uint8 cost volume, which
wraps; the port packs in int32, as the JAX kernel path and the
single-device pipeline do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching_key
from gpu_stereo_matching_tpu_torch.ops.aggregate import aggregate_cost_volume
from gpu_stereo_matching_tpu_torch.ops.cost import ad_cost_volume_offset
from gpu_stereo_matching_tpu_torch.ops.postprocess import lr_consistency_mask, median_filter_u8
from gpu_stereo_matching_tpu_torch.parallel.collectives import all_reduce
from gpu_stereo_matching_tpu_torch.parallel.halo import extend_with_row_halos
from gpu_stereo_matching_tpu_torch.parallel.mesh import DeviceMesh

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class ShardedBatch:
    """A (B, H, W) batch laid out on a mesh: ``pieces[i][j]`` lists the
    copies of frames block ``i`` (``data``), rows band ``j`` (``space``).
    An input holds one copy per device of the ``disp`` group; a step's
    result holds one, on the group's first device. On a mesh that spans
    processes a rank holds only its own coordinates' pieces (the others are
    None), and a result holds one copy on each rank of the group, on the
    rank's first device of it, as JAX replicates a step's output over
    ``disp``."""

    mesh: DeviceMesh
    pieces: List[List[List[Optional[torch.Tensor]]]]


def shard_batch(
    mesh: DeviceMesh, left: torch.Tensor, right: torch.Tensor
) -> Tuple[ShardedBatch, ShardedBatch]:
    """Place a (B, H, W) uint8 stereo batch with the steps' input layout:
    frames split over ``data``, rows over ``space``, each piece copied to
    every device of its ``disp`` group. On a mesh that spans processes each
    rank gives the whole batch and places only its own pieces."""
    check_gray_pair(left, right, 1, "shard_batch")
    if left.dim() != 3:
        raise ValueError(f"shard_batch: expected (B, H, W), got {tuple(left.shape)}")
    n_data, n_space, n_disp = mesh.devices.shape
    b, h, _ = left.shape
    if b % n_data:
        raise ValueError(f"shard_batch: {b} frames do not divide over data={n_data}")
    if h % n_space:
        raise ValueError(f"shard_batch: {h} rows do not divide over space={n_space}")

    def place(x):
        return ShardedBatch(mesh, [
            [
                [band.to(mesh.devices[i, j, k]) if mesh.is_local(i, j, k) else None
                 for k in range(n_disp)]
                for j, band in enumerate(block.chunk(n_space, dim=1))
            ]
            for i, block in enumerate(x.chunk(n_data, dim=0))
        ])

    return place(left), place(right)


def own_pieces(batch: ShardedBatch) -> Dict[Tuple[int, int], torch.Tensor]:
    """This process's pieces of a sharded batch: ``(i, j)`` -> its first
    copy of frames block ``i``, rows band ``j``."""
    out = {}
    for i, block in enumerate(batch.pieces):
        for j, band in enumerate(block):
            piece = next((p for p in band if p is not None), None)
            if piece is not None:
                out[(i, j)] = piece
    return out


def unshard(
    batch: ShardedBatch, device: str | torch.device | None = None
) -> Optional[torch.Tensor]:
    """Gather a sharded batch into one (B, H, W) tensor on ``device``
    (default: the device of the first piece).

    On a mesh that spans processes every rank calls this; the pieces go to
    rank 0 through the host (``dist.gather_object``), which returns the
    batch (on ``device``, default the host) while the other ranks return
    None. :func:`own_pieces` gives a rank its own pieces without moving any.
    """
    if batch.mesh.ranks is not None:
        everyone = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
        dist.gather_object({ij: p.cpu() for ij, p in own_pieces(batch).items()}, everyone)
        if everyone is None:
            return None
        pieces = {ij: p for part in everyone for ij, p in part.items()}
        n_data, n_space, _ = batch.mesh.devices.shape
        out = torch.cat([torch.cat([pieces[(i, j)] for j in range(n_space)], dim=1)
                         for i in range(n_data)], dim=0)
        return out if device is None else out.to(device)
    dev = batch.pieces[0][0][0].device if device is None else torch.device(device)
    return torch.cat(
        [torch.cat([band[0].to(dev) for band in block], dim=1) for block in batch.pieces],
        dim=0,
    )


def _disparities_per_shard(mesh: DeviceMesh, config: BlockMatchingConfig) -> int:
    if config.num_disparities % mesh.shape["disp"]:
        raise ValueError("num_disparities must divide evenly over the disp axis")
    return config.num_disparities // mesh.shape["disp"]


def _run_sharded(
    left: ShardedBatch,
    right: ShardedBatch,
    halo: int,
    local_keys: Callable,
    finish: Callable,
) -> ShardedBatch:
    """The frame of both steps. For every ``(data, space)`` group: halo
    rows, then ``local_keys(slab_l, slab_r, k)`` -> a tuple of key tensors
    on each ``disp`` device ``k`` this process drives, their elementwise
    minimum on the first of them, on a mesh that spans processes that
    minimum's ``all_reduce(MIN)`` over the group's ranks, and
    ``finish(keys, j)`` -> the band, on the first of those devices."""
    mesh = left.mesh
    n_data, n_space, n_disp = mesh.devices.shape
    out = []
    for i in range(n_data):
        # slabs[k][j]: band j with its halo rows, on device (i, j, k).
        slabs = []
        for k in range(n_disp):
            owners = None if mesh.ranks is None else [int(r) for r in mesh.ranks[i, :, k]]
            slabs.append(tuple(
                extend_with_row_halos([x.pieces[i][j][k] for j in range(n_space)], halo, owners)
                for x in (left, right)))
        bands = []
        for j in range(n_space):
            mine = [k for k in range(n_disp) if mesh.is_local(i, j, k)]
            keys = None
            for k in mine:
                part = local_keys(slabs[k][0][j], slabs[k][1][j], k)
                part = tuple(p.to(mesh.devices[i, j, mine[0]]) for p in part)
                keys = part if keys is None else tuple(
                    torch.minimum(a, b) for a, b in zip(keys, part)
                )
            if mine and mesh.ranks is not None:
                group = mesh.disp_groups[(i, j)]
                keys = tuple(all_reduce(key, dist.ReduceOp.MIN, group) for key in keys)
            bands.append([finish(keys, j) if mine else None])
        out.append(bands)
    return ShardedBatch(mesh, out)


def make_sharded_block_matching(
    mesh: DeviceMesh, config: BlockMatchingConfig, use_kernel: bool = True
) -> Callable[[ShardedBatch, ShardedBatch], ShardedBatch]:
    """Build the sharded disparity step: two sharded (B, H, W) uint8
    batches (``shard_batch``) -> sharded (B, H, W) int32 disparities.

    ``use_kernel`` runs each shard's partial-range WTA through
    ``fused_block_matching_key``, one call for all its local frames: on a
    CUDA device that launches the key kernel or raises, on the CPU it runs
    the kernel's plain twin. ``use_kernel=False`` is the JAX step's
    ``use_pallas=False`` branch in plain torch on whatever device:
    ``ad_cost_volume_offset`` -> ``aggregate_cost_volume`` -> packed key ->
    minimum over the local range.
    """
    num_d = config.num_disparities
    d_per_shard = _disparities_per_shard(mesh, config)
    radius = config.sad_radius

    def crop(x):
        return x[..., radius:-radius, :] if radius > 0 else x

    def frame_keys(lf, rf, d0):
        vol = ad_cost_volume_offset(lf, rf, d_per_shard, d0, int(config.invalid_cost))
        sad = crop(aggregate_cost_volume(vol, radius).to(torch.int32))
        d_ids = torch.arange(d0, d0 + d_per_shard, dtype=torch.int32, device=lf.device)
        return (sad * num_d + d_ids[:, None, None]).amin(dim=0)

    def local_keys(slab_l, slab_r, k):
        d0 = k * d_per_shard
        if use_kernel:
            keys = fused_block_matching_key(
                slab_l.contiguous(), slab_r.contiguous(), d0, d_per_shard, num_d, radius
            )
            return (crop(keys),)
        return (torch.stack([frame_keys(lf, rf, d0) for lf, rf in zip(slab_l, slab_r)]),)

    def finish(keys, j):
        return (keys[0] % num_d).to(torch.int32)

    def step(left: ShardedBatch, right: ShardedBatch) -> ShardedBatch:
        return _run_sharded(left, right, radius, local_keys, finish)

    return step


def make_sharded_block_matching_full(
    mesh: DeviceMesh, config: BlockMatchingConfig
) -> Callable[[ShardedBatch, ShardedBatch], ShardedBatch]:
    """Sharded config-2 step: SAD + WTA + LR consistency + median.

    The halo covers the chained windows (SAD radius + median radius), both
    views' WTA reduce over ``disp`` as minima of packed keys, and the
    median leaves out slab rows past the global image through a validity
    mask. As in the JAX package it runs no hand-written kernel (plain torch
    and ``ops/postprocess.py``, the median with ``method="sort"``), and the
    LR check always runs, whatever ``config.lr_consistency`` says.
    """
    num_d = config.num_disparities
    d_per_shard = _disparities_per_shard(mesh, config)
    sad_r = config.sad_radius
    med_r = config.median_radius
    halo = sad_r + med_r
    n_space = mesh.shape["space"]

    def frame_keys(lf, rf, d0):
        vol = ad_cost_volume_offset(lf, rf, d_per_shard, d0, int(config.invalid_cost))
        sad = aggregate_cost_volume(vol, sad_r).to(torch.int32)  # (dl, slab, W)
        d = torch.arange(d0, d0 + d_per_shard, device=lf.device)
        d_ids = d.to(torch.int32)[:, None, None]
        key_l = (sad * num_d + d_ids).amin(dim=0)
        # Right-view SAD: right(d, y, x) = left(d, y, x + d); past the image
        # the key (not the SAD) is INT32_MAX, so packing cannot overflow.
        w = sad.shape[-1]
        src = torch.arange(w, device=lf.device)[None, :] + d[:, None]
        gathered = torch.gather(sad, -1, src.clamp(max=w - 1)[:, None, :].expand(sad.shape))
        key_r = (gathered * num_d + d_ids).masked_fill_((src > w - 1)[:, None, :], _INT32_MAX)
        return key_l, key_r.amin(dim=0)

    def local_keys(slab_l, slab_r, k):
        pairs = [frame_keys(lf, rf, k * d_per_shard) for lf, rf in zip(slab_l, slab_r)]
        return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])

    def finish(keys, j):
        disp_l = (keys[0] % num_d).to(torch.int32)
        disp_r = (keys[1] % num_d).to(torch.int32)
        slab_rows, w = disp_l.shape[-2:]
        h_local = slab_rows - 2 * halo
        mask = lr_consistency_mask(disp_l, disp_r, config.lr_max_diff)
        out = torch.where(mask, disp_l, 0)
        if med_r > 0:
            # Slab rows that lie inside the global image.
            global_row = j * h_local + torch.arange(slab_rows, device=out.device) - halo
            row_valid = (global_row >= 0) & (global_row < h_local * n_space)
            out = median_filter_u8(
                out.to(torch.uint8), med_r, method="sort",
                valid_mask=row_valid[:, None].expand(slab_rows, w),
            ).to(torch.int32)
        return out[..., halo : halo + h_local, :]

    def step(left: ShardedBatch, right: ShardedBatch) -> ShardedBatch:
        return _run_sharded(left, right, halo, local_keys, finish)

    return step
