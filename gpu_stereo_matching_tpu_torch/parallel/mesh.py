"""Device-mesh construction for sharded stereo.

As ``gpu_stereo_matching_tpu/parallel/mesh.py``, a mesh has three axes:

* ``data``  - frames of a batch (independent, nothing is exchanged),
* ``space`` - the image's H axis in bands; window ops take halo rows from
  the neighbouring bands,
* ``disp``  - the disparity range in contiguous parts; winner-take-all
  becomes an elementwise minimum of packed keys across the parts.

A :class:`DeviceMesh` is an array of ``torch.device`` of shape
``(data, space, disp)``. Built by :func:`build_mesh`, one process runs
every coordinate's work on its device, and rows and keys move between
devices as tensor copies, as one JAX controller drives its ``Mesh``.
Devices may repeat: a mesh whose every coordinate is one device
(:func:`virtual_mesh`) is the counterpart of the virtual CPU mesh, and on
one card it runs every shard's kernel launch, with a range start
``d_start > 0`` where ``disp > 1``.

Built by :func:`process_mesh`, the mesh spans the ranks of a
``torch.distributed`` process group, PyTorch's way across cards and hosts
(one process a card) and the counterpart of a JAX ``Mesh`` under
``jax.distributed``: each coordinate is driven by one rank, which runs its
work; halo rows between ranks move point to point and each ``(data,
space)`` group's keys are reduced over the group's ranks
(``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gpu_stereo_matching_tpu_torch.core.config import MeshConfig
from gpu_stereo_matching_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """``devices``: object array of ``torch.device``, shape (data, space, disp).

    A mesh that spans processes also holds ``ranks``, the rank that drives
    each coordinate (an int array of the same shape), this process's
    ``rank``, and ``disp_groups``: for each ``(data, space)`` index, the
    process group of the ranks that hold its ``disp`` coordinates. A mesh
    that one process drives has ``ranks=None``.
    """

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "space", "disp")
    ranks: Optional[np.ndarray] = None
    rank: int = 0
    disp_groups: Optional[Dict[Tuple[int, int], object]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def is_local(self, i: int, j: int, k: int) -> bool:
        """Whether this process drives coordinate ``(i, j, k)``."""
        return self.ranks is None or int(self.ranks[i, j, k]) == self.rank

    def unique_devices(self) -> list:
        """The distinct devices this process drives, in mesh order."""
        return list(dict.fromkeys(
            d for idx, d in np.ndenumerate(self.devices) if self.is_local(*idx)))


def build_mesh(config: MeshConfig, devices: Sequence[str | torch.device]) -> DeviceMesh:
    """Arrange the first ``config.num_devices`` of ``devices`` as a
    ``(data, space, disp)`` mesh.

    ``data`` is the outermost (slowest-varying) axis, so the devices of one
    ``(space, disp)`` group, which exchange halos and keys, are neighbours
    in the list. Each device goes through ``resolve_device``, which raises
    for a CUDA device this process does not have.
    """
    devs = [resolve_device(d) for d in devices]
    need = config.num_devices
    if len(devs) < need:
        raise ValueError(f"mesh {config.shape} needs {need} devices, have {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return DeviceMesh(arr.reshape(config.shape))


def virtual_mesh(config: MeshConfig, device: str | torch.device = "cuda") -> DeviceMesh:
    """A mesh whose every coordinate is ``device``: all shards of the
    sharded step run, one after another, on that one device."""
    return build_mesh(config, [device] * config.num_devices)


def virtual_cpu_mesh(config: MeshConfig) -> DeviceMesh:
    """JAX's name for a mesh over the CPU, which tests and dry runs use:
    :func:`virtual_mesh` with every coordinate on the CPU."""
    return virtual_mesh(config, "cpu")


def owner_ranks(config: MeshConfig, per_rank: int, across: str = "data") -> np.ndarray:
    """The rank that drives each coordinate when every rank drives
    ``per_rank`` of them: ranks 0, 1, ... take contiguous blocks in order,
    with axis ``across`` outermost. With ``"data"``, the default, rank r
    drives the r-th block of the data-major mesh, so the devices of one
    ``(space, disp)`` group, which exchange halos and keys, share a rank
    where they can (as JAX ``build_mesh`` lays out hosts); ``"space"`` or
    ``"disp"`` put that axis across the ranks. Returns an int array of shape
    ``config.shape``."""
    axis = config.axis_names.index(across)
    need = config.num_devices
    if per_rank < 1 or need % per_rank:
        raise ValueError(f"mesh {config.shape}: {need} coordinates do not divide into blocks "
                         f"of {per_rank} a rank")
    moved = (config.shape[axis],) + tuple(n for a, n in enumerate(config.shape) if a != axis)
    order = np.moveaxis(np.arange(need).reshape(moved), 0, axis)
    return order // per_rank


def process_mesh(
    config: MeshConfig, local_devices: Sequence[str | torch.device], across: str = "data"
) -> DeviceMesh:
    """A mesh over the ranks of the initialized process group, built alike
    on every rank.

    Each rank names the devices it drives (``local_devices``, as many on
    every rank); :func:`owner_ranks` gives each coordinate its rank, and the
    rank's devices fill its coordinates in order. A mesh smaller than the
    ranks' devices leaves the last ranks idle (their steps do nothing); a
    larger one raises. Every rank must call this for every mesh, in one
    order: it creates the process subgroup of each ``(data, space)``
    group's ``disp`` ranks (the whole world where the group spans it), one
    per distinct set of ranks.
    """
    own = [resolve_device(d) for d in local_devices]
    world, rank = dist.get_world_size(), dist.get_rank()
    listed = [None] * world
    dist.all_gather_object(listed, [str(d) for d in own])
    if any(len(names) != len(own) for names in listed):
        raise ValueError(f"process_mesh: ranks name different numbers of devices: {listed}")
    owners = owner_ranks(config, len(own), across)
    if owners.max() >= world:
        raise ValueError(f"mesh {config.shape} needs {config.num_devices} devices, the {world} "
                         f"ranks drive {world * len(own)}")
    devices = np.empty(config.shape, dtype=object)
    order = owner_ranks(config, 1, across)  # each coordinate's place in the rank blocks
    for idx, r in np.ndenumerate(owners):
        slot = int(order[idx]) % len(own)
        devices[idx] = own[slot] if r == rank else torch.device(listed[r][slot])
    groups, made = {}, {}
    for i, j in np.ndindex(config.data, config.space):
        members = tuple(sorted({int(r) for r in owners[i, j]}))
        if members not in made:
            made[members] = dist.group.WORLD if len(members) == world else dist.new_group(
                list(members))
        groups[(i, j)] = made[members]
    return DeviceMesh(devices, ranks=owners, rank=rank, disp_groups=groups)
