"""Device-mesh construction for sharded stereo.

As ``gpu_stereo_matching_tpu/parallel/mesh.py``, a mesh has three axes:

* ``data``  - frames of a batch (independent, nothing is exchanged),
* ``space`` - the image's H axis in bands; window ops take halo rows from
  the neighbouring bands,
* ``disp``  - the disparity range in contiguous parts; winner-take-all
  becomes an elementwise minimum of packed keys across the parts.

The JAX package is single-controller: one process drives every device of
its ``Mesh``, and its tests run on virtual CPU devices in one process. The
port keeps that model. A :class:`DeviceMesh` is an array of
``torch.device`` of shape ``(data, space, disp)``, one process runs each
coordinate's work on its device, and rows and keys move between devices as
tensor copies. Devices may repeat: a mesh whose every coordinate is one
device (:func:`virtual_mesh`) is the counterpart of the virtual CPU mesh,
and on one card it runs every shard's kernel launch, with a range start
``d_start > 0`` where ``disp > 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import MeshConfig
from gpu_stereo_matching_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``devices``: object array of ``torch.device``, shape (data, space, disp)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "space", "disp")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def unique_devices(self) -> list:
        """The mesh's distinct devices, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))


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
