"""Carry state from the JAX package to the port: a rig's maps, a mesh's shape.

The system has no weights: a rig's state is its four float32
rectification maps, which the JAX rig holds in ``StereoRig._maps`` as
(left map_x, left map_y, right map_x, right map_y). Passed as numpy arrays
(``np.asarray`` of each), they become the port rig's buffers, so both rigs
compute from the same maps. The sharded steps' state is the mesh's shape,
which crosses as a plain dict of ints.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.core.config import MeshConfig
from gpu_stereo_matching_tpu_torch.models.streaming import MAP_NAMES, StereoRig


def maps_to_state_dict(
    maps: Sequence[np.ndarray], device: str | torch.device = "cpu"
) -> Dict[str, torch.Tensor]:
    """Four float32 (H, W) maps -> the port rig's ``state_dict``."""
    if len(maps) != len(MAP_NAMES):
        raise ValueError(f"expected {len(MAP_NAMES)} maps, got {len(maps)}")
    state = {}
    for name, m in zip(MAP_NAMES, maps):
        m = np.asarray(m)
        if m.dtype != np.float32 or m.ndim != 2:
            raise TypeError(f"{name}: expected a 2-D float32 map, got {m.shape} {m.dtype}")
        state[name] = torch.tensor(m, device=device)
    return state


def load_maps(rig: StereoRig, maps: Sequence[np.ndarray]) -> StereoRig:
    """Replace ``rig``'s maps with ``maps`` (shapes must match); returns it."""
    state = maps_to_state_dict(maps, rig.device)
    for name, t in state.items():
        if tuple(t.shape) != rig.image_size_hw:
            raise ValueError(f"{name}: map shape {tuple(t.shape)} != rig size {rig.image_size_hw}")
    rig.load_state_dict(state, strict=True)
    return rig


def mesh_config_from_jax(axis_sizes: Mapping[str, int]) -> MeshConfig:
    """The port's ``MeshConfig`` of a JAX mesh, given as
    ``dict(zip(mesh.axis_names, mesh.devices.shape))``: plain ints, so a test
    builds both meshes from one description."""
    names = MeshConfig().axis_names
    if set(axis_sizes) != set(names):
        raise ValueError(f"expected the axes {names}, got {tuple(axis_sizes)}")
    return MeshConfig(**{name: int(axis_sizes[name]) for name in names})
