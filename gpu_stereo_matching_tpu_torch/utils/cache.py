"""Content-addressed artifact cache for host precomputations (the rig's
rectification maps).

The port keeps its own copy: importing ``gpu_stereo_matching_tpu.utils``
imports jax. With no directory the cache lives in memory only; a
directory adds a pickle tier there, read back only by this cache.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Optional

import numpy as np


def content_key(*parts: Any) -> str:
    """Hash of arrays (bytes, shape, dtype) and reprs of everything else;
    the same key as ``gpu_stereo_matching_tpu.utils.cache.content_key``."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
            h.update(str(p.shape).encode())
            h.update(str(p.dtype).encode())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:32]


class ArtifactCache:
    """In-memory cache with an optional pickle directory."""

    def __init__(self, directory: Optional[str] = None) -> None:
        self.directory = directory
        self._mem: dict = {}

    def get_or_compute(self, key: str, compute: Callable[[], Any]) -> Any:
        if key in self._mem:
            return self._mem[key]
        path = None if self.directory is None else os.path.join(self.directory, key + ".pkl")
        if path is not None and os.path.exists(path):
            with open(path, "rb") as f:
                value = pickle.load(f)
            self._mem[key] = value
            return value
        value = compute()
        if path is not None:
            os.makedirs(self.directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
        self._mem[key] = value
        return value
