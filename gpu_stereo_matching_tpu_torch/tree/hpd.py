"""What the stride-bucket filter (``tree/stride.py``) takes from the JAX
package's ``tree/hpd.py``, and nothing else of it: the exact weight LUT, the
24-bit index packing, ``_pow2`` and the persisted layout registry.

The heavy-path, plan-order and coded filters of that file are not ported.

The registry converges the stride layout (bucket path-slot caps, scan
caps, the round counts) so that all frames of one image size share one
static layout. It persists to its own file,
``~/.cache/gpu_stereo_matching_tpu_torch/hpd_layouts.json``, so the two
packages' caps never mix. Only the registries that the stride layout uses
are ported; those of the heavy-path and plan-order layouts are not.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

_ROUNDS_REGISTRY: dict = {}  # N -> max padded round count seen
_SCAN_REGISTRY: dict = {}  # (N, rounds) -> per-round pow2 max path length
_REAL_ROUNDS_REGISTRY: dict = {}  # (N, rounds) -> max non-dummy rounds
_BUCKET_REGISTRY: dict = {}  # (N, rounds) -> per-round per-exp path counts
_REGISTRY_PATH = None
_REGISTRY_LOADED = False
# Streaming pipelines build plans from worker threads.
_REGISTRY_LOCK = threading.Lock()


def _registry_file():
    global _REGISTRY_PATH
    if _REGISTRY_PATH is None:
        _REGISTRY_PATH = os.path.join(
            os.path.expanduser("~"), ".cache", "gpu_stereo_matching_tpu_torch",
            "hpd_layouts.json",
        )
    return _REGISTRY_PATH


def _registry_load():
    global _REGISTRY_LOADED
    if _REGISTRY_LOADED:
        return
    _REGISTRY_LOADED = True
    path = _registry_file()
    if os.path.exists(path):
        try:
            with open(path) as f:
                raw = json.load(f)
            for key, caps in raw.items():
                parts = key.split(":")
                if len(parts) == 3 and parts[0] == "S":
                    _SCAN_REGISTRY[(int(parts[1]), int(parts[2]))] = [
                        int(v) for v in caps
                    ]
                elif len(parts) == 3 and parts[0] == "NR":
                    _REAL_ROUNDS_REGISTRY[(int(parts[1]), int(parts[2]))] = (
                        int(caps)
                    )
                elif len(parts) == 3 and parts[0] == "B":
                    _BUCKET_REGISTRY[(int(parts[1]), int(parts[2]))] = [
                        [int(v) for v in row] for row in caps
                    ]
                elif len(parts) == 2 and parts[0] == "R":
                    _ROUNDS_REGISTRY[int(parts[1])] = int(caps)
        except (OSError, ValueError, TypeError, AttributeError):
            pass  # corrupt cache: start fresh


def _registry_save():
    path = _registry_file()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        raw = {f"S:{k[0]}:{k[1]}": list(v) for k, v in _SCAN_REGISTRY.items()}
        raw.update(
            {f"NR:{k[0]}:{k[1]}": v
             for k, v in _REAL_ROUNDS_REGISTRY.items()}
        )
        raw.update(
            {f"B:{k[0]}:{k[1]}": [list(row) for row in v]
             for k, v in _BUCKET_REGISTRY.items()}
        )
        raw.update({f"R:{k}": v for k, v in _ROUNDS_REGISTRY.items()})
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(raw, f)
        os.replace(tmp, path)
    except OSError:
        pass  # cache is best-effort


def _pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


def _registry_scan_caps(n: int, padded_rounds: int, needed):
    """Merge per-round max-path-length pow2 caps (doubling-scan step
    counts) into the persisted registry: elementwise max, monotone."""
    with _REGISTRY_LOCK:
        _registry_load()
        key = (n, padded_rounds)
        caps = _SCAN_REGISTRY.get(key)
        if caps is None or any(nd > c for nd, c in zip(needed, caps)):
            caps = (
                list(needed)
                if caps is None
                else [max(nd, c) for nd, c in zip(needed, caps)]
            )
            _SCAN_REGISTRY[key] = caps
            _registry_save()
        return caps


def _registry_bucket_caps(n: int, padded_rounds: int, needed):
    """Merge per-round per-stride-exponent path counts (stride-bucket
    layout, :mod:`tree.stride`) into the persisted registry.

    ``needed`` is a list (per round) of lists (per exponent e, stride 2^e)
    of already-granularity-padded path counts. Merge is elementwise max
    with ragged extension: monotone, so frame layouts converge to one
    static shape per (N, rounds) key.
    """
    with _REGISTRY_LOCK:
        _registry_load()
        key = (n, padded_rounds)
        caps = _BUCKET_REGISTRY.get(key)
        grew = caps is None
        if caps is None:
            caps = [list(row) for row in needed]
        else:
            caps = [list(row) for row in caps]
            while len(caps) < len(needed):
                caps.append([])
                grew = True
            for row, nd_row in zip(caps, needed):
                while len(row) < len(nd_row):
                    row.append(0)
                    grew = True
                for e, nd in enumerate(nd_row):
                    if nd > row[e]:
                        row[e] = nd
                        grew = True
        if grew:
            _BUCKET_REGISTRY[key] = [list(row) for row in caps]
            _registry_save()
        return [tuple(row) for row in caps]


def _registry_real_rounds(n: int, padded_rounds: int, needed: int) -> int:
    """Converge the number of non-dummy rounds (monotone max per layout)."""
    with _REGISTRY_LOCK:
        _registry_load()
        key = (n, padded_rounds)
        cur = _REAL_ROUNDS_REGISTRY.get(key, 0)
        if needed > cur:
            _REAL_ROUNDS_REGISTRY[key] = needed
            _registry_save()
            cur = needed
        return cur


def _registry_rounds(n: int, needed: int) -> int:
    """Converge the padded round count per tree size.

    Without this, two frames of one video whose trees straddle a
    power-of-two light-depth boundary would get plans of different static
    shape, and plans could not be stacked. The registry makes round padding
    monotone per N, like the per-round caps.
    """
    with _REGISTRY_LOCK:
        _registry_load()
        cur = _ROUNDS_REGISTRY.get(n, 0)
        if needed > cur:
            _ROUNDS_REGISTRY[n] = needed
            _registry_save()
            cur = needed
        return cur


def weight_lut(sigma: float) -> np.ndarray:
    """(256, 2) f32 LUT: column 0 the weight per distance code (must match
    ``parent_weights``), column 1 the matching ``1 - w²``. The second
    column is tabulated on the HOST because the plan emitters compute it
    as two separate f32 ops — a device-side ``1 - w*w`` may contract into
    an FMA and drift by an ulp."""
    sigma = max(0.01, float(sigma))
    w = np.exp(
        -np.arange(256, dtype=np.float64) / (255.0 * sigma)
    ).astype(np.float32)
    return np.stack([w, (1.0 - w * w).astype(np.float32)], axis=1)


def pack_ints24(ints: np.ndarray) -> np.ndarray:
    """Pack a non-negative i32 index stream (< 2²⁴) as (3, L) u8 bytes.

    Plan indices address buffers of ``total_pos + 1`` rows; even a 4K
    frame (~10.8M plan positions) stays under 2²⁴, so the top i32 byte
    is structurally zero. Packing on the host trims 25% off the per-frame
    plan upload; :func:`_unpack_ints24` reassembles on the device,
    losslessly.
    """
    if ints.max(initial=0) >= (1 << 24):
        raise ValueError("plan index stream exceeds 24-bit packing range")
    if ints.min(initial=0) < 0:
        # A negative index would wrap through uint32 into a large in-range
        # 24-bit value instead of failing — guard explicitly.
        raise ValueError("plan index stream contains negative indices")
    v = ints.astype(np.uint32)
    return np.stack(
        [v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF]
    ).astype(np.uint8)


def _unpack_ints24(packed: torch.Tensor) -> torch.Tensor:
    """(3, L) u8 -> (L,) i32."""
    b = packed.to(torch.int32)
    return b[0] | (b[1] << 8) | (b[2] << 16)


def _exact_lut(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for u8 codes and a (256, C) table.

    The JAX package computes this as a one-hot contraction, which avoids a
    gather on the TPU and is exact there; an indexed read is exact on any
    device, so the two give the same floats.
    """
    return table[idx.long()]
