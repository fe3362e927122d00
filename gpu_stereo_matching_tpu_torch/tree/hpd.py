"""Heavy-path tree aggregation, a port of the JAX package's ``tree/hpd.py``:
the heavy-path (HPD), plan-order (PO) and coded plans with their filters,
the stacking, converging and merging of plans, and what the stride-bucket
filter (``tree/stride.py``) shares with them: the persisted layout registry,
the exact weight LUT, the 24-bit index packing and the two affine scans.

The filters compute the sequential reference filter
(``STMatching/SegmentTree.cpp:148-181``) up to float summation order:

* each node's *heavy* child is the one with the largest subtree; heavy
  edges form vertex-disjoint paths, and any root-to-leaf walk crosses at
  most ⌈log₂N⌉ *light* edges, so the tree is walked in that many rounds;
* the upward recurrence ``S[v] = c[v] + Σ_child w·S[child]`` restricted to
  one heavy path is the affine recurrence ``S[i] = B[i] + A[i]·S[i+1]``,
  solved for all paths of one round at once by one affine scan; a zero A
  at every path tail stops it at the path's end;
* the downward pass ``F[v] = w·F[parent] + (1-w²)·S[v]`` is the mirrored
  forward recurrence, each path head folding in its light parent's value.

The host half (the plan builders, C++ and NumPy) is copied with the same
arithmetic. The device half is plain torch, each float operation its own
torch op in the JAX function's order, so the card and the CPU give the same
bits, and the port equals the JAX function run op by op. Two places need
care for that:

* ``jax.lax.associative_scan`` is JAX's recursive odd/even scan, not a
  doubling scan; :func:`_assoc_scan` repeats its order of operations.
* The HPD filter's light-child scatter-add repeats a parent position once
  per light child; XLA on the CPU adds them in stream order. The port adds
  them in that order too, in duplicate-free passes, one per sibling rank,
  built on the host (``HeavyPathPlan.light_slots``), so that no atomic add
  on the card can reorder them.

The registry converges every layout (HPD round caps, PO light-slot counts,
scan caps, stride buckets, the round counts) so that all frames of one
image size share one static layout. It persists to its own file,
``~/.cache/gpu_stereo_matching_tpu_torch/hpd_layouts.json``, so the two
packages' caps never mix.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.tree.builder import SegmentTree

_LAYOUT_REGISTRY: dict = {}  # (N, rounds) -> per-round (L, H, M) caps
_K_REGISTRY: dict = {}  # (N, rounds) -> per-round max light-children slots
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
                if len(parts) == 3 and parts[0] == "K":
                    _K_REGISTRY[(int(parts[1]), int(parts[2]))] = [
                        int(v) for v in caps
                    ]
                elif len(parts) == 3 and parts[0] == "S":
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
                elif len(parts) == 2:
                    _LAYOUT_REGISTRY[(int(parts[0]), int(parts[1]))] = [
                        tuple(row) for row in caps
                    ]
        except (OSError, ValueError, TypeError, AttributeError):
            pass  # corrupt cache: start fresh


def _registry_save():
    path = _registry_file()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        raw = {f"{k[0]}:{k[1]}": [list(row) for row in v]
               for k, v in _LAYOUT_REGISTRY.items()}
        raw.update(
            {f"K:{k[0]}:{k[1]}": list(v) for k, v in _K_REGISTRY.items()}
        )
        raw.update(
            {f"S:{k[0]}:{k[1]}": list(v) for k, v in _SCAN_REGISTRY.items()}
        )
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


def _registry_caps(n: int, padded_rounds: int, needed):
    """Merge per-round sizes into the persisted layout registry → caps."""
    with _REGISTRY_LOCK:
        _registry_load()
        reg_key = (n, padded_rounds)
        caps = _LAYOUT_REGISTRY.get(reg_key)
        if caps is None or any(
            any(nd > c for nd, c in zip(row, cap_row))
            for row, cap_row in zip(needed, caps)
        ):
            caps = (
                needed
                if caps is None
                else [
                    tuple(max(nd, c) for nd, c in zip(row, cap_row))
                    for row, cap_row in zip(needed, caps)
                ]
            )
            caps = [tuple(row) for row in caps]
            _LAYOUT_REGISTRY[reg_key] = caps
            _registry_save()
        return caps


def _registry_caps_k(n: int, padded_rounds: int, needed):
    """Merge per-round light-slot counts (plan-order layout) → caps."""
    with _REGISTRY_LOCK:
        _registry_load()
        key = (n, padded_rounds)
        caps = _K_REGISTRY.get(key)
        if caps is None or any(nd > c for nd, c in zip(needed, caps)):
            caps = (
                list(needed)
                if caps is None
                else [max(nd, c) for nd, c in zip(needed, caps)]
            )
            _K_REGISTRY[key] = caps
            _registry_save()
        return caps


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


def _as_tensor(v):
    """A numpy array wrapped as a tensor (no copy); anything else as is."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v))
    return v


def _wrap_arrays(plan, names) -> None:
    for name in names:
        object.__setattr__(plan, name, _as_tensor(getattr(plan, name)))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# The two affine scans
# ---------------------------------------------------------------------------


def _scan_affine(a, b, steps: int, reverse: bool):
    """Hillis–Steele affine scan along axis 0: ``b = b + a * b_shifted``,
    then ``a = a * a_shifted``, ``steps`` times (the JAX package's
    ``_seg_scan``, and the stride filter's per-bucket scan over (S, P, D)).

    The step count may stop at log₂(max segment length): a = 0 at every
    segment boundary makes the larger windows exact no-ops.
    """
    for k in range(steps):
        sh = 1 << k
        if sh >= b.shape[0]:
            break
        pad_a = torch.ones((sh,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        pad_b = torch.zeros((sh,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
        if reverse:
            a_sh = torch.cat([a[sh:], pad_a], dim=0)
            b_sh = torch.cat([b[sh:], pad_b], dim=0)
        else:
            a_sh = torch.cat([pad_a, a[:-sh]], dim=0)
            b_sh = torch.cat([pad_b, b[:-sh]], dim=0)
        b = b + a * b_sh
        a = a * a_sh
    return b


def _combine(u, v):
    """Scan combiner: apply the right (later-in-scan) affine map after the
    left: (v ∘ u)(x) = Av·(Au·x + Bu) + Bv."""
    au, bu = u
    av, bv = v
    return av * au, av * bu + bv


def _interleave(even, odd):
    """``even[0], odd[0], even[1], …`` along axis 0. JAX adds two zero-padded
    arrays to interleave, so every value leaves plus zero (a -0.0 as +0.0);
    the final ``+ 0.0`` repeats that."""
    m = odd.shape[0]
    out = torch.stack([even[:m], odd], dim=1).flatten(0, 1)
    if even.shape[0] > m:
        out = torch.cat([out, even[m:]], dim=0)
    return out + 0.0


def _assoc_scan_b(a, b):
    """The B half of ``jax.lax.associative_scan(_combine, (a, b))`` along
    axis 0 (jax 0.9.0, ``loops.py::associative_scan``): combine adjacent
    pairs, recurse on the half, combine its results with the even elements,
    prepend the first element, interleave. The scan's A outputs never feed
    its B outputs, so only the A of each pair reduction is formed."""
    n = b.shape[0]
    if n < 2:
        return b
    ra, rb = _combine((a[0:-1:2], b[0:-1:2]), (a[1::2], b[1::2]))
    odd = _assoc_scan_b(ra, rb)
    prev = odd[:-1] if n % 2 == 0 else odd
    even = a[2::2] * prev + b[2::2]
    even = torch.cat([b[0:1], even], dim=0)
    return _interleave(even, odd)


def _assoc_scan(a, b, reverse: bool = False):
    """``jax.lax.associative_scan(_combine, (a, b), reverse, axis=0)[1]`` in
    JAX's own order of float operations (see :func:`_assoc_scan_b`). With
    ``reverse`` the inputs are flipped first and the output flipped back."""
    if reverse:
        return torch.flip(_assoc_scan_b(torch.flip(a, [0]), torch.flip(b, [0])), [0])
    return _assoc_scan_b(a, b)


# ---------------------------------------------------------------------------
# Heavy-path plan and filter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Round:
    """Static per-round sizes: L path nodes, H heads, M light children."""

    num_nodes: int
    num_heads: int
    num_lights: int


_HPD_ARRAYS = ("ints", "floats", "light_slots")


@dataclasses.dataclass(frozen=True)
class HeavyPathPlan:
    """Packed heavy-path plan (see module docstring).

    ``ints`` per round: nodes(L), head_pos(H), head_parent(H),
    light_child(M), light_parent_pos(M). ``floats`` per round:
    heavy_a(L), parent_a(L), light_w(M). Rounds are unpacked with static
    slices.

    ``light_slots`` (2, S) int32 and ``slot_meta`` are the port's own,
    derived on the host from ``ints``: per round and sibling rank k, the
    light entries that are the k-th light child of their parent position,
    as (position row, entry row), so that the filter adds a position's light
    children in stream order without a duplicate index in any one pass.
    ``slot_meta`` holds the count per rank, per round.
    """

    num_nodes: int
    rounds_meta: Tuple[_Round, ...]
    ints: torch.Tensor    # int32, Σ(L + 2H + 2M)
    floats: torch.Tensor  # f32,  Σ(2L + M)
    light_slots: Optional[torch.Tensor] = None
    slot_meta: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        _wrap_arrays(self, _HPD_ARRAYS)
        if self.light_slots is None:
            slots, meta = _light_slots(
                self.num_nodes, self.rounds_meta, self.ints.cpu().numpy(),
                self.floats.cpu().numpy(),
            )
            object.__setattr__(self, "light_slots", torch.from_numpy(slots).to(self.ints.device))
            object.__setattr__(self, "slot_meta", meta)

    @staticmethod
    def from_tree(
        tree: SegmentTree, sigma: float, native: bool = True, device="cpu",
    ) -> "HeavyPathPlan":
        """Build the plan. ``native=True`` runs the C++ core
        (``gsm_hpd_plan_*``); ``native=False`` keeps the vectorized-NumPy
        construction as the bit-exact oracle. Both share the persisted
        layout registry. ``device`` is where the arrays go.
        """
        caps, ints, floats = _packed_arrays(tree, sigma, native)
        metas = tuple(_Round(int(a), int(b), int(c)) for a, b, c in caps)
        return HeavyPathPlan(
            num_nodes=tree.num_nodes, rounds_meta=metas, ints=ints, floats=floats,
        ).to(device)

    def to(self, device) -> "HeavyPathPlan":
        """The plan with every array on ``device`` (the upload)."""
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(device) for name in _HPD_ARRAYS})

    @property
    def transport_nbytes(self) -> int:
        """Bytes shipped host→device per plan."""
        return _nbytes(self.ints, self.floats, self.light_slots)


def _packed_arrays(tree: SegmentTree, sigma: float, native: bool = True):
    """Packed plan arrays as host NumPy: (caps, ints, floats)."""
    if native:
        return _packed_arrays_native(tree, sigma)
    return _packed_arrays_numpy(tree, sigma)


def _packed_arrays_native(tree: SegmentTree, sigma: float):
    import ctypes

    from gpu_stereo_matching_tpu_torch.tree.builder import _lib

    lib = _lib()
    n = tree.num_nodes
    weights = tree.parent_weights(sigma).astype(np.float32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    def p32(a):
        return np.ascontiguousarray(a, np.int32).ctypes.data_as(i32p)

    handle = ctypes.c_void_p(
        lib.gsm_hpd_plan_new(
            n, p32(tree.parent), p32(tree.level_of),
            p32(tree.subtree_size), p32(tree.bfs_order),
            weights.ctypes.data_as(f32p),
        )
    )
    try:
        n_rounds = lib.gsm_hpd_plan_rounds(handle)
        ls = np.empty(n_rounds, np.int32)
        hs = np.empty(n_rounds, np.int32)
        ms = np.empty(n_rounds, np.int32)
        lib.gsm_hpd_plan_sizes(
            handle, ls.ctypes.data_as(i32p), hs.ctypes.data_as(i32p),
            ms.ctypes.data_as(i32p),
        )
        padded_rounds = _registry_rounds(n, _pow2(n_rounds))
        needed = [
            (
                _pow2(int(ls[t]) + 1),
                _pow2(max(int(hs[t]), 1)),
                _pow2(max(int(ms[t]), 1)),
            )
            if t < n_rounds
            else (1, 1, 1)
            for t in range(padded_rounds)
        ]
        caps = _registry_caps(n, padded_rounds, needed)
        caps_l = np.array([c[0] for c in caps], np.int32)
        caps_h = np.array([c[1] for c in caps], np.int32)
        caps_m = np.array([c[2] for c in caps], np.int32)
        ints = np.empty(int(np.sum(caps_l + 2 * caps_h + 2 * caps_m)),
                        np.int32)
        floats = np.empty(int(np.sum(2 * caps_l + caps_m)), np.float32)
        lib.gsm_hpd_plan_fill(
            handle, padded_rounds,
            caps_l.ctypes.data_as(i32p), caps_h.ctypes.data_as(i32p),
            caps_m.ctypes.data_as(i32p),
            ints.ctypes.data_as(i32p), floats.ctypes.data_as(f32p),
        )
    finally:
        lib.gsm_hpd_plan_free(handle)
    return caps, ints, floats


def _packed_arrays_numpy(tree: SegmentTree, sigma: float):
    n = tree.num_nodes
    parent = tree.parent.astype(np.int64)
    weights = tree.parent_weights(sigma).astype(np.float32)
    sub = tree.subtree_size

    # Heavy child per node: child with max subtree size (ties: lowest
    # id), via sorting children by (parent, size desc, id asc).
    heavy = np.full(n, -1, np.int64)
    ch = np.arange(n)
    ch = ch[ch != 0]
    order = np.lexsort((ch, -sub[ch], parent[ch]))
    ch_sorted = ch[order]
    par_sorted = parent[ch_sorted]
    first = np.ones(len(ch_sorted), bool)
    first[1:] = par_sorted[1:] != par_sorted[:-1]
    heavy[par_sorted[first]] = ch_sorted[first]

    is_heavy_child = np.zeros(n, bool)
    is_heavy_child[heavy[heavy >= 0]] = True

    # Light depth (light edges on the root path) and path head per node,
    # by pointer doubling: O(log depth) vectorized rounds.
    light = ~is_heavy_child
    light[0] = False  # the root has no parent edge
    light_depth64 = light.astype(np.int64)
    jump = parent.copy()
    # head pointer: fixed point at path heads (light nodes and the root)
    head_ptr = np.where(light | (np.arange(n) == 0), np.arange(n), parent)
    max_depth = int(tree.num_levels)
    rounds = max(1, int(np.ceil(np.log2(max(max_depth, 2)))))
    for _ in range(rounds):
        light_depth64 = light_depth64 + light_depth64[jump]
        jump = jump[jump]
        head_ptr = head_ptr[head_ptr]
    light_depth = light_depth64.astype(np.int32)
    head_of = head_ptr.astype(np.int64)

    # Concatenated layout: sort all nodes by (round, path head, depth);
    # every path is contiguous head→tail inside its round block.
    depth = tree.level_of.astype(np.int64)
    order_all = np.lexsort((depth, head_of, light_depth))
    sorted_nodes = order_all
    sorted_round = light_depth[sorted_nodes]
    is_head_all = sorted_nodes == head_of[sorted_nodes]
    n_rounds = int(light_depth.max()) + 1
    round_starts = np.searchsorted(sorted_round, np.arange(n_rounds + 1))

    pos_of = np.empty(n, np.int64)
    pos_of[sorted_nodes] = np.arange(n) - round_starts[sorted_round]

    all_lights = np.arange(n)[(~is_heavy_child) & (np.arange(n) != 0)]
    light_round = light_depth[parent[all_lights]]
    light_order = np.argsort(light_round, kind="stable")
    lights_sorted = all_lights[light_order]
    light_starts = np.searchsorted(
        light_round[light_order], np.arange(n_rounds + 1)
    )

    # Pad every per-round size up to a power of two and the round count
    # to a power of two, then fit the result into the layout registry
    # (elementwise max, keyed by image size), so that the static layout
    # converges to one shape across frames. Padding is inert: dummy path
    # nodes have A=0 and write into the scratch slot N; dummy light/head
    # entries carry zero weights and point at the padded tail.
    padded_rounds = _registry_rounds(n, _pow2(n_rounds))
    needed = []
    per_round_data = []
    for t in range(padded_rounds):
        if t < n_rounds:
            s, e = round_starts[t], round_starts[t + 1]
            concat = sorted_nodes[s:e]
            is_head = is_head_all[s:e]
            lc = lights_sorted[light_starts[t] : light_starts[t + 1]]
        else:
            concat = np.zeros(0, np.int64)
            is_head = np.zeros(0, bool)
            lc = np.zeros(0, np.int64)
        per_round_data.append((concat, is_head, lc))
        needed.append(
            (_pow2(len(concat) + 1), _pow2(max(len(np.where(is_head)[0]), 1)),
             _pow2(max(len(lc), 1)))
        )

    caps = _registry_caps(n, padded_rounds, needed)

    ints_parts, float_parts = [], []
    for t in range(padded_rounds):
        concat, is_head, lc = per_round_data[t]
        l_pad, h_pad, m_pad = caps[t]

        hv = heavy[concat]
        heavy_a = np.where(hv >= 0, weights[np.maximum(hv, 0)], 0.0)
        parent_a = weights[concat].copy()
        parent_a[concat == 0] = 0.0
        head_pos = np.where(is_head)[0]
        head_nodes = concat[head_pos]
        head_parent = np.where(head_nodes == 0, n, parent[head_nodes])
        light_parent_pos = pos_of[parent[lc]]

        pad_l = l_pad - len(concat)
        concat = np.concatenate([concat, np.full(pad_l, n)])
        heavy_a = np.concatenate([heavy_a, np.zeros(pad_l)])
        parent_a = np.concatenate([parent_a, np.zeros(pad_l)])
        # Dummy heads/lights target the padded tail of this round.
        dummy_pos = l_pad - 1
        pad_h = h_pad - len(head_pos)
        head_pos = np.concatenate([head_pos, np.full(pad_h, dummy_pos)])
        head_parent = np.concatenate([head_parent, np.full(pad_h, n)])
        pad_m = m_pad - len(lc)
        lc = np.concatenate([lc, np.full(pad_m, n)])
        light_parent_pos = np.concatenate(
            [light_parent_pos, np.full(pad_m, dummy_pos)]
        )
        light_w = np.concatenate([weights[lc[: m_pad - pad_m].astype(np.int64)],
                                  np.zeros(pad_m)])

        ints_parts += [concat, head_pos, head_parent, lc, light_parent_pos]
        float_parts += [heavy_a, parent_a, light_w]

    ints = np.concatenate(ints_parts) if ints_parts else np.zeros(0)
    floats = np.concatenate(float_parts) if float_parts else np.zeros(0)
    return caps, ints.astype(np.int32), floats.astype(np.float32)


def _occurrence_rank(keys: np.ndarray) -> np.ndarray:
    """Per entry, how many earlier entries carry the same key."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    newgrp = np.ones(len(ks), bool)
    newgrp[1:] = ks[1:] != ks[:-1]
    grp_start = np.maximum.accumulate(np.where(newgrp, np.arange(len(ks)), 0))
    rank = np.empty(len(ks), np.int64)
    rank[order] = np.arange(len(ks)) - grp_start
    return rank


def _light_slots(n: int, rounds_meta, ints: np.ndarray, floats: np.ndarray):
    """Host side: the duplicate-free light passes of an HPD plan (see
    :class:`HeavyPathPlan`) → ((2, S) int32 [position; entry], per round the
    entry count per sibling rank).

    Checks what lets the filter leave the padding out of its scatters: a
    repeated head position or a dummy light entry (child N) is the round's
    padded tail row L−1, which holds node N, with zero weight. There the
    JAX filter only adds and writes +0.0 (a padded row's costs, scans and
    weights are all zero), so leaving the dummies out, or letting identical
    +0.0 writes race, gives its bits.
    """
    parts, meta = [], []
    io = fo = 0
    for m in rounds_meta:
        l, h, k = m.num_nodes, m.num_heads, m.num_lights
        nodes = ints[io : io + l]
        head_pos = ints[io + l : io + l + h]
        head_parent = ints[io + l + h : io + l + 2 * h]
        lc = ints[io + l + 2 * h : io + l + 2 * h + k]
        lpp = ints[io + l + 2 * h + k : io + l + 2 * h + 2 * k]
        io += l + 2 * h + 2 * k
        parent_a = floats[fo + l : fo + 2 * l]
        light_w = floats[fo + 2 * l : fo + 2 * l + k]
        fo += 2 * l + k
        dummy = lc == n
        dup_head = _occurrence_rank(head_pos.astype(np.int64)) > 0
        tail_ok = l > 0 and nodes[l - 1] == n and parent_a[l - 1] == 0.0
        if (dummy.any() or dup_head.any()) and not tail_ok:
            raise AssertionError("HPD plan padding does not point at a padded tail row")
        if not (np.all(lpp[dummy] == l - 1) and np.all(light_w[dummy] == 0.0)):
            raise AssertionError("dummy light entry off the padded tail or weighted")
        dup_pos = np.isin(head_pos, head_pos[dup_head])
        if not (np.all(head_pos[dup_pos] == l - 1) and np.all(head_parent[dup_pos] == n)):
            raise AssertionError("repeated head position off the padded tail")
        ent = np.flatnonzero(~dummy)
        rank = _occurrence_rank(lpp[ent].astype(np.int64))
        order = np.lexsort((ent, rank))
        parts.append(np.stack([lpp[ent[order]], ent[order]]))
        meta.append(tuple(int(c) for c in np.bincount(rank, minlength=0)))
    slots = (np.concatenate(parts, axis=1) if parts else np.zeros((2, 0))).astype(np.int32)
    return slots, tuple(meta)


def _unpack_rounds(plan: HeavyPathPlan):
    """Per-round static-slice views of the packed arrays."""
    rounds = []
    io = fo = 0
    for m in plan.rounds_meta:
        l, h, k = m.num_nodes, m.num_heads, m.num_lights
        nodes = plan.ints[io : io + l]
        head_pos = plan.ints[io + l : io + l + h]
        head_parent = plan.ints[io + l + h : io + l + 2 * h]
        light_child = plan.ints[io + l + 2 * h : io + l + 2 * h + k]
        light_parent_pos = plan.ints[io + l + 2 * h + k : io + l + 2 * h + 2 * k]
        io += l + 2 * h + 2 * k
        heavy_a = plan.floats[fo : fo + l]
        parent_a = plan.floats[fo + l : fo + 2 * l]
        light_w = plan.floats[fo + 2 * l : fo + 2 * l + k]
        fo += 2 * l + k
        rounds.append(
            (nodes, heavy_a, parent_a, head_pos, head_parent,
             light_child, light_w, light_parent_pos)
        )
    return rounds


def _unpack_slots(plan: HeavyPathPlan):
    """Per round, per sibling rank: (position rows, entry rows) views."""
    out, so = [], 0
    for counts in plan.slot_meta:
        passes = []
        for c in counts:
            passes.append((plan.light_slots[0, so : so + c], plan.light_slots[1, so : so + c]))
            so += c
        out.append(passes)
    return out


def tree_filter_nodes_hpd(cost_nodes: torch.Tensor, plan: HeavyPathPlan) -> torch.Tensor:
    """Exact non-local aggregation of (N, D) costs via heavy-path scans, on
    the plan's device.

    ``b.at[light_parent_pos].add(...)`` of the JAX function becomes one
    duplicate-free pass per sibling rank, in the order XLA adds them on the
    CPU; ``.at[nodes].set`` and ``.at[head_pos].add`` repeat only the padded
    tail, whose values are all +0.0 (:func:`_light_slots`).
    """
    n = plan.num_nodes
    d = cost_nodes.shape[1]
    dt, dev = cost_nodes.dtype, cost_nodes.device
    cost_ext = torch.cat([cost_nodes, torch.zeros((1, d), dtype=dt, device=dev)], dim=0)
    rounds = _unpack_rounds(plan)
    slots = _unpack_slots(plan)

    s_buf = torch.zeros((n + 1, d), dtype=dt, device=dev)
    # Upward: deepest light-round first.
    for t in reversed(range(len(rounds))):
        (nodes, heavy_a, _pa, _hp, _hpar, light_child, light_w,
         _lpp) = rounds[t]
        if nodes.shape[0] == 0:
            continue
        b = cost_ext[nodes]
        if light_child.shape[0]:
            contrib = light_w[:, None] * s_buf[light_child]
            for pos, ent in slots[t]:
                b[pos] = b[pos] + contrib[ent]
        # S[i] = B[i] + A[i]·S[i+1] → suffix composition f_i∘f_{i+1}∘…
        s_buf[nodes] = _assoc_scan(heavy_a[:, None], b, reverse=True)

    f_buf = torch.zeros((n + 1, d), dtype=dt, device=dev)
    # Downward: root round first.
    for (nodes, _ha, parent_a, head_pos, head_parent, _lc, _lw,
         _lpp) in rounds:
        if nodes.shape[0] == 0:
            continue
        l = nodes.shape[0]
        is_head = torch.zeros((l,), dtype=torch.bool, device=dev)
        is_head[head_pos] = True
        w = parent_a[:, None]
        b = (1.0 - w * w) * s_buf[nodes]
        if head_pos.shape[0]:
            b[head_pos] = b[head_pos] + parent_a[head_pos][:, None] * f_buf[head_parent]
        a = torch.where(is_head[:, None], 0.0, w)
        # F[i] = A[i]·F[i-1] + B[i] → prefix composition …∘f_{i-1}∘f_i.
        f_buf[nodes] = _assoc_scan(a, b)

    return f_buf[:n]


# ---------------------------------------------------------------------------
# Plan-order (scatter-free) formulation
# ---------------------------------------------------------------------------


_PO_ARRAYS = ("ints", "floats")


@dataclasses.dataclass(frozen=True)
class PlanOrderPlan:
    """Scatter-free heavy-path plan.

    All per-round state lives in **plan order**, the concatenation of the
    rounds' path-node blocks, so the filter needs one permutation gather
    in, a slice write per round, per-round light/head *gathers* (pulls from
    already-written plan positions), and one gather out: no scatter, so the
    filter batches over a leading frame axis (:func:`tree_filter_nodes_po_batched`).

    Light children are laid out as K dense per-position slots per round
    (K = max light children of any path node in that round, ≤ 4 by the
    grid degree); slot k of position i holds the plan position of i's k-th
    light child (dummy = P, the always-zero row) and its edge weight.

    ``ints``: per round ``[head_src(L), light_src(K·L)]``, then
    ``perm(P)``, then ``inv_perm(N)``. ``floats``: per round
    ``[heavy_a(L), down_a(L), one_minus_w2(L), head_w(L), light_w(K·L)]``.
    A stacked plan has a leading batch axis on both arrays.
    """

    num_nodes: int
    total_pos: int
    rounds_meta: Tuple[Tuple[int, int], ...]  # (L, K) per round
    ints: torch.Tensor
    floats: torch.Tensor

    def __post_init__(self):
        _wrap_arrays(self, _PO_ARRAYS)

    @staticmethod
    def from_tree(
        tree: SegmentTree, sigma: float, native: bool = True, device="cpu",
    ) -> "PlanOrderPlan":
        """Build the plan. ``native=True`` emits the plan-order buffers
        directly from the C++ plan core (``gsm_po_plan_*``); ``native=False``
        keeps the two-step NumPy construction as the bit-exact oracle.
        ``device`` is where the arrays go (:func:`merge_plans` and
        :func:`code_plan` take host plans)."""
        if native:
            plan = _plan_order_native(tree, sigma)
        else:
            caps, ints, floats = _packed_arrays(tree, sigma, native=False)
            plan = _plan_order_from_packed(tree.num_nodes, caps, ints, floats)
        return plan.to(device)

    def to(self, device) -> "PlanOrderPlan":
        """The plan with every array on ``device`` (the upload)."""
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(device) for name in _PO_ARRAYS})

    def frame(self, g: int) -> "PlanOrderPlan":
        """Frame ``g``'s plan of a stacked plan."""
        return PlanOrderPlan(self.num_nodes, self.total_pos, self.rounds_meta,
                             self.ints[g], self.floats[g])

    @property
    def transport_nbytes(self) -> int:
        """Bytes shipped host→device per plan."""
        return _nbytes(self.ints, self.floats)


def _plan_order_from_packed(
    n: int, caps, ints: np.ndarray, floats: np.ndarray
) -> PlanOrderPlan:
    """Host-side conversion of the packed per-round plan into plan order."""
    total = int(sum(c[0] for c in caps))
    pos_all = np.full(n + 1, total, np.int64)  # node id -> plan position
    rounds_raw = []
    io = fo = 0
    off = 0
    for (l, h, m) in caps:
        nodes = ints[io : io + l].astype(np.int64)
        head_pos = ints[io + l : io + l + h].astype(np.int64)
        head_parent = ints[io + l + h : io + l + 2 * h].astype(np.int64)
        lc = ints[io + l + 2 * h : io + l + 2 * h + m].astype(np.int64)
        lpp = ints[io + l + 2 * h + m : io + l + 2 * h + 2 * m].astype(np.int64)
        io += l + 2 * h + 2 * m
        heavy_a = floats[fo : fo + l]
        parent_a = floats[fo + l : fo + 2 * l]
        light_w = floats[fo + 2 * l : fo + 2 * l + m]
        fo += 2 * l + m
        real = nodes != n
        pos_all[nodes[real]] = off + np.where(real)[0]
        rounds_raw.append(
            (l, nodes, head_pos, head_parent, lc, lpp, heavy_a, parent_a,
             light_w)
        )
        off += l
    pos_all[n] = total

    # Slot assignment: sort valid light entries by parent position; the
    # occurrence rank within each equal-position run is the slot index.
    needed_k, grouped = [], []
    for (_l, _nodes, _hp, _hpar, lc, lpp, _ha, _pa, lw) in rounds_raw:
        valid = lc != n
        order = np.argsort(lpp[valid], kind="stable")
        lpp_s = lpp[valid][order]
        lc_s = lc[valid][order]
        lw_s = lw[valid][order]
        if len(lpp_s):
            newgrp = np.ones(len(lpp_s), bool)
            newgrp[1:] = lpp_s[1:] != lpp_s[:-1]
            grp_start = np.maximum.accumulate(
                np.where(newgrp, np.arange(len(lpp_s)), 0)
            )
            rank = np.arange(len(lpp_s)) - grp_start
            k_need = int(rank.max()) + 1
        else:
            rank = np.zeros(0, np.int64)
            k_need = 0
        needed_k.append(k_need)
        grouped.append((lpp_s, lc_s, lw_s, rank))

    k_caps = _registry_caps_k(n, len(caps), needed_k)

    metas, perm_parts, ints_parts, float_parts = [], [], [], []
    for (l, nodes, head_pos, head_parent, _lc, _lpp, heavy_a, parent_a,
         _lw), (lpp_s, lc_s, lw_s, rank), kk in zip(rounds_raw, grouped,
                                                    k_caps):
        down_a = parent_a.copy()
        down_a[head_pos] = 0.0  # heads break the in-path recurrence
        omw2 = 1.0 - parent_a * parent_a
        head_src = np.full(l, total, np.int64)
        head_w = np.zeros(l, np.float32)
        # Padded head entries point at the round's dummy tail with
        # parent_a == 0, so these writes are inert there.
        head_src[head_pos] = pos_all[head_parent]
        head_w[head_pos] = parent_a[head_pos]
        light_src = np.full((kk, l), total, np.int64)
        light_sw = np.zeros((kk, l), np.float32)
        if len(lpp_s):
            light_src[rank, lpp_s] = pos_all[lc_s]
            light_sw[rank, lpp_s] = lw_s
        metas.append((int(l), int(kk)))
        perm_parts.append(nodes)
        ints_parts += [head_src, light_src.reshape(-1)]
        float_parts += [heavy_a, down_a, omw2, head_w, light_sw.reshape(-1)]

    perm = np.concatenate(perm_parts)
    inv_perm = pos_all[:n]
    ints_po = np.concatenate(ints_parts + [perm, inv_perm]).astype(np.int32)
    floats_po = (
        np.concatenate(float_parts).astype(np.float32)
        if float_parts else np.zeros(0, np.float32)
    )
    return PlanOrderPlan(
        num_nodes=n, total_pos=total, rounds_meta=tuple(metas),
        ints=ints_po, floats=floats_po,
    )


def _plan_order_native(tree: SegmentTree, sigma: float) -> PlanOrderPlan:
    """One-shot C++ plan-order emission (host arrays; see gsm_po_plan_*)."""
    import ctypes

    from gpu_stereo_matching_tpu_torch.tree.builder import _lib

    lib = _lib()
    n = tree.num_nodes
    weights = tree.parent_weights(sigma).astype(np.float32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    def p32(a):
        return np.ascontiguousarray(a, np.int32).ctypes.data_as(i32p)

    handle = ctypes.c_void_p(
        lib.gsm_hpd_plan_new(
            n, p32(tree.parent), p32(tree.level_of),
            p32(tree.subtree_size), p32(tree.bfs_order),
            weights.ctypes.data_as(f32p),
        )
    )
    try:
        n_rounds = lib.gsm_hpd_plan_rounds(handle)
        ls = np.empty(n_rounds, np.int32)
        hs = np.empty(n_rounds, np.int32)
        ms = np.empty(n_rounds, np.int32)
        lib.gsm_hpd_plan_sizes(
            handle, ls.ctypes.data_as(i32p), hs.ctypes.data_as(i32p),
            ms.ctypes.data_as(i32p),
        )
        padded_rounds = _registry_rounds(n, _pow2(n_rounds))
        needed = [
            (
                _pow2(int(ls[t]) + 1),
                _pow2(max(int(hs[t]), 1)),
                _pow2(max(int(ms[t]), 1)),
            )
            if t < n_rounds
            else (1, 1, 1)
            for t in range(padded_rounds)
        ]
        caps = _registry_caps(n, padded_rounds, needed)

        k_raw = np.zeros(max(n_rounds, 1), np.int32)
        lib.gsm_po_plan_k(handle, k_raw.ctypes.data_as(i32p))
        needed_k = [
            int(k_raw[t]) if t < n_rounds else 0 for t in range(padded_rounds)
        ]
        k_caps = _registry_caps_k(n, padded_rounds, needed_k)

        caps_l = np.array([c[0] for c in caps], np.int32)
        k_arr = np.array(k_caps, np.int32)
        total = int(caps_l.sum())
        ints = np.empty(
            int(np.sum(caps_l + k_arr * caps_l)) + total + n, np.int32
        )
        floats = np.empty(int(np.sum(4 * caps_l + k_arr * caps_l)), np.float32)
        lib.gsm_po_plan_fill(
            handle, padded_rounds,
            caps_l.ctypes.data_as(i32p), k_arr.ctypes.data_as(i32p),
            ints.ctypes.data_as(i32p), floats.ctypes.data_as(f32p),
        )
    finally:
        lib.gsm_hpd_plan_free(handle)
    metas = tuple((int(l), int(k)) for l, k in zip(caps_l, k_arr))
    return PlanOrderPlan(
        num_nodes=n, total_pos=total, rounds_meta=metas,
        ints=ints, floats=floats,
    )


def _unpack_po(plan: PlanOrderPlan):
    """Per-round static-slice views + (perm, inv_perm, offsets), along the
    last axis (a stacked plan keeps its leading batch axis)."""
    rounds, offs = [], []
    io = fo = 0
    off = 0
    for (l, k) in plan.rounds_meta:
        head_src = plan.ints[..., io : io + l]
        light_src = plan.ints[..., io + l : io + l + k * l].unflatten(-1, (k, l))
        io += l + k * l
        heavy_a = plan.floats[..., fo : fo + l]
        down_a = plan.floats[..., fo + l : fo + 2 * l]
        omw2 = plan.floats[..., fo + 2 * l : fo + 3 * l]
        head_w = plan.floats[..., fo + 3 * l : fo + 4 * l]
        light_w = plan.floats[..., fo + 4 * l : fo + 4 * l + k * l].unflatten(-1, (k, l))
        fo += 4 * l + k * l
        rounds.append((head_src, light_src, heavy_a, down_a, omw2, head_w,
                       light_w))
        offs.append(off)
        off += l
    perm = plan.ints[..., io : io + plan.total_pos]
    inv_perm = plan.ints[..., io + plan.total_pos : io + plan.total_pos
                         + plan.num_nodes]
    return rounds, offs, perm, inv_perm


def _po_filter(cost_b: torch.Tensor, plan: PlanOrderPlan) -> torch.Tensor:
    """The plan-order filter over a leading frame axis: (B, N, D) costs and
    a plan whose arrays are (B, ·) → (B, N, D).

    State is kept position-major, (P, B, D), so each round's scans run along
    axis 0 as in the single-frame filter and every gather covers the whole
    group; each element sees the JAX function's float operations in its
    order, so a frame's result does not depend on the batch.
    """
    bsz, _n, d = cost_b.shape
    dt, dev = cost_b.dtype, cost_b.device
    total = plan.total_pos
    bi = torch.arange(bsz, device=dev)
    cost_ext = torch.cat([cost_b, torch.zeros((bsz, 1, d), dtype=dt, device=dev)], dim=1)
    rounds, offs, perm, inv_perm = _unpack_po(plan)
    cost_plan = cost_ext[bi, perm.T]  # the one gather in, (P, B, D)

    def col(x):  # (B, L) per-position weights → (L, B, 1)
        return x.T[:, :, None]

    s_buf = torch.zeros((total + 1, bsz, d), dtype=dt, device=dev)
    # Upward: deepest light-round first; light children pull from rounds
    # already written.
    for off, (l, kk), (
        _hs, light_src, heavy_a, _da, _o, _hw, light_w
    ) in reversed(list(zip(offs, plan.rounds_meta, rounds))):
        b = cost_plan[off : off + l]
        for k in range(kk):
            b = b + col(light_w[:, k]) * s_buf[light_src[:, k].T, bi]
        s_buf[off : off + l] = _assoc_scan(col(heavy_a), b, reverse=True)

    f_buf = torch.zeros((total + 1, bsz, d), dtype=dt, device=dev)
    # Downward: root round first; heads pull their parent's final value.
    for off, (l, _kk), (
        head_src, _ls, _ha, down_a, omw2, head_w, _lw
    ) in zip(offs, plan.rounds_meta, rounds):
        s_t = s_buf[off : off + l]
        b = col(omw2) * s_t + col(head_w) * f_buf[head_src.T, bi]
        f_buf[off : off + l] = _assoc_scan(col(down_a), b)

    return f_buf[inv_perm.T, bi].transpose(0, 1)


def tree_filter_nodes_po(
    cost_nodes: torch.Tensor, plan: PlanOrderPlan
) -> torch.Tensor:
    """Exact non-local aggregation of (N, D) costs, scatter-free, on the
    plan's device."""
    one = PlanOrderPlan(plan.num_nodes, plan.total_pos, plan.rounds_meta,
                        plan.ints[None], plan.floats[None])
    return _po_filter(cost_nodes[None], one)[0]


# ---------------------------------------------------------------------------
# Coded plan: the float payload of a PlanOrderPlan compressed to two u8
# streams. Every float field the filter consumes derives from the per-plan-
# position parent edge weight w[i] = exp(-dist/(255σ)) plus an is-head bit
# (the reference's weight LUT, ``STMatching/SegmentTree.cpp:141-146``):
#
#     down_a[i]  = is_head[i] ? 0 : w[i]
#     heavy_a[i] = down_a[i+1]            (next-in-path parent weight)
#     omw2[i]    = 1 - w[i]²
#     head_w[i]  = is_head[i] ? w[i] : 0
#     light_w[k][i] = w[light_src[k][i]]  (the child's own parent weight)
#
# so instead of 4·total + K·total f32 per frame the plan carries one u8
# distance code and one u8 flag per position, reconstructed on the device
# through an exact 256-entry LUT. The light weights never materialize: the
# upward pass writes w·s rows alongside s, and the light gather pulls from
# that premultiplied buffer, the same two f32 operands multiplied in the
# same order, so results stay bit-identical to :func:`tree_filter_nodes_po`.
# ---------------------------------------------------------------------------


_CODED_ARRAYS = ("ints", "codes", "table")


@dataclasses.dataclass(frozen=True)
class CodedPlan:
    """Plan-order plan with u8-coded float payload.

    ``ints`` carries the same index stream as :class:`PlanOrderPlan`,
    packed 24-bit little-endian as a ``(3, L)`` u8 array (every index is
    a buffer position ≤ ``total_pos`` < 2²⁴ even at 4K); a plain ``(L,)``
    i32 stream is also accepted. ``codes`` is ``(2, total)`` u8: row 0 the
    parent-distance code per plan position, row 1 flags (bit0 = is_head,
    bit1 = force-zero weight — root and padding rows). ``table`` is the
    shared 256-entry f32 weight LUT for the plan's σ. A stacked plan has a
    leading batch axis on ``ints`` and ``codes``.
    """

    num_nodes: int
    total_pos: int
    rounds_meta: Tuple[Tuple[int, int], ...]
    ints: torch.Tensor
    codes: torch.Tensor
    table: torch.Tensor
    # Registry-converged static schedule: per-round doubling-scan step
    # count (= log2 of the pow2-capped max path length) and the number of
    # leading rounds that can contain real nodes (the padded tail is
    # skipped by the filter — dummy scans are exact no-ops).
    scan_steps: Tuple[int, ...] = ()
    n_real: int = -1

    def __post_init__(self):
        _wrap_arrays(self, _CODED_ARRAYS)

    @property
    def layout_key(self):
        return (
            self.num_nodes, self.total_pos, self.rounds_meta,
            self.scan_steps, self.n_real,
        )

    @staticmethod
    def from_tree(
        tree: SegmentTree, sigma: float, native: bool = True, device="cpu",
    ) -> "CodedPlan":
        plan = PlanOrderPlan.from_tree(tree, sigma, native=native)
        return code_plan(plan, tree, sigma, device=device)

    def to(self, device) -> "CodedPlan":
        """The plan with every array on ``device`` (the upload)."""
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(device) for name in _CODED_ARRAYS})

    def frame(self, g: int) -> "CodedPlan":
        """Frame ``g``'s plan of a stacked plan (``table`` is shared)."""
        return dataclasses.replace(self, ints=self.ints[g], codes=self.codes[g])

    @property
    def transport_nbytes(self) -> int:
        """Bytes shipped host→device per plan (the shared table aside)."""
        return _nbytes(self.ints, self.codes)


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


def code_plan(
    plan: PlanOrderPlan, tree: SegmentTree, sigma: float, device="cpu"
) -> CodedPlan:
    """Derive the u8 code streams from a host-side plan; the coded plan's
    arrays go to ``device``.

    ``is_head`` falls out of ``down_a == 0``: real-node weights are always
    nonzero f32 (exp(-d/(255σ)) with d ≤ 255, σ ≥ 0.01 stays above the f32
    subnormal floor), so a zero down_a means head or padding.
    """
    if plan.ints.device.type != "cpu":
        raise TypeError("code_plan needs a host-side plan (on the CPU)")
    ints_np, floats_np = plan.ints.numpy(), plan.floats.numpy()
    n, total = plan.num_nodes, plan.total_pos
    io = sum(l + k * l for (l, k) in plan.rounds_meta)
    perm = ints_np[io : io + total]
    down_a = np.concatenate(
        [
            floats_np[fo + l : fo + 2 * l]
            for fo, l in _float_round_offsets(plan.rounds_meta)
        ]
    )
    pad = perm == n
    pd = np.where(pad, 0, tree.parent_dist[np.minimum(perm, n - 1)])
    is_head = (down_a == 0.0) & ~pad
    zero_w = pad | (perm == 0)
    codes = np.stack(
        [pd.astype(np.uint8), (is_head + 2 * zero_w).astype(np.uint8)]
    )
    table = weight_lut(sigma)

    # Static doubling-scan schedule: per round the pow2 cap on the longest
    # path (boundaries are down_a == 0 rows: heads and padding), converged
    # through the registry so frames of one video share one layout.
    boundary = is_head | pad
    need_caps, need_real = [], 0
    off = 0
    for t, (l, _k) in enumerate(plan.rounds_meta):
        sl = boundary[off : off + l]
        real = ~pad[off : off + l]
        if real.any():
            need_real = t + 1
        starts = np.flatnonzero(sl)
        if len(starts) == 0:
            need_caps.append(1)
        else:
            runs = np.diff(np.append(starts, l))
            need_caps.append(_pow2(int(runs.max())))
        off += l
    caps = _registry_scan_caps(n, len(plan.rounds_meta), need_caps)
    n_real = _registry_real_rounds(n, len(plan.rounds_meta), need_real)
    steps = tuple(int(np.log2(c)) for c in caps)

    # Indices are bounded by total (the dummy row), so 24-bit packing is
    # lossless whenever the plan fits, which it does for any frame size
    # this framework targets (4K ≈ 10.8M positions < 2²⁴). Beyond that,
    # fail loudly: callers that outgrow 24 bits should use PlanOrderPlan.
    if total >= (1 << 24):
        raise ValueError(
            f"plan has {total} positions (>= 2^24); coded plans pack "
            "indices as 24-bit u8 triples — use PlanOrderPlan for frames "
            "this large"
        )
    ints = pack_ints24(ints_np)
    return CodedPlan(
        n, total, plan.rounds_meta, ints, codes, table, steps, n_real
    ).to(device)


def _float_round_offsets(rounds_meta):
    fo = 0
    for (l, k) in rounds_meta:
        yield fo, l
        fo += 4 * l + k * l


def _unpack_po_ints(ints, rounds_meta, total, n):
    """Per-round (head_src, light_src) views + (perm, inv_perm, offsets)."""
    rounds, offs = [], []
    io = 0
    off = 0
    for (l, k) in rounds_meta:
        head_src = ints[io : io + l]
        light_src = ints[io + l : io + l + k * l].reshape(k, l)
        io += l + k * l
        rounds.append((head_src, light_src))
        offs.append(off)
        off += l
    perm = ints[io : io + total]
    inv_perm = ints[io + total : io + total + n]
    return rounds, offs, perm, inv_perm


def _exact_lut(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for u8 codes and a (256, C) table.

    The JAX package computes this as a one-hot contraction, which avoids a
    gather on the TPU and is exact there; an indexed read is exact on any
    device, so the two give the same floats.
    """
    return table[idx.long()]


def _reconstruct_po_fields(codes: torch.Tensor, table: torch.Tensor):
    """(w, heavy_a, down_a, omw2, head_w) per plan position from codes."""
    pd = codes[0]
    flags = codes[1].to(torch.int32)
    vals = _exact_lut(pd, table)
    zero = (flags & 2) != 0
    w = torch.where(zero, torch.zeros_like(vals[:, 0]), vals[:, 0])
    omw2 = torch.where(zero, torch.ones_like(vals[:, 1]), vals[:, 1])
    is_head = (flags & 1) != 0
    down_a = torch.where(is_head, torch.zeros_like(w), w)
    heavy_a = torch.cat([down_a[1:], torch.zeros((1,), dtype=w.dtype, device=w.device)])
    head_w = torch.where(is_head, w, torch.zeros_like(w))
    return w, heavy_a, down_a, omw2, head_w


def tree_filter_nodes_po_coded(
    cost_nodes: torch.Tensor, plan: CodedPlan, assoc_scan: bool = False,
    reduce: str = "none",
) -> torch.Tensor:
    """Exact (N, D) aggregation from a coded plan, on the plan's device.

    With ``assoc_scan=True`` the per-round scans are JAX's associative scan
    (:func:`_assoc_scan`) and the result is bit-identical to
    :func:`tree_filter_nodes_po` on the equivalent uncoded plan. The
    default uses :func:`_scan_affine` doubling with the plan's static
    per-round step caps; summation order inside a path differs, so results
    match the oracle to float tolerance rather than bitwise.

    ``reduce="argmin"`` fuses WTA (ties → lowest d, as
    ``ops.wta.wta_disparity``) before the inverse permutation and
    returns (N,) int32 disparities.
    """
    d = cost_nodes.shape[1]
    dt, dev = cost_nodes.dtype, cost_nodes.device
    total = plan.total_pos
    cost_ext = torch.cat([cost_nodes, torch.zeros((1, d), dtype=dt, device=dev)], dim=0)
    ints = plan.ints
    if ints.dim() == 2 and ints.dtype == torch.uint8:
        # 24-bit packed (3, L) u8 stream; the dtype check keeps a stacked
        # unpacked i32 plan from being misread as packed bytes.
        ints = _unpack_ints24(ints)
    elif ints.dim() != 1:
        raise ValueError(
            f"CodedPlan.ints must be (L,) i32 or (3, L) u8; got "
            f"{tuple(ints.shape)} {ints.dtype}"
        )
    rounds, offs, perm, inv_perm = _unpack_po_ints(
        ints, plan.rounds_meta, total, plan.num_nodes
    )
    w, heavy_a, down_a, omw2, head_w = _reconstruct_po_fields(
        plan.codes, plan.table
    )
    cost_plan = cost_ext[perm]

    n_real = plan.n_real if plan.n_real >= 0 else len(plan.rounds_meta)
    steps = plan.scan_steps or tuple(
        int(np.ceil(np.log2(max(l, 1)))) for (l, _k) in plan.rounds_meta
    )
    live = list(zip(offs, plan.rounds_meta, rounds, steps))[:n_real]

    s_buf = torch.zeros((total + 1, d), dtype=dt, device=dev)
    ws_buf = torch.zeros((total + 1, d), dtype=dt, device=dev)  # w[i]·s[i] rows
    for off, (l, _kk), (_hs, light_src), st in reversed(live):
        b = cost_plan[off : off + l]
        for k in range(light_src.shape[0]):
            b = b + ws_buf[light_src[k]]
        a = heavy_a[off : off + l][:, None]
        if assoc_scan:
            s = _assoc_scan(a, b, reverse=True)
        else:
            s = _scan_affine(a, b, st, reverse=True)
        s_buf[off : off + l] = s
        ws_buf[off : off + l] = w[off : off + l][:, None] * s

    f_buf = torch.zeros((total + 1, d), dtype=dt, device=dev)
    for off, (l, _kk), (head_src, _ls), st in live:
        s_t = s_buf[off : off + l]
        b = omw2[off : off + l][:, None] * s_t \
            + head_w[off : off + l][:, None] * f_buf[head_src]
        a = down_a[off : off + l][:, None]
        if assoc_scan:
            f = _assoc_scan(a, b)
        else:
            f = _scan_affine(a, b, st, reverse=False)
        f_buf[off : off + l] = f

    if reduce == "argmin":
        # WTA in plan order (argmin is row-local): the final un-permute
        # gather then moves one int32 per node instead of D floats.
        return torch.argmin(f_buf, dim=1).to(torch.int32)[inv_perm]
    return f_buf[inv_perm]


# ---------------------------------------------------------------------------
# Stacking, converging and merging plans
# ---------------------------------------------------------------------------


def stack_coded_plans(plans) -> CodedPlan:
    """Stack same-layout coded plans (shared table, batched ints/codes)."""
    p0 = plans[0]
    for p in plans[1:]:
        if p.layout_key != p0.layout_key:
            raise ValueError(
                "plan layouts diverged; rebuild until layout_keys agree"
            )
        if not torch.equal(p.table.cpu(), p0.table.cpu()):
            raise ValueError("coded plans must share one weight table (σ)")
    return CodedPlan(
        p0.num_nodes, p0.total_pos, p0.rounds_meta,
        torch.stack([p.ints for p in plans]), torch.stack([p.codes for p in plans]),
        p0.table, p0.scan_steps, p0.n_real,
    )


def stack_plans(plans) -> PlanOrderPlan:
    """Stack same-layout plans into one batched plan (leading B axis)."""
    p0 = plans[0]
    for p in plans[1:]:
        if (p.num_nodes, p.total_pos, p.rounds_meta) != (
            p0.num_nodes, p0.total_pos, p0.rounds_meta
        ):
            raise ValueError(
                "plan layouts diverged; build them via converged_plan_batch"
            )
    return PlanOrderPlan(
        p0.num_nodes, p0.total_pos, p0.rounds_meta,
        torch.stack([p.ints for p in plans]), torch.stack([p.floats for p in plans]),
    )


def converged_plan_batch(trees, sigma: float, native: bool = True) -> PlanOrderPlan:
    """Build one stacked plan (on the host) for several same-size trees.

    Building a plan can still *grow* the layout registry (a tree needing
    more light rounds moves every same-N plan to a new ``(N,
    padded_rounds)`` cap key), so one rebuild of stale plans is not a fixed
    point. Iterate: rebuild every plan until all layouts agree; the
    registry is monotone, which bounds this at a handful of repacks.
    """
    plans = [PlanOrderPlan.from_tree(t, sigma, native) for t in trees]
    for _ in range(8):
        layouts = {(p.rounds_meta, p.total_pos) for p in plans}
        if len(layouts) == 1:
            return stack_plans(plans)
        plans = [PlanOrderPlan.from_tree(t, sigma, native) for t in trees]
    raise RuntimeError("plan layouts failed to converge")  # pragma: no cover


def converged_coded_batch(trees, sigma: float, native: bool = True) -> CodedPlan:
    """One stacked coded plan (on the host) for several same-size trees
    (layout-converged like :func:`converged_plan_batch`, including the
    scan-step schedule)."""
    plans = [CodedPlan.from_tree(t, sigma, native) for t in trees]
    for _ in range(8):
        if len({p.layout_key for p in plans}) == 1:
            return stack_coded_plans(plans)
        plans = [CodedPlan.from_tree(t, sigma, native) for t in trees]
    raise RuntimeError("plan layouts failed to converge")  # pragma: no cover


def tree_filter_nodes_po_batched(
    cost_nodes: torch.Tensor, plans: PlanOrderPlan
) -> torch.Tensor:
    """Batched aggregation: (B, N, D) costs × stacked plans → (B, N, D), each
    frame bit for bit its :func:`tree_filter_nodes_po`."""
    return _po_filter(cost_nodes, plans)


def merge_plans(plans) -> PlanOrderPlan:
    """Merge B same-layout plans into ONE forest plan (on the host).

    Round t of the merged plan is the concatenation of every input plan's
    round-t block; all plan-position references get the matching offset.
    The merged plan drives the plain single-frame filter on (B·N, D) costs.

    Exactness: the filter's recurrences never cross path boundaries
    (``heavy_a`` is 0 at every path tail, ``down_a`` is 0 at every head),
    and round blocks are whole paths, so concatenating blocks cannot mix
    frames. Per-round block lengths are powers of two (registry padding),
    so for a power-of-two B the associative-scan combine tree restricted
    to an aligned block is the same as the standalone scan's: results are
    bit-identical to per-frame filtering.
    """
    p0 = plans[0]
    for p in plans[1:]:
        if (p.num_nodes, p.total_pos, p.rounds_meta) != (
            p0.num_nodes, p0.total_pos, p0.rounds_meta
        ):
            raise ValueError(
                "plan layouts diverged; build them via converged_plan_batch"
            )
    bsz = len(plans)
    n = p0.num_nodes
    total = p0.total_pos
    ls = np.array([l for l, _ in p0.rounds_meta], np.int64)
    off = np.concatenate([[0], np.cumsum(ls)])          # old round offsets
    off2 = np.concatenate([[0], np.cumsum(bsz * ls)])   # merged offsets
    total2 = bsz * total

    def remap_pos(idx: np.ndarray, b: int) -> np.ndarray:
        # plan position -> merged plan position (dummy `total` -> `total2`)
        idx = idx.astype(np.int64)
        r = np.clip(np.searchsorted(off, idx, side="right") - 1, 0, len(ls) - 1)
        out = off2[r] + b * ls[r] + (idx - off[r])
        return np.where(idx == total, total2, out).astype(np.int32)

    unpacked = []  # per plan: (rounds, perm, inv_perm) as host arrays
    for p in plans:
        ints = p.ints.cpu().numpy()
        floats = p.floats.cpu().numpy()
        rounds = []
        io = fo = 0
        for (l, k) in p0.rounds_meta:
            head_src = ints[io : io + l]
            light_src = ints[io + l : io + l + k * l].reshape(k, l)
            io += l + k * l
            fl = floats[fo : fo + 4 * l + k * l]
            fo += 4 * l + k * l
            rounds.append((head_src, light_src, fl))
        perm = ints[io : io + total]
        inv_perm = ints[io + total : io + total + n]
        unpacked.append((rounds, perm, inv_perm))

    ints_parts, float_parts, metas = [], [], []
    perm_parts = []
    pos = 0
    for t, (l, k) in enumerate(p0.rounds_meta):
        hs = np.concatenate(
            [remap_pos(u[0][t][0], b) for b, u in enumerate(unpacked)]
        )
        # light_src: (k, l) per plan -> (k, B·l) merged, k-major flat.
        if k:
            lsrc = np.concatenate(
                [
                    np.stack(
                        [remap_pos(row, b) for row in u[0][t][1]]
                    )
                    for b, u in enumerate(unpacked)
                ],
                axis=1,
            ).reshape(-1)
        else:
            lsrc = np.zeros(0, np.int32)
        ints_parts += [hs, lsrc]
        fls = [u[0][t][2] for u in unpacked]
        # floats per round: heavy_a(l) down_a(l) omw2(l) head_w(l) light_w(k·l)
        for s in range(4):
            float_parts.append(
                np.concatenate([f[s * l : (s + 1) * l] for f in fls])
            )
        if k:
            float_parts.append(
                np.concatenate(
                    [f[4 * l :].reshape(k, l) for f in fls], axis=1
                ).reshape(-1)
            )
        metas.append((int(bsz * l), int(k)))
        # perm: node ids, frame b's ids offset by b·n (dummy n -> B·n).
        for b, u in enumerate(unpacked):
            pr = u[1][pos : pos + l].astype(np.int64)
            perm_parts.append(
                np.where(pr == n, bsz * n, pr + b * n).astype(np.int32)
            )
        pos += l
    inv_parts = [
        remap_pos(u[2], b) for b, u in enumerate(unpacked)
    ]
    ints_m = np.concatenate(ints_parts + perm_parts + inv_parts)
    floats_m = np.concatenate(float_parts)
    return PlanOrderPlan(
        num_nodes=bsz * n, total_pos=total2, rounds_meta=tuple(metas),
        ints=ints_m.astype(np.int32), floats=floats_m.astype(np.float32),
    )


def tree_filter_nodes_po_merged(
    cost_nodes: torch.Tensor, merged: PlanOrderPlan
) -> torch.Tensor:
    """Batched aggregation via a merged forest plan: (B, N, D) → (B, N, D)."""
    b, n, d = cost_nodes.shape
    out = tree_filter_nodes_po(cost_nodes.reshape(b * n, d), merged)
    return out.reshape(b, n, d)
