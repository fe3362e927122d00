"""Stride-bucket tree aggregation: the exact tree filter of the ST pipelines.

A port of ``gpu_stereo_matching_tpu/tree/stride.py``. The host half (the
heavy-path decomposition, the registry-converged bucket layout and the plan
emitters, C++ and NumPy) is copied with the same arithmetic; the device half
is plain torch, each float operation its own torch op in the JAX function's
order, so the card and the CPU give the same bits.

The filter computes the sequential reference filter
(``STMatching/SegmentTree.cpp:148-181``) up to float summation order,
around a **stride-bucket layout** that makes every structural access static:

* Within each light-round, heavy paths are grouped into power-of-two
  length buckets. A bucket with stride S and P path slots stores path
  ``p``'s ``j``-th node at local offset ``j·P + p`` — paths interleaved,
  not concatenated. Path heads are the first P rows of each bucket (a
  slice, not a gather); scans are per bucket with exactly log2(S) doubling
  steps over a reshaped (S, P, D) block, no segment masking.
* The up-pass light pull needs no index stream: light children of round t
  are exactly the path heads of round t+1. The filter extracts those heads,
  reorders them by (parent position, sibling rank) with one H-row gather
  (``head_perm``), forms sibling prefix sums with two shifted adds, and
  addresses the result with ``base = exclusive-cumsum(light_count)``; the
  light counts ride two bits of the flags stream.

Plan payload (the **lean** format, the default): ``ints`` = bucket-head
node ids ‖ per-round [parent_pos ‖ head_perm], 24-bit-packed u8 triples;
``codes`` = (total,) u8 parent-distance codes; ``flg`` = nibble-packed
3-bit flags (two positions per byte); ``res`` = 2-bit heavy-chain perm
residuals; ``table`` = the 256-entry exact weight LUT
(:func:`tree.hpd.weight_lut`). Flags: bit0 = force-zero weight (root and
padding), bits1-2 = light-child count (≤ 3). The perm ships as residuals
and is decoded on the device; inv_perm ships not at all and is recomputed
there by one scatter. ``lean=False`` keeps the older format (codes
(2, total) with the flags in row 1, inv_perm in ``ints``).

The static layout is converged through the persisted registry of
:mod:`tree.hpd`, so all frames of one image size share one layout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.tree.builder import SegmentTree
from gpu_stereo_matching_tpu_torch.tree.hpd import (
    _exact_lut,
    _nbytes,
    _pow2,
    _registry_bucket_caps,
    _registry_real_rounds,
    _registry_rounds,
    _registry_scan_caps,
    _scan_affine,
    _unpack_ints24,
    _wrap_arrays,
    pack_ints24,
    weight_lut,
)

_PLAN_ARRAYS = ("ints", "codes", "table", "res", "flg")


def _pad_count(p: int) -> int:
    """Path-slot granularity: pow2 up to 8, then quarter-pow2 multiples.

    Coarse enough that the layout registry converges in a few frames
    (every cap bump recompiles), fine enough that slot padding stays
    under ~25% — unlike the plan-order layout's full pow2 round caps.
    """
    if p <= 0:
        return 0
    if p <= 8:
        return _pow2(p)
    g = 1 << (int(p).bit_length() - 3)  # 2^(floor(log2 p) - 2)
    return ((p + g - 1) // g) * g


def _decompose(tree: SegmentTree):
    """Heavy-path decomposition: per node (light_depth, head, path depth).

    Same construction as ``tree.hpd._packed_arrays_numpy`` (heavy child =
    max subtree, ties lowest id; pointer doubling for depths/heads).
    """
    n = tree.num_nodes
    parent = tree.parent.astype(np.int64)
    sub = tree.subtree_size

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
    light = ~is_heavy_child
    light[0] = False

    light_depth64 = light.astype(np.int64)
    jump = parent.copy()
    head_ptr = np.where(light | (np.arange(n) == 0), np.arange(n), parent)
    max_depth = int(tree.num_levels)
    rounds = max(1, int(np.ceil(np.log2(max(max_depth, 2)))))
    for _ in range(rounds):
        light_depth64 = light_depth64 + light_depth64[jump]
        jump = jump[jump]
        head_ptr = head_ptr[head_ptr]
    head_of = head_ptr.astype(np.int64)
    depth_in_path = (tree.level_of.astype(np.int64)
                     - tree.level_of.astype(np.int64)[head_of])
    return light_depth64.astype(np.int64), head_of, depth_in_path


@dataclasses.dataclass(frozen=True)
class StridePlan:
    """Stride-bucket plan (see module docstring).

    ``buckets``: per round, a tuple of ``(exp, P)`` — stride ``2**exp``
    with ``P`` path slots; zero-slot buckets are omitted. ``n_real`` is
    the number of leading rounds containing real nodes (the registry-
    padded tail is skipped). The arrays are torch tensors (numpy arrays
    given to the constructor are wrapped, without a copy); :meth:`to`
    moves them to a device.
    """

    num_nodes: int
    total_pos: int
    buckets: Tuple[Tuple[Tuple[int, int], ...], ...]
    n_real: int
    ints: torch.Tensor   # (3, L) u8 (24-bit packed)
    codes: torch.Tensor  # lean: (total,) u8 dist codes; legacy: (2, total)
    table: torch.Tensor  # (256, 2) f32
    # ``res``: the 2-bit heavy-chain residual codes (4 per byte) from which
    # the filter reconstructs the perm — row j of a bucket column is row
    # j−1's heavy child, a grid neighbor, so perm[j]−perm[j−1] is one of
    # {+W, +1, −1, −W}. ``width`` is the image W the residuals are coded
    # against. ``res=None`` is the layout with the perm shipped verbatim.
    res: "torch.Tensor | None" = None   # ((R+3)//4,) u8, R = total − H_all
    width: int = 0
    # Lean format (``flg is not None``, requires ``res``): ``codes`` is
    # (total,) dist codes only, ``flg`` the 3-bit flags stream nibble-packed
    # two per byte, and ``ints`` has no inv_perm section (``heads ‖
    # per-round streams``): the filter inverts the decoded perm instead.
    flg: "torch.Tensor | None" = None   # ((total+1)//2,) u8

    def __post_init__(self):
        _wrap_arrays(self, _PLAN_ARRAYS)

    @property
    def layout_key(self):
        return (
            self.num_nodes, self.total_pos, self.buckets, self.n_real,
            self.width, self.res is None, self.flg is None,
        )

    @staticmethod
    def from_tree(
        tree: SegmentTree, sigma: float, native: bool = True,
        device="cpu", lean: bool = True,
    ) -> "StridePlan":
        return build_stride_plan(tree, sigma, native=native, lean=lean).to(device)

    def to(self, device) -> "StridePlan":
        """The plan with every array on ``device`` (the upload)."""
        return dataclasses.replace(self, **{
            name: None if getattr(self, name) is None else getattr(self, name).to(device)
            for name in _PLAN_ARRAYS
        })

    def frame(self, g: int) -> "StridePlan":
        """Per-frame view of a stacked plan (leading batch axis on the
        per-frame arrays; ``table`` is shared)."""
        return StridePlan(
            self.num_nodes, self.total_pos, self.buckets, self.n_real,
            self.ints[g], self.codes[g], self.table,
            res=None if self.res is None else self.res[g],
            width=self.width,
            flg=None if self.flg is None else self.flg[g],
        )

    @property
    def transport_nbytes(self) -> int:
        """Bytes shipped host→device per plan (all per-frame streams)."""
        return _nbytes(self.ints, self.codes, self.res, self.flg)


def _layout_from_heads(n: int, head_round, path_len):
    """Registry-converged static layout from per-path (round, length).

    Returns (buckets, n_real, exp_of) where buckets[t] is the per-exponent
    (stride 2^exp, path-slot cap) tuple for round t.
    """
    n_rounds = int(head_round.max()) + 1
    padded_rounds = _registry_rounds(n, _pow2(n_rounds))

    # Max path length cap per round (shared semantic with the coded
    # plans' doubling-scan schedule registry).
    need_caps = []
    for t in range(padded_rounds):
        sel = head_round == t
        need_caps.append(
            _pow2(int(path_len[sel].max())) if sel.any() else 1
        )
    scan_caps = _registry_scan_caps(n, padded_rounds, need_caps)

    # Per-(round, exponent) path-slot counts, granularity-padded.
    exp_of = np.zeros(len(path_len), np.int64)
    nz = path_len > 1
    exp_of[nz] = np.ceil(np.log2(path_len[nz])).astype(np.int64)
    needed = []
    need_real = 0
    for t in range(padded_rounds):
        sel = head_round == t
        max_e = int(np.log2(scan_caps[t]))
        row = [0] * (max_e + 1)
        if sel.any():
            need_real = t + 1
            for e, c in zip(*np.unique(exp_of[sel], return_counts=True)):
                row[int(e)] = _pad_count(int(c))
        needed.append(row)
    caps = _registry_bucket_caps(n, padded_rounds, needed)
    n_real = _registry_real_rounds(n, padded_rounds, need_real)
    buckets = tuple(
        tuple((e, int(p)) for e, p in enumerate(row) if p > 0)
        for row in caps
    )
    return buckets, n_real, exp_of


def _layout_offsets(buckets):
    """Static offsets for a bucket layout: per-round position/head bases."""
    round_off = []
    bucket_off = []  # per round: {exp: position offset within the plan}
    head_off = []    # per round: {exp: head index offset within the round}
    total = 0
    for row in buckets:
        round_off.append(total)
        bo, ho = {}, {}
        h_acc = 0
        for e, p in row:
            bo[e] = total
            ho[e] = h_acc
            total += (1 << e) * p
            h_acc += p
        bucket_off.append(bo)
        head_off.append(ho)
    hp = [sum(p for _e, p in row) for row in buckets]
    return round_off, bucket_off, head_off, hp, total


def build_stride_plan(
    tree: SegmentTree, sigma: float, native: bool = True, lean: bool = True
) -> StridePlan:
    """Emit the stride-bucket plan (host NumPy arrays).

    ``native=True`` runs the C++ emitter (``gsm_sb_plan_*``, the streaming
    host hot path); ``native=False`` is the bit-exact vectorized-NumPy
    oracle. Both share the registry-converged layout. ``lean=True`` (the
    production default) emits the round-5 transport format: no inv_perm
    section, dist-only codes, nibble-packed flags (see the class doc).
    """
    n = tree.num_nodes
    if native:
        ints, codes, buckets, n_real, total = _emit_native(tree)
    else:
        light_depth, head_of, depth_in_path = _decompose(tree)
        heads = np.flatnonzero(head_of == np.arange(n))
        path_len = np.bincount(head_of, minlength=n)[heads]
        head_round = light_depth[heads]
        buckets, n_real, exp_of = _layout_from_heads(n, head_round, path_len)
        round_off, bucket_off, head_off, hp, total = _layout_offsets(buckets)
        ints, codes = _emit_numpy(
            tree, buckets, round_off, bucket_off, head_off, hp, total,
            light_depth, head_of, depth_in_path,
            heads, path_len, head_round, exp_of,
        )
    # Compress the perm section: heads + 2-bit heavy-chain residuals (the
    # converter is emitter-agnostic, so C++ and NumPy emissions stay
    # bitwise-comparable end to end).
    head_vals, res = _compress_perm(ints[:total], buckets, tree.width, n)
    pack = _pack24_native if native else pack_ints24
    if lean:
        # Drop the inv_perm(N) section (recomputed in-graph from the
        # decoded perm) and nibble-pack the 3-bit flags two-per-byte.
        ints_c = np.concatenate(
            [head_vals, ints[total + n :]]
        ).astype(np.int32)
        return StridePlan(
            num_nodes=n, total_pos=total, buckets=buckets, n_real=n_real,
            ints=pack(ints_c), codes=np.ascontiguousarray(codes[0]),
            table=weight_lut(sigma), res=res, width=tree.width,
            flg=_pack_flags(codes[1]),
        )
    ints_c = np.concatenate([head_vals, ints[total:]]).astype(np.int32)
    return StridePlan(
        num_nodes=n, total_pos=total, buckets=buckets, n_real=n_real,
        ints=pack(ints_c), codes=codes, table=weight_lut(sigma),
        res=res, width=tree.width,
    )


def _pack_flags(flags: np.ndarray) -> np.ndarray:
    """Nibble-pack the (total,) 3-bit flags stream, two per byte."""
    f = np.asarray(flags, np.uint8)
    if f.max(initial=0) > 0xF:
        raise AssertionError("flags exceed one nibble")
    pad = (-len(f)) % 2
    f = np.concatenate([f, np.zeros(pad, np.uint8)])
    return (f[0::2] | (f[1::2] << 4)).astype(np.uint8)


def _emit_numpy(
    tree, buckets, round_off, bucket_off, head_off, hp, total,
    light_depth, head_of, depth_in_path,
    heads, path_len, head_round, exp_of,
):
    n = tree.num_nodes
    parent = tree.parent.astype(np.int64)

    # Path slot per head: within (round, exp), order by head node id
    # (deterministic; the up-pass reorders by parent position anyway).
    slot_of_head = np.empty(len(heads), np.int64)
    order = np.lexsort((heads, exp_of, head_round))
    hs = heads[order]
    key_r = head_round[order]
    key_e = exp_of[order]
    newgrp = np.ones(len(hs), bool)
    newgrp[1:] = (key_r[1:] != key_r[:-1]) | (key_e[1:] != key_e[:-1])
    grp_start = np.maximum.accumulate(
        np.where(newgrp, np.arange(len(hs)), 0)
    )
    slot_sorted = np.arange(len(hs)) - grp_start
    slot_of_head[order] = slot_sorted

    head_slot = np.zeros(n, np.int64)   # per node: its path's slot
    head_exp = np.zeros(n, np.int64)    # per node: its path's exponent
    head_slot[heads] = slot_of_head
    head_exp[heads] = exp_of
    head_slot = head_slot[head_of]
    head_exp = head_exp[head_of]

    # Position of every node: bucket base + j·P + slot.
    r_of = light_depth
    p_caps = np.zeros((len(buckets), max(
        (max((e for e, _p in row), default=0) for row in buckets), default=0
    ) + 1), np.int64)
    b_offs = np.zeros_like(p_caps)
    for t, row in enumerate(buckets):
        for e, p in row:
            p_caps[t, e] = p
            b_offs[t, e] = bucket_off[t][e]
    pos_of = (
        b_offs[r_of, head_exp]
        + depth_in_path * p_caps[r_of, head_exp]
        + head_slot
    )

    perm = np.full(total, n, np.int64)
    perm[pos_of] = np.arange(n)
    inv_perm = pos_of

    # Parent positions per head (bucket order), light counts per position.
    parent_pos_node = np.where(np.arange(n) == 0, total, pos_of[parent])
    # Light-child count per plan position: every non-root head is the
    # light child of its parent's position.
    cnt = np.bincount(
        parent_pos_node[heads[heads != 0]], minlength=total + 1
    )[:total]
    if cnt.max(initial=0) > 3:
        raise AssertionError("grid node with > 3 light children")

    codes = np.zeros((2, total), np.uint8)
    real = perm != n
    codes[0, real] = tree.parent_dist[perm[real]].astype(np.uint8)
    zero_w = ~real
    zero_w[pos_of[0]] = True  # the root carries no parent edge
    codes[1] = (zero_w + 2 * cnt).astype(np.uint8)

    # Per-round head streams.
    h_offs = np.zeros_like(p_caps)
    for t, row in enumerate(buckets):
        for e, _p in row:
            h_offs[t, e] = head_off[t][e]
    stream_parts = [perm, inv_perm]
    for t, row in enumerate(buckets):
        h_t = hp[t]
        if h_t == 0:
            continue
        parent_pos = np.full(h_t, total, np.int64)
        is_real = np.zeros(h_t, bool)
        sel = head_round == t
        hsel = heads[sel]
        idx_in_round = h_offs[t, exp_of[sel]] + slot_of_head[sel]
        parent_pos[idx_in_round] = parent_pos_node[hsel]
        is_real[idx_in_round] = True
        # head_perm: real heads sorted by (parent position, head index)
        # first — sibling runs become adjacent for the prefix-sum trick —
        # dummies at the tail pointing past the raw array (a zero row).
        real_idx = np.flatnonzero(is_real)
        order = real_idx[np.lexsort((real_idx, parent_pos[real_idx]))]
        head_perm = np.concatenate(
            [order, np.full(h_t - len(order), h_t, np.int64)]
        )
        stream_parts += [parent_pos, head_perm]

    ints = np.concatenate(stream_parts).astype(np.int32)
    return ints, codes


def _pack24_native(ints: np.ndarray) -> np.ndarray:
    """C++ 24-bit packing, bit-identical to :func:`tree.hpd.pack_ints24`
    (~7× faster — the NumPy stack/shift chain costs ~14 ms at Middlebury
    plan sizes, a real slice of the streaming host budget)."""
    import ctypes

    from gpu_stereo_matching_tpu_torch.tree.builder import _lib

    lib = _lib()
    src = np.ascontiguousarray(ints, np.int32)
    out = np.empty((3, src.size), np.uint8)
    rc = lib.gsm_pack24(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(src.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise ValueError(
            "plan index stream outside the 24-bit packing range"
        )
    return out


def _emit_native(tree: SegmentTree):
    """One-shot C++ emission (see ``gsm_sb_plan_*`` in segment_tree.cpp).

    The C++ core recomputes the heavy-path decomposition in one BFS pass
    (the NumPy pointer-doubling twin costs ~70 ms/frame at Middlebury
    size); Python keeps only the registry-converged layout math.
    """
    import ctypes

    from gpu_stereo_matching_tpu_torch.tree.builder import _lib

    lib = _lib()
    n = tree.num_nodes
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def p32(a):
        return np.ascontiguousarray(a, np.int32).ctypes.data_as(i32p)

    handle = ctypes.c_void_p(
        lib.gsm_sb_ctx_new(
            n, p32(tree.parent), p32(tree.subtree_size), p32(tree.bfs_order)
        )
    )
    try:
        nh = lib.gsm_sb_num_heads(handle)
        head_node = np.empty(nh, np.int32)
        head_round = np.empty(nh, np.int32)
        path_len = np.empty(nh, np.int32)
        lib.gsm_sb_head_info(
            handle, p32(head_node), head_round.ctypes.data_as(i32p),
            path_len.ctypes.data_as(i32p),
        )
        buckets, n_real, _exp = _layout_from_heads(
            n, head_round.astype(np.int64), path_len.astype(np.int64)
        )
        _ro, _bo, _ho, hp, total = _layout_offsets(buckets)
        n_exp = max(
            (max((e for e, _p in row), default=0) for row in buckets),
            default=0,
        ) + 1
        caps = np.zeros((len(buckets), n_exp), np.int32)
        for t, row in enumerate(buckets):
            for e, p in row:
                caps[t, e] = p
        n_streams = sum(2 * h for h in hp if h > 0)
        ints = np.empty(total + n + n_streams, np.int32)
        codes = np.empty((2, total), np.uint8)
        rc = lib.gsm_sb_plan_fill(
            handle, len(buckets), n_exp,
            caps.ctypes.data_as(i32p), p32(tree.parent_dist),
            ints.ctypes.data_as(i32p),
            codes.ctypes.data_as(u8p),
        )
        if rc != 0:
            raise RuntimeError(f"gsm_sb_plan_fill failed (code {rc})")
    finally:
        lib.gsm_hpd_plan_free(handle)
    return ints, codes, buckets, n_real, total


def _compress_perm(perm: np.ndarray, buckets, width: int, n: int):
    """Host side: perm(total) → (heads(H_all), 2-bit residual codes).

    Within a bucket column, row j's node is row j−1's heavy child — a
    4-connected grid neighbor — so the step ``perm[j] − perm[j−1]`` is one
    of {+W, +1, −1, −W}; pad rows (value n) get code 0 and are masked by
    the decoder via the codes zero-weight flag. Exact by construction.
    """
    heads_parts, res_parts = [], []
    off = 0
    for row in buckets:
        for e, p in row:
            s = 1 << e
            blk = perm[off : off + s * p].reshape(s, p)
            heads_parts.append(blk[0])
            if s > 1:
                d = blk[1:].astype(np.int64) - blk[:-1].astype(np.int64)
                code = np.zeros((s - 1, p), np.uint8)
                code[d == 1] = 1
                code[d == -1] = 2
                code[d == -width] = 3
                real = blk[1:] != n
                ok = (
                    (d == width) | (d == 1) | (d == -1) | (d == -width)
                )
                if not bool(np.all(ok | ~real)):
                    raise AssertionError(
                        "non-neighbor heavy step in perm stream"
                    )
                code[~real] = 0
                res_parts.append(code.reshape(-1))
            off += s * p
    heads = np.concatenate(heads_parts) if heads_parts else np.zeros(0)
    res = (
        np.concatenate(res_parts) if res_parts else np.zeros(0, np.uint8)
    )
    pad = (-len(res)) % 4
    res = np.concatenate([res, np.zeros(pad, np.uint8)])
    packed = (
        res[0::4] | (res[1::4] << 2) | (res[2::4] << 4) | (res[3::4] << 6)
    ).astype(np.uint8)
    return heads.astype(np.int64), packed


def _decode_perm(heads, res_packed, codes_zero, plan: StridePlan):
    """On-device inverse of :func:`_compress_perm` → (total,) i32 perm."""
    n, w = plan.num_nodes, plan.width
    b = res_packed.to(torch.int32)
    codes4 = torch.stack(
        [b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3], dim=-1
    ).reshape(-1)
    # code -> step, branch-free: {0:+W, 1:+1, 2:-1, 3:-W}
    steps_all = torch.where(
        codes4 == 0, w,
        torch.where(codes4 == 1, 1, torch.where(codes4 == 2, -1, -w)),
    ).to(torch.int32)
    parts = []
    off = 0       # position offset (for the pad mask)
    hoff = 0      # heads offset
    roff = 0      # residual offset
    for row in plan.buckets:
        for e, p in row:
            s = 1 << e
            head = heads[hoff : hoff + p]
            if s == 1:
                parts.append(head)
            else:
                st = steps_all[roff : roff + (s - 1) * p].reshape(s - 1, p)
                col = (head[None, :] + torch.cumsum(st, dim=0)).to(torch.int32)
                blk = torch.cat([head[None, :], col], dim=0)
                pad = codes_zero[off : off + s * p].reshape(s, p)
                # rows >= 1: zero-weight <=> padding (the root is a head)
                rows = torch.arange(s, device=blk.device)[:, None]
                blk = torch.where(pad & (rows > 0), n, blk)
                parts.append(blk.reshape(-1))
                roff += (s - 1) * p
            hoff += p
            off += s * p
    return torch.cat(parts)


def _unpack_sb_ints(ints, plan: StridePlan):
    total, n = plan.total_pos, plan.num_nodes
    if plan.res is not None:
        h_all = sum(p for row in plan.buckets for _e, p in row)
        heads = ints[:h_all]
        if plan.flg is not None:
            # Lean layout: no inv_perm section (recomputed on the device).
            inv_perm = None
            off = h_all
        else:
            inv_perm = ints[h_all : h_all + n]
            off = h_all + n
        head_streams = []
        for row in plan.buckets:
            h_t = sum(p for _e, p in row)
            if h_t == 0:
                head_streams.append((None, None))
                continue
            head_streams.append(
                (ints[off : off + h_t], ints[off + h_t : off + 2 * h_t])
            )
            off += 2 * h_t
        return heads, inv_perm, head_streams
    perm = ints[:total]
    inv_perm = ints[total : total + n]
    off = total + n
    head_streams = []
    for row in plan.buckets:
        h_t = sum(p for _e, p in row)
        if h_t == 0:
            head_streams.append((None, None))
            continue
        head_streams.append(
            (ints[off : off + h_t], ints[off + h_t : off + 2 * h_t])
        )
        off += 2 * h_t
    return perm, inv_perm, head_streams


def _invert_perm(perm: torch.Tensor, n: int) -> torch.Tensor:
    """On-device inverse of the (total,) position→node map → (N,) i32.

    Real perm entries are a permutation of 0..N−1; pads carry value N. One
    scatter of position ids into N + 1 rows: the pads all land in the last
    row, which is dropped (the JAX function's drop-mode scatter).
    """
    iota = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    out = torch.zeros((n + 1,), dtype=torch.int32, device=perm.device)
    out[perm.long()] = iota
    return out[:n]


def tree_filter_nodes_sb(
    cost_nodes: torch.Tensor, plan: StridePlan
) -> torch.Tensor:
    """Exact (N, D) non-local aggregation from a stride-bucket plan on the
    plan's device.

    Matches the level-scan filter (:func:`tree.filter.tree_filter_nodes`)
    and the reference filter to float tolerance: sibling light
    contributions are pre-summed pairwise ((h1+h2)+h3) and bucket scans stop
    at the bucket's own log2(S). Every float operation is a separate torch
    op, in the JAX function's order (no fused multiply-add), so the result
    is the same on the card and on the CPU, bit for bit.
    """
    d = cost_nodes.shape[1]
    dt = cost_nodes.dtype
    dev = cost_nodes.device
    total = plan.total_pos
    ints = plan.ints
    if ints.dim() == 2 and ints.dtype == torch.uint8:
        ints = _unpack_ints24(ints)
    first, inv_perm, head_streams = _unpack_sb_ints(ints, plan)

    if plan.flg is not None:
        # Lean layout: (total,) dist codes + nibble-packed flags.
        dist_codes = plan.codes
        fb = plan.flg.to(torch.int32)
        flags = torch.stack([fb & 0xF, fb >> 4], dim=-1).reshape(-1)[:total]
    else:
        dist_codes = plan.codes[0]
        flags = plan.codes[1].to(torch.int32)
    vals = _exact_lut(dist_codes, plan.table)
    zero = (flags & 1) != 0
    w = torch.where(zero, torch.zeros_like(vals[:, 0]), vals[:, 0])
    omw2 = torch.where(zero, torch.ones_like(vals[:, 1]), vals[:, 1])
    cnt = (flags >> 1) & 3

    if plan.res is not None:
        perm = _decode_perm(first, plan.res, zero, plan)
    else:
        perm = first
    if inv_perm is None:
        inv_perm = _invert_perm(perm, plan.num_nodes)
    cost_ext = torch.cat([cost_nodes, torch.zeros((1, d), dtype=dt, device=dev)], dim=0)
    cost_plan = cost_ext[perm.long()]

    live = list(range(min(plan.n_real if plan.n_real >= 0 else len(
        plan.buckets), len(plan.buckets))))
    round_off = []
    off = 0
    for row in plan.buckets:
        round_off.append(off)
        off += sum((1 << e) * p for e, p in row)
    hp = [sum(p for _e, p in row) for row in plan.buckets]
    z1 = torch.zeros((1, d), dtype=dt, device=dev)

    # ---- Up pass (leaf-most round first) -------------------------------
    s_blocks: dict = {}   # round -> list of (S, P, D) scanned blocks
    ws_heads: dict = {}   # round -> (H_t, D) w·s at heads, bucket order
    for t in reversed(live):
        off_t = round_off[t]
        l_t = sum((1 << e) * p for e, p in plan.buckets[t])
        b_t = cost_plan[off_t : off_t + l_t]

        nxt = t + 1
        if nxt < len(plan.buckets) and nxt in ws_heads and hp[nxt] > 0:
            h_nx = hp[nxt]
            _pp, head_perm = head_streams[nxt]
            raw_ext = torch.cat([ws_heads[nxt], z1], dim=0)
            h1 = raw_ext[head_perm.long()]  # by (parent pos, rank)
            # Sibling prefix sums via shifted adds; the pad keeps every
            # shift exactly H rows (h1[k:] alone under-fills when H < k).
            h1p = torch.cat([h1, z1, z1], dim=0)
            h2 = h1 + h1p[1 : h_nx + 1]
            h3 = h2 + h1p[2 : h_nx + 2]
            stacked = torch.cat([h1, h2, h3, z1], dim=0)
            cnt_t = cnt[off_t : off_t + l_t]
            base = (torch.cumsum(cnt_t, dim=0) - cnt_t).to(torch.int32)
            idx = torch.where(cnt_t > 0, base + h_nx * (cnt_t - 1), 3 * h_nx)
            b_t = b_t + stacked[idx.long()]

        blocks, heads_t = [], []
        bo = 0
        for e, p in plan.buckets[t]:
            s_e = 1 << e
            blk = b_t[bo : bo + s_e * p].reshape(s_e, p, d)
            w_blk = w[off_t + bo : off_t + bo + s_e * p].reshape(s_e, p)
            a_blk = torch.cat(
                [w_blk[1:], torch.zeros((1, p), dtype=dt, device=dev)], dim=0
            )[:, :, None]
            # Paths occupy disjoint columns: the scan needs no boundary mask.
            s_blk = _scan_affine(a_blk, blk, e, reverse=True)
            blocks.append((e, p, s_blk, w_blk))
            heads_t.append(w_blk[0][:, None] * s_blk[0])
            bo += s_e * p
        s_blocks[t] = blocks
        ws_heads[t] = (
            torch.cat(heads_t, dim=0) if heads_t
            else torch.zeros((0, d), dtype=dt, device=dev)
        )

    # ---- Down pass (root round first) ----------------------------------
    f_buf = torch.zeros((total + 1, d), dtype=dt, device=dev)
    for t in live:
        off_t = round_off[t]
        parent_pos, _hperm = head_streams[t]
        fp = f_buf[parent_pos.long()] if parent_pos is not None else None
        f_parts = []
        bo = 0
        h_acc = 0
        for e, p, s_blk, w_blk in s_blocks[t]:
            s_e = 1 << e
            omw2_blk = omw2[off_t + bo : off_t + bo + s_e * p].reshape(s_e, p)
            b_blk = omw2_blk[:, :, None] * s_blk
            row0 = b_blk[0]
            if fp is not None:
                row0 = row0 + w_blk[0][:, None] * fp[h_acc : h_acc + p]
            b_blk = torch.cat([row0[None], b_blk[1:]], dim=0)
            a_blk = torch.cat(
                [torch.zeros((1, p), dtype=dt, device=dev), w_blk[1:]], dim=0
            )[:, :, None]
            f_blk = _scan_affine(a_blk, b_blk, e, reverse=False)
            f_parts.append(f_blk.reshape(s_e * p, d))
            bo += s_e * p
            h_acc += p
        if f_parts:
            seg = torch.cat(f_parts, dim=0)
            f_buf[off_t : off_t + seg.shape[0]] = seg

    return f_buf[inv_perm.long()]


def stack_stride_plans(plans) -> StridePlan:
    """Stack same-layout stride plans (shared table, batched ints/codes)."""
    p0 = plans[0]
    for p in plans[1:]:
        if p.layout_key != p0.layout_key:
            raise ValueError(
                "plan layouts diverged; rebuild until layout_keys agree"
            )
        if not torch.equal(p.table.cpu(), p0.table.cpu()):
            raise ValueError("stride plans must share one weight table (σ)")
    ints = torch.stack([p.ints for p in plans])
    codes = torch.stack([p.codes for p in plans])
    res = None if p0.res is None else torch.stack([p.res for p in plans])
    flg = None if p0.flg is None else torch.stack([p.flg for p in plans])
    return StridePlan(
        p0.num_nodes, p0.total_pos, p0.buckets, p0.n_real,
        ints, codes, p0.table, res=res, width=p0.width, flg=flg,
    )


def converge_stride_plans(builds, pool=None) -> StridePlan:
    """Call every plan builder in ``builds`` (callables returning a
    :class:`StridePlan`), on ``pool`` (an executor) if one is given, until
    all the plans report the same layout key; return them stacked.

    Building a plan can grow the layout registry (a longer path, a fuller
    bucket), so an earlier plan of the batch may have a smaller layout than
    a later one. The registry's caps only grow, so a rebuild converges:
    this bounds it at 8 rounds, as the JAX package does.
    """
    mapper = map if pool is None else pool.map

    def run():
        return list(mapper(lambda f: f(), builds))

    plans = run()
    for _ in range(8):
        if len({p.layout_key for p in plans}) == 1:
            return stack_stride_plans(plans)
        plans = run()
    raise RuntimeError("plan layouts failed to converge")  # pragma: no cover


def converged_stride_batch(trees, sigma: float, native: bool = True) -> StridePlan:
    """One stacked stride plan (on the host) for several same-size trees."""
    return converge_stride_plans([
        functools.partial(StridePlan.from_tree, t, sigma, native=native) for t in trees
    ])
