"""Python bindings + weight providers for the C++ segment-tree builder.

A copy of ``gpu_stereo_matching_tpu/tree/builder.py`` with the same
arithmetic; ``csrc/segment_tree.cpp`` is a verbatim copy of that package's
source. The builder itself (sorted-edge Kruskal/FH scans) is sequential by
nature and runs on the host in C++, bound via ctypes (no pybind11
dependency). ``g++ -O3 -std=c++17`` builds it at first use into this
package's git-ignored ``tree/_build/``. It emits flat arrays consumed by the
tree filters (``tree/stride.py``, ``tree/filter.py``). A pure-NumPy twin
(`build_segment_tree_py`) exists for parity tests.

Edge-weight providers mirror the reference:

* `color_edge_weights` — max-channel abs difference of the 3×3
  median-presmoothed BGR image (``SegmentTree.cpp:183-194``), scale 1.0;
* `color_depth_edge_weights` — ST-2 second iteration: where both endpoints
  are LR-stable, ``0.5·|Δd|/maxLevel + 0.5·maxΔcolor/255``, else color
  only / 255 (``SegmentTree.cpp:196-219``), scale 255.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.ops.postprocess import median_filter_u8

_CSRC = os.path.join(os.path.dirname(__file__), "csrc", "segment_tree.cpp")
_LIB_CACHE: Optional[ctypes.CDLL] = None
# The streaming pipelines build trees from worker threads: one g++ at first use.
_LIB_LOCK = threading.Lock()


def _compile_library() -> str:
    build_dir = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, "libsegtree.so")
    src_mtime = os.path.getmtime(_CSRC)
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= src_mtime:
        return lib_path
    with tempfile.TemporaryDirectory() as tmp:
        tmp_lib = os.path.join(tmp, "libsegtree.so")
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp_lib, _CSRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp_lib, lib_path)
    return lib_path


def _lib() -> ctypes.CDLL:
    with _LIB_LOCK:
        return _load_lib()


def _load_lib() -> ctypes.CDLL:
    global _LIB_CACHE
    if _LIB_CACHE is None:
        lib = ctypes.CDLL(_compile_library())
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gsm_num_edges.restype = ctypes.c_int32
        lib.gsm_num_edges.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.gsm_grid_edges.restype = None
        lib.gsm_grid_edges.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p]
        lib.gsm_build_segment_tree.restype = ctypes.c_int32
        lib.gsm_build_segment_tree.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            i32p, i32p, i32p, i32p, i32p, i32p, i32p, ctypes.c_int32,
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.gsm_median3x3.restype = None
        lib.gsm_median3x3.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
        ]
        lib.gsm_color_weights.restype = None
        lib.gsm_color_weights.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f32p,
        ]
        lib.gsm_color_depth_weights.restype = None
        lib.gsm_color_depth_weights.argtypes = [
            u8p, f32p, u8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32, f32p,
        ]
        lib.gsm_hpd_plan_new.restype = ctypes.c_void_p
        lib.gsm_hpd_plan_new.argtypes = [
            ctypes.c_int32, i32p, i32p, i32p, i32p, f32p,
        ]
        lib.gsm_hpd_plan_free.restype = None
        lib.gsm_hpd_plan_free.argtypes = [ctypes.c_void_p]
        lib.gsm_hpd_plan_rounds.restype = ctypes.c_int32
        lib.gsm_hpd_plan_rounds.argtypes = [ctypes.c_void_p]
        lib.gsm_hpd_plan_sizes.restype = None
        lib.gsm_hpd_plan_sizes.argtypes = [ctypes.c_void_p, i32p, i32p, i32p]
        lib.gsm_hpd_plan_fill.restype = None
        lib.gsm_hpd_plan_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p, i32p, i32p, f32p,
        ]
        lib.gsm_po_plan_k.restype = None
        lib.gsm_po_plan_k.argtypes = [ctypes.c_void_p, i32p]
        lib.gsm_po_plan_fill.restype = None
        lib.gsm_po_plan_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p, i32p, f32p,
        ]
        lib.gsm_sb_num_heads.restype = ctypes.c_int32
        lib.gsm_sb_num_heads.argtypes = [ctypes.c_void_p]
        lib.gsm_sb_head_info.restype = None
        lib.gsm_sb_head_info.argtypes = [ctypes.c_void_p, i32p, i32p, i32p]
        lib.gsm_sb_plan_fill.restype = ctypes.c_int32
        lib.gsm_sb_plan_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
            i32p, u8p,
        ]
        lib.gsm_sb_ctx_new.restype = ctypes.c_void_p
        lib.gsm_sb_ctx_new.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
        lib.gsm_pack24.restype = ctypes.c_int32
        lib.gsm_pack24.argtypes = [i32p, ctypes.c_int64, u8p]
        _LIB_CACHE = lib
    return _LIB_CACHE


@dataclasses.dataclass
class SegmentTree:
    """Flat spanning-tree structure over the H×W pixel grid.

    Node ids are pixel ids ``y*W + x``. ``bfs_order`` is monotone in depth;
    children always appear after their parent.
    """

    height: int
    width: int
    bfs_order: np.ndarray     # (N,) int32
    parent: np.ndarray        # (N,) int32, root -> itself
    parent_dist: np.ndarray   # (N,) int32, quantized [0, 255]
    level_of: np.ndarray      # (N,) int32 BFS depth per node
    level_start: np.ndarray   # (L+1,) int32 offsets into bfs_order
    dfs_order: np.ndarray     # (N,) int32 preorder (contiguous subtrees)
    subtree_size: np.ndarray  # (N,) int32

    @property
    def num_nodes(self) -> int:
        return self.height * self.width

    @property
    def num_levels(self) -> int:
        return len(self.level_start) - 1

    def parent_weights(self, sigma: float) -> np.ndarray:
        """exp(-dist / (255·σ)) per node (the reference's weight LUT,
        ``SegmentTree.cpp:141-146``); root weight is irrelevant (dist 0)."""
        sigma = max(0.01, float(sigma))
        return np.exp(-self.parent_dist.astype(np.float64) / (255.0 * sigma)).astype(
            np.float32
        )


def grid_edges(height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical 4-connected edge enumeration (right then up per pixel)."""
    lib = _lib()
    n = lib.gsm_num_edges(height, width)
    ea = np.empty(n, np.int32)
    eb = np.empty(n, np.int32)
    lib.gsm_grid_edges(
        height, width,
        ea.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        eb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return ea, eb


def build_segment_tree(
    weights: np.ndarray,
    height: int,
    width: int,
    tau: float = 1200.0,
    min_size: int = 50,
    penalty: float = 5.0,
    weight_scale: float = 1.0,
) -> SegmentTree:
    """Build the spanning tree from canonical-order edge weights (C++ path)."""
    lib = _lib()
    n_nodes = height * width
    n_edges = lib.gsm_num_edges(height, width)
    w = np.ascontiguousarray(weights, dtype=np.float32)
    if w.shape != (n_edges,):
        raise ValueError(f"expected {n_edges} edge weights, got {w.shape}")

    bfs_order = np.empty(n_nodes, np.int32)
    parent = np.empty(n_nodes, np.int32)
    parent_dist = np.empty(n_nodes, np.int32)
    level_of = np.empty(n_nodes, np.int32)
    dfs_order = np.empty(n_nodes, np.int32)
    subtree_size = np.empty(n_nodes, np.int32)
    cap = n_nodes + 2
    level_start = np.empty(cap, np.int32)

    i32p = ctypes.POINTER(ctypes.c_int32)
    n_levels = lib.gsm_build_segment_tree(
        height, width,
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        float(tau), int(min_size), float(penalty), float(weight_scale),
        bfs_order.ctypes.data_as(i32p),
        parent.ctypes.data_as(i32p),
        parent_dist.ctypes.data_as(i32p),
        level_of.ctypes.data_as(i32p),
        dfs_order.ctypes.data_as(i32p),
        subtree_size.ctypes.data_as(i32p),
        level_start.ctypes.data_as(i32p),
        cap,
    )
    if n_levels < 0:
        raise RuntimeError(f"segment tree build failed (code {n_levels})")
    return SegmentTree(
        height=height,
        width=width,
        bfs_order=bfs_order,
        parent=parent,
        parent_dist=parent_dist,
        level_of=level_of,
        level_start=level_start[: n_levels + 1].copy(),
        dfs_order=dfs_order,
        subtree_size=subtree_size,
    )


# --------------------------------------------------------------------------
# Edge-weight providers (host side; NumPy on uint8 images)
# --------------------------------------------------------------------------


def _presmooth_bgr(img_bgr: np.ndarray) -> np.ndarray:
    """3×3 clipped-window median per channel (``MeanFilter(img, img, 1)``),
    by the port's ``median_filter_u8`` on a CPU tensor (the JAX package
    jits its own median here)."""
    cmaj = np.ascontiguousarray(np.moveaxis(img_bgr, -1, 0))
    sm = median_filter_u8(torch.from_numpy(cmaj), radius=1).numpy()
    return np.moveaxis(sm, 0, -1)


def color_edge_weights(
    img_bgr: np.ndarray, presmooth: bool = True, native: bool = True
) -> np.ndarray:
    """Max-channel abs difference on the presmoothed image, canonical order.

    ``native=True`` runs the single-pass C++ provider (the streaming host
    hot path); ``native=False`` keeps the NumPy/torch composition as the
    bit-exact oracle.
    """
    h, w, _ = img_bgr.shape
    if native:
        lib = _lib()
        img = np.ascontiguousarray(img_bgr, dtype=np.uint8)
        out = np.empty(lib.gsm_num_edges(h, w), np.float32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.gsm_color_weights(
            img.ctypes.data_as(u8p), h, w, int(presmooth),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    img = _presmooth_bgr(img_bgr) if presmooth else img_bgr
    ea, eb = grid_edges(h, w)
    flat = img.reshape(-1, 3).astype(np.int32)
    diff = np.abs(flat[ea] - flat[eb]).max(axis=1)
    return diff.astype(np.float32)


def color_depth_edge_weights(
    img_bgr: np.ndarray,
    disparity: np.ndarray,
    stable_mask: np.ndarray,
    max_level: int,
    alpha: float = 0.5,
    presmooth: bool = True,
    native: bool = True,
) -> np.ndarray:
    """ST-2 re-segmentation weights: color+depth where both ends are stable."""
    h, w, _ = img_bgr.shape
    if native:
        lib = _lib()
        img = np.ascontiguousarray(img_bgr, dtype=np.uint8)
        disp = np.ascontiguousarray(disparity.reshape(-1), dtype=np.float32)
        stab = np.ascontiguousarray(
            stable_mask.reshape(-1).astype(np.uint8)
        )
        out = np.empty(lib.gsm_num_edges(h, w), np.float32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.gsm_color_depth_weights(
            img.ctypes.data_as(u8p), disp.ctypes.data_as(f32p),
            stab.ctypes.data_as(u8p), h, w,
            int(max_level), float(alpha), int(presmooth),
            out.ctypes.data_as(f32p),
        )
        return out
    img = _presmooth_bgr(img_bgr) if presmooth else img_bgr
    ea, eb = grid_edges(h, w)
    flat = img.reshape(-1, 3).astype(np.int32)
    color = np.abs(flat[ea] - flat[eb]).max(axis=1).astype(np.float32) / 255.0
    disp = disparity.reshape(-1).astype(np.float32)
    dval = np.abs(disp[ea] - disp[eb]) / float(max_level)
    stable = stable_mask.reshape(-1).astype(bool)
    both = stable[ea] & stable[eb]
    return np.where(both, alpha * dval + (1.0 - alpha) * color, color).astype(
        np.float32
    )


# --------------------------------------------------------------------------
# Pure-NumPy twin of the C++ builder (slow; parity-test oracle)
# --------------------------------------------------------------------------


def build_segment_tree_py(
    weights: np.ndarray,
    height: int,
    width: int,
    tau: float = 1200.0,
    min_size: int = 50,
    penalty: float = 5.0,
    weight_scale: float = 1.0,
) -> SegmentTree:
    n = height * width
    ea, eb = grid_edges(height, width)
    w = np.asarray(weights, dtype=np.float32).copy()
    order = np.lexsort((ea, eb, w))  # ascending by (w, b, a)

    parent_ds = np.arange(n)
    rank = np.zeros(n, np.int32)
    size = np.ones(n, np.int64)

    def find(x):
        root = x
        while parent_ds[root] != root:
            root = parent_ds[root]
        while parent_ds[x] != root:
            parent_ds[x], x = root, parent_ds[x]
        return root

    def join(x, y):
        if rank[x] > rank[y]:
            x, y = y, x
        parent_ds[x] = y
        size[y] += size[x]
        if rank[x] == rank[y]:
            rank[y] += 1
        return y

    threshold = np.full(n, tau, np.float64)
    selected = np.zeros(len(w), bool)
    for i in order:
        a, b = find(ea[i]), find(eb[i])
        if a == b:
            continue
        if w[i] <= threshold[a] and w[i] <= threshold[b]:
            selected[i] = True
            root = join(a, b)
            threshold[root] = w[i] + tau / size[root]
    for i in order:
        a, b = find(ea[i]), find(eb[i])
        if a == b:
            continue
        smin = min(size[a], size[b])
        join(a, b)
        selected[i] = True
        if smin > min_size:
            w[i] += penalty

    dist = np.minimum((w * weight_scale + 0.5).astype(np.int32), 255)
    adj = [[] for _ in range(n)]
    for i in order:
        if selected[i]:
            adj[ea[i]].append((eb[i], dist[i]))
            adj[eb[i]].append((ea[i], dist[i]))

    bfs = np.empty(n, np.int32)
    par = np.zeros(n, np.int32)
    pdist = np.zeros(n, np.int32)
    level = np.zeros(n, np.int32)
    visited = np.zeros(n, bool)
    bfs[0] = 0
    visited[0] = True
    head, tail = 0, 1
    while head < tail:
        u = bfs[head]
        head += 1
        for v, dd in adj[u]:
            if not visited[v]:
                visited[v] = True
                par[v] = u
                pdist[v] = dd
                level[v] = level[u] + 1
                bfs[tail] = v
                tail += 1
    assert tail == n, "graph not connected"

    n_levels = int(level.max()) + 1
    level_start = np.zeros(n_levels + 1, np.int32)
    np.add.at(level_start, level + 1, 1)
    level_start = np.cumsum(level_start).astype(np.int32)

    # DFS preorder + subtree sizes
    dfs = np.empty(n, np.int32)
    sub = np.ones(n, np.int32)
    stack = [0]
    idx = 0
    while stack:
        u = stack.pop()
        dfs[idx] = u
        idx += 1
        for v, _ in adj[u]:
            if par[v] == u and v != u:
                stack.append(v)
    for i in range(n - 1, 0, -1):
        v = bfs[i]
        sub[par[v]] += sub[v]

    return SegmentTree(
        height=height,
        width=width,
        bfs_order=bfs,
        parent=par,
        parent_dist=pdist,
        level_of=level,
        level_start=level_start,
        dfs_order=dfs,
        subtree_size=sub,
    )
