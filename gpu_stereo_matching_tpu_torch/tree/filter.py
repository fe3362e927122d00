"""Non-local segment-tree cost aggregation as level scans: the simple oracle
of the stride-bucket filter (``tree/stride.py``), ported from
``gpu_stereo_matching_tpu/tree/filter.py``.

The reference filter (``STMatching/SegmentTree.cpp:148-181``) is two
strictly sequential passes over the BFS array:

* leaf→root:  ``buf[parent(v)] += w(v) · buf[v]``  (children before parents)
* root→leaf:  ``final[v] = w(v)·(final[parent(v)] − w(v)·buf[v]) + buf[v]``

Nodes of one BFS depth have no ancestor/descendant relations, so each pass
is a loop over depths whose step is one vectorized scatter-add (upward) or
gather (downward) over all nodes of that depth and all disparities.
Depth-padded index matrices are precomputed on the host from the tree's
level offsets; a dummy slot (index N) absorbs padding lanes.

Exact up to the order of additions. The upward scatter-add repeats parents
(``index_add_``), whose summation order a CUDA device does not fix: compare
its results to a tolerance, never bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_stereo_matching_tpu_torch.tree.builder import SegmentTree


@dataclasses.dataclass(frozen=True)
class TreeFilterPlan:
    """Level-scan plan for one segment tree (host tensors; :meth:`to`
    moves them to a device)."""

    num_nodes: int
    level_idx: torch.Tensor     # (L-1, Wmax) int64 node ids, depth 1.. ; pad = N
    parent_idx: torch.Tensor    # (L-1, Wmax) int64 parent ids; pad = N
    parent_w: torch.Tensor      # (L-1, Wmax) f32 edge weights; pad = 0

    @staticmethod
    def from_tree(tree: SegmentTree, sigma: float) -> "TreeFilterPlan":
        n = tree.num_nodes
        weights = tree.parent_weights(sigma)
        starts = tree.level_start
        num_levels = tree.num_levels
        widths = np.diff(starts)[1:]  # per-depth node counts, depth >= 1
        wmax = int(widths.max()) if len(widths) else 1
        li = np.full((max(num_levels - 1, 1), wmax), n, np.int64)
        pi = np.full_like(li, n)
        pw = np.zeros(li.shape, np.float32)
        for l in range(1, num_levels):
            nodes = tree.bfs_order[starts[l] : starts[l + 1]]
            li[l - 1, : len(nodes)] = nodes
            pi[l - 1, : len(nodes)] = tree.parent[nodes]
            pw[l - 1, : len(nodes)] = weights[nodes]
        return TreeFilterPlan(
            num_nodes=n,
            level_idx=torch.from_numpy(li),
            parent_idx=torch.from_numpy(pi),
            parent_w=torch.from_numpy(pw),
        )

    def to(self, device) -> "TreeFilterPlan":
        return TreeFilterPlan(
            self.num_nodes, self.level_idx.to(device), self.parent_idx.to(device),
            self.parent_w.to(device),
        )


def tree_filter_nodes(cost_nodes: torch.Tensor, plan: TreeFilterPlan) -> torch.Tensor:
    """Aggregate (N, D) node-major costs over the tree → (N, D)."""
    n = plan.num_nodes
    pad = torch.zeros((1, cost_nodes.shape[1]), dtype=cost_nodes.dtype,
                      device=cost_nodes.device)
    buf = torch.cat([cost_nodes, pad], dim=0)  # (N+1, D)

    # leaf → root: deepest level first.
    for level in range(plan.level_idx.shape[0] - 1, -1, -1):
        idx, par, w = plan.level_idx[level], plan.parent_idx[level], plan.parent_w[level]
        vals = buf[idx] * w[:, None]
        buf.index_add_(0, par, vals)

    final = buf.clone()
    for level in range(plan.level_idx.shape[0]):
        idx, par, w = plan.level_idx[level], plan.parent_idx[level], plan.parent_w[level]
        wv = w[:, None]
        newv = wv * (final[par] - wv * buf[idx]) + buf[idx]
        final[idx] = newv
    return final[:n]


def tree_filter(
    cost_volume: torch.Tensor,
    tree: SegmentTree,
    sigma: float,
) -> torch.Tensor:
    """Aggregate a (D, H, W) cost volume over ``tree`` → (D, H, W), on the
    volume's device."""
    d, h, w = cost_volume.shape
    plan = TreeFilterPlan.from_tree(tree, sigma).to(cost_volume.device)
    nodes = cost_volume.movedim(0, -1).reshape(h * w, d)
    out = tree_filter_nodes(nodes, plan)
    return out.reshape(h, w, d).movedim(-1, 0)
