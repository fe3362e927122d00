"""The segment tree: the host builder (C++ via ctypes), the stride-bucket
plan and filter, the heavy-path, plan-order and coded plans and filters,
and the level-scan filter; see each module's docstring."""

from gpu_stereo_matching_tpu_torch.tree.builder import (  # noqa: F401
    SegmentTree,
    build_segment_tree,
    color_depth_edge_weights,
    color_edge_weights,
)
from gpu_stereo_matching_tpu_torch.tree.filter import tree_filter  # noqa: F401
