"""Configuration and input checks; see the package docstring."""

from gpu_stereo_matching_tpu_torch.core.config import (  # noqa: F401
    BlockMatchingConfig,
    CostConstants,
    MeshConfig,
    SegmentTreeConfig,
)
