"""The pipelines: block matching, the segment-tree matchers and the rig;
see the package docstring."""

from gpu_stereo_matching_tpu_torch.models.block_matching import (  # noqa: F401
    block_matching_disparity,
    block_matching_pipeline,
)
from gpu_stereo_matching_tpu_torch.models.segment_tree import (  # noqa: F401
    segment_tree_disparity,
    st1_disparity,
    st2_disparity,
)
from gpu_stereo_matching_tpu_torch.models.streaming import (  # noqa: F401
    StereoRig,
    rig_from_yaml,
)
