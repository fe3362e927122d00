"""Plain torch stages; see the package docstring."""

from gpu_stereo_matching_tpu_torch.ops.postprocess import (  # noqa: F401
    lr_consistency_mask,
    median_filter_u8,
)
