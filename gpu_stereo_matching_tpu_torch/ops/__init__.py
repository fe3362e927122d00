"""Plain torch stages; see the package docstring. The gray conversions are
``ops/color.py``'s plain versions, as in the reference's ``ops``, not the
kernels of ``kernels/gray.py``."""

from gpu_stereo_matching_tpu_torch.ops.color import (  # noqa: F401
    gradient_x,
    gray_blockmatching_bgr,
    gray_rec601_bgr,
    grayscale_u8,
    round_sat_u8,
)
from gpu_stereo_matching_tpu_torch.ops.cost import (  # noqa: F401
    ad_cost_volume,
    color_gradient_cost_volume,
    right_cost_from_left,
)
from gpu_stereo_matching_tpu_torch.ops.aggregate import (  # noqa: F401
    aggregate_cost_volume,
    box_filter_sum,
    window_counts,
)
from gpu_stereo_matching_tpu_torch.ops.wta import wta_disparity  # noqa: F401
from gpu_stereo_matching_tpu_torch.ops.postprocess import (  # noqa: F401
    lr_consistency_mask,
    median_filter_u8,
)
from gpu_stereo_matching_tpu_torch.ops.remap import remap_bilinear_u8  # noqa: F401
