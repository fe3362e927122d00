"""Hand-written CUDA kernels and their wrappers; sources in ``csrc/``."""

from gpu_stereo_matching_tpu_torch.kernels.ctmf_median import ctmf_median_u8  # noqa: F401
from gpu_stereo_matching_tpu_torch.kernels.gray import (  # noqa: F401
    gray_blockmatching_bgr,
    gray_rec601_bgr,
    grayscale_u8,
)
from gpu_stereo_matching_tpu_torch.kernels.remap import (  # noqa: F401
    rectify_gray_pair,
    remap_bilinear_u8_direct,
)
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import (  # noqa: F401
    fused_block_matching,
    fused_block_matching_batched,
    fused_block_matching_key,
)
from gpu_stereo_matching_tpu_torch.kernels.split_phase import (  # noqa: F401
    sad_volume,
    split_phase_block_matching,
    wta_from_sad,
)
