"""gpu_stereo_matching_tpu_torch: the stereo engine in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

A port of ``gpu_stereo_matching_tpu`` (JAX on a TPU), which stays beside it
as the reference. The port mirrors its layout and names and imports
neither ``jax`` nor anything of the reference package: it keeps its own
copies of the plain-numpy host modules it uses (``core/config.py``, ``io/``,
``calib/rectify.py``). The configuration types, as the reference's top
level has them, and the host types and block-matching entry points of its
public API are re-exported here.
"""

from gpu_stereo_matching_tpu_torch.core.config import (  # noqa: F401
    BlockMatchingConfig,
    MeshConfig,
    SegmentTreeConfig,
)
from gpu_stereo_matching_tpu_torch.io.calib_yaml import StereoCalibration  # noqa: F401
from gpu_stereo_matching_tpu_torch.models.block_matching import (  # noqa: F401
    block_matching_pipeline,
)
from gpu_stereo_matching_tpu_torch.ops.postprocess import (  # noqa: F401
    lr_consistency_mask,
    median_filter_u8,
)

__version__ = "0.1.0"
