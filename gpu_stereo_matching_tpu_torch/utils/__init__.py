"""Profiling and the artifact cache; see the package docstring."""

from gpu_stereo_matching_tpu_torch.utils.cache import ArtifactCache  # noqa: F401
from gpu_stereo_matching_tpu_torch.utils.profiling import StageTimer  # noqa: F401
