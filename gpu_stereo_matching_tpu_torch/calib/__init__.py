from gpu_stereo_matching_tpu_torch.calib.rectify import (  # noqa: F401
    RectificationResult,
    stereo_rectify,
    undistort_rectify_maps,
    rectification_maps_from_calibration,
)
