from gpu_stereo_matching_tpu_torch.io.images import (  # noqa: F401
    load_image_bgr,
    load_image_gray,
    save_image,
)
from gpu_stereo_matching_tpu_torch.io.calib_yaml import (  # noqa: F401
    StereoCalibration,
    load_opencv_stereo_yaml,
)
from gpu_stereo_matching_tpu_torch.io.middlebury import (  # noqa: F401
    MiddleburyScene,
    list_middlebury_scenes,
    load_middlebury_scene,
)
