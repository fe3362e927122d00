"""The SAD volume's share of its roofline: the least time of the calls'
volumes (``sad_volume_work``, one a frame) over the device time of the
kernels of ``kernels/split_phase.py::sad_volume``."""

from benchmark import roofline, trace

LAYER = "SAD volume: kernels/split_phase.py::sad_volume"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS = ("volume_strip_kernel", "sad_volume_kernel")


def read(run):
    seconds, _ = trace.kernel_seconds(run.trace, KERNELS)
    if seconds <= 0:
        return None
    h, w = run.config["image_hw"]
    least = roofline.bound_s(*roofline.sad_volume_work(h, w, run.config["num_disparities"],
                                                       run.batch))
    return 100.0 * run.traced_calls * least / seconds
