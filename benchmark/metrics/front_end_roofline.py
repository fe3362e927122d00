"""The front end's share of its roofline: the least time of the calls'
gray and remap of both views (``remap_work``) over the device time of the
kernels that implement it."""

from benchmark import roofline, trace

LAYER = "Front end: kernels/remap.py::rectify_gray_pair"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS = ("front_end_kernel",)


def read(run):
    seconds, _ = trace.kernel_seconds(run.trace, KERNELS)
    if seconds <= 0:
        return None
    h, w = run.config["image_hw"]
    least = roofline.bound_s(*roofline.remap_work(run.batch, h * w, 2, bgr=True))
    return 100.0 * run.traced_calls * least / seconds
