"""The argmin's share of its roofline: the least time of the calls'
argmins (``wta_work``; a frame takes one, two with the LR check) over the
device time of the kernel of ``kernels/split_phase.py::wta_from_sad``."""

from benchmark import roofline, trace

LAYER = "Argmin: kernels/split_phase.py::wta_from_sad"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS = ("wta_kernel",)


def read(run):
    seconds, _ = trace.kernel_seconds(run.trace, KERNELS)
    if seconds <= 0:
        return None
    h, w = run.config["image_hw"]
    volumes = run.batch * (2 if run.config["lr_consistency"] else 1)
    least = roofline.bound_s(*roofline.wta_work(h, w, run.config["num_disparities"], volumes))
    return 100.0 * run.traced_calls * least / seconds
