"""The median's share of its roofline: the least time of the calls'
medians (``median_work``, Huang's count, one a frame) over the device time
of the kernels of ``kernels/ctmf_median.py``."""

from benchmark import roofline, trace

LAYER = "Median: kernels/ctmf_median.py"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS = ("rank_select_kernel", "histogram_kernel")


def read(run):
    seconds, _ = trace.kernel_seconds(run.trace, KERNELS)
    if seconds <= 0:
        return None
    h, w = run.config["image_hw"]
    least = roofline.bound_s(*roofline.median_work(h, w, run.config["median_radius"], run.batch))
    return 100.0 * run.traced_calls * least / seconds
