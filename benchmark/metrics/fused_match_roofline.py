"""Fused matching's share of its roofline: the least time of the calls'
fused SAD + WTA (``fused_sad_work``) over the device time of every kernel
that ``kernels/sad_wta.py`` launches for it."""

from benchmark import roofline, trace

LAYER = "Fused matching: kernels/sad_wta.py"
UNIT = "%"
MOVES = "frames_per_s"
KERNELS = ("sad_wta_kernel", "strip_kernel", "sad_wta_mma_kernel")


def read(run):
    seconds, _ = trace.kernel_seconds(run.trace, KERNELS)
    if seconds <= 0:
        return None
    h, w = run.config["image_hw"]
    least = roofline.bound_s(*roofline.fused_sad_work(h, w, run.config["num_disparities"],
                                                      run.batch))
    return 100.0 * run.traced_calls * least / seconds
