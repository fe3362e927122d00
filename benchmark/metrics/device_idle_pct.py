"""The share of the traced window in which no kernel, copy or set ran on
the device: the window minus the union of their intervals, over the window."""

LAYER = "Device"
UNIT = "%"
MOVES = "frames_per_s"


def read(run):
    return 100.0 * (run.trace.window_s - run.trace.busy_s) / run.trace.window_s
