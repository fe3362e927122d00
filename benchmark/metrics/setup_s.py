"""Seconds from the start of the run's process to its first timed call:
imports, the CUDA context, the kernel library (built on a checkout's first
run, loaded afterwards), the rig's maps, the frames from the seed and the
warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
