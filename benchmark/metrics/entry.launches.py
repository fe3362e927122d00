"""Kernel launches a call makes: the host's launch calls into the CUDA
runtime or driver (``cudaLaunchKernel``, ``cuLaunchKernel`` and their
variants) that start inside a call span (``run.call_span``, the rig's
``rig.process_batch``), over the number of such spans in the traced
window. The program's own kernels and the plain torch ones count alike."""

from benchmark import spans

LAYER = "Entry: StereoRig.process_batch"
UNIT = "launches"
MOVES = "frames_per_s"
API = ("cuda_runtime", "cuda_driver")


def read(run):
    found = spans.calls(run.trace, run.call_span)
    if not found:
        return None
    inside = spans.by_call(run.trace, found,
                           lambda o: o.category in API and "LaunchKernel" in o.name)
    return sum(len(ops) for ops in inside) / len(found)
