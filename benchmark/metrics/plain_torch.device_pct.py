"""The share of the device's busy time spent in kernels that are not the
program's own CUDA kernels (``kernels/csrc``): on the bm+ path the median's
int32 cast and the ``torch.stack`` of a batch's maps, in plain torch."""

from benchmark import trace

LAYER = "Plain-torch stages: the median's int32 cast and torch.stack, the one-launch bm.lr_check"
UNIT = "%"
MOVES = "frames_per_s"
# Every kernel of the program's kernels/csrc.
PROGRAM_KERNELS = frozenset((
    "front_end_kernel", "remap_u8_kernel", "gray_kernel", "sad_wta_kernel", "strip_kernel",
    "sad_wta_mma_kernel", "sad_key_kernel", "volume_strip_kernel", "sad_volume_kernel",
    "wta_kernel", "rank_select_kernel", "histogram_kernel",
))


def read(run):
    busy = run.trace.busy_s
    if busy <= 0:
        return None
    others = [o for o in run.trace.kernels() if o.name not in PROGRAM_KERNELS]
    return 100.0 * trace.union_s([(o.start_us, o.end_us) for o in others],
                                 run.trace.window) / busy
