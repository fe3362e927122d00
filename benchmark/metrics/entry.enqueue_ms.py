"""The median, over the calls of the untraced part of a traced run, of the
host's milliseconds inside ``StereoRig.process_batch``: from just before the
call until it returns (the benchmark's own span around the entry)."""

import statistics

from benchmark import window

LAYER = "Entry: StereoRig.process_batch"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    return statistics.median(window.enqueue_ms(run.span_calls)) if run.span_calls else None
