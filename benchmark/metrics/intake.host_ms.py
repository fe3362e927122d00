"""The median, over the calls of the traced window, of the host's
milliseconds inside the span ``rig.intake`` (``StereoRig._intake``, both
views' frames): the checks of resident frames, or their copy to the card."""

from benchmark import spans

LAYER = "Frame intake: StereoRig._intake"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    return spans.median_span_ms(run.trace, ("rig.intake",), run.call_span)
