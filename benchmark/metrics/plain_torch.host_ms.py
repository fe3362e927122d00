"""The median, over the calls of the traced window, of the host's
milliseconds inside the spans ``bm.right_view`` and ``bm.lr_check``: the
plain-torch stages' enqueue, beside their device share
(``plain_torch.device_pct``)."""

from benchmark import spans

LAYER = "Plain-torch stages: block_matching.py::_right_view_sad, lr_consistency_mask"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    return spans.median_span_ms(run.trace, ("bm.right_view", "bm.lr_check"))
