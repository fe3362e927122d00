"""The median, over the calls of the traced window, of the host's
milliseconds inside the spans ``bm.right_view`` and ``bm.lr_check``, beside
the plain-torch stages' device share (``plain_torch.device_pct``). On the
bm+ path ``bm.lr_check`` holds one launch of E2's right-view body
(``lr_check_from_sad``); ``bm.right_view`` opens only on the reference path
(``block_matching_reference``)."""

from benchmark import spans

LAYER = "Plain-torch stages: the median's int32 cast and torch.stack, the one-launch bm.lr_check"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    return spans.median_span_ms(run.trace, ("bm.right_view", "bm.lr_check"), run.call_span)
