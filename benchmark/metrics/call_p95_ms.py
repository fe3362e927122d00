"""The 95th percentile, over every call of the window, of a call's
milliseconds from submission until its maps are ready (host clock at
submission; the call's event, read on the host's time line, at the end)."""

from benchmark import window


def read(run):
    return window.percentile(window.latency_ms(run.calls), 95)
