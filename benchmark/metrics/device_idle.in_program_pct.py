"""The share of the traced window in which the device stood idle while the
host was inside a call span (``run.call_span``, the rig's
``rig.process_batch``): the window minus the union of kernels, copies and
sets, intersected with the union of those spans, over the window. What is
left of ``device_idle_pct`` is the benchmark loop's."""

from benchmark import spans, trace

LAYER = "Device"
UNIT = "%"
MOVES = "frames_per_s"


def read(run):
    tr = run.trace
    found = spans.calls(tr, run.call_span)
    if not found:
        return None
    busy = [(o.start_us, o.end_us) for o in tr.device]
    # Idle inside the calls = |calls or busy| - |busy|.
    either_s = trace.union_s(busy + [(c.start_us, c.end_us) for c in found], tr.window)
    return 100.0 * (either_s - tr.busy_s) / tr.window_s
