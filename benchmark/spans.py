"""The program's own spans in a traced window: the calls of a system's
entry and what the host did inside them.

The program opens its spans (``gpu_stereo_matching_tpu_torch/utils/profiling.py::
span``) only while a profiler runs, as user annotations on the clock of the
trace's kernels and runtime calls. A call is a span named by the system's
``CALL_SPAN`` (``CALL``, the rig's, where it names none; the readers take it
from ``run.call_span``) that lies wholly inside the window. A program
without the spans has no calls, and a trace without device activity (the
CPU's plain twins, whose host time is the work itself) is not read: the
readers of both return nothing.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Sequence

from benchmark.trace import Op, Trace

CALL = "rig.process_batch"


def calls(tr: Trace, call: str = CALL) -> List[Op]:
    """The spans named ``call`` wholly inside the window, in order; none
    where the trace has no device activity."""
    if not tr.device:
        return []
    w0, w1 = tr.window
    return [o for o in tr.host if o.category == "user_annotation" and o.name == call
            and w0 <= o.start_us and o.end_us <= w1]


def by_call(tr: Trace, found: List[Op], keep) -> List[List[Op]]:
    """For each call of ``found``, the host operations ``keep(op)`` accepts
    that start inside it (a call's spans do not overlap another's)."""
    starts = [c.start_us for c in found]
    out: List[List[Op]] = [[] for _ in found]
    for o in tr.host:
        i = bisect.bisect_right(starts, o.start_us) - 1
        if i >= 0 and o.start_us < found[i].end_us and o is not found[i] and keep(o):
            out[i].append(o)
    return out


def median_span_ms(tr: Trace, names: Sequence[str], call: str = CALL) -> Optional[float]:
    """The median over the calls (spans ``call``) of the milliseconds a
    call spent in the spans ``names``; nothing where no call opened one."""
    found = calls(tr, call)
    inside = by_call(tr, found, lambda o: o.category == "user_annotation" and o.name in names)
    if not any(inside):
        return None
    return statistics.median(sum(o.end_us - o.start_us for o in ops) * 1e-3 for ops in inside)
