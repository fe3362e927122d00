"""The device trace of a window, and what the per-layer readers take from it.

:func:`profiled` runs a part of the window under ``torch.profiler`` with
host and CUDA activity (the pattern of the program's
``utils/profiling.py::trace``), inside a ``bench.window`` annotation that
marks the traced window. The trace is exported as Chrome JSON under the
run's temporary directory, read back and deleted.

Device time is the union of kernel, copy and set intervals. A kernel is
named by its function's own identifier, without namespaces, template
arguments or parameters, and assigned to a layer only by equality with a
name that a reader lists: ``strip_kernel`` is not ``volume_strip_kernel``.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
import os
import re
import tempfile
from typing import Callable, Dict, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclasses.dataclass
class Op:
    name: str       # the kernel's identifier, or the copy's or set's trace name
    category: str
    start_us: float
    end_us: float
    nbytes: int = 0


@dataclasses.dataclass
class Trace:
    device: List[Op]
    host: List[Op]
    window: Tuple[float, float]  # the traced window, microseconds on the trace's clock

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_s([(o.start_us, o.end_us) for o in self.device], self.window)

    def kernels(self) -> List[Op]:
        return [o for o in self.device if o.category == "kernel"]


def _mangled_name(name: str) -> str:
    """The last identifier of an Itanium-mangled name (``_ZN...E``)."""
    i = 2
    nested = name[i:i + 1] == "N"
    i += nested
    last = name
    while i < len(name):
        while i < len(name) and name[i] in "KVrL":
            i += 1
        m = re.match(r"\d+", name[i:])
        if not m:
            break
        n = int(m.group())
        i += len(m.group())
        last = name[i:i + n]
        i += n
        if not nested:
            break
    return last


def kernel_name(name: str) -> str:
    """A kernel's own identifier from its demangled (or mangled) name:
    ``void (anonymous namespace)::front_end_kernel<true>(View, int)`` ->
    ``front_end_kernel``."""
    s = name.strip()
    if s.startswith("_Z"):
        return _mangled_name(s)
    for close, open_ in ((")", "("), (">", "<")):
        while s.endswith(close):
            depth = 0
            for i in range(len(s) - 1, -1, -1):
                if s[i] == close:
                    depth += 1
                elif s[i] == open_:
                    depth -= 1
                    if depth == 0:
                        s = s[:i].rstrip()
                        break
            else:
                break
    return s.split(" ")[-1].split("::")[-1]


def union_s(intervals: Iterable[Tuple[float, float]],
            clip: Optional[Tuple[float, float]] = None) -> float:
    """Seconds covered by the union of (start, end) microsecond intervals,
    clipped to ``clip``."""
    spans = sorted(intervals)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if clip is not None:
            s, e = max(s, clip[0]), min(e, clip[1])
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def parse(events: List[dict]) -> Trace:
    """The device and host operations of Chrome trace events, and the
    window that the ``bench.window`` annotation marks."""
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        start = float(ev["ts"])
        end = start + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            name = kernel_name(ev["name"]) if cat == "kernel" else ev["name"]
            device.append(Op(name, cat, start, end, int(ev.get("args", {}).get("bytes", 0))))
        elif cat in HOST_CATEGORIES:
            if cat == "user_annotation" and ev["name"] == WINDOW:
                window = (start, end)
            else:
                host.append(Op(ev["name"], cat, start, end))
    if window is None:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    device.sort(key=lambda o: o.start_us)
    host.sort(key=lambda o: o.start_us)
    return Trace(device, host, window)


def profiled(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler, inside the window annotation; return
    its result and the parsed trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return result, parse(events)


def seconds_by_name(ops: Iterable[Op]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for o in ops:
        out[o.name] = out.get(o.name, 0.0) + (o.end_us - o.start_us) * 1e-6
    return out


def kernel_seconds(trace: Trace, names: Iterable[str]) -> Tuple[float, int]:
    """Seconds and launches of the kernels whose identifier is one of ``names``."""
    wanted = set(names)
    ops = [o for o in trace.kernels() if o.name in wanted]
    return sum((o.end_us - o.start_us) * 1e-6 for o in ops), len(ops)


def idle_gaps(trace: Trace) -> Dict[str, float]:
    """Seconds the device stood idle inside the window, by what the host
    was doing when each gap began: the outermost benchmark annotation and
    the innermost operation that covered that instant."""
    w0, w1 = trace.window
    gaps, cursor = [], w0
    for o in trace.device:
        if o.start_us > cursor:
            gaps.append((cursor, min(o.start_us, w1)))
        cursor = max(cursor, o.end_us)
    if cursor < w1:
        gaps.append((cursor, w1))
    out: Dict[str, float] = {}
    starts = [o.start_us for o in trace.host]
    active: List[Tuple[float, int]] = []  # (end, index) of host ops begun so far
    j = 0
    for a, b in sorted(gaps):
        if b <= a:
            continue
        j_new = bisect.bisect_right(starts, a)
        for k in range(j, j_new):
            heapq.heappush(active, (trace.host[k].end_us, k))
        j = j_new
        while active and active[0][0] <= a:
            heapq.heappop(active)
        covering = sorted((trace.host[k] for _, k in active), key=lambda o: o.start_us)
        outer = next((o.name for o in covering if o.category == "user_annotation"), None)
        inner = covering[-1].name if covering else "python"
        label = inner if outer in (None, inner) else f"{outer} > {inner}"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def top(entries: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(entries.items(), key=lambda kv: -kv[1])[:n]]
