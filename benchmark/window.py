"""The measured window: a closed loop of calls, and the arithmetic of its
rate and tail.

The loop keeps at most ``in_flight`` calls outstanding: before each call it
waits on the oldest one's event. A call is stamped with the host clock just
before it is made and just after it returns; an event recorded after it
marks when the device has finished its work. Events are put on the host's
time line by two anchors, one on the idle device before the window and one
after its last call (``CudaClock``), so a call's completion is read where it
happened, wherever the loop happened to be when it finished.

On the CPU (the tests), a call's work is done when it returns.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import random
import statistics
import time
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class Call:
    index: int
    frames: int
    submit_s: float          # host clock just before the call
    return_s: float          # host clock when the call returned
    event: object = None
    done_s: Optional[float] = None  # when the device finished, on the host's time line


class CudaClock:
    """Events on the current stream, read on the host's time line.

    An anchor is an event recorded on the idle device and bracketed by the
    host clock from just before its record to just after its wait; of
    ``ANCHOR_ROUNDS`` tries the tightest bracket is kept, and its middle is
    the event's host time. One anchor at the window's start and one after
    its last call map every event between them linearly, so neither the
    start's offset nor a drift of the device's timer against the host's
    clock over the window moves a call's completion by more than the
    brackets' few microseconds."""

    ANCHOR_ROUNDS = 64

    def __init__(self, device: torch.device) -> None:
        self.device = device

    def _anchor(self) -> tuple:
        torch.cuda.synchronize(self.device)
        best = None
        for _ in range(self.ANCHOR_ROUNDS):
            ev = torch.cuda.Event(enable_timing=True)
            before = time.perf_counter()
            ev.record()
            ev.synchronize()
            after = time.perf_counter()
            if best is None or after - before < best[2] - best[1]:
                best = (ev, before, after)
        return best

    def start(self) -> float:
        self._start = self._anchor()
        self._t0 = 0.5 * (self._start[1] + self._start[2])
        return self._t0

    def finish(self) -> None:
        """The second anchor, once every call has finished."""
        end = self._anchor()
        self._device_s = self._start[0].elapsed_time(end[0]) * 1e-3
        self._host_s = 0.5 * (end[1] + end[2]) - self._t0
        self._end = end

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def wait(ev) -> None:
        ev.synchronize()

    def done_s(self, ev) -> float:
        return self._t0 + self._start[0].elapsed_time(ev) * 1e-3 * (self._host_s / self._device_s)

    def report(self) -> dict:
        """The anchors' brackets, and how far the device's timer and the
        host's clock drifted apart between them, in microseconds."""
        return {"anchor_us": [(a[2] - a[1]) * 1e6 for a in (self._start, self._end)],
                "drift_us": (self._host_s - self._device_s) * 1e6,
                "span_s": self._host_s}


class HostClock:
    """The CPU's stand-in: a call's work is done when it returns."""

    def start(self) -> float:
        return time.perf_counter()

    @staticmethod
    def finish() -> None:
        pass

    @staticmethod
    def mark():
        return time.perf_counter()

    @staticmethod
    def wait(ev) -> None:
        pass

    @staticmethod
    def done_s(ev) -> float:
        return ev

    @staticmethod
    def report() -> dict:
        return {}


class Sample:
    """The calls whose outputs the check compares, drawn from the seed: for
    each batch of the pool, one of its calls drawn uniformly (reservoir
    sampling) and its last call. So every batch of the pool is compared,
    once late in the window, and a map that is left unchanged, or goes stale
    as the window runs, differs from some batch's reference. Only the kept
    outputs stay alive."""

    def __init__(self, seed: int, pool_batches: int) -> None:
        self.rng = random.Random(seed)
        self.pool_batches = pool_batches
        self.drawn: dict = {}
        self.last: dict = {}
        self.count: dict = {}
        self.seen = 0

    def offer(self, index: int, output) -> None:
        p = index % self.pool_batches
        self.seen += 1
        self.count[p] = self.count.get(p, 0) + 1
        if self.rng.randrange(self.count[p]) == 0:
            self.drawn[p] = (index, output)
        self.last[p] = (index, output)

    @property
    def kept(self) -> List[tuple]:
        """(index, output) of each kept call, in the order of the calls."""
        found = dict(self.drawn.values())
        found.update(self.last.values())
        return sorted(found.items(), key=lambda kv: kv[0])


def closed_loop(step: Callable, pool: list, frames_per_call: int, seconds: float,
                in_flight: int, clock, sample: Sample, first_index: int = 0) -> tuple:
    """Call ``step(*pool[k % len(pool)])`` for ``seconds`` with at most
    ``in_flight`` calls outstanding. Returns (calls, window start, window end);
    every call has finished and has its ``done_s``."""
    calls: List[Call] = []
    pending = collections.deque()
    t_start = clock.start()
    t_end = t_start + seconds
    k = first_index
    while True:
        while len(pending) >= in_flight:
            clock.wait(pending.popleft().event)
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        out = step(*pool[k % len(pool)])
        t1 = time.perf_counter()
        call = Call(k, frames_per_call, t0, t1, clock.mark())
        calls.append(call)
        pending.append(call)
        sample.offer(k, out)
        del out
        k += 1
    for call in pending:
        clock.wait(call.event)
    clock.finish()
    for call in calls:
        call.done_s = clock.done_s(call.event)
        call.event = None
    return calls, t_start, t_end


def frames_per_s(calls: List[Call], t_start: float, t_end: float) -> float:
    """Frames done in the window, over its seconds, read off the cumulative
    frames-done curve at the window's two edges. The curve steps by a call's
    frames where it finished; at an edge it is read by linear interpolation
    between the last completion before the edge and the first after it, so
    the reading carries no quantum of a call whatever the phase of the
    window against the completions. Where no completion lies after the end,
    the end is read as a step: the frames of the calls that finished inside.
    The closed loop starts on an idle card, so no completion lies before the
    start and the start reads 0; a stall in the window costs its time."""
    done = sorted((c.done_s, c.frames) for c in calls)
    times = [t for t, _ in done]
    before = list(itertools.accumulate((f for _, f in done), initial=0))

    def curve(t: float, k: int) -> float:
        # ``k`` completions lie before ``t``; the next ones, at one instant,
        # count in proportion to how far ``t`` lies toward them.
        if k == len(done):
            return before[k]
        prev = times[k - 1] if k else t_start
        if t <= prev:
            return before[k]
        at_next = bisect.bisect_right(times, times[k])
        return before[k] + (before[at_next] - before[k]) * (t - prev) / (times[k] - prev)

    start = curve(t_start, bisect.bisect_left(times, t_start))
    end = curve(t_end, bisect.bisect_right(times, t_end))
    return (end - start) / (t_end - t_start)


def latency_ms(calls: List[Call]) -> List[float]:
    """Each call's milliseconds from submission until its maps were ready."""
    return [(c.done_s - c.submit_s) * 1e3 for c in calls]


def percentile(values: List[float], q: int) -> float:
    """The ``q``-th percentile (1..99) by ``statistics.quantiles``' inclusive
    method."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def enqueue_ms(calls: List[Call]) -> List[float]:
    """Each call's milliseconds on the host until it returned."""
    return [(c.return_s - c.submit_s) * 1e3 for c in calls]
