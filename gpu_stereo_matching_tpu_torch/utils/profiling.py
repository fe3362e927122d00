"""Structured per-stage timing and the spans of the profiler's trace.

The port of ``gpu_stereo_matching_tpu/utils/profiling.py``:

* :class:`StageTimer` — wall-clock stage spans, fenced so that work a stage
  enqueued on a card is attributed to that stage: PyTorch returns from a
  launch before the device finishes, so the span closes after
  ``torch.cuda.synchronize`` on the device of the tensors it is given. On the
  CPU there is nothing to wait for.
* :func:`span` — a named host span in the ``torch.profiler`` trace, on the
  clock of the card's kernels, copies and runtime calls; open only while a
  profiler runs, and otherwise one check and nothing more.
* :func:`trace` — a ``torch.profiler`` trace of the host and the card,
  written as TensorBoard-readable files; the spans of :func:`span` are
  among its user annotations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import torch


@dataclasses.dataclass
class StageSpan:
    name: str
    seconds: float


def _fence(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree`` (a tensor,
    or lists, tuples and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        _fence(list(tree.values()))
    elif isinstance(tree, (list, tuple)):
        for leaf in tree:
            _fence(leaf)


class StageTimer:
    """Accumulates named stage timings; device work is fenced per stage."""

    def __init__(self) -> None:
        self.spans: List[StageSpan] = []

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        """Time a stage. The devices of ``fence`` (a tensor or a nest of
        them) are waited for before the span closes, so that work launched
        asynchronously is attributed to the stage that launched it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence)
            self.spans.append(StageSpan(name, time.perf_counter() - t0))

    def record(self, name: str, seconds: float) -> None:
        self.spans.append(StageSpan(name, seconds))

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.spans)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    def summary(self) -> str:
        parts = [f"{s.name}={s.seconds * 1e3:.2f}ms" for s in self.spans]
        return " ".join(parts) + f" total={self.total_seconds * 1e3:.2f}ms"


# Whether a profiler is collecting: the one check a span makes when none
# is.
_profiling = torch._C._autograd._profiler_enabled
# Stateless and reusable: a span off hands out this one object.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A host span named ``name`` (``<component>.<stage>``) in the trace of
    a running ``torch.profiler``: its ``record_function``, a user
    annotation on the same clock as the card's kernels, copies and runtime
    calls. With no profiler active it creates no ``RecordFunction``, reads
    no clock and allocates nothing: a shared null context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context: host activity, and the card's where
    there is one, written under ``log_dir`` for TensorBoard."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
