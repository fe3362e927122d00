"""Port ``utils/profiling.py`` against the JAX package's: the same spans,
dictionaries, summaries and JSON records from the same calls, the fence on
tensors and nests of them, and a ``torch.profiler`` trace that writes files."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.utils import profiling as jprof
from gpu_stereo_matching_tpu_torch.utils import profiling as tprof


def _drive(mod, fence):
    timer = mod.StageTimer()
    with timer.stage("gray"):
        time.sleep(0.002)
    with timer.stage("match", fence=fence):
        pass
    with timer.stage("gray"):
        pass
    timer.record("upload", 0.25)
    return timer


def test_stage_timer_matches_jax_timer():
    port = _drive(tprof, torch.zeros(3))
    ref = _drive(jprof, jnp.zeros(3))
    assert [s.name for s in port.spans] == [s.name for s in ref.spans]
    assert list(port.as_dict()) == list(ref.as_dict()) == ["gray", "match", "upload"]
    assert port.as_dict()["upload"] == ref.as_dict()["upload"] == 0.25
    assert port.as_dict()["gray"] == port.spans[0].seconds + port.spans[2].seconds >= 0.002
    assert port.total_seconds == pytest.approx(sum(port.as_dict().values()))
    # The same text but for the measured digits.
    strip = lambda text: "".join(c for c in text if not c.isdigit())  # noqa: E731
    assert strip(port.summary()) == strip(ref.summary())
    assert port.summary().endswith(f"total={port.total_seconds * 1e3:.2f}ms")


def test_stage_records_the_span_when_the_body_raises():
    for mod in (tprof, jprof):
        timer = mod.StageTimer()
        with pytest.raises(KeyError):
            with timer.stage("broken"):
                raise KeyError("x")
        assert [s.name for s in timer.spans] == ["broken"]


@pytest.mark.parametrize("fence", [
    torch.zeros(2), [torch.zeros(2), (torch.ones(1),)], {"a": torch.zeros(1), "b": [None, 3]},
    np.zeros(2), None,
])
def test_fence_takes_tensors_and_nests_on_the_cpu(fence):
    """On the CPU there is nothing to wait for; a nest of tensors, or leaves
    that are no tensors, pass through."""
    timer = tprof.StageTimer()
    with timer.stage("s", fence=fence):
        pass
    assert len(timer.spans) == 1 and timer.spans[0].seconds >= 0


def test_fence_waits_for_a_cuda_tensors_device(monkeypatch):
    """A CUDA tensor's device is synchronized before the span closes, a CPU
    tensor's is not (a tensor subclass that reports a CUDA device stands in
    for a tensor on a card)."""
    waited = []
    monkeypatch.setattr(tprof.torch.cuda, "synchronize", waited.append)

    class OnCard(torch.Tensor):
        device = torch.device("cuda", 1)

    fake = torch.zeros(1).as_subclass(OnCard)
    timer = tprof.StageTimer()
    with timer.stage("frame", fence=[torch.zeros(1), fake]):
        assert waited == []
    assert waited == [torch.device("cuda", 1)]


def test_stage_span_fields_match_jax_record():
    assert [f.name for f in dataclasses.fields(tprof.StageSpan)] == [
        f.name for f in dataclasses.fields(jprof.StageSpan)]


def _refuse(*args, **kwargs):
    raise AssertionError("a RecordFunction was made with no profiler active")


def test_span_off_makes_no_record_function(monkeypatch):
    """With no profiler active a span is the one shared null context: no
    ``record_function``, no ``RecordFunction`` behind it."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", _refuse)
    assert not torch._C._autograd._profiler_enabled()
    with tprof.span("rig.intake") as inner:
        assert inner is None
    assert tprof.span("a") is tprof.span("b")


def test_span_on_is_a_user_annotation_of_the_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.span("rig.match"):
            torch.ones(8).sum()
        with tprof.span("rig.match"):
            pass
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["rig.match"] == 2
    assert tprof.span("rig.match") is tprof.span("x")  # off again once it stopped


def test_trace_writes_a_profile(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert list(tmp_path.iterdir())
