"""The readers of the program's spans (``spans.py``) on a canned list of
profiler events: calls cut by the window's edges are left out, and so are
launches and idle time outside the calls."""

import types

import pytest

from benchmark import spans, trace
from benchmark.registry import Registry


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


def _span(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _launch(ts, name="cudaLaunchKernel", cat="cuda_runtime"):
    return _x(cat, name, ts, 5.0)


# A window of 1000 us. Two calls wholly inside it (50-450, 500-800), one cut
# by its start (-50-30) and one by its end (900-1100); launches and a kernel
# between and around the calls.
EVENTS = [
    _span(trace.WINDOW, 0.0, 1000.0),
    _span(spans.CALL, -50.0, 80.0), _launch(10.0), _span("rig.intake", -40.0, 10.0),
    _span(spans.CALL, 50.0, 400.0),
    _span("rig.intake", 60.0, 10.0), _span("rig.intake", 70.0, 10.0),
    _span("rig.front_end", 80.0, 20.0), _launch(90.0),
    _span("bm.right_view", 200.0, 60.0), _launch(210.0), _x("cpu_op", "aten::gather", 205.0, 20.0),
    _span("bm.lr_check", 300.0, 40.0), _launch(310.0, "cuLaunchKernel", "cuda_driver"),
    _launch(320.0, "cudaLaunchKernelExC"), _x("cuda_runtime", "cudaEventRecord", 400.0, 5.0),
    _launch(470.0),
    _span(spans.CALL, 500.0, 300.0),
    _span("rig.intake", 510.0, 20.0), _span("rig.intake", 530.0, 10.0), _launch(550.0),
    _span("bm.right_view", 600.0, 100.0), _launch(650.0), _span("bm.lr_check", 700.0, 10.0),
    _span(spans.CALL, 900.0, 200.0), _span("rig.intake", 910.0, 10.0), _launch(950.0),
    _x("kernel", "void front_end_kernel<true>(View)", 100.0, 200.0),
    _x("kernel", "wta_kernel", 600.0, 50.0),
    _x("kernel", "rank_select_kernel", 820.0, 50.0),
]


def _read(name, events=EVENTS, call_span=spans.CALL):
    run = types.SimpleNamespace(trace=trace.parse(events), call_span=call_span)
    return Registry().metric(name).read(run)


def test_only_calls_wholly_inside_the_window_count():
    found = spans.calls(trace.parse(EVENTS))
    assert [(c.start_us, c.end_us) for c in found] == [(50.0, 450.0), (500.0, 800.0)]


def test_launches_a_call_counts_its_own_only():
    # 4 in the first call (runtime, driver and the Ex variant), 2 in the second;
    # those at 10, 470 and 950 lie outside a counted call, the event record is none.
    assert _read("entry.launches") == pytest.approx(3.0)


def test_idle_in_the_program_leaves_out_the_loop():
    # Calls 50-450 and 500-800 hold 700 us; the device is busy 100-300 and
    # 600-650 inside them: 450 us idle in calls, of a 1000 us window. The kernel
    # at 820-870 and the idle time around the calls do not count.
    assert _read("device_idle.in_program_pct") == pytest.approx(45.0)
    device_idle = _read("device_idle_pct")
    assert device_idle == pytest.approx(70.0) and _read("device_idle.in_program_pct") <= device_idle


def test_span_medians_per_call():
    # Right view and LR check: 100 us, then 110 us; intake 20 us, then 30 us.
    assert _read("plain_torch.host_ms") == pytest.approx(0.105)
    assert _read("intake.host_ms") == pytest.approx(0.025)


@pytest.mark.parametrize("name", ["entry.launches", "device_idle.in_program_pct",
                                  "plain_torch.host_ms", "intake.host_ms"])
def test_a_trace_without_the_spans_or_the_device_gives_nothing(name):
    """The parent's program opens no span; the CPU has no device trace."""
    no_spans = [e for e in EVENTS if e["name"] not in spans.CALL
                and not e["name"].startswith(("rig.", "bm."))]
    no_spans.append(_span(trace.WINDOW, 0.0, 1000.0))
    assert _read(name, no_spans) is None
    assert _read(name, [e for e in EVENTS if e["cat"] != "kernel"]) is None


@pytest.mark.parametrize("name", ["entry.launches", "device_idle.in_program_pct",
                                  "plain_torch.host_ms", "intake.host_ms"])
def test_calls_are_the_spans_the_system_names(name):
    """A system whose entry opens ``st.process_batch`` gets the same readings
    from its own calls, and none under the rig's name."""
    renamed = [{**e, "name": "st.process_batch"} if e["name"] == spans.CALL else e
               for e in EVENTS]
    assert _read(name, renamed, "st.process_batch") == pytest.approx(_read(name))
    assert _read(name, renamed) is None


def test_fused_calls_have_no_plain_torch_spans():
    fused = [e for e in EVENTS if e["name"] not in ("bm.right_view", "bm.lr_check")]
    assert _read("plain_torch.host_ms", fused) is None
    assert _read("intake.host_ms", fused) == pytest.approx(0.025)


def test_idle_gaps_inside_a_call_carry_its_spans():
    """``trace.idle_gaps`` names a gap by the outermost span and the innermost
    host operation at the instant it begins."""
    gaps = trace.idle_gaps(trace.parse(EVENTS))
    assert gaps == pytest.approx({
        spans.CALL: 100e-6,  # 0-100, inside the call cut by the window's start
        f"{spans.CALL} > bm.lr_check": 300e-6,  # 300-600
        f"{spans.CALL} > cudaLaunchKernel": 170e-6,  # 650-820
        "python": 130e-6,  # 870-1000: the loop's own
    })
