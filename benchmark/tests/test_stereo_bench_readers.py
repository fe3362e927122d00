"""The trace's arithmetic and the metric readers on a canned list of
profiler events."""

import types

import pytest

from benchmark import trace
from benchmark.registry import Registry


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


# One window of 1000 us on the trace's clock: two calls of the fused rig
# (front end, then the strip body), a volume-strip kernel that must not count
# as fused matching, a plain torch kernel, an upload and a set.
EVENTS = [
    {"ph": "M", "name": "process_name", "args": {"name": "python3"}},
    _x("user_annotation", trace.WINDOW, 0.0, 1000.0),
    _x("kernel", "void (anonymous namespace)::front_end_kernel<true>(View, View, int, int)",
       100.0, 50.0),
    _x("kernel", "void gsm::strip_kernel<5, gsm::KeepMinKey<int> >(unsigned char const*, int)",
       150.0, 200.0),
    _x("kernel", "_ZN12_GLOBAL__N_116front_end_kernelILb1EEEvNS_4ViewES1_iiii", 400.0, 50.0),
    _x("kernel", "_Z12strip_kernelILi5EEvPKhS1_Piiiii", 450.0, 200.0),
    _x("kernel", "void volume_strip_kernel<5>(unsigned char const*, int)", 700.0, 50.0),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>,"
       " std::array<char*, 1ul> >(int, at::native::FillFunctor<int>, std::array<char*, 1ul>)",
       740.0, 20.0),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 800.0, 100.0, bytes=1 << 22),
    _x("gpu_memset", "Memset (Device)", 850.0, 100.0),
    _x("gpu_user_annotation", "bench.call", 0.0, 1000.0),
    _x("cpu_op", "aten::empty", 0.0, 20.0),
    _x("cuda_runtime", "cudaEventSynchronize", 640.0, 60.0),
]


@pytest.fixture
def tr():
    return trace.parse(EVENTS)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::front_end_kernel<true>(View, int)", "front_end_kernel"),
    ("void gsm::strip_kernel<5, gsm::KeepMinKey<int> >(unsigned char const*)", "strip_kernel"),
    ("volume_strip_kernel", "volume_strip_kernel"),
    ("_Z10wta_kernelPKiPiii", "wta_kernel"),
    ("_ZN12_GLOBAL__N_116front_end_kernelILb1EEEvNS_4ViewE", "front_end_kernel"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl<F>("
     "at::TensorIteratorBase&, F const&)::{lambda(int)#1}>(int, at::native::gpu_kernel_impl<F>("
     "at::TensorIteratorBase&, F const&)::{lambda(int)#1})", "elementwise_kernel"),
])
def test_kernel_name_is_the_function_identifier(name, want):
    assert trace.kernel_name(name) == want


def test_union_clips_and_merges():
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    assert trace.union_s([(0, 10), (5, 20)], clip=(8, 12)) == pytest.approx(4e-6)
    assert trace.union_s([]) == 0.0


def test_busy_is_the_union_with_copies_and_sets_and_no_annotations(tr):
    # Kernels 100-350, 400-650, 700-760; the copy 800-900 and the set 850-950 overlap.
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx(710e-6)
    assert {o.category for o in tr.device} == {"kernel", "gpu_memcpy", "gpu_memset"}


def test_names_match_exactly(tr):
    seconds, launches = trace.kernel_seconds(tr, ("strip_kernel",))
    assert launches == 2 and seconds == pytest.approx(400e-6)
    seconds, launches = trace.kernel_seconds(tr, ("volume_strip_kernel",))
    assert launches == 1 and seconds == pytest.approx(50e-6)


def _run(tr, cell="rig800-fused.resident-b16", traced_calls=2):
    registry = Registry()
    found = registry.cell(cell)
    return types.SimpleNamespace(config=found.config, traffic=found.traffic,
                                 batch=found.traffic["batch"], trace=tr,
                                 traced_calls=traced_calls, span_calls=[])


def test_roofline_readers(tr):
    from benchmark import roofline

    registry = Registry()
    run = _run(tr)
    least = roofline.bound_s(*roofline.fused_sad_work(800, 1280, 64, 16))
    assert registry.metric("fused_match_roofline").read(run) == pytest.approx(
        100 * 2 * least / 400e-6)
    least = roofline.bound_s(*roofline.remap_work(16, 800 * 1280, 2, bgr=True))
    assert registry.metric("front_end_roofline").read(run) == pytest.approx(
        100 * 2 * least / 100e-6)
    # No median kernel ran: the reader finds nothing and returns nothing.
    assert registry.metric("median_roofline").read(_run(tr, "rig800-plus.resident-b8")) is None


def test_idle_and_plain_torch_readers(tr):
    registry = Registry()
    run = _run(tr)
    busy = 710e-6
    assert registry.metric("device_idle_pct").read(run) == pytest.approx(
        100 * (1000e-6 - busy) / 1000e-6)
    assert registry.metric("plain_torch.device_pct").read(run) == pytest.approx(
        100 * 20e-6 / busy)


def test_idle_gaps_are_named_by_the_host(tr):
    gaps = trace.idle_gaps(tr)
    assert gaps["aten::empty"] == pytest.approx(100e-6)  # 0-100: before the first kernel
    assert gaps["cudaEventSynchronize"] == pytest.approx(50e-6)  # 650-700
    assert gaps["python"] == pytest.approx(140e-6)  # 350-400, 760-800, 950-1000: no host op
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]
