"""The rig's spans (``utils/profiling.py::span``) in a profiler trace read
by ``benchmark/trace.py``: every span of a batch call inside its
``rig.process_batch``, in the counts the path makes; with no profiler, no
span at all and the same maps. One test on the card shows the spans share
the clock of the card's launches and kernels."""

import json

import numpy as np
import pytest
import torch

from benchmark import trace
from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu_torch.io.calib_yaml import StereoCalibration
from gpu_stereo_matching_tpu_torch.kernels.remap import rectify_gray_pair
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching_batched
from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig

SIZE_HW = (24, 32)
BATCH = 2
CONFIG = BlockMatchingConfig(num_disparities=4, sad_radius=1, lr_consistency=True,
                             lr_max_diff=1, median_radius=1)
RIG_SPANS = ("rig.process_batch", "rig.intake", "rig.front_end", "rig.match")
BM_SPANS = ("bm.volume", "bm.argmin", "bm.right_view", "bm.lr_check", "bm.median")


def _calib():
    k = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1.0]])
    return StereoCalibration(
        left_intrinsics=k,
        right_intrinsics=k * np.array([[1.02], [1.01], [1.0]]),
        left_distortion=np.array([0.01, -0.02, 0.0, 0.0, 0.0]),
        right_distortion=np.array([0.02, -0.01, 0.0, 0.0, 0.0]),
        rotation=np.eye(3),
        translation=np.array([-5.0, 0.0, 0.0]),
    )


def _frames(device, size_hw=SIZE_HW, batch=BATCH, seed=7):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (batch, *size_hw, 3), dtype=np.uint8)).to(device)
            for _ in range(2)]


def _parent_path(rig, left, right):
    """``process_batch`` as it was before it had spans."""
    rl, rr = rectify_gray_pair(left, right, rig.left_map_x, rig.left_map_y,
                               rig.right_map_x, rig.right_map_y)
    if not rig.fused:
        return block_matching_pipeline(rl, rr, rig.config)
    return fused_block_matching_batched(rl, rr, rig.config.num_disparities, rig.config.sad_radius)


def _spans(tr, names):
    return [o for o in tr.host if o.category == "user_annotation" and o.name in names]


def _inside(o, call):
    return call.start_us <= o.start_us and o.end_us <= call.end_us


@pytest.mark.parametrize("fused", [True, False])
def test_batch_call_spans_nest_in_counts(fused):
    rig = StereoRig(_calib(), SIZE_HW, CONFIG, device="cpu", fused=fused)
    left, right = _frames("cpu")
    calls = 2
    _, tr = trace.profiled(lambda: [rig.process_batch(left, right) for _ in range(calls)])
    outer = _spans(tr, ("rig.process_batch",))
    assert len(outer) == calls
    want = {"rig.intake": 1, "rig.front_end": 1, "rig.match": int(fused)}
    want.update(dict.fromkeys(BM_SPANS, 0) if fused else {
        "bm.volume": BATCH, "bm.argmin": BATCH, "bm.right_view": 0,
        "bm.lr_check": BATCH, "bm.median": BATCH})
    inner = _spans(tr, RIG_SPANS[1:] + BM_SPANS)
    for call in outer:
        found = [o.name for o in inner if _inside(o, call)]
        assert {n: found.count(n) for n in want} == want
    assert all(any(_inside(o, call) for call in outer) for o in inner)


def test_process_passes_through_the_inner_spans():
    """``process`` opens no outer span but runs the shared ones."""
    rig = StereoRig(_calib(), SIZE_HW, CONFIG, device="cpu", fused=False)
    left, right = _frames("cpu", batch=1)
    _, tr = trace.profiled(lambda: rig.process(left[0], right[0]))
    names = [o.name for o in _spans(tr, RIG_SPANS + BM_SPANS)]
    assert {n: names.count(n) for n in set(names)} == {
        "rig.intake": 1, "rig.front_end": 1, "bm.volume": 1, "bm.argmin": 1,
        "bm.lr_check": 1, "bm.median": 1}


def _refuse(*args, **kwargs):
    raise AssertionError("a span was opened with no profiler active")


@pytest.mark.parametrize("fused", [True, False])
def test_no_profiler_no_span_and_the_same_maps(monkeypatch, fused):
    rig = StereoRig(_calib(), SIZE_HW, CONFIG, device="cpu", fused=fused)
    left, right = _frames("cpu")
    want = _parent_path(rig, left, right)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", _refuse)
    got = rig.process_batch(left, right)
    assert got.dtype == torch.int32 and tuple(got.shape) == (BATCH, *SIZE_HW)
    assert torch.equal(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace of the card's launches and kernels")
    return torch.device("cuda", 0)


# How far the profiler may place the card's time line off the host's. On an
# H100 with torch 2.11 some sessions put every kernel 0.07-0.27 ms early,
# before its own launch call; most sessions put none early.
CLOCK_SLACK_US = 1000.0


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_front_end_span_holds_its_launch_on_the_card(cuda_device, fused, tmp_path):
    """Each ``rig.front_end`` span holds one launch call, the one whose
    correlation id its ``front_end_kernel`` carries, and that kernel starts
    after the span opened, to within ``CLOCK_SLACK_US``: the spans, the
    runtime calls and the kernels are on one clock."""
    from torch.profiler import ProfilerActivity, profile

    size_hw = (80, 128)
    rig = StereoRig(_calib(), size_hw, CONFIG, device=cuda_device, fused=fused)
    left, right = _frames(cuda_device, size_hw)
    rig.process_batch(left, right)
    torch.cuda.synchronize(cuda_device)
    calls = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rig.process_batch(left, right)
        torch.cuda.synchronize(cuda_device)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]

    def ends(e):
        return e["ts"], e["ts"] + e.get("dur", 0)

    front = [ends(e) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == "rig.front_end"]
    launches = {e["args"]["correlation"]: ends(e) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e["name"]}
    kernels = [e for e in events
               if e.get("cat") == "kernel" and trace.kernel_name(e["name"]) == "front_end_kernel"]
    assert len(front) == len(kernels) == calls
    for s0, s1 in front:
        assert len([1 for l0, l1 in launches.values() if s0 <= l0 and l1 <= s1]) == 1
    t0 = min(e["ts"] for e in events)
    rows = []
    for k in kernels:
        l0, l1 = launches[k["args"]["correlation"]]
        s0, s1 = next((s0, s1) for s0, s1 in front if s0 <= l0 and l1 <= s1)
        rows.append((s0 - t0, l0 - t0, k["ts"] - t0))
    assert all(s0 <= l0 and s0 - CLOCK_SLACK_US <= k0 for s0, l0, k0 in rows), rows
    assert torch.equal(rig.process_batch(left, right).cpu(), _parent_path(rig, left, right).cpu())
