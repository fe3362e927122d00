"""The port's streaming segment-tree pipelines
(``models/segment_tree_stream.py``) on the CPU: each yields the maps of its
per-frame call bit for bit (``st1_disparity`` or ``st2_disparity``), short
last groups included, as ``tests/test_segment_tree_pipeline.py:119-270``
holds the JAX ones. Then the layout registry under a pool of threads, the
checks, and on a card the pipelines against the CPU."""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.models import segment_tree as tst
from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import (
    SegmentTreeBatchPipeline,
    SegmentTreeST2BatchPipeline,
    SegmentTreeVideoPipeline,
)
from gpu_stereo_matching_tpu_torch.tree import hpd as thpd
from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan, converge_stride_plans
from tests.torch_st_helpers import fresh_registries  # noqa: F401

CFG = SegmentTreeConfig(max_disp_levels=5, tau=90.0, min_size_seg=5)


def _frames(seed, n, h=10, w=14):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
             rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for _ in range(n)]


def _assert_per_frame(frames, got, per_frame, cfg=CFG):
    assert len(got) == len(frames)
    for (left, right), disp in zip(frames, got):
        assert disp.dtype == torch.uint8 and disp.device.type == "cpu"
        assert torch.equal(disp, per_frame(left, right, cfg, device="cpu"))


@pytest.mark.parametrize("make,per_frame,n", [
    (lambda: SegmentTreeVideoPipeline(CFG, device="cpu"), tst.st1_disparity, 4),
    (lambda: SegmentTreeBatchPipeline(CFG, group_size=4, workers=2, device="cpu"),
     tst.st1_disparity, 5),
    (lambda: SegmentTreeBatchPipeline(CFG, group_size=3, workers=2, device="cpu"),
     tst.st1_disparity, 4),
    (lambda: SegmentTreeST2BatchPipeline(CFG, group_size=4, workers=2, device="cpu"),
     tst.st2_disparity, 5),
], ids=["video", "batch-4-of-5", "batch-odd-group", "st2-batch-4-of-5"])
def test_pipeline_matches_per_frame(fresh_registries, make, per_frame, n):
    frames = _frames(n, n)
    _assert_per_frame(frames, list(make().process(iter(frames))), per_frame)


@pytest.mark.parametrize("make,per_frame", [
    (lambda: SegmentTreeVideoPipeline(CFG, device="cpu"), tst.st1_disparity),
    (lambda: SegmentTreeBatchPipeline(CFG, group_size=4, device="cpu"), tst.st1_disparity),
    (lambda: SegmentTreeST2BatchPipeline(CFG, group_size=4, device="cpu"), tst.st2_disparity),
], ids=["video", "batch", "st2-batch"])
def test_pipeline_empty_and_single(make, per_frame):
    pipe = make()
    assert list(pipe.process(iter([]))) == []
    frames = _frames(9, 1, 8, 12)
    got = list(pipe.process(iter(frames)))
    assert len(got) == 1 and tuple(got[0].shape) == (8, 12)
    _assert_per_frame(frames, got, per_frame)


def test_st2_batch_lean_and_legacy_plans_give_the_same_maps():
    frames = _frames(10, 3)
    lean = list(SegmentTreeST2BatchPipeline(CFG, group_size=2, lean=True,
                                            device="cpu").process(frames))
    legacy = list(SegmentTreeST2BatchPipeline(CFG, group_size=2, lean=False,
                                              device="cpu").process(frames))
    assert all(torch.equal(a, b) for a, b in zip(lean, legacy)) and len(lean) == 3


def test_pipelines_take_tensors_and_check_pairs():
    left, right = _frames(11, 1)[0]
    got = list(SegmentTreeVideoPipeline(CFG, device="cpu").process(
        [(torch.from_numpy(left), torch.from_numpy(right))]))
    assert torch.equal(got[0], tst.st1_disparity(left, right, CFG, device="cpu"))
    bad = [(left, right[:, :-1])]
    for pipe, what in ((SegmentTreeVideoPipeline(CFG, device="cpu"), "st1"),
                       (SegmentTreeBatchPipeline(CFG, device="cpu"), "st1"),
                       (SegmentTreeST2BatchPipeline(CFG, device="cpu"), "st2")):
        with pytest.raises(ValueError, match=f"{what}: left/right shapes differ"):
            list(pipe.process(bad))


def test_batch_pipeline_refuses_bands_and_bad_groups():
    with pytest.raises(NotImplementedError, match="tiled segment-tree slice"):
        SegmentTreeBatchPipeline(CFG, bands=2, device="cpu")
    with pytest.raises(ValueError, match="bands must be >= 1"):
        SegmentTreeBatchPipeline(CFG, bands=0, device="cpu")
    for cls in (SegmentTreeBatchPipeline, SegmentTreeST2BatchPipeline):
        with pytest.raises(ValueError, match="group_size must be >= 1"):
            cls(CFG, group_size=0, device="cpu")


def test_pipelines_ask_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SegmentTreeVideoPipeline, SegmentTreeBatchPipeline, SegmentTreeST2BatchPipeline):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(CFG)


def _plan_builders(n):
    """Plan builders over n different trees of one size."""
    imgs = [f[0] for f in _frames(12, n, 24, 32)]
    return [lambda im=im: StridePlan.from_tree(tst._sigma1_tree(im, CFG), CFG.sigma_one)
            for im in imgs]


def _arrays(plan):
    return plan.ints, plan.codes, plan.res, plan.flg, plan.table


def test_registry_on_a_pool_matches_a_sequential_build(fresh_registries, monkeypatch):
    """Eight frames' plans built on a pool of 4 threads, the interpreter
    switching threads as often as it can, converge to the stacked plan of a
    sequential build: the registry's read-modify-writes lose no update."""
    builds = _plan_builders(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4) as pool:
            on_pool = converge_stride_plans(builds, pool)
    finally:
        sys.setswitchinterval(old)
    caps = (dict(thpd._BUCKET_REGISTRY), dict(thpd._SCAN_REGISTRY))
    for name in ("_ROUNDS_REGISTRY", "_SCAN_REGISTRY", "_REAL_ROUNDS_REGISTRY",
                 "_BUCKET_REGISTRY"):
        monkeypatch.setattr(thpd, name, {})
    monkeypatch.setattr(thpd, "_REGISTRY_PATH", str(fresh_registries / "sequential.json"))
    monkeypatch.setattr(thpd, "_REGISTRY_LOADED", False)
    sequential = converge_stride_plans(builds)
    assert (dict(thpd._BUCKET_REGISTRY), dict(thpd._SCAN_REGISTRY)) == caps
    assert on_pool.layout_key == sequential.layout_key
    assert tuple(on_pool.ints.shape)[0] == 8
    for a, b in zip(_arrays(on_pool), _arrays(sequential)):
        assert torch.equal(a, b)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the median kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_pipelines_on_the_card_equal_the_cpu(card):
    """On the card each pipeline gives the CPU's per-frame maps bit for bit,
    launching kernel D once a frame for ST-1 and three times for ST-2."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median

    frames = _frames(13, 5, 40, 64)
    cfg = SegmentTreeConfig(max_disp_levels=16)
    for pipe, per_frame, per in (
            (SegmentTreeVideoPipeline(cfg, device=card), tst.st1_disparity, 1),
            (SegmentTreeBatchPipeline(cfg, group_size=4, device=card), tst.st1_disparity, 1),
            (SegmentTreeST2BatchPipeline(cfg, group_size=4, device=card), tst.st2_disparity, 3)):
        before = ctmf_median.LAUNCHES
        got = list(pipe.process(frames))
        launched = ctmf_median.LAUNCHES - before
        # A short last group is padded to the group size on the device.
        assert launched == per * (5 if isinstance(pipe, SegmentTreeVideoPipeline) else 8)
        for (left, right), disp in zip(frames, got):
            assert disp.device.type == "cuda"
            assert torch.equal(disp.cpu(), per_frame(left, right, cfg, device="cpu"))
