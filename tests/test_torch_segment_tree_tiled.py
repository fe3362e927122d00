"""Per-band segment trees in the port (``models/segment_tree_tiled.py``,
``_st1_device_group_banded`` and the banded batch pipeline) on the CPU,
at the JAX tests' shapes (H = 8 a band, W = 18, D = 5, tau 90, min size 5).

Against the JAX package: its filter runs jitted, where XLA contracts some
float multiply-adds, so the maps are held to a share of equal pixels (ST-1
0.99 on random pairs); one case runs JAX op by op under
``jax.disable_jit()``, where the port equals it bit for bit. Inside the
port the relations are exact: each band equals ST-1 and ST-2 on its crop,
the sliced cost equals the crop's cost, and the banded pipeline equals the
tiled call frame by frame."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig as JaxConfig
from gpu_stereo_matching_tpu.io import middlebury as jmb
from gpu_stereo_matching_tpu.models import segment_tree as jst
from gpu_stereo_matching_tpu.models import segment_tree_tiled as jtiled
from gpu_stereo_matching_tpu.tree import builder as jb
from gpu_stereo_matching_tpu.tree import stride as js
from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.io import middlebury as tmb
from gpu_stereo_matching_tpu_torch.models import segment_tree as tst
from gpu_stereo_matching_tpu_torch.models import segment_tree_tiled as ttiled
from gpu_stereo_matching_tpu_torch.models.segment_tree_stream import SegmentTreeBatchPipeline
from gpu_stereo_matching_tpu_torch.ops.cost import color_gradient_cost_volume
from gpu_stereo_matching_tpu_torch.tree import builder as tb
from gpu_stereo_matching_tpu_torch.tree.stride import converged_stride_batch
from tests.torch_st_helpers import fresh_registries  # noqa: F401

SMALL = dict(max_disp_levels=5, tau=90.0, min_size_seg=5)
CFG = SegmentTreeConfig(**SMALL)
JCFG = JaxConfig(**SMALL)


def _pair(seed, h, w=18):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _share(a, b) -> float:
    return float(np.mean(np.asarray(a) == np.asarray(b)))


@pytest.mark.parametrize("tiles,h", [(1, 8), (2, 16), (3, 24), (3, 26), (4, 32)],
                         ids=["1", "2", "3", "3-unequal", "4"])
def test_st1_tiled_matches_jax(fresh_registries, tiles, h):
    """Bands of 8 rows or more, as the JAX tests' (numpy's linspace cuts 26
    rows in 3 tiles into 8, 9 and 9). Bands of 5 and 6 rows flip a near tie
    over most of a band's width more often (0.975 equal): such bands are
    held to JAX op by op below."""
    left, right = _pair(100 + tiles * h, h)
    got = ttiled.st1_disparity_tiled(left, right, tiles, CFG, device="cpu")
    want = jtiled.st1_disparity_tiled(left, right, tiles, JCFG)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (h, 18)
    assert _share(got.numpy(), want) >= 0.99


def test_st1_tiled_equals_jax_op_by_op(fresh_registries):
    """Three unequal bands (16 rows: 5, 5 and 6) with JAX under
    ``disable_jit``: the same float ops in the same order, so the same bits.
    10 columns, since every op's first eager call compiles it apart."""
    left, right = _pair(148, 16, 10)
    got = ttiled.st1_disparity_tiled(left, right, 3, CFG, device="cpu")
    with jax.disable_jit():
        want = jtiled.st1_disparity_tiled(left, right, 3, JCFG)
    np.testing.assert_array_equal(got.numpy(), want)


def test_st1_tiled_one_band_is_st1():
    left, right = _pair(8, 24)
    cfg = SegmentTreeConfig(max_disp_levels=6)
    assert torch.equal(ttiled.st1_disparity_tiled(left, right, 1, cfg, device="cpu"),
                       tst.st1_disparity(left, right, cfg, device="cpu"))


@pytest.mark.parametrize("tiles,h", [(2, 16), (3, 16)])
def test_each_band_is_the_per_frame_call_on_its_crop(tiles, h):
    """ST-1's bands slice one cost volume, ST-2's run on crops: each band
    equals ``st1_disparity`` and ``st2_disparity`` on its crop."""
    left, right = _pair(9 + h, h)
    st1 = ttiled.st1_disparity_tiled(left, right, tiles, CFG, device="cpu")
    st2 = ttiled.st2_disparity_tiled(left, right, tiles, CFG, device="cpu")
    bounds = np.linspace(0, h, tiles + 1).astype(int)
    for y0, y1 in zip(bounds[:-1], bounds[1:]):
        crop = (left[y0:y1], right[y0:y1])
        assert torch.equal(st1[y0:y1], tst.st1_disparity(*crop, CFG, device="cpu"))
        assert torch.equal(st2[y0:y1], tst.st2_disparity(*crop, CFG, device="cpu"))


def test_sliced_cost_is_the_crops_cost():
    """The color+gradient cost has no vertical taps: a band of the frame's
    volume is the volume of the band's crop, bit for bit."""
    left, right = _pair(11, 23, 40)
    full = color_gradient_cost_volume(torch.from_numpy(left), torch.from_numpy(right), 16)
    for y0, y1 in ((0, 1), (0, 7), (7, 16), (16, 23), (5, 6)):
        crop = color_gradient_cost_volume(torch.from_numpy(left[y0:y1]),
                                          torch.from_numpy(right[y0:y1]), 16)
        assert torch.equal(full[:, y0:y1], crop)


def test_st1_device_group_banded_matches_jax(fresh_registries):
    """Two frames of two bands each, frame g's band t at plan g·2 + t."""
    frames = [_pair(12 + g, 16) for g in range(2)]
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    tree_args = dict(tau=CFG.tau, min_size=CFG.min_size_seg, penalty=CFG.penalty_cross_seg)
    crops = [band for f in lefts for band in tst._equal_bands(f, 2)]  # frame-major
    tplans = converged_stride_batch(
        [tb.build_segment_tree(tb.color_edge_weights(c), 8, 18, **tree_args) for c in crops],
        CFG.sigma)
    jplans = js.converged_stride_batch(
        [jb.build_segment_tree(jb.color_edge_weights(c), 8, 18, **tree_args) for c in crops],
        CFG.sigma).to_device()
    got = tst._st1_device_group_banded(torch.from_numpy(lefts), torch.from_numpy(rights),
                                       tplans, 5, 2)
    want = np.asarray(jst._st1_device_group_banded_jit(jnp.asarray(lefts), jnp.asarray(rights),
                                                       jplans, 5, 2))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (2, 16, 18)
    assert _share(got.numpy(), want) >= 0.99
    for g in range(2):
        tiled = ttiled.st1_disparity_tiled(*frames[g], 2, SegmentTreeConfig(
            **SMALL, disparity_scale=1), device="cpu")
        assert torch.equal(got[g], tiled)
    with pytest.raises(TypeError, match="stacked StridePlan"):
        tst._st1_device_group_banded(torch.from_numpy(lefts), torch.from_numpy(rights),
                                     object(), 5, 2)


@pytest.mark.parametrize("bands,n,group", [(2, 3, 2), (4, 5, 2)])
def test_banded_pipeline_equals_tiled(fresh_registries, bands, n, group):
    """The mirror of the JAX ``test_banded_batch_pipeline_matches_tiled``,
    with a short last group."""
    frames = [_pair(20 + k, 8 * bands, 14) for k in range(n)]
    pipe = SegmentTreeBatchPipeline(CFG, group_size=group, workers=2, bands=bands, device="cpu")
    got = list(pipe.process(iter(frames)))
    assert len(got) == n
    for (left, right), disp in zip(frames, got):
        assert torch.equal(disp, ttiled.st1_disparity_tiled(left, right, bands, CFG,
                                                            device="cpu"))


def _scene(module, h=16, w=24, shift=3):
    """A textured view and its copy shifted by ``shift`` columns, with the
    ground truth of a Middlebury third-size scene (3 × the disparity) in
    both views; the first ``shift`` columns have no match."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (h, w + shift, 3), dtype=np.uint8)
    base = np.repeat(base[:, ::2], 2, axis=1)[:, :w + shift]  # coarser texture
    left = np.ascontiguousarray(base[:, shift:])
    right = np.ascontiguousarray(base[:, :w])
    gt = np.full((h, w), 3 * shift, np.uint8)
    gt[:, :shift] = 0
    return module.MiddleburyScene("synthetic", left, right, gt, gt.copy())


def test_tiling_accuracy_report_matches_jax(fresh_registries, capsys):
    cfg = dict(max_disp_levels=8, disparity_scale=1, tau=90.0, min_size_seg=5)
    got = ttiled.tiling_accuracy_report(_scene(tmb), (1, 2), SegmentTreeConfig(**cfg),
                                        device="cpu")
    lines = capsys.readouterr().out.splitlines()
    want = jtiled.tiling_accuracy_report(_scene(jmb), (1, 2), JaxConfig(**cfg))
    assert [r["tiles"] for r in got] == [r["tiles"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert g["bad2"] == pytest.approx(w["bad2"], abs=0.01)
        assert g["bad2_nonocc"] == pytest.approx(w["bad2_nonocc"], abs=0.01)
    assert lines[0].startswith("tiles=1: bad2=") and "nonocc=" in lines[0] and len(lines) == 2


def test_tiled_entries_ask_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right = _pair(13, 16)
    for fn in (ttiled.st1_disparity_tiled, ttiled.st2_disparity_tiled):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(left, right, 2, CFG)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the median kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_tiled_and_banded_on_the_card_equal_the_cpu(card):
    """On the card each tiled entry and the banded pipeline give the CPU's
    maps bit for bit, launching kernel D once a band (three times for ST-2)."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median

    cfg = SegmentTreeConfig(max_disp_levels=16)
    left, right = _pair(14, 60, 64)
    for fn, tiles, per in ((ttiled.st1_disparity_tiled, 3, 1),
                           (ttiled.st1_disparity_tiled, 4, 1),
                           (ttiled.st2_disparity_tiled, 4, 3)):
        before = ctmf_median.LAUNCHES
        got = fn(left, right, tiles, cfg, device=card)
        assert ctmf_median.LAUNCHES - before == per * tiles and got.device.type == "cuda"
        assert torch.equal(got.cpu(), fn(left, right, tiles, cfg, device="cpu"))
    frames = [_pair(15 + k, 60, 64) for k in range(3)]
    before = ctmf_median.LAUNCHES
    got = list(SegmentTreeBatchPipeline(cfg, group_size=2, bands=3, device=card).process(frames))
    assert ctmf_median.LAUNCHES - before == 3 * 4
    for (lf, rt), disp in zip(frames, got):
        assert torch.equal(disp.cpu(), ttiled.st1_disparity_tiled(lf, rt, 3, cfg, device="cpu"))
