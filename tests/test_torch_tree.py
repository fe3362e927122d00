"""The port's host tree against the JAX package's: the C++ source, the
builder (C++ and NumPy), the edge-weight providers, the weight LUT and the
24-bit packing, and every array of the stride-bucket plans (lean and
``lean=False``, C++ and NumPy emitters), on the same inputs."""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.tree import builder as jb
from gpu_stereo_matching_tpu.tree import hpd as jhpd
from gpu_stereo_matching_tpu.tree import stride as js
from gpu_stereo_matching_tpu_torch.tree import builder as tb
from gpu_stereo_matching_tpu_torch.tree import hpd as thpd
from gpu_stereo_matching_tpu_torch.tree import stride as ts
from tests.torch_st_helpers import fresh_registries  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TREE_ARRAYS = ("bfs_order", "parent", "parent_dist", "level_of", "level_start",
               "dfs_order", "subtree_size")
PLAN_SHAPES = [(1, 1), (1, 8), (8, 1), (7, 9), (16, 21), (13, 29), (23, 17)]


def _weights(seed, h, w):
    ea, _eb = jb.grid_edges(h, w)
    return (np.random.default_rng(seed).random(len(ea)) * 60).astype(np.float32)


def _trees(seed, h, w, **kw):
    kw = {"tau": 100.0, "min_size": 6, "penalty": 5.0, **kw}
    wts = _weights(seed, h, w)
    return jb.build_segment_tree(wts, h, w, **kw), tb.build_segment_tree(wts, h, w, **kw)


def _assert_trees_equal(ours, theirs):
    assert (ours.height, ours.width) == (theirs.height, theirs.width)
    for name in TREE_ARRAYS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_plans_equal(ours, theirs):
    assert ours.layout_key == theirs.layout_key
    for name in ("ints", "codes", "table", "res", "flg"):
        a, b = getattr(ours, name), getattr(theirs, name)
        if b is None:
            assert a is None, name
            continue
        assert isinstance(a, torch.Tensor), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert a.numpy().dtype == np.asarray(b).dtype, name
    assert ours.transport_nbytes == theirs.transport_nbytes


def test_cpp_source_is_a_verbatim_copy():
    assert filecmp.cmp(ROOT / "gpu_stereo_matching_tpu_torch/tree/csrc/segment_tree.cpp",
                       ROOT / "gpu_stereo_matching_tpu/tree/csrc/segment_tree.cpp", shallow=False)


def test_library_builds_into_the_ports_own_directory():
    path = Path(tb._compile_library())
    assert path.parent == ROOT / "gpu_stereo_matching_tpu_torch/tree/_build"


@pytest.mark.parametrize("hw", [(1, 1), (1, 6), (5, 1), (5, 7), (12, 31)])
def test_grid_edges_equal(hw):
    for a, b in zip(tb.grid_edges(*hw), jb.grid_edges(*hw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (6, 9), (11, 8), (13, 29)])
@pytest.mark.parametrize("params", [
    {"tau": 80.0, "min_size": 4, "penalty": 5.0},
    {"tau": 1200.0, "min_size": 50, "penalty": 5.0, "weight_scale": 255.0},
])
def test_builders_equal_the_jax_builders(hw, params):
    h, w = hw
    wts = _weights(3, h, w) / (255.0 if "weight_scale" in params else 1.0)
    _assert_trees_equal(tb.build_segment_tree(wts, h, w, **params),
                        jb.build_segment_tree(wts, h, w, **params))
    _assert_trees_equal(tb.build_segment_tree_py(wts, h, w, **params),
                        jb.build_segment_tree_py(wts, h, w, **params))


def test_builder_refuses_wrong_weight_count():
    with pytest.raises(ValueError, match="edge weights"):
        tb.build_segment_tree(np.zeros(3, np.float32), 4, 4)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("presmooth", [True, False])
@pytest.mark.parametrize("hw", [(1, 1), (1, 7), (6, 1), (9, 13), (24, 40)])
def test_color_edge_weights_equal(native, presmooth, hw):
    img = np.random.default_rng(5).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = tb.color_edge_weights(img, presmooth=presmooth, native=native)
    want = jb.color_edge_weights(img, presmooth=presmooth, native=native)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", [True, False])
def test_color_depth_edge_weights_equal(native):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (11, 17, 3), dtype=np.uint8)
    disp = rng.integers(0, 60, (11, 17), dtype=np.uint8)
    mask = rng.random((11, 17)) > 0.3
    got = tb.color_depth_edge_weights(img, disp, mask, 60, 0.5, native=native)
    want = jb.color_depth_edge_weights(img, disp, mask, 60, 0.5, native=native)
    np.testing.assert_array_equal(got, want)


def test_tree_of_an_image_equals_and_parent_weights():
    img = np.random.default_rng(8).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    wts = tb.color_edge_weights(img)
    ours = tb.build_segment_tree(wts, 20, 30)
    theirs = jb.build_segment_tree(wts, 20, 30)
    _assert_trees_equal(ours, theirs)
    for sigma in (0.005, 0.08, 0.1):
        np.testing.assert_array_equal(ours.parent_weights(sigma), theirs.parent_weights(sigma))


@pytest.mark.parametrize("sigma", [0.001, 0.08, 0.1, 0.5])
def test_weight_lut_and_exact_lut_equal(sigma):
    """The port's indexed read gives the table's floats. XLA flushes
    subnormal floats to zero (the JAX package's one-hot contraction on the
    CPU; the TPU has none), torch keeps them: below sigma = 0.0115 the
    largest distance codes have subnormal weights, and only there do the
    two differ."""
    ours, theirs = thpd.weight_lut(sigma), jhpd.weight_lut(sigma)
    np.testing.assert_array_equal(ours, theirs)
    idx = np.arange(256, dtype=np.uint8)[::-1].copy()
    got = thpd._exact_lut(torch.from_numpy(idx), torch.from_numpy(ours)).numpy()
    want = np.asarray(jhpd._exact_lut(jnp.asarray(idx), jnp.asarray(theirs)))
    np.testing.assert_array_equal(got, ours[idx])
    subnormal = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    assert subnormal.any() == (sigma < 0.0115)
    np.testing.assert_array_equal(np.where(subnormal, 0.0, got), want)


def test_pack_ints24_roundtrip_and_checks():
    ints = np.random.default_rng(9).integers(0, 1 << 24, 1000).astype(np.int32)
    packed = thpd.pack_ints24(ints)
    np.testing.assert_array_equal(packed, jhpd.pack_ints24(ints))
    np.testing.assert_array_equal(ts._pack24_native(ints), packed)
    np.testing.assert_array_equal(thpd._unpack_ints24(torch.from_numpy(packed)).numpy(), ints)
    with pytest.raises(ValueError, match="24-bit"):
        thpd.pack_ints24(np.array([1 << 24], np.int32))
    with pytest.raises(ValueError, match="negative"):
        thpd.pack_ints24(np.array([-1], np.int32))
    with pytest.raises(ValueError, match="24-bit"):
        ts._pack24_native(np.array([1 << 24], np.int32))


def test_registry_has_its_own_file(monkeypatch):
    monkeypatch.setattr(thpd, "_REGISTRY_PATH", None)
    monkeypatch.setattr(jhpd, "_REGISTRY_PATH", None)
    ours, theirs = thpd._registry_file(), jhpd._registry_file()
    assert ours != theirs
    assert ours.endswith("gpu_stereo_matching_tpu_torch/hpd_layouts.json")


def test_registry_persists_and_merges(fresh_registries):
    assert thpd._registry_rounds(100, 4) == 4
    assert thpd._registry_rounds(100, 2) == 4
    assert thpd._registry_bucket_caps(100, 4, [[2, 1], [4]]) == [(2, 1), (4,)]
    assert thpd._registry_bucket_caps(100, 4, [[1, 3, 2]]) == [(2, 3, 2), (4,)]
    assert thpd._registry_scan_caps(100, 4, [4, 2]) == [4, 2]
    assert thpd._registry_real_rounds(100, 4, 3) == 3
    # A fresh process reads what this one wrote.
    for name in ("_ROUNDS_REGISTRY", "_SCAN_REGISTRY", "_REAL_ROUNDS_REGISTRY",
                 "_BUCKET_REGISTRY"):
        getattr(thpd, name).clear()
    thpd._REGISTRY_LOADED = False
    assert thpd._registry_rounds(100, 1) == 4
    assert thpd._registry_bucket_caps(100, 4, [[0]]) == [(2, 3, 2), (4,)]
    assert thpd._registry_scan_caps(100, 4, [1, 1]) == [4, 2]
    assert thpd._registry_real_rounds(100, 4, 1) == 3
    assert (fresh_registries / "torch.json").exists()
    assert not (fresh_registries / "jax.json").exists()


@pytest.mark.parametrize("hw", PLAN_SHAPES)
@pytest.mark.parametrize("lean", [True, False])
@pytest.mark.parametrize("native", [True, False])
def test_stride_plans_equal(fresh_registries, hw, lean, native):
    jt, tt = _trees(11, *hw)
    theirs = js.build_stride_plan(jt, 0.1, native=native, lean=lean)
    ours = ts.build_stride_plan(tt, 0.1, native=native, lean=lean)
    _assert_plans_equal(ours, theirs)
    assert (ours.res is not None) and ((ours.flg is not None) == lean)


def test_native_and_numpy_emitters_agree(fresh_registries):
    for hw in [(7, 9), (16, 21), (3, 25)]:
        _jt, tt = _trees(12, *hw)
        for lean in (True, False):
            a = ts.build_stride_plan(tt, 0.1, native=True, lean=lean)
            b = ts.build_stride_plan(tt, 0.1, native=False, lean=lean)
            assert a.layout_key == b.layout_key
            for name in ("ints", "codes", "table", "res", "flg"):
                if getattr(b, name) is not None:
                    assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_plan_of_an_image_tree_equals(fresh_registries):
    img = np.random.default_rng(13).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    wts = tb.color_edge_weights(img)
    jt, tt = jb.build_segment_tree(wts, 40, 56), tb.build_segment_tree(wts, 40, 56)
    _assert_plans_equal(ts.StridePlan.from_tree(tt, 0.1),
                        js.StridePlan.from_tree(jt, 0.1, device=False))


def test_plan_to_device_and_frames(fresh_registries):
    jt, tt = _trees(14, 9, 11)
    plan = ts.StridePlan.from_tree(tt, 0.1, device="cpu")
    moved = plan.to(torch.device("cpu"))
    assert moved.layout_key == plan.layout_key
    assert all(isinstance(getattr(moved, n), torch.Tensor) for n in ("ints", "codes", "table"))
    jplans = js.converged_stride_batch([jt, jt], 0.1)
    tplans = ts.converged_stride_batch([tt, tt], 0.1)
    _assert_plans_equal(tplans, jplans)
    for g in range(2):
        _assert_plans_equal(tplans.frame(g), jplans.frame(g))
        _assert_plans_equal(tplans.frame(g), plan)


def test_stack_rejects_diverged_layouts_and_tables(fresh_registries):
    _, small = _trees(15, 5, 7)
    _, big = _trees(16, 9, 9)
    a = ts.StridePlan.from_tree(small, 0.1)
    with pytest.raises(ValueError, match="layouts diverged"):
        ts.stack_stride_plans([a, ts.StridePlan.from_tree(big, 0.1)])
    with pytest.raises(ValueError, match="weight table"):
        ts.stack_stride_plans([a, ts.StridePlan.from_tree(small, 0.2)])
