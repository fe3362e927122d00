"""ST-1's device paths over the heavy-path, plan-order and coded plans
(``models/segment_tree.py``: ``_st1_device``, ``_st1_device_group``,
``_st1_device_batched``, ``_st1_device_merged``) against the JAX package's
on the CPU.

Jitted, XLA contracts some of the JAX filter's multiply-adds, so near-tied
WTA decisions may flip: the median-filtered maps are held to a share of
equal pixels (0.99). Run op by op under ``jax.disable_jit()`` the JAX
paths do the port's float operations in its order, and the maps are equal
bit for bit. Inside the port the group paths equal the per-frame call bit
for bit."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.models import segment_tree as jst
from gpu_stereo_matching_tpu.tree import builder as jb
from gpu_stereo_matching_tpu.tree import hpd as jh
from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr
from gpu_stereo_matching_tpu_torch.models import segment_tree as tst
from gpu_stereo_matching_tpu_torch.tree import builder as tb
from gpu_stereo_matching_tpu_torch.tree import hpd as th
from gpu_stereo_matching_tpu_torch.tree.stride import converged_stride_batch
from tests.torch_st_helpers import fresh_registries  # noqa: F401

ART = Path(__file__).resolve().parents[1] / "examples" / "art_left.png"
D = 8
SIGMA = 0.1
SHARE = 0.99


def _frames(b, h, w, seed=0):
    """``b`` crops of the art view, each with its own offset, and their
    right views shifted by 3 columns (the last column repeated)."""
    img = load_image_bgr(str(ART))
    out = []
    for k in range(b):
        y0, x0 = 90 + 7 * k + seed, 140 + 11 * k
        left = np.ascontiguousarray(img[y0 : y0 + h, x0 : x0 + w])
        cols = np.minimum(np.arange(w) + 3, w - 1)
        out.append((left, np.ascontiguousarray(left[:, cols])))
    return out


def _tree(left):
    h, w = left.shape[:2]
    return tb.build_segment_tree(tb.color_edge_weights(left), h, w)


def _jtree(tree):
    return jb.SegmentTree(**{f: getattr(tree, f) for f in (
        "height", "width", "bfs_order", "parent", "parent_dist", "level_of", "level_start",
        "dfs_order", "subtree_size")})


def _plan(kind, tree):
    """(port plan, JAX plan on its device) of one kind."""
    cls = {"hpd": (th.HeavyPathPlan, jh.HeavyPathPlan), "po": (th.PlanOrderPlan, jh.PlanOrderPlan),
           "coded": (th.CodedPlan, jh.CodedPlan)}[kind]
    return cls[0].from_tree(tree, SIGMA), cls[1].from_tree(_jtree(tree), SIGMA)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _share(got, want):
    return float(np.mean(got.numpy() == np.asarray(want)))


@pytest.mark.parametrize("kind", ["hpd", "po", "coded"])
def test_st1_device_matches_jax(fresh_registries, kind):
    (left, right), = _frames(1, 24, 40)
    ours, theirs = _plan(kind, _tree(left))
    got = tst._st1_device(_t(left), _t(right), ours, D)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (24, 40)
    want = jst._st1_device_jit(jnp.asarray(left), jnp.asarray(right), theirs, D)
    assert _share(got, want) >= SHARE
    # Every formulation gives the stride plan's map to the same band.
    stride = tst._st1_device(_t(left), _t(right), converged_stride_batch(
        [_tree(left)], SIGMA).frame(0), D)
    assert _share(got, stride) >= SHARE


@pytest.mark.parametrize("kind", ["hpd", "po", "coded"])
def test_st1_device_equals_jax_op_by_op(fresh_registries, kind):
    (left, right), = _frames(1, 8, 12, seed=3)
    ours, theirs = _plan(kind, _tree(left))
    got = tst._st1_device(_t(left), _t(right), ours, 6)
    with jax.disable_jit():
        want = jst._st1_device(jnp.asarray(left), jnp.asarray(right), theirs, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _group(b, h, w, kind, seed=0):
    frames = _frames(b, h, w, seed)
    trees = [_tree(lf) for lf, _ in frames]
    lb = np.stack([lf for lf, _ in frames])
    rb = np.stack([rt for _, rt in frames])
    if kind == "po":
        ours = th.converged_plan_batch(trees, SIGMA)
        theirs = jh.converged_plan_batch([_jtree(t) for t in trees], SIGMA)
    else:
        ours = th.converged_coded_batch(trees, SIGMA)
        theirs = jh.converged_coded_batch([_jtree(t) for t in trees], SIGMA)
    return trees, lb, rb, ours, theirs


def _per_frame(lb, rb, plans, num_disp=D):
    return torch.stack([tst._st1_device(_t(lb[g]), _t(rb[g]), plans.frame(g), num_disp)
                        for g in range(lb.shape[0])])


@pytest.mark.parametrize("kind", ["po", "coded"])
def test_st1_device_group_matches_jax(fresh_registries, kind):
    _trees, lb, rb, ours, theirs = _group(3, 16, 24, kind)
    got = tst._st1_device_group(_t(lb), _t(rb), ours, D)
    assert tuple(got.shape) == (3, 16, 24)
    assert torch.equal(got, _per_frame(lb, rb, ours))
    want = jst._st1_device_group_jit(jnp.asarray(lb), jnp.asarray(rb), theirs, D)
    assert _share(got, want) >= SHARE


def test_st1_device_batched_matches_jax(fresh_registries):
    _trees, lb, rb, ours, theirs = _group(3, 16, 24, "po")
    got = tst._st1_device_batched(_t(lb), _t(rb), ours, D)
    assert tuple(got.shape) == (3, 16, 24) and got.dtype == torch.uint8
    assert torch.equal(got, _per_frame(lb, rb, ours))
    want = jst._st1_device_batched_jit(jnp.asarray(lb), jnp.asarray(rb), theirs, D)
    assert _share(got, want) >= SHARE


@pytest.mark.parametrize("b", [2, 4])
def test_st1_device_merged_matches_jax(fresh_registries, b):
    trees, lb, rb, ours, _theirs = _group(b, 16, 24, "po")
    plans = [th.PlanOrderPlan.from_tree(t, SIGMA) for t in trees]
    got = tst._st1_device_merged(_t(lb), _t(rb), th.merge_plans(plans), D)
    assert torch.equal(got, _per_frame(lb, rb, ours))
    jmerged = jh.merge_plans([jh.PlanOrderPlan.from_tree(_jtree(t), SIGMA, device=False)
                              for t in trees])
    want = jst._st1_device_merged_jit(jnp.asarray(lb), jnp.asarray(rb), jh.PlanOrderPlan(
        jmerged.num_nodes, jmerged.total_pos, jmerged.rounds_meta,
        jnp.asarray(jmerged.ints), jnp.asarray(jmerged.floats)), D)
    assert _share(got, want) >= SHARE


@pytest.mark.parametrize("path", ["group_po", "group_coded", "batched", "merged"])
def test_group_paths_equal_jax_op_by_op(fresh_registries, path):
    kind = "coded" if path == "group_coded" else "po"
    trees, lb, rb, ours, theirs = _group(2, 8, 12, kind, seed=5)
    jl, jr = jnp.asarray(lb), jnp.asarray(rb)
    if path == "merged":
        ours = th.merge_plans([th.PlanOrderPlan.from_tree(t, SIGMA) for t in trees])
        jm = jh.merge_plans([jh.PlanOrderPlan.from_tree(_jtree(t), SIGMA, device=False)
                             for t in trees])
        theirs = jh.PlanOrderPlan(jm.num_nodes, jm.total_pos, jm.rounds_meta,
                                  jnp.asarray(jm.ints), jnp.asarray(jm.floats))
    ours_fn, theirs_fn = {
        "group_po": (tst._st1_device_group, jst._st1_device_group),
        "group_coded": (tst._st1_device_group, jst._st1_device_group),
        "batched": (tst._st1_device_batched, jst._st1_device_batched),
        "merged": (tst._st1_device_merged, jst._st1_device_merged),
    }[path]
    got = ours_fn(_t(lb), _t(rb), ours, 6)
    with jax.disable_jit():
        want = theirs_fn(jl, jr, theirs, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paths_refuse_plans_they_cannot_take(fresh_registries):
    frames = _frames(2, 8, 12)
    lb = _t(np.stack([lf for lf, _ in frames]))
    rb = _t(np.stack([rt for _, rt in frames]))
    trees = [_tree(lf) for lf, _ in frames]
    hpd = th.HeavyPathPlan.from_tree(trees[0], SIGMA)
    coded = th.converged_coded_batch(trees, SIGMA)
    with pytest.raises(TypeError, match="StridePlan, CodedPlan or PlanOrderPlan"):
        tst._st1_device_group(lb, rb, hpd, 6)
    with pytest.raises(TypeError, match="stacked PlanOrderPlan"):
        tst._st1_device_batched(lb, rb, coded, 6)
    with pytest.raises(TypeError, match="stacked StridePlan"):
        tst._st1_device_group_banded(lb, rb, coded, 6, 1)
