"""The port's heavy-path, plan-order and coded plans and filters
(``tree/hpd.py``) against the JAX package's on the CPU.

Plans: every array equals JAX's bit for bit, from the C++ emitters and the
NumPy builders alike, with both packages' registries fresh and the same
trees built in the same order (the ``fresh_registries`` fixture); so do the
stacked, converged and merged plans. Filters: against the jitted JAX filter
at the bands ``tests/test_tree.py`` allows between formulations (jitted, XLA
contracts the scans' multiply-adds), and bit for bit against JAX run op by
op under ``jax.disable_jit()``. Inside the port the relations are exact:
coded with the associative scan equals plan-order, batched and merged equal
per-frame filtering."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.tree import builder as jb
from gpu_stereo_matching_tpu.tree import hpd as jh
from gpu_stereo_matching_tpu_torch.tree import builder as tb
from gpu_stereo_matching_tpu_torch.tree import filter as tf
from gpu_stereo_matching_tpu_torch.tree import hpd as th
from gpu_stereo_matching_tpu_torch.tree import stride as ts
from tests import oracles
from tests.torch_st_helpers import fresh_registries  # noqa: F401

SHAPES = [(9, 12), (19, 23), (1, 17), (16, 1)]


def _tree(seed, h, w, tau=100.0, min_size=6):
    ea, _eb = tb.grid_edges(h, w)
    weights = (np.random.default_rng(seed).random(len(ea)) * 60).astype(np.float32)
    return tb.build_segment_tree(weights, h, w, tau=tau, min_size=min_size, penalty=5.0)


def _jtree(tree):
    """The JAX package's tree over the same arrays."""
    return jb.SegmentTree(**{f: getattr(tree, f) for f in (
        "height", "width", "bfs_order", "parent", "parent_dist", "level_of", "level_start",
        "dfs_order", "subtree_size")})


def _cost(seed, n, d):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def _rounds(plan):
    return [dataclasses.astuple(r) for r in plan.rounds_meta]


def _eq(ours, theirs):
    np.testing.assert_array_equal(ours.cpu().numpy(), np.asarray(theirs))


def _plans(kind, tree, native=True):
    """(port plan, JAX plan) of one kind over one tree, port first."""
    if kind == "hpd":
        return (th.HeavyPathPlan.from_tree(tree, 0.1, native=native),
                jh.HeavyPathPlan.from_tree(_jtree(tree), 0.1, native=native))
    if kind == "po":
        return (th.PlanOrderPlan.from_tree(tree, 0.1, native=native),
                jh.PlanOrderPlan.from_tree(_jtree(tree), 0.1, native=native))
    return (th.CodedPlan.from_tree(tree, 0.1, native=native),
            jh.CodedPlan.from_tree(_jtree(tree), 0.1, native=native))


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("native", [True, False])
def test_hpd_plan_matches_jax(fresh_registries, hw, native):
    ours, theirs = _plans("hpd", _tree(1, *hw), native)
    assert _rounds(ours) == _rounds(theirs) and ours.num_nodes == theirs.num_nodes
    _eq(ours.ints, theirs.ints)
    _eq(ours.floats, theirs.floats)
    assert ours.ints.dtype == torch.int32 and ours.floats.dtype == torch.float32


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("native", [True, False])
def test_plan_order_plan_matches_jax(fresh_registries, hw, native):
    ours, theirs = _plans("po", _tree(2, *hw), native)
    assert (ours.rounds_meta, ours.total_pos) == (theirs.rounds_meta, theirs.total_pos)
    _eq(ours.ints, theirs.ints)
    _eq(ours.floats, theirs.floats)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("native", [True, False])
def test_coded_plan_matches_jax(fresh_registries, hw, native):
    ours, theirs = _plans("coded", _tree(3, *hw), native)
    assert ours.layout_key == theirs.layout_key  # with scan_steps and n_real
    assert ours.ints.dtype == torch.uint8 and ours.ints.shape[0] == 3
    for name in ("ints", "codes", "table"):
        _eq(getattr(ours, name), getattr(theirs, name))


@pytest.mark.parametrize("hw", [(14, 19), (1, 9)])
def test_native_plans_equal_numpy_plans(fresh_registries, hw):
    tree = _tree(4, *hw)
    for cls in (th.HeavyPathPlan, th.PlanOrderPlan, th.CodedPlan):
        native = cls.from_tree(tree, 0.1, native=True)
        oracle = cls.from_tree(tree, 0.1, native=False)
        assert native.rounds_meta == oracle.rounds_meta
        for name in ("ints", "floats", "codes", "light_slots"):
            if hasattr(native, name):
                assert torch.equal(getattr(native, name), getattr(oracle, name)), (cls, name)


@pytest.mark.parametrize("b", [2, 3])
def test_stacked_and_converged_plans_match_jax(fresh_registries, b):
    trees = [_tree(10 + i, 12, 15) for i in range(b)]
    jtrees = [_jtree(t) for t in trees]
    ours = th.converged_plan_batch(trees, 0.1)
    theirs = jh.converged_plan_batch(jtrees, 0.1)
    assert ours.ints.shape[0] == b and ours.rounds_meta == theirs.rounds_meta
    _eq(ours.ints, theirs.ints)
    _eq(ours.floats, theirs.floats)
    coded = th.converged_coded_batch(trees, 0.1)
    jcoded = jh.converged_coded_batch(jtrees, 0.1)
    assert coded.layout_key == jcoded.layout_key
    _eq(coded.ints, jcoded.ints)
    _eq(coded.codes, jcoded.codes)
    # The layouts have converged: plans built now stack to the same arrays.
    po = th.stack_plans([th.PlanOrderPlan.from_tree(t, 0.1) for t in trees])
    jpo = jh.stack_plans([jh.PlanOrderPlan.from_tree(t, 0.1, device=False) for t in jtrees])
    _eq(po.ints, jpo.ints)
    _eq(po.floats, jpo.floats)
    cp = th.stack_coded_plans([th.CodedPlan.from_tree(t, 0.1) for t in trees])
    jcp = jh.stack_coded_plans([jh.CodedPlan.from_tree(t, 0.1, device=False) for t in jtrees])
    _eq(cp.ints, jcp.ints)
    _eq(cp.codes, jcp.codes)
    for g in range(b):
        assert torch.equal(po.frame(g).ints, po.ints[g])
        assert cp.frame(g).layout_key == cp.layout_key


@pytest.mark.parametrize("b", [2, 3, 4])
def test_merged_plan_matches_jax(fresh_registries, b):
    trees = [_tree(20 + i, 11, 13) for i in range(b)]
    jtrees = [_jtree(t) for t in trees]
    th.converged_plan_batch(trees, 0.1)
    jh.converged_plan_batch(jtrees, 0.1)
    ours = th.merge_plans([th.PlanOrderPlan.from_tree(t, 0.1) for t in trees])
    theirs = jh.merge_plans([jh.PlanOrderPlan.from_tree(t, 0.1, device=False) for t in jtrees])
    assert (ours.num_nodes, ours.total_pos, ours.rounds_meta) == (
        theirs.num_nodes, theirs.total_pos, theirs.rounds_meta)
    _eq(ours.ints, theirs.ints)
    _eq(ours.floats, theirs.floats)


def test_registry_round_trip(fresh_registries):
    """Every key kind, the heavy-path layout and K caps included, is saved
    and loaded back as it was, and the file's keys are the JAX package's."""
    for tree in (_tree(30, 9, 12), _tree(31, 8, 14)):
        th.CodedPlan.from_tree(tree, 0.1)
        ts.StridePlan.from_tree(tree, 0.1)
    names = ("_LAYOUT_REGISTRY", "_K_REGISTRY", "_ROUNDS_REGISTRY", "_SCAN_REGISTRY",
             "_REAL_ROUNDS_REGISTRY", "_BUCKET_REGISTRY")
    before = {name: dict(getattr(th, name)) for name in names}
    assert all(before.values())
    with open(th._registry_file()) as f:
        kinds = {k.split(":")[0] if not k[0].isdigit() else "layout" for k in json.load(f)}
    assert kinds == {"layout", "K", "R", "S", "NR", "B"}
    for name in names:
        getattr(th, name).clear()
    th._REGISTRY_LOADED = False
    th._registry_load()
    after = {name: dict(getattr(th, name)) for name in names}
    assert after == before


def test_mixed_builds_converge_to_jax_layouts(fresh_registries):
    """HPD, plan-order, coded and stride plans of one N share the round
    and scan registries: after the same builds in the same order, every
    registry of the port holds what JAX's holds, and a stride plan built
    last has JAX's layout."""
    from gpu_stereo_matching_tpu.tree import stride as js

    trees = [_tree(32 + i, 12, 15) for i in range(3)]
    builds = [(th.CodedPlan, jh.CodedPlan, 0), (ts.StridePlan, js.StridePlan, 1),
              (th.HeavyPathPlan, jh.HeavyPathPlan, 2), (th.PlanOrderPlan, jh.PlanOrderPlan, 1),
              (th.CodedPlan, jh.CodedPlan, 2)]
    for ours, theirs, i in builds:
        ours.from_tree(trees[i], 0.1)
        theirs.from_tree(_jtree(trees[i]), 0.1)
    for name in ("_LAYOUT_REGISTRY", "_K_REGISTRY", "_ROUNDS_REGISTRY", "_SCAN_REGISTRY",
                 "_REAL_ROUNDS_REGISTRY", "_BUCKET_REGISTRY"):
        assert getattr(th, name) == getattr(jh, name), name
    ours = ts.StridePlan.from_tree(trees[0], 0.1)
    theirs = js.StridePlan.from_tree(_jtree(trees[0]), 0.1)
    assert ours.layout_key == theirs.layout_key
    _eq(ours.ints, theirs.ints)


# ---------------------------------------------------------------- filters


def _ours(kind, tree, cost, **kw):
    c = torch.from_numpy(cost)
    if kind == "hpd":
        return th.tree_filter_nodes_hpd(c, th.HeavyPathPlan.from_tree(tree, 0.1))
    if kind == "po":
        return th.tree_filter_nodes_po(c, th.PlanOrderPlan.from_tree(tree, 0.1))
    return th.tree_filter_nodes_po_coded(c, th.CodedPlan.from_tree(tree, 0.1), **kw)


def _theirs(kind, tree, cost, jit=True, **kw):
    jt, c = _jtree(tree), jnp.asarray(cost)
    if kind == "hpd":
        fn, plan = jh.tree_filter_nodes_hpd, jh.HeavyPathPlan.from_tree(jt, 0.1)
    elif kind == "po":
        fn, plan = jh.tree_filter_nodes_po, jh.PlanOrderPlan.from_tree(jt, 0.1)
    else:
        fn, plan = jh.tree_filter_nodes_po_coded, jh.CodedPlan.from_tree(jt, 0.1)
    if jit:
        return np.asarray(jax.jit(lambda c, p: fn(c, p, **kw))(c, plan))
    with jax.disable_jit():
        return np.asarray(fn(c, plan, **kw))


FORMULATIONS = [("hpd", {}), ("po", {}), ("coded", {"assoc_scan": True}),
                ("coded", {"assoc_scan": False})]


@pytest.mark.parametrize("kind,kw", FORMULATIONS)
@pytest.mark.parametrize("hw", [(9, 12), (16, 21), (1, 8)])
def test_filter_matches_jitted_jax(fresh_registries, kind, kw, hw):
    h, w = hw
    tree = _tree(5, h, w)
    cost = _cost(6, h * w, 6)
    got = _ours(kind, tree, cost, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h * w, 6)
    np.testing.assert_allclose(got.numpy(), _theirs(kind, tree, cost, **kw),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("kind,kw", FORMULATIONS)
def test_filter_equals_jax_op_by_op(fresh_registries, kind, kw):
    """Op by op the JAX filter does the port's float operations in the
    port's order (its associative scan included), so the two give the
    same bits."""
    tree = _tree(7, 9, 12)
    cost = _cost(8, 9 * 12, 5)
    np.testing.assert_array_equal(_ours(kind, tree, cost, **kw).numpy(),
                                  _theirs(kind, tree, cost, jit=False, **kw))


def test_coded_argmin_matches_jax(fresh_registries):
    tree = _tree(9, 16, 21)
    cost = _cost(10, 16 * 21, 8)
    got = _ours("coded", tree, cost, reduce="argmin")
    full = _ours("coded", tree, cost)
    assert got.dtype == torch.int32 and tuple(got.shape) == (16 * 21,)
    assert torch.equal(got, torch.argmin(full, dim=1).to(torch.int32))
    want = _theirs("coded", tree, cost, reduce="argmin")
    assert float(np.mean(got.numpy() == want)) >= 0.99
    with jax.disable_jit():
        exact = jh.tree_filter_nodes_po_coded(
            jnp.asarray(cost), jh.CodedPlan.from_tree(_jtree(tree), 0.1), reduce="argmin")
    np.testing.assert_array_equal(got.numpy(), np.asarray(exact))


@pytest.mark.parametrize("hw", [(7, 9), (16, 21), (1, 8), (23, 31)])
def test_coded_with_the_associative_scan_equals_plan_order(hw):
    tree = _tree(11, *hw)
    cost = _cost(12, hw[0] * hw[1], 6)
    assert torch.equal(_ours("coded", tree, cost, assoc_scan=True), _ours("po", tree, cost))


@pytest.mark.parametrize("kind,kw", FORMULATIONS)
def test_filters_match_the_level_filter_and_the_oracle(kind, kw):
    h, w = 16, 21
    tree = _tree(13, h, w)
    cost = _cost(14, h * w, 6)
    got = _ours(kind, tree, cost, **kw).numpy()
    level = tf.tree_filter_nodes(torch.from_numpy(cost), tf.TreeFilterPlan.from_tree(tree, 0.1))
    np.testing.assert_allclose(got, level.numpy(), rtol=2e-5, atol=2e-5)
    want = oracles.tree_filter_oracle(cost, tree.bfs_order, tree.parent, tree.parent_weights(0.1))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_filters_of_a_larger_tree_match_the_level_filter():
    """40x37, σ 0.08 (``tests/test_tree.py``'s large HPD case)."""
    tree = _tree(15, 40, 37, tau=300.0, min_size=20)
    cost = torch.from_numpy(_cost(16, 40 * 37, 8))
    want = tf.tree_filter_nodes(cost, tf.TreeFilterPlan.from_tree(tree, 0.08)).numpy()
    for got in (th.tree_filter_nodes_hpd(cost, th.HeavyPathPlan.from_tree(tree, 0.08)),
                th.tree_filter_nodes_po(cost, th.PlanOrderPlan.from_tree(tree, 0.08)),
                th.tree_filter_nodes_po_coded(cost, th.CodedPlan.from_tree(tree, 0.08))):
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def _frames(b, h, w, d, seed):
    trees = [_tree(seed + i, h, w) for i in range(b)]
    costs = np.stack([_cost(seed + 100 + i, h * w, d) for i in range(b)])
    return trees, costs


def test_batched_equals_per_frame_and_jax(fresh_registries):
    trees, costs = _frames(3, 12, 15, 7, 40)
    batch = th.converged_plan_batch(trees, 0.1)
    got = th.tree_filter_nodes_po_batched(torch.from_numpy(costs), batch)
    assert tuple(got.shape) == costs.shape
    for i in range(3):
        assert torch.equal(got[i], th.tree_filter_nodes_po(torch.from_numpy(costs[i]),
                                                           batch.frame(i)))
    jbatch = jh.converged_plan_batch([_jtree(t) for t in trees], 0.1)
    want = jax.jit(jh.tree_filter_nodes_po_batched)(jnp.asarray(costs), jbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("b", [2, 4])
def test_merged_equals_per_frame(fresh_registries, b):
    trees, costs = _frames(b, 12, 15, 7, 50)
    th.converged_plan_batch(trees, 0.1)
    plans = [th.PlanOrderPlan.from_tree(t, 0.1) for t in trees]
    got = th.tree_filter_nodes_po_merged(torch.from_numpy(costs), th.merge_plans(plans))
    for i in range(b):
        assert torch.equal(got[i], th.tree_filter_nodes_po(torch.from_numpy(costs[i]), plans[i]))


def test_merged_of_three_equals_jax_op_by_op(fresh_registries):
    trees, costs = _frames(3, 9, 12, 5, 60)
    th.converged_plan_batch(trees, 0.1)
    merged = th.merge_plans([th.PlanOrderPlan.from_tree(t, 0.1) for t in trees])
    got = th.tree_filter_nodes_po_merged(torch.from_numpy(costs), merged)
    jtrees = [_jtree(t) for t in trees]
    jh.converged_plan_batch(jtrees, 0.1)
    jmerged = jh.merge_plans([jh.PlanOrderPlan.from_tree(t, 0.1, device=False)
                              for t in jtrees])
    with jax.disable_jit():
        want = jh.tree_filter_nodes_po_merged(jnp.asarray(costs), jh.PlanOrderPlan(
            jmerged.num_nodes, jmerged.total_pos, jmerged.rounds_meta,
            jnp.asarray(jmerged.ints), jnp.asarray(jmerged.floats)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- scans


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 64, 97])
@pytest.mark.parametrize("reverse", [False, True])
def test_assoc_scan_equals_jax_op_by_op(n, reverse):
    """``_assoc_scan`` is ``jax.lax.associative_scan`` over ``_combine``
    bit for bit, signed zeros included (JAX's interleave leaves a -0.0 as
    +0.0), at even, odd and length-1 inputs."""
    rng = np.random.default_rng(n + 1000 * reverse)
    a = rng.uniform(0.0, 0.99, (n, 1)).astype(np.float32)
    a[rng.random(n) < 0.2] = 0.0
    b = rng.standard_normal((n, 3)).astype(np.float32)
    b[rng.random((n, 3)) < 0.2] = -0.0
    got = th._assoc_scan(torch.from_numpy(a), torch.from_numpy(b), reverse=reverse).numpy()
    with jax.disable_jit():
        want = np.asarray(jax.lax.associative_scan(
            jh._combine, (jnp.asarray(a), jnp.asarray(b)), reverse=reverse, axis=0)[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def test_seg_scan_is_the_stride_scan_and_matches_jax():
    """One doubling scan serves the coded and the stride filters."""
    assert ts._scan_affine is th._scan_affine
    rng = np.random.default_rng(3)
    a = rng.uniform(0.1, 0.99, (96, 1)).astype(np.float32)
    a[::16] = 0.0
    b = rng.standard_normal((96, 4)).astype(np.float32)
    for reverse in (False, True):
        got = th._scan_affine(torch.from_numpy(a), torch.from_numpy(b), 4, reverse).numpy()
        with jax.disable_jit():
            want = np.asarray(jh._seg_scan(jnp.asarray(a), jnp.asarray(b), 4, reverse))
        np.testing.assert_array_equal(got, want)


def test_coded_fields_reconstruct_the_plan_order_floats():
    tree = _tree(17, 14, 19)
    plan = th.PlanOrderPlan.from_tree(tree, 0.1)
    coded = th.CodedPlan.from_tree(tree, 0.1)
    _w, heavy_a, down_a, omw2, head_w = th._reconstruct_po_fields(coded.codes, coded.table)
    rounds, offs, _perm, _inv = th._unpack_po(plan)
    for off, (l, _k), (_hs, _ls, r_heavy, r_down, r_omw2, r_headw, _lw) in zip(
            offs, plan.rounds_meta, rounds):
        for got, want in ((heavy_a, r_heavy), (down_a, r_down), (omw2, r_omw2),
                          (head_w, r_headw)):
            assert torch.equal(got[off : off + l], want)


# ---------------------------------------------------------------- errors


def test_hpd_padding_is_checked():
    """The padded tail that the HPD filter's scatters may repeat is
    checked on the host: a light entry moved off it is refused."""
    plan = th.HeavyPathPlan.from_tree(_tree(18, 9, 12), 0.1)
    assert plan.light_slots.shape[0] == 2 and len(plan.slot_meta) == len(plan.rounds_meta)
    ints = plan.ints.clone()
    io = 0
    for m in plan.rounds_meta:
        l, h, k = m.num_nodes, m.num_heads, m.num_lights
        lc = ints[io + l + 2 * h : io + l + 2 * h + k]
        lpp = ints[io + l + 2 * h + k : io + l + 2 * h + 2 * k]
        dummy = torch.nonzero(lc == plan.num_nodes).flatten()
        if len(dummy):
            lpp[dummy[0]] = 0
            break
        io += l + 2 * h + 2 * k
    with pytest.raises(AssertionError, match="dummy light entry"):
        th.HeavyPathPlan(plan.num_nodes, plan.rounds_meta, ints, plan.floats)


def test_diverged_layouts_are_refused(fresh_registries):
    t_a, t_b = _tree(19, 10, 11), _tree(20, 9, 12)  # N = 110 and 108
    po = [th.PlanOrderPlan.from_tree(t, 0.1) for t in (t_a, t_b)]
    coded = [th.CodedPlan.from_tree(t, 0.1) for t in (t_a, t_b)]
    assert po[0].total_pos != po[1].total_pos or po[0].rounds_meta != po[1].rounds_meta
    with pytest.raises(ValueError, match="plan layouts diverged"):
        th.stack_plans(po)
    with pytest.raises(ValueError, match="plan layouts diverged"):
        th.merge_plans(po)
    with pytest.raises(ValueError, match="plan layouts diverged"):
        th.stack_coded_plans(coded)
    other_sigma = th.CodedPlan.from_tree(t_a, 0.2)
    with pytest.raises(ValueError, match="one weight table"):
        th.stack_coded_plans([coded[0], dataclasses.replace(other_sigma, ints=coded[0].ints,
                                                            codes=coded[0].codes)])


def test_code_plan_refuses_a_device_plan():
    tree = _tree(21, 9, 12)
    plan = th.PlanOrderPlan.from_tree(tree, 0.1).to("meta")
    with pytest.raises(TypeError, match="host-side plan"):
        th.code_plan(plan, tree, 0.1)
    with pytest.raises(TypeError):
        jh.code_plan(jh.PlanOrderPlan.from_tree(_jtree(tree), 0.1), _jtree(tree), 0.1)


def test_code_plan_refuses_2_pow_24_positions(fresh_registries):
    """A plan of 2^24 positions cannot be packed 24-bit: both packages
    raise before packing (the plan's arrays are never read that far)."""
    tree = _tree(22, 4, 5)
    meta = ((1 << 24, 0),)
    ints = np.full(8, tree.num_nodes, np.int32)
    floats = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="2\\^24"):
        th.code_plan(th.PlanOrderPlan(tree.num_nodes, 1 << 24, meta, ints, floats), tree, 0.1)
    with pytest.raises(ValueError, match="2\\^24"):
        jh.code_plan(jh.PlanOrderPlan(tree.num_nodes, 1 << 24, meta, ints, floats),
                     _jtree(tree), 0.1)


def test_coded_filter_refuses_a_bad_index_stream():
    plan = th.CodedPlan.from_tree(_tree(23, 9, 12), 0.1)
    bad = dataclasses.replace(plan, ints=plan.ints.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(L,\) i32 or \(3, L\) u8"):
        th.tree_filter_nodes_po_coded(torch.zeros(9 * 12, 3), bad)
