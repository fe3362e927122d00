"""The port's tree filters against the JAX package's and the sequential
oracle on the CPU: the stride-bucket filter (``tree_filter_nodes_sb``, lean
and ``lean=False`` plans) and the level-scan filter
(``tree_filter_nodes``), at the bands of ``tests/test_tree.py`` and
``tests/test_stride.py``, with their perm decode and inversion exact. The
JAX filter runs jitted (its first eager call compiles every op apart), and
once op by op under ``jax.disable_jit()``, where the port equals it bit for
bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.tree import builder as jb
from gpu_stereo_matching_tpu.tree import filter as jf
from gpu_stereo_matching_tpu.tree import stride as js
from gpu_stereo_matching_tpu_torch.tree import builder as tb
from gpu_stereo_matching_tpu_torch.tree import filter as tf
from gpu_stereo_matching_tpu_torch.tree import stride as ts
from tests import oracles
from tests.torch_st_helpers import fresh_registries  # noqa: F401

SHAPES = [(1, 1), (1, 8), (8, 1), (1, 17), (16, 1), (7, 9), (16, 21), (23, 17), (13, 29)]
# (shape, lean) held against the JAX filter; every case of SHAPES against
# the sequential oracle.
JAX_CASES = [((1, 1), True), ((1, 8), True), ((8, 1), True), ((16, 21), True), ((13, 29), True),
             ((23, 17), False), ((1, 17), False)]


def _tree(seed, h, w):
    ea, _eb = tb.grid_edges(h, w)
    weights = (np.random.default_rng(seed).random(len(ea)) * 60).astype(np.float32)
    return tb.build_segment_tree(weights, h, w, tau=100.0, min_size=6, penalty=5.0)


def _cost(seed, n, d):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def _oracle(cost, tree, sigma):
    return oracles.tree_filter_oracle(cost, tree.bfs_order, tree.parent,
                                      tree.parent_weights(sigma))


def _jax_plan(tree, sigma, lean):
    """The JAX package's plan over the same tree (a tree is plain arrays)."""
    jtree = jb.SegmentTree(**{f: getattr(tree, f) for f in (
        "height", "width", "bfs_order", "parent", "parent_dist", "level_of", "level_start",
        "dfs_order", "subtree_size")})
    return jtree, js.StridePlan.from_tree(jtree, sigma, lean=lean)


@pytest.fixture(scope="module")
def jax_sb():
    return jax.jit(js.tree_filter_nodes_sb)


def _sb(hw, lean):
    h, w = hw
    tree = _tree(1, h, w)
    cost = _cost(2, h * w, 6)
    got = ts.tree_filter_nodes_sb(torch.from_numpy(cost), ts.StridePlan.from_tree(
        tree, 0.1, lean=lean))
    assert got.dtype == torch.float32 and tuple(got.shape) == (h * w, 6)
    return tree, cost, got


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("lean", [True, False])
def test_stride_filter_matches_oracle(hw, lean):
    tree, cost, got = _sb(hw, lean)
    np.testing.assert_allclose(got.numpy(), _oracle(cost, tree, 0.1), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hw,lean", JAX_CASES)
def test_stride_filter_matches_jax(jax_sb, hw, lean):
    tree, cost, got = _sb(hw, lean)
    _jtree, jplan = _jax_plan(tree, 0.1, lean)
    want = np.asarray(jax_sb(jnp.asarray(cost), jplan))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("lean", [True, False])
def test_stride_filter_equals_jax_op_by_op(fresh_registries, lean):
    """Run op by op, the JAX filter does the port's float operations in the
    port's order (jitted, XLA contracts the scans' multiply-adds), so the
    two give the same bits."""
    tree, cost, got = _sb((13, 29), lean)
    _jtree, jplan = _jax_plan(tree, 0.1, lean)
    with jax.disable_jit():
        want = np.asarray(js.tree_filter_nodes_sb(jnp.asarray(cost), jplan))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(13, 29), (23, 17), (1, 17), (16, 1)])
def test_lean_and_legacy_plans_filter_bit_identically(hw):
    tree = _tree(3, *hw)
    cost = torch.from_numpy(_cost(4, hw[0] * hw[1], 5))
    lean = ts.StridePlan.from_tree(tree, 0.1, lean=True)
    legacy = ts.StridePlan.from_tree(tree, 0.1, lean=False)
    assert lean.transport_nbytes < legacy.transport_nbytes
    assert torch.equal(ts.tree_filter_nodes_sb(cost, lean),
                       ts.tree_filter_nodes_sb(cost, legacy))


@pytest.mark.parametrize("hw", [(13, 29), (8, 1), (1, 1)])
def test_perm_decode_and_inversion_match_jax(fresh_registries, hw):
    tree = _tree(5, *hw)
    plan = ts.StridePlan.from_tree(tree, 0.1, lean=False)
    ints = ts._unpack_ints24(plan.ints)
    heads, inv_shipped, _streams = ts._unpack_sb_ints(ints, plan)
    zero = (plan.codes[1].to(torch.int32) & 1) != 0
    perm = ts._decode_perm(heads, plan.res, zero, plan)
    _jtree, jplan = _jax_plan(tree, 0.1, False)
    jints = js._unpack_ints24(jnp.asarray(jplan.ints))
    jheads, _jinv, _ = js._unpack_sb_ints(jints, jplan)
    jzero = (jnp.asarray(jplan.codes[1]).astype(jnp.int32) & 1) != 0
    jperm = js._decode_perm(jheads, jnp.asarray(jplan.res), jzero, jplan)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    inv = ts._invert_perm(perm, plan.num_nodes)
    np.testing.assert_array_equal(inv.numpy(), inv_shipped.numpy())
    np.testing.assert_array_equal(inv.numpy(), np.asarray(js._invert_perm(jperm,
                                                                          plan.num_nodes)))


def test_stride_filter_of_a_larger_tree_matches_the_level_filter():
    tree = _tree(6, 40, 37)
    cost = torch.from_numpy(_cost(7, 40 * 37, 8))
    got = ts.tree_filter_nodes_sb(cost, ts.StridePlan.from_tree(tree, 0.08))
    want = tf.tree_filter_nodes(cost, tf.TreeFilterPlan.from_tree(tree, 0.08))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("hw", SHAPES)
def test_level_filter_matches_jax_and_oracle(hw):
    h, w = hw
    tree = _tree(8, h, w)
    cost = _cost(9, h * w, 5)
    got = tf.tree_filter_nodes(torch.from_numpy(cost), tf.TreeFilterPlan.from_tree(tree, 0.1))
    jtree, _ = _jax_plan(tree, 0.1, True)
    want = np.asarray(jf.tree_filter_nodes(jnp.asarray(cost), jf.TreeFilterPlan.from_tree(
        jtree, 0.1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _oracle(cost, tree, 0.1), rtol=2e-5, atol=2e-5)


def test_tree_filter_volume_wrapper_matches_jax():
    h, w, d = 9, 12, 5
    tree = _tree(10, h, w)
    cost = np.random.default_rng(11).random((d, h, w)).astype(np.float32)
    got = tf.tree_filter(torch.from_numpy(cost), tree, sigma=0.1)
    jtree, _ = _jax_plan(tree, 0.1, True)
    want = np.asarray(jf.tree_filter(jnp.asarray(cost), jtree, sigma=0.1))
    assert tuple(got.shape) == (d, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_uniform_weights_give_the_global_sum():
    """All distances 0: every weight is 1 and each node's filtered cost is
    the sum over all nodes, in both filters."""
    h, w, d = 5, 6, 3
    tree = tb.build_segment_tree(np.zeros(2 * h * w - h - w, np.float32), h, w,
                                 tau=1e9, min_size=1000, penalty=0.0)
    cost = _cost(12, h * w, d)
    want = np.broadcast_to(cost.sum(axis=0), cost.shape)
    for got in (ts.tree_filter_nodes_sb(torch.from_numpy(cost), ts.StridePlan.from_tree(tree, 0.1)),
                tf.tree_filter_nodes(torch.from_numpy(cost), tf.TreeFilterPlan.from_tree(tree, 0.1))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
