"""Sharded segment-tree stereo in the port (``parallel/segment_tree.py``)
on virtual CPU meshes, at the JAX tests' shapes (H = 8 · space, W = 18,
D = 5, tau 90, min size 5): bit for bit equal to the port's tiled entries
with as many tiles (the JAX contract, ``tests/test_parallel.py:94-139``),
and against the JAX sharded entries on the 8 virtual CPU devices by the
share of equal pixels (ST-1 0.99, ST-2 0.97: XLA contracts some float
multiply-adds in the jitted filter). Then the checks, the ST-2 past 128
levels, and on a card the card against the CPU."""

import numpy as np
import pytest
import torch

import jax

from gpu_stereo_matching_tpu.core.config import MeshConfig as JaxMeshConfig
from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig as JaxConfig
from gpu_stereo_matching_tpu.parallel import mesh as jmesh
from gpu_stereo_matching_tpu.parallel import segment_tree as jpst
from gpu_stereo_matching_tpu_torch.core.config import MeshConfig, SegmentTreeConfig
from gpu_stereo_matching_tpu_torch.models import segment_tree_tiled as ttiled
from gpu_stereo_matching_tpu_torch.parallel import segment_tree as tpst
from gpu_stereo_matching_tpu_torch.parallel.mesh import virtual_mesh
from tests.torch_st_helpers import fresh_registries  # noqa: F401

SMALL = dict(max_disp_levels=5, tau=90.0, min_size_seg=5)
CFG = SegmentTreeConfig(**SMALL)


def _pair(seed, h, w=18):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 4, 1), (2, 2, 1), (1, 2, 2)],
                         ids=["space2", "space4", "data2-space2", "space2-disp2"])
def test_sharded_equals_tiled(shape):
    space = shape[1]
    left, right = _pair(space * 10 + shape[0], 8 * space)
    mesh = virtual_mesh(MeshConfig(*shape), "cpu")
    st1 = tpst.st1_disparity_sharded(left, right, mesh, CFG)
    st2 = tpst.st2_disparity_sharded(left, right, mesh, CFG)
    assert st1.dtype == st2.dtype == torch.uint8 and st1.device.type == "cpu"
    assert torch.equal(st1, ttiled.st1_disparity_tiled(left, right, space, CFG, device="cpu"))
    assert torch.equal(st2, ttiled.st2_disparity_tiled(left, right, space, CFG, device="cpu"))


@pytest.fixture
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@pytest.mark.parametrize("space", [2, 4])
def test_sharded_matches_jax(_eight_devices, fresh_registries, space):
    left, right = _pair(space, 8 * space)
    jm = jmesh.build_mesh(JaxMeshConfig(data=1, space=space, disp=1))
    mesh = virtual_mesh(MeshConfig(1, space, 1), "cpu")
    for fn, jfn, least in ((tpst.st1_disparity_sharded, jpst.st1_disparity_sharded, 0.99),
                           (tpst.st2_disparity_sharded, jpst.st2_disparity_sharded, 0.97)):
        got = fn(left, right, mesh, CFG).numpy()
        want = jfn(left, right, jm, JaxConfig(**SMALL))
        assert got.shape == want.shape == (8 * space, 18)
        assert float(np.mean(got == want)) >= least


def test_build_band_plans_and_a_callers_plan():
    """``plan=`` takes the stacked plan of :func:`build_band_plans`; the
    plan has one frame a band on the host."""
    left, right = _pair(5, 24)
    mesh = virtual_mesh(MeshConfig(1, 3, 1), "cpu")
    plan = tpst.build_band_plans(left, 3, CFG)
    assert plan.ints.shape[0] == 3 and plan.ints.device.type == "cpu"
    assert plan.num_nodes == 8 * 18
    assert torch.equal(tpst.st1_disparity_sharded(left, right, mesh, CFG, plan=plan),
                       tpst.st1_disparity_sharded(left, right, mesh, CFG))


def test_indivisible_height_raises_the_jax_message():
    left, right = _pair(6, 10, 12)
    cfg = SegmentTreeConfig(max_disp_levels=4, tau=90.0, min_size_seg=5)
    mesh = virtual_mesh(MeshConfig(1, 4, 1), "cpu")
    for call in (lambda: tpst.st1_disparity_sharded(left, right, mesh, cfg),
                 lambda: tpst.st2_disparity_sharded(left, right, mesh, cfg),
                 lambda: tpst.build_band_plans(left, 4, cfg),
                 lambda: tpst.st1_disparity_sharded(
                     left, right, mesh, cfg, plan=tpst.build_band_plans(left, 2, cfg))):
        with pytest.raises(ValueError, match="H=10 must divide into 4 equal bands"):
            call()
    with pytest.raises(ValueError, match="st1_sharded: left/right shapes differ"):
        tpst.st1_disparity_sharded(left, right[:, :-1], mesh, cfg)


def test_sharded_st2_runs_past_128_levels():
    """Phase A keeps the map and the mask apart, so 129 levels run; the
    tiled ST-2 (per-frame ST-2 packs both into a byte) refuses them."""
    left, right = _pair(7, 16, 132)
    cfg = SegmentTreeConfig(max_disp_levels=129, tau=90.0, min_size_seg=5)
    got = tpst.st2_disparity_sharded(left, right, virtual_mesh(MeshConfig(1, 2, 1), "cpu"), cfg)
    assert tuple(got.shape) == (16, 132) and got.dtype == torch.uint8
    with pytest.raises(ValueError, match="num_disp <= 128"):
        ttiled.st2_disparity_tiled(left, right, 2, cfg, device="cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the median kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_sharded_on_the_cards_equal_the_cpu(card):
    """On a mesh of the cards there are (every coordinate on ``cuda:0``
    with one card) the sharded entries give the CPU's maps bit for bit,
    launching kernel D once a band (three times for ST-2)."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median
    from gpu_stereo_matching_tpu_torch.parallel.mesh import build_mesh

    cfg = SegmentTreeConfig(max_disp_levels=16)
    left, right = _pair(8, 64, 64)
    n = torch.cuda.device_count()
    devices = [f"cuda:{k % n}" for k in range(4)]
    mesh = build_mesh(MeshConfig(1, 4, 1), devices)
    cpu = virtual_mesh(MeshConfig(1, 4, 1), "cpu")
    for fn, per in ((tpst.st1_disparity_sharded, 1), (tpst.st2_disparity_sharded, 3)):
        before = ctmf_median.LAUNCHES
        got = fn(left, right, mesh, cfg)
        assert ctmf_median.LAUNCHES - before == 4 * per
        assert got.device == torch.device(devices[0])
        assert torch.equal(got.cpu(), fn(left, right, cpu, cfg))
