"""Port sharded block matching on a virtual CPU mesh, bit-exact against the
JAX sharded steps on the 8 virtual CPU devices (Pallas in interpret mode)
and against the port's single-device functions; halos, mesh construction,
the scaling sweep and the launcher at a tiny size."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig as JaxBMConfig
from gpu_stereo_matching_tpu.core.config import MeshConfig as JaxMeshConfig
from gpu_stereo_matching_tpu.models.block_matching import block_matching_pipeline as jax_pipeline
from gpu_stereo_matching_tpu.parallel import halo as jhalo
from gpu_stereo_matching_tpu.parallel import mesh as jmesh
from gpu_stereo_matching_tpu.parallel import stereo as jstereo
from gpu_stereo_matching_tpu_torch import convert
from gpu_stereo_matching_tpu_torch.bench.scaling import run_scaling_benchmark
from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig, MeshConfig
from gpu_stereo_matching_tpu_torch.kernels import sad_wta as tsad
from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu_torch.parallel import launch
from gpu_stereo_matching_tpu_torch.parallel.halo import extend_with_row_halos
from gpu_stereo_matching_tpu_torch.parallel.mesh import DeviceMesh, build_mesh, virtual_mesh
from gpu_stereo_matching_tpu_torch.parallel.stereo import (
    make_sharded_block_matching,
    make_sharded_block_matching_full,
    shard_batch,
    unshard,
)


@pytest.fixture(autouse=True)
def _need_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _batch(seed, shape):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 256, shape, dtype=np.uint8),
        rng.integers(0, 256, shape, dtype=np.uint8),
    )


def _meshes(mesh_shape):
    """The JAX mesh on the virtual CPU devices and the port's mesh on
    ``cpu``, built from one description."""
    jm = jmesh.build_mesh(JaxMeshConfig(*mesh_shape))
    cfg = convert.mesh_config_from_jax(dict(zip(jm.axis_names, jm.devices.shape)))
    return jm, virtual_mesh(cfg, "cpu")


def _jax_run(step, jm, left, right):
    jl, jr = jstereo.shard_batch(jm, jnp.asarray(left), jnp.asarray(right))
    return np.asarray(step(jl, jr))


def _port_run(step, mesh, left, right):
    sl, sr = shard_batch(mesh, torch.from_numpy(left), torch.from_numpy(right))
    out = unshard(step(sl, sr))
    assert out.dtype == torch.int32 and tuple(out.shape) == left.shape
    return out.numpy()


# The mesh shapes and sizes of tests/test_parallel.py.
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize(
    "mesh_shape",
    [(1, 1, 1), (2, 1, 1), (1, 4, 1), (1, 1, 4), (2, 2, 2), (1, 4, 2), (1, 2, 2), (2, 1, 2)],
)
def test_sharded_step_matches_jax(mesh_shape, use_kernel):
    left, right = _batch(1234, (4, 24, 20))
    jm, mesh = _meshes(mesh_shape)
    jax_cfg = JaxBMConfig(num_disparities=8, sad_radius=2)
    cfg = BlockMatchingConfig(num_disparities=8, sad_radius=2)
    want = _jax_run(
        jstereo.make_sharded_block_matching(jm, jax_cfg, use_pallas=use_kernel, interpret=True),
        jm, left, right,
    )
    before = tsad.KEY_LAUNCHES
    got = _port_run(make_sharded_block_matching(mesh, cfg, use_kernel=use_kernel), mesh, left, right)
    np.testing.assert_array_equal(got, want)
    assert tsad.KEY_LAUNCHES == before  # CPU shards run the twin
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    np.testing.assert_array_equal(got, tsad.fused_block_matching_batched(lt, rt, 8, 2).numpy())
    np.testing.assert_array_equal(got, block_matching_pipeline(lt, rt, cfg).numpy())


@pytest.mark.parametrize("mesh_shape", [(1, 1, 1), (1, 4, 1), (2, 2, 2), (1, 2, 4)])
def test_sharded_full_step_matches_jax(mesh_shape):
    left, right = _batch(1234, (2, 24, 20))
    jm, mesh = _meshes(mesh_shape)
    kwargs = dict(num_disparities=8, sad_radius=2, lr_consistency=True, median_radius=2)
    want = _jax_run(jstereo.make_sharded_block_matching_full(jm, JaxBMConfig(**kwargs)),
                    jm, left, right)
    cfg = BlockMatchingConfig(**kwargs)
    got = _port_run(make_sharded_block_matching_full(mesh, cfg), mesh, left, right)
    np.testing.assert_array_equal(got, want)
    single = block_matching_pipeline(torch.from_numpy(left), torch.from_numpy(right), cfg)
    np.testing.assert_array_equal(got, single.numpy())


@pytest.mark.parametrize("median_radius", [0, 1])
def test_sharded_full_step_other_radii_match_jax(median_radius):
    """No median (the halo is the SAD radius alone) and a 3x3 median, with
    a looser LR tolerance."""
    left, right = _batch(77, (2, 24, 36))
    jm, mesh = _meshes((1, 2, 2))
    kwargs = dict(num_disparities=12, sad_radius=3, lr_max_diff=2, median_radius=median_radius)
    want = _jax_run(jstereo.make_sharded_block_matching_full(jm, JaxBMConfig(**kwargs)),
                    jm, left, right)
    got = _port_run(make_sharded_block_matching_full(mesh, BlockMatchingConfig(**kwargs)),
                    mesh, left, right)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [4, 16, 30])
@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (1, 1, 4)])
def test_plain_step_follows_the_fused_formula_at_d64(seed, mesh_shape):
    """D=64, r=5: the zero halo rows at the global border are real rows of
    the slab, so the sharded step, with the kernel and without it, equals
    the fused kernel everywhere and differs from the unfused pipeline
    within r rows of the top and bottom, exactly as the JAX step does."""
    left, right = _batch(seed, (1, 30, 120))
    jm, mesh = _meshes(mesh_shape)
    cfg = BlockMatchingConfig(num_disparities=64, sad_radius=5)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    fused = tsad.fused_block_matching_batched(lt, rt, 64, 5).numpy()
    for use_kernel in (True, False):
        got = _port_run(make_sharded_block_matching(mesh, cfg, use_kernel), mesh, left, right)
        np.testing.assert_array_equal(got, fused)
    want = _jax_run(
        jstereo.make_sharded_block_matching(jm, JaxBMConfig(num_disparities=64, sad_radius=5)),
        jm, left, right,
    )
    np.testing.assert_array_equal(fused, want)
    ops = block_matching_pipeline(lt, rt, cfg).numpy()
    rows = np.nonzero((ops != fused).any(axis=(0, 2)))[0]
    assert rows.size > 0 and np.all((rows < 5) | (rows >= 25))
    jax_ops = np.asarray(jax_pipeline(jnp.asarray(left), jnp.asarray(right),
                                      JaxBMConfig(num_disparities=64, sad_radius=5)))
    np.testing.assert_array_equal(ops, jax_ops)


@pytest.mark.parametrize("seed,differs", [(4, 0), (16, 0), (30, 0), (127, 13), (151, 5)])
def test_full_step_at_d64_against_the_unfused_pipeline(seed, differs):
    """D=64, r=5, LR, median r=3 on (1, 2, 2): the full step equals the JAX
    full step; against the single-device bm+ pipeline it differs on
    ``differs`` pixels (its slab charges invalid columns in the zero halo
    rows, the fused formula, before LR and the median)."""
    left, right = _batch(seed, (1, 30, 120))
    jm, mesh = _meshes((1, 2, 2))
    kwargs = dict(num_disparities=64, sad_radius=5, lr_consistency=True, median_radius=3)
    cfg = BlockMatchingConfig(**kwargs)
    got = _port_run(make_sharded_block_matching_full(mesh, cfg), mesh, left, right)
    want = _jax_run(jstereo.make_sharded_block_matching_full(jm, JaxBMConfig(**kwargs)),
                    jm, left, right)
    np.testing.assert_array_equal(got, want)
    single = block_matching_pipeline(torch.from_numpy(left), torch.from_numpy(right), cfg)
    assert int((single.numpy() != got).sum()) == differs


def test_radius_zero_plain_step_keeps_int32_keys():
    """r = 0: the JAX plain step packs its key from the uint8 cost volume,
    which wraps; the JAX Pallas step and the single-device pipeline do not.
    The port's plain step packs in int32 and agrees with those two."""
    left, right = _batch(0, (2, 8, 20))
    jm, mesh = _meshes((1, 1, 2))
    jax_cfg = JaxBMConfig(num_disparities=8, sad_radius=0)
    cfg = BlockMatchingConfig(num_disparities=8, sad_radius=0)
    wrapped = _jax_run(jstereo.make_sharded_block_matching(jm, jax_cfg), jm, left, right)
    pallas = _jax_run(
        jstereo.make_sharded_block_matching(jm, jax_cfg, use_pallas=True, interpret=True),
        jm, left, right,
    )
    single = np.asarray(jax_pipeline(jnp.asarray(left), jnp.asarray(right), jax_cfg))
    np.testing.assert_array_equal(pallas, single)
    assert (wrapped != single).any()
    for use_kernel in (True, False):
        got = _port_run(make_sharded_block_matching(mesh, cfg, use_kernel), mesh, left, right)
        np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("n_space,radius", [(1, 2), (2, 3), (4, 1), (4, 6), (2, 0)])
def test_halos_match_jax_under_shard_map(n_space, radius):
    x = np.random.default_rng(5).integers(0, 256, (2, 24, 10), dtype=np.uint8)
    jm = jmesh.build_mesh(JaxMeshConfig(1, n_space, 1))
    spec = P(None, "space", None)
    f = shard_map(lambda a: jhalo.extend_with_row_halos(a, radius, "space"),
                  mesh=jm, in_specs=spec, out_specs=spec, check_vma=False)
    want = np.asarray(jax.jit(f)(jnp.asarray(x)))
    shards = list(torch.from_numpy(x).chunk(n_space, dim=1))
    got = extend_with_row_halos(shards, radius)
    assert all(g.shape[1] == 24 // n_space + 2 * max(radius, 0) for g in got)
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want)


def test_halo_edge_cases():
    x = torch.arange(24, dtype=torch.uint8).reshape(1, 6, 4)
    assert extend_with_row_halos([x], 0)[0] is x
    assert extend_with_row_halos([x], -1)[0] is x
    (one,) = extend_with_row_halos([x], 2)
    assert torch.equal(one[:, 2:-2], x) and not one[:, :2].any() and not one[:, -2:].any()
    top, bottom = extend_with_row_halos([x[:, :3], x[:, 3:]], 2)
    assert torch.equal(top[:, 2:], x[:, :5]) and torch.equal(bottom[:, :-2], x[:, 1:])
    with pytest.raises(ValueError, match="halo rows"):
        extend_with_row_halos([x[:, :3], x[:, 3:]], 4)


def test_mesh_construction():
    mesh = build_mesh(MeshConfig(2, 2, 2), ["cpu"] * 9)
    assert isinstance(mesh, DeviceMesh) and mesh.devices.shape == (2, 2, 2)
    assert mesh.shape == {"data": 2, "space": 2, "disp": 2}
    assert mesh.unique_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs 8 devices, have 7"):
        build_mesh(MeshConfig(2, 2, 2), ["cpu"] * 7)
    with pytest.raises(ValueError, match="unsupported device"):
        build_mesh(MeshConfig(), ["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            virtual_mesh(MeshConfig())  # the default device is the card


def test_mesh_is_data_outermost_like_jax(monkeypatch):
    """Device n of the list sits at the same coordinate in both meshes."""
    from gpu_stereo_matching_tpu_torch.parallel import mesh as tmesh

    jm = jmesh.build_mesh(JaxMeshConfig(2, 2, 2))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    monkeypatch.setattr(tmesh, "resolve_device", lambda d: d)  # stand-ins for 8 cards
    mesh = tmesh.build_mesh(MeshConfig(2, 2, 2), list(range(10)))
    np.testing.assert_array_equal(mesh.devices.astype(int), ids)
    assert mesh.unique_devices() == list(range(8))


def test_mesh_config_from_jax():
    jm = jmesh.build_mesh(JaxMeshConfig(1, 4, 2))
    cfg = convert.mesh_config_from_jax(dict(zip(jm.axis_names, jm.devices.shape)))
    assert cfg == MeshConfig(data=1, space=4, disp=2)
    assert convert.mesh_config_from_jax({"disp": 2, "data": 1, "space": 1}).shape == (1, 1, 2)
    with pytest.raises(ValueError, match="axes"):
        convert.mesh_config_from_jax({"data": 1, "space": 1})


def test_sharding_rejects_what_does_not_divide():
    mesh = virtual_mesh(MeshConfig(2, 4, 4), "cpu")
    with pytest.raises(ValueError, match="num_disparities"):
        make_sharded_block_matching(mesh, BlockMatchingConfig(num_disparities=6))
    with pytest.raises(ValueError, match="num_disparities"):
        make_sharded_block_matching_full(mesh, BlockMatchingConfig(num_disparities=6))
    u8 = torch.zeros((4, 24, 20), dtype=torch.uint8)
    with pytest.raises(ValueError, match="frames"):
        shard_batch(mesh, u8[:3], u8[:3])
    with pytest.raises(ValueError, match="rows"):
        shard_batch(mesh, u8[:, :22], u8[:, :22])
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        shard_batch(mesh, u8[0], u8[0])
    with pytest.raises(TypeError, match="uint8"):
        shard_batch(mesh, u8.float(), u8.float())


def test_shard_batch_layout_and_unshard_round_trip():
    left, right = _batch(8, (4, 24, 20))
    mesh = virtual_mesh(MeshConfig(2, 4, 2), "cpu")
    sl, sr = shard_batch(mesh, torch.from_numpy(left), torch.from_numpy(right))
    assert len(sl.pieces) == 2 and len(sl.pieces[0]) == 4 and len(sl.pieces[0][0]) == 2
    assert tuple(sl.pieces[1][2][1].shape) == (2, 6, 20)
    np.testing.assert_array_equal(sl.pieces[1][2][1].numpy(), left[2:, 12:18])
    np.testing.assert_array_equal(unshard(sl).numpy(), left)
    np.testing.assert_array_equal(unshard(sr, "cpu").numpy(), right)


def test_scaling_benchmark_runs_on_cpu(capsys):
    cfg = BlockMatchingConfig(num_disparities=8, sad_radius=2)
    points = run_scaling_benchmark(MeshConfig(2, 2, 2), ["cpu"] * 8, cfg, num_frames=4, height=16,
                                   width=24)
    assert [p.mesh for p in points] == [
        {"data": 1, "space": 2, "disp": 2}, {"data": 2, "space": 2, "disp": 2}]
    assert [p.devices for p in points] == [4, 8]
    assert points[0].efficiency is None and points[1].efficiency > 0
    assert all(p.fps > 0 and p.device == "cpu" for p in points)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [line["devices"] for line in lines] == [4, 8]
    listed = run_scaling_benchmark(MeshConfig(1, 2, 1), ["cpu", "cpu"], cfg, num_frames=2,
                                   height=16, width=24)
    assert len(listed) == 1 and listed[0].devices == 2


def test_launch_main_on_cpu(capsys):
    rc = launch.main(["--data", "2", "--space", "2", "--disp", "2", "--frames", "4",
                      "--height", "24", "--width", "72", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [line["mesh"]["data"] for line in lines] == [1, 2]
    assert all(line["device"] == "cpu" for line in lines)
    # A virtual mesh says so: 4 and 8 coordinates on one device, one process.
    assert [(line["devices"], line["distinct_devices"], line["processes"]) for line in lines] == [
        (4, 1, 1), (8, 1, 1)]
    for flag in ("--coordinator", "--num-processes", "--process-id"):
        with pytest.raises(SystemExit):
            launch.main([flag, "1"])
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.main(["--frames", "1"])  # the default device is the card


@pytest.mark.gpu
def test_sharded_steps_on_distinct_cards():
    """A mesh over more than one physical card: every coordinate's slab and
    kernel launch on its own device, halo rows and keys copied between
    cards. Both steps equal their single-card results at every pixel."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs at least two CUDA devices")
    shape = (1, 2, 2) if n >= 4 else (1, 1, 2)
    cards = [f"cuda:{i}" for i in range(shape[1] * shape[2])]
    mesh = build_mesh(MeshConfig(*shape), cards)
    assert [str(d) for d in mesh.unique_devices()] == cards
    cfg = BlockMatchingConfig(num_disparities=64, sad_radius=5, lr_consistency=True,
                              median_radius=3)
    for size in [(2, 60, 200), (2, 1080, 1920)]:
        left, right = (torch.from_numpy(x) for x in _batch(21, size))
        sl, sr = shard_batch(mesh, left, right)
        assert [[str(p.device) for p in band] for band in sl.pieces[0]] == [
            cards[j * shape[2]:(j + 1) * shape[2]] for j in range(shape[1])]
        before = tsad.KEY_LAUNCHES
        got = unshard(make_sharded_block_matching(mesh, cfg)(sl, sr), "cpu")
        assert tsad.KEY_LAUNCHES == before + len(cards)
        fused = tsad.fused_block_matching_batched(left.to("cuda:0"), right.to("cuda:0"), 64, 5)
        assert torch.equal(got, fused.cpu())
        one = virtual_mesh(MeshConfig(*shape), "cuda:0")
        want = unshard(make_sharded_block_matching_full(one, cfg)(*shard_batch(one, left, right)))
        got = unshard(make_sharded_block_matching_full(mesh, cfg)(sl, sr), "cpu")
        assert torch.equal(got, want.cpu())
