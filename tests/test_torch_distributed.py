"""The port's sharded steps across processes: two gloo ranks on the CPU.

``tests/torch_dist_worker.py`` runs each rank (no rank imports JAX); this
file computes the JAX package's results on the virtual CPU mesh (Pallas
interpreted, as ``tests/test_torch_parallel.py`` runs it), hands them over
as files, and reads what each rank found. Three layouts of a (data=2,
space=2, disp=2) mesh at 4x64x128: ``space`` across the ranks (as
``tools/dist_worker.py`` lays out its mesh), ``disp`` across the ranks, and
the config-2 step with ``space`` across the ranks. Then the launcher with
its multi-process flags, and the process group's set-up in this process.
The config-2 step also runs with ``disp`` across the ranks."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig as JaxBMConfig
from gpu_stereo_matching_tpu.core.config import MeshConfig as JaxMeshConfig
from gpu_stereo_matching_tpu.parallel import mesh as jmesh
from gpu_stereo_matching_tpu.parallel import stereo as jstereo
from gpu_stereo_matching_tpu_torch.core.config import BlockMatchingConfig, MeshConfig
from gpu_stereo_matching_tpu_torch.parallel import launch
from gpu_stereo_matching_tpu_torch.parallel.mesh import owner_ranks

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
WORKER_TIMEOUT_S = 120
STEP = dict(num_disparities=16, sad_radius=2)
FULL = dict(num_disparities=16, sad_radius=2, lr_consistency=True, median_radius=2)
LAYOUTS = [  # name, axis across the ranks, config-2 step, use_kernel
    ("space", "space", False, True),
    ("space_plain", "space", False, False),
    ("disp", "disp", False, True),
    ("disp_plain", "disp", False, False),
    ("full_space", "space", True, None),
    ("full_disp", "disp", True, None),
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argvs, timeout=WORKER_TIMEOUT_S):
    """Run one process per argv with the repository on the path and one
    thread each; kill them all if any outlives ``timeout``. Returns each
    one's (exit code, output)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv], env=env, cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("ranks timed out:\n" + "\n".join(outs))
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.fixture(scope="module")
def ranks_found(tmp_path_factory):
    """Both ranks' findings, keyed by rank."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(42)
    left = rng.integers(0, 256, (4, 64, 128), dtype=np.uint8)
    right = rng.integers(0, 256, (4, 64, 128), dtype=np.uint8)
    np.savez(tmp / "inputs.npz", left=left, right=right)
    jm = jmesh.build_mesh(JaxMeshConfig(2, 2, 2))
    jl, jr = jstereo.shard_batch(jm, jnp.asarray(left), jnp.asarray(right))
    steps = {
        False: jstereo.make_sharded_block_matching(jm, JaxBMConfig(**STEP), use_pallas=True,
                                                   interpret=True),
        True: jstereo.make_sharded_block_matching_full(jm, JaxBMConfig(**FULL)),
    }
    for full, step in steps.items():
        np.save(tmp / f"jax_{int(full)}.npy", np.asarray(step(jl, jr)))
    spec = {"inputs": str(tmp / "inputs.npz"), "layouts": [
        {"name": name, "mesh": [2, 2, 2], "across": across, "full": full,
         "use_kernel": use_kernel, "config": FULL if full else STEP,
         "jax": str(tmp / f"jax_{int(full)}.npy")}
        for name, across, full, use_kernel in LAYOUTS]}
    (tmp / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    runs = _spawn([[str(WORKER), str(r), "2", str(port), str(tmp / "spec.json"), str(tmp)]
                   for r in range(2)])
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    return {r: json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)}


@pytest.mark.parametrize("name,owned", [
    ("space", [[[0, 0], [1, 0]], [[0, 1], [1, 1]]]),
    ("space_plain", [[[0, 0], [1, 0]], [[0, 1], [1, 1]]]),
    ("disp", [[[0, 0], [0, 1], [1, 0], [1, 1]]] * 2),
    ("disp_plain", [[[0, 0], [0, 1], [1, 0], [1, 1]]] * 2),
    ("full_space", [[[0, 0], [1, 0]], [[0, 1], [1, 1]]]),
    ("full_disp", [[[0, 0], [0, 1], [1, 0], [1, 1]]] * 2),
])
def test_each_ranks_pieces_equal_jax_and_the_single_process_step(ranks_found, name, owned):
    """With ``space`` across the ranks each rank holds one band of both
    frame blocks; with ``disp`` across them both hold every band (a
    result is replicated over ``disp``). Every piece equals the JAX step,
    the single-process step and ``fused_block_matching`` (the config-2 step:
    ``block_matching_pipeline``), bit for bit; rank 0 gathers the batch."""
    for r in range(2):
        got = ranks_found[r]["layouts"][name]
        assert got["pieces"] == owned[r]
        assert got["equal"] == {"jax": True, "single_process": True, "single_device": True}
        assert got["gathered"] is (True if r == 0 else None)


def test_a_mesh_larger_than_the_ranks_devices_raises(ranks_found):
    for r in range(2):
        assert ranks_found[r]["too_large"] == (
            "mesh (4, 2, 2) needs 16 devices, the 2 ranks drive 8")


def test_launch_main_across_two_processes():
    """``parallel/launch.py`` with ``--coordinator --num-processes
    --process-id``: the data sweep over both ranks, rank 0 printing one line
    a point (rank 1 idle at the first)."""
    port = _free_port()
    runs = _spawn([["-m", "gpu_stereo_matching_tpu_torch.parallel.launch", "--coordinator",
                    f"localhost:{port}", "--num-processes", "2", "--process-id", str(r),
                    "--device", "cpu", "--frames", "4", "--height", "24", "--width", "72"]
                   for r in range(2)])
    assert [rc for rc, _ in runs] == [0, 0], runs
    lines = [json.loads(s) for s in runs[0][1].splitlines() if s.startswith("{")]
    assert [(p["mesh"], p["devices"], p["processes"]) for p in lines] == [
        ({"data": 1, "space": 1, "disp": 1}, 1, 1), ({"data": 2, "space": 1, "disp": 1}, 2, 2)]
    assert all(p["device"] == "cpu" and p["distinct_devices"] == 1 and p["fps"] > 0
               for p in lines)
    assert lines[1]["efficiency"] > 0
    assert not [s for s in runs[1][1].splitlines() if s.startswith("{")]


def test_launch_main_one_rank(capsys):
    """One gloo rank in this process: a mesh of two cards is refused, one of
    a card runs, and the group is torn down either way."""
    import torch.distributed as dist

    flags = ["--num-processes", "1", "--process-id", "0", "--device", "cpu", "--frames", "2",
             "--height", "12", "--width", "72"]
    with pytest.raises(ValueError, match=r"needs 2 cards, the 1 ranks own 1"):
        launch.main(["--coordinator", f"localhost:{_free_port()}", *flags, "--data", "2"])
    assert not dist.is_initialized()
    assert launch.main(["--coordinator", f"localhost:{_free_port()}", *flags]) == 0
    assert not dist.is_initialized()
    (line,) = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert line["processes"] == 1 and line["devices"] == 1
    for bad in (["--coordinator", "localhost:1"], ["--num-processes", "2"],
                ["--device", "cpu", "--backend", "gloo"]):
        with pytest.raises(SystemExit):
            launch.main(bad)
    assert "go together" in capsys.readouterr().err


def test_initialize_distributed_under_torchrun_variables(monkeypatch):
    """``env://`` from torchrun's variables, the rank's device, and a
    one-rank process mesh whose step reduces its keys through the group
    and equals the fused function."""
    import torch.distributed as dist

    from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching_batched
    from gpu_stereo_matching_tpu_torch.parallel.mesh import process_mesh
    from gpu_stereo_matching_tpu_torch.parallel.stereo import (
        make_sharded_block_matching,
        shard_batch,
        unshard,
    )

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        launch.initialize_distributed(device="cpu")
    with pytest.raises(ValueError, match="go together"):
        launch.initialize_distributed("localhost:1", 2, device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    assert launch.initialize_distributed(device="cpu", timeout=30) == torch.device("cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = process_mesh(MeshConfig(1, 2, 2), ["cpu"] * 4, across="disp")
        assert mesh.ranks.tolist() == [[[0, 0], [0, 0]]] and mesh.rank == 0
        assert set(mesh.disp_groups) == {(0, 0), (0, 1)}
        rng = np.random.default_rng(3)
        left, right = (torch.from_numpy(rng.integers(0, 256, (2, 16, 40), dtype=np.uint8))
                       for _ in range(2))
        got = unshard(make_sharded_block_matching(mesh, BlockMatchingConfig(**STEP))(
            *shard_batch(mesh, left, right)))
        assert torch.equal(got, fused_block_matching_batched(left, right, 16, 2))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("across,per_rank,want", [
    ("data", 4, [[[0, 0], [0, 0]], [[1, 1], [1, 1]]]),
    ("space", 4, [[[0, 0], [1, 1]], [[0, 0], [1, 1]]]),
    ("disp", 4, [[[0, 1], [0, 1]], [[0, 1], [0, 1]]]),
    ("data", 1, [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]),
    ("space", 2, [[[0, 0], [2, 2]], [[1, 1], [3, 3]]]),
])
def test_owner_ranks(across, per_rank, want):
    """Ranks take contiguous blocks with the named axis outermost; ``data``
    outermost is the data-major order of the mesh itself."""
    assert owner_ranks(MeshConfig(2, 2, 2), per_rank, across).tolist() == want


def test_owner_ranks_rejects_blocks_that_do_not_divide():
    with pytest.raises(ValueError, match="do not divide"):
        owner_ranks(MeshConfig(1, 3, 1), 2)
