"""The import guard, the plain reference against the rig's semantics, its
control, and the frozen work counts at the cells' shapes."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.registry import BENCHMARK_JSON, HERE, Registry
from benchmark.reference import stereo_rig as ref
from benchmark.run import FORBIDDEN, forbidden_modules

MODULES = sorted(HERE.rglob("*.py"))
SYSTEMS = sorted({Registry().config(c["name"])["system"]
                  for c in json.loads(BENCHMARK_JSON.read_text())["configs"]})


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imported(path)}
    assert not tops & {"jax", "jaxlib", "flax", "gpu_stereo_matching_tpu"}
    if "reference" in path.relative_to(HERE).parts:
        assert "gpu_stereo_matching_tpu_torch" not in tops


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["gpu_stereo_matching_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "gpu_stereo_matching_tpu.ops"]) == [
        "gpu_stereo_matching_tpu.ops", "jax.numpy"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "gpu_stereo_matching_tpu"}


@pytest.mark.parametrize("system", SYSTEMS)
def test_the_benchmark_and_the_rig_load_without_jax(system):
    """The harness, every reader, the system and each module of the program
    that the system imports, in a fresh process."""
    path = Path(Registry().system(system).__file__)
    program = sorted(n for n in _imported(path)
                     if n.split(".")[0] == "gpu_stereo_matching_tpu_torch")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.control, benchmark.faults, benchmark.scene\n"
            "from benchmark.registry import Registry\n"
            "r = Registry()\n"
            "[r.metric(m['name']) for m in r.spec['end_to_end'] + r.spec['per_layer']]\n"
            "r.system(%r)\n"
            "%s"
            "print(benchmark.run.forbidden_modules())\n") % (
                str(HERE.parent), system, "".join(f"import {m}\n" for m in program))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _pair(seed, hw=(40, 64), frames=2):
    from benchmark import scene

    g = torch.Generator().manual_seed(seed)
    mix = {"max_disparity": 12, "background_disparity": [1, 5], "objects": [1, 3],
           "object_disparity": [4, 12], "object_size_frac": [0.1, 0.4],
           "texture_scales": [2, 4, 8], "noise_level": 12}
    return scene.frame_pairs(g, frames, hw, mix, "cpu")


def test_the_scene_is_the_seed_s():
    a, b = _pair(5), _pair(5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(_pair(6)[0], a[0])
    left, right = a
    assert left.shape == (2, 40, 64, 3) and left.dtype == torch.uint8 and left.is_contiguous()


def test_reference_pieces_match_the_rig_semantics_on_small_cases():
    # Gray: the float32 chain rounds once a step, then half to even.
    bgr = torch.tensor([[[10, 20, 30], [255, 255, 255], [0, 0, 1]]], dtype=torch.uint8)
    w = np.float32([0.299, 0.587, 0.114]).astype(np.float64)

    def fma(a, b, c):  # a * b + c rounded once to float32 (exact in float64 here)
        return np.float32(a * b + np.float64(c))

    want = [fma(c[2], w[2], fma(c[1], w[1], np.float32(c[0] * w[0]))) for c in bgr[0].tolist()]
    assert ref.gray(bgr)[0].tolist() == [int(np.clip(np.rint(v), 0, 255)) for v in want]
    # Remap: identity maps give the image; the last row and column give 0.
    img = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    y, x = torch.meshgrid(torch.arange(3.0), torch.arange(4.0), indexing="ij")
    out = ref.remap(img, x, y)
    assert torch.equal(out[:2, :3], img[:2, :3]) and out[2].sum() == 0 and out[:, 3].sum() == 0
    assert ref.remap(img, x[:1, :1] + 0.5, y[:1, :1] + 0.5).item() == 2  # (0+1+4+5)/4 = 2.5 -> 2
    # WTA ties go to the smallest d; a flat pair is all ties.
    flat = torch.full((6, 9), 7, dtype=torch.uint8)
    assert ref.fused_disparity(flat, flat, 4, 1).sum() == 0
    # The median of a clipped window: the (n // 2 + 1)-th smallest.
    x = torch.tensor([[0, 9, 9], [9, 9, 9], [9, 9, 1]], dtype=torch.uint8)
    assert ref._median_u8(x, 1).tolist() == [[9, 9, 9], [9, 9, 9], [9, 9, 9]]


@pytest.mark.parametrize("fused", [True, False])
def test_reference_equals_the_program_s_plain_path(fused, tiny):
    """At 40x64 on the CPU the program's rig runs its plain twins; the
    reference, written apart from them, gives the same disparities."""
    from benchmark.systems import stereo_rig

    cfg = tiny.config("fused.tiny" if fused else "plus.tiny")
    left, right = _pair(11)
    program = stereo_rig.build(cfg, torch.device("cpu")).process_batch(left, right)
    expected = stereo_rig.reference(cfg, torch.device("cpu"))(left, right)
    assert program.dtype == expected.dtype == torch.int32
    assert torch.equal(program, expected)
    assert expected.float().std() > 0


def test_the_control_fails_the_comparison(stand_in, tiny):
    """The reference with its front end in bfloat16, the precision below
    float32, put in the program's place under the entry, comes out not
    correct through the harness's own check on every seed tried."""
    from benchmark.control import control
    from benchmark.run import run_cell

    for seed in (1, 2, 3):
        result, _, _ = run_cell(tiny, stand_in, seed, 0.3, False, torch.device("cpu"), 0.0,
                                wrap=control(tiny, stand_in, torch.device("cpu")))
        assert not result["correct"]
        assert result["checks"]["disparity_mismatch_px"]["value"] > 0


def test_the_rig_maps_are_worked_out_again():
    from gpu_stereo_matching_tpu_torch.calib.rectify import rectification_maps_from_calibration
    from gpu_stereo_matching_tpu_torch.io.calib_yaml import StereoCalibration

    from benchmark.registry import Registry

    cfg = Registry().config("rig800-fused")
    calib = StereoCalibration(**{k: np.asarray(v, np.float64)
                                 for k, v in cfg["calibration"].items()})
    (lx, ly), (rx, ry) = rectification_maps_from_calibration(calib, (800, 1280))
    for mine, theirs in zip(ref.maps(cfg), (lx, ly, rx, ry)):
        assert mine.dtype == np.float32 and np.array_equal(mine, theirs)
    # A real rig: the maps land near the identity, inside the sensor.
    assert 0 < float(np.median(lx[400])) < 1280 and abs(float(ly[400, 640]) - 400) < 20


@pytest.mark.parametrize("fn,args,want", [
    (roofline.fused_sad_work, (800, 1280, 64, 16), (8 * 64 * 16384000, 6 * 16384000)),
    (roofline.fused_sad_work, (1080, 1920, 64), (1061683200, 12441600)),
    (roofline.remap_work, (16, 1024000, 2, True),
     (2 * (10 * 1024000 + 16 * 1024000 * 44), 2 * (8 * 1024000 + 16 * 1024000 * 4))),
    (roofline.sad_volume_work, (800, 1280, 64, 8), (6 * 64 * 8192000, 258 * 8192000)),
    (roofline.wta_work, (800, 1280, 64, 16), (2 * 64 * 16384000, 260 * 16384000)),
    (roofline.median_work, (800, 1280, 3, 8), (46 * 8192000, 2 * 8192000)),
])
def test_work_counts_at_the_cells_shapes(fn, args, want):
    assert fn(*args) == want


def test_bounds_and_what_sets_them():
    ops, nbytes = roofline.fused_sad_work(1080, 1920, 64)
    assert roofline.bound_s(ops, nbytes) == pytest.approx(1061683200 / 67e12)
    assert roofline.bound_by(ops, nbytes) == "operations"
    assert roofline.bound_by(*roofline.sad_volume_work(800, 1280, 64)) == "bytes"
    assert roofline.bound_by(*roofline.remap_work(16, 1024000, 2, True)) == "bytes"
