"""Import guard: every module of the port, and ``chip_smoke.py``, loads
without importing jax or anything of the JAX package; and the port's
``tree/hpd.py`` and ``models/segment_tree.py`` define what the JAX
package's do."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PORT_MODULES = [
    "gpu_stereo_matching_tpu_torch",
    "gpu_stereo_matching_tpu_torch.device",
    "gpu_stereo_matching_tpu_torch.core.config",
    "gpu_stereo_matching_tpu_torch.core.validation",
    "gpu_stereo_matching_tpu_torch.io.calib_yaml",
    "gpu_stereo_matching_tpu_torch.io.images",
    "gpu_stereo_matching_tpu_torch.io.visualize",
    "gpu_stereo_matching_tpu_torch.io.middlebury",
    "gpu_stereo_matching_tpu_torch.calib.rectify",
    "gpu_stereo_matching_tpu_torch.calib.zhang",
    "gpu_stereo_matching_tpu_torch.calib.chessboard",
    "gpu_stereo_matching_tpu_torch.io.capture",
    "gpu_stereo_matching_tpu_torch.ops.color",
    "gpu_stereo_matching_tpu_torch.ops.remap",
    "gpu_stereo_matching_tpu_torch.ops.cost",
    "gpu_stereo_matching_tpu_torch.ops.aggregate",
    "gpu_stereo_matching_tpu_torch.ops.wta",
    "gpu_stereo_matching_tpu_torch.ops.postprocess",
    "gpu_stereo_matching_tpu_torch.models.block_matching",
    "gpu_stereo_matching_tpu_torch.models.segment_tree",
    "gpu_stereo_matching_tpu_torch.models.segment_tree_stream",
    "gpu_stereo_matching_tpu_torch.models.segment_tree_tiled",
    "gpu_stereo_matching_tpu_torch.tree",
    "gpu_stereo_matching_tpu_torch.tree.builder",
    "gpu_stereo_matching_tpu_torch.tree.hpd",
    "gpu_stereo_matching_tpu_torch.tree.stride",
    "gpu_stereo_matching_tpu_torch.tree.filter",
    "gpu_stereo_matching_tpu_torch.kernels._build",
    "gpu_stereo_matching_tpu_torch.kernels.sad_wta",
    "gpu_stereo_matching_tpu_torch.kernels.gray",
    "gpu_stereo_matching_tpu_torch.kernels.remap",
    "gpu_stereo_matching_tpu_torch.kernels.split_phase",
    "gpu_stereo_matching_tpu_torch.kernels.ctmf_median",
    "gpu_stereo_matching_tpu_torch.utils.cache",
    "gpu_stereo_matching_tpu_torch.utils.profiling",
    "gpu_stereo_matching_tpu_torch.models.streaming",
    "gpu_stereo_matching_tpu_torch.convert",
    "gpu_stereo_matching_tpu_torch.cli.main",
    "gpu_stereo_matching_tpu_torch.parallel.mesh",
    "gpu_stereo_matching_tpu_torch.parallel.halo",
    "gpu_stereo_matching_tpu_torch.parallel.collectives",
    "gpu_stereo_matching_tpu_torch.parallel.stereo",
    "gpu_stereo_matching_tpu_torch.parallel.launch",
    "gpu_stereo_matching_tpu_torch.parallel.segment_tree",
    "gpu_stereo_matching_tpu_torch.bench.fused_kernel",
    "gpu_stereo_matching_tpu_torch.bench.scaling",
    "gpu_stereo_matching_tpu_torch.bench.middlebury",
    "gpu_stereo_matching_tpu_torch.bench",
    "gpu_stereo_matching_tpu_torch.bench.headline",
    "gpu_stereo_matching_tpu_torch.bench.micro",
    "gpu_stereo_matching_tpu_torch.bench.streaming",
    "gpu_stereo_matching_tpu_torch.bench.st_profile",
    "gpu_stereo_matching_tpu_torch.bench.st_streaming",
    "gpu_stereo_matching_tpu_torch.bench.st2_streaming",
    "gpu_stereo_matching_tpu_torch.bench.st_hd",
    "gpu_stereo_matching_tpu_torch.bench.st_config3",
    "gpu_stereo_matching_tpu_torch.bench.roofline",
]

# Modules that must not be loaded once the port is: jax, and the JAX package
# (whose name the port's own begins with).
FORBIDDEN_CHECK = (
    "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'gpu_stereo_matching_tpu')\n"
    "             or m.startswith(('jax.', 'jaxlib.', 'gpu_stereo_matching_tpu.')))\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)


def _run(code):
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_modules_cover_the_package():
    pkg = ROOT / "gpu_stereo_matching_tpu_torch"
    found = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    }
    subpackages = {m for m in found if (ROOT / m.replace(".", "/") / "__init__.py").exists()}
    assert found - subpackages == set(PORT_MODULES) - subpackages


def test_port_imports_no_jax():
    _run(
        "import sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    __import__(m)\n"
        + FORBIDDEN_CHECK
    )


def test_chip_smoke_imports_no_jax():
    """``chip_smoke`` as a module, with the imports its ``main`` makes, and
    without running it."""
    _run(
        "import ast, sys\n"
        "import chip_smoke\n"
        "tree = ast.parse(open(chip_smoke.__file__).read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.Import):\n"
        "        for a in node.names:\n"
        "            __import__(a.name)\n"
        "    elif isinstance(node, ast.ImportFrom) and node.level == 0:\n"
        "        __import__(node.module)\n"
        + FORBIDDEN_CHECK
    )


def test_the_check_catches_the_jax_package():
    """The guard fails when a module of the JAX package is loaded, even one
    that does not import jax."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\nimport gpu_stereo_matching_tpu.core.config\n" + FORBIDDEN_CHECK],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "gpu_stereo_matching_tpu" in proc.stderr


def _definitions(path: Path) -> set:
    """Names a module defines at its top level (functions, classes and
    assignments), read from its source without importing it."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return names


# JAX names whose work the port does another way: the registry lock is
# made at import (``_REGISTRY_LOCK``), not lazily, and the coded filter's
# doubling scan is ``tree/hpd.py::_scan_affine``, the stride filter's.
_DONE_OTHERWISE = {"_registry_lock", "_seg_scan"}


@pytest.mark.parametrize("rel", ["tree/hpd.py", "models/segment_tree.py"])
def test_port_defines_what_the_jax_module_defines(rel):
    """Every definition of the JAX module has its namesake in the port's:
    ``tree/hpd.py`` whole, ``models/segment_tree.py``'s device paths; the
    port keeps no ``jax.jit`` wrappers (names ending in ``_jit``), and the
    names in ``_DONE_OTHERWISE`` do their work under another name."""
    theirs = _definitions(ROOT / "gpu_stereo_matching_tpu" / rel)
    ours = _definitions(ROOT / "gpu_stereo_matching_tpu_torch" / rel)
    missing = {n for n in theirs - ours - _DONE_OTHERWISE if not n.endswith("_jit")}
    assert not missing, sorted(missing)
