"""Import guard: every module of the port, and ``chip_smoke.py``, loads
without importing jax or anything of the JAX package."""

import subprocess
import sys
from pathlib import Path

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
    "gpu_stereo_matching_tpu_torch.parallel.stereo",
    "gpu_stereo_matching_tpu_torch.parallel.launch",
    "gpu_stereo_matching_tpu_torch.parallel.segment_tree",
    "gpu_stereo_matching_tpu_torch.bench.fused_kernel",
    "gpu_stereo_matching_tpu_torch.bench.scaling",
    "gpu_stereo_matching_tpu_torch.bench.middlebury",
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
