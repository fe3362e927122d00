"""Import guard: every module of the port loads without importing jax."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PORT_MODULES = [
    "gpu_stereo_matching_tpu_torch",
    "gpu_stereo_matching_tpu_torch.device",
    "gpu_stereo_matching_tpu_torch.core.validation",
    "gpu_stereo_matching_tpu_torch.ops.color",
    "gpu_stereo_matching_tpu_torch.ops.remap",
    "gpu_stereo_matching_tpu_torch.ops.cost",
    "gpu_stereo_matching_tpu_torch.ops.aggregate",
    "gpu_stereo_matching_tpu_torch.ops.wta",
    "gpu_stereo_matching_tpu_torch.ops.postprocess",
    "gpu_stereo_matching_tpu_torch.models.block_matching",
    "gpu_stereo_matching_tpu_torch.kernels._build",
    "gpu_stereo_matching_tpu_torch.kernels.sad_wta",
    "gpu_stereo_matching_tpu_torch.kernels.remap",
    "gpu_stereo_matching_tpu_torch.kernels.split_phase",
    "gpu_stereo_matching_tpu_torch.kernels.ctmf_median",
    "gpu_stereo_matching_tpu_torch.utils.cache",
    "gpu_stereo_matching_tpu_torch.models.streaming",
    "gpu_stereo_matching_tpu_torch.convert",
    "gpu_stereo_matching_tpu_torch.cli.main",
]


def test_port_modules_cover_the_package():
    pkg = ROOT / "gpu_stereo_matching_tpu_torch"
    found = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    }
    subpackages = {m for m in found if (ROOT / m.replace(".", "/") / "__init__.py").exists()}
    assert found - subpackages == set(PORT_MODULES) - subpackages


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
