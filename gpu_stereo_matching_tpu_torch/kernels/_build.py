"""Build the CUDA sources in ``kernels/csrc`` with ``nvcc`` and load them.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, at first use, into ``kernels/_build/`` (git-ignored). The file
name carries a hash of the sources and flags, so an edited source rebuilds.
The library is loaded with :mod:`ctypes`; each wrapper passes pointers and
the stream as ``c_void_p``. There is no fallback: without ``nvcc``, or when
the build fails, :func:`load_library` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # The remap kernel must not contract multiply-adds (it also spells its
    # float math with __fmul_rn/__fadd_rn); the SAD kernel is integer-only.
    "-fmad=false",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry name -> argument types; every entry returns a cudaError_t as int.
_SIGNATURES = {
    "gsm_sad_wta_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsm_remap_bilinear_u8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_library = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgsm_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gsm_error_string.argtypes = [ctypes.c_int]
        lib.gsm_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.gsm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
