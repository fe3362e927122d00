"""Build the CUDA sources in ``kernels/csrc`` with ``nvcc`` and load them.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, at first use, into ``kernels/_build/`` (git-ignored): one
``nvcc -c`` per source, all started together, then one link. The file
name carries a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds.
Each compile runs ptxas verbosely; its report (registers, spills, stack and
static shared memory per kernel) is kept beside the library, and
:func:`ptxas_usage` reads it. The library is loaded with :mod:`ctypes`; each
wrapper passes pointers and the stream as ``c_void_p``. There is no fallback: without ``nvcc``, or when
the build fails, :func:`load_library` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # The remap and gray kernels must not contract multiply-adds (they also
    # spell their float math with __fmul_rn/__fadd_rn/__fmaf_rn); the other
    # kernels are integer-only.
    "-fmad=false",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry name -> argument types; every entry returns a cudaError_t as int.
_SIGNATURES = {
    "gsm_sad_wta_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsm_sad_wta_plan": [_I, _I, _I, _I, _I, _P],
    "gsm_sad_wta_mma_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsm_sad_wta_mma_plan": [_I, _I, _I, _I, _I, _P],
    "gsm_sad_key_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gsm_sad_key_plan": [_I, _I, _I, _I, _I, _I, _P],
    "gsm_remap_bilinear_u8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "gsm_rectify_gray_pair": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsm_front_end_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "gsm_remap_plan": [_I, _I, _I, _I, _I, _P],
    "gsm_front_end_plan": [_I, _I, _I, _I, _I, _P],
    "gsm_gray_u8": [_P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                    ctypes.c_float, _I, _P],
    "gsm_sad_volume_u8": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsm_sad_volume_plan": [_I, _I, _I, _I, _P],
    "gsm_wta_i32": [_P, _P, _I, _I, _P],
    "gsm_wta_lr_i32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gsm_median_u8": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gsm_median_plan": [_I, _I, _I, _I, _P],
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


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgsm_kernels-{h.hexdigest()[:16]}.so"


def ptxas_log_path() -> Path:
    """Where :func:`build` keeps ptxas's report of the library's kernels."""
    return library_path().with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", obj]
            for src, obj in zip(_sources(), objects)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd in compiles
        ]
        # All compiles run at once; collect each one's errors in turn.
        errors = [p.communicate()[1] for p in procs]
        for cmd, p, err in zip(compiles, procs, errors):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
        ptxas_log_path().write_text("".join(errors))
        os.replace(lib, out)
    return out


def ptxas_usage(kernel: str) -> dict:
    """ptxas's report, from the build, of each kernel whose mangled name
    holds ``kernel``: mangled name -> registers, spill stores and loads
    (bytes), stack frame (bytes) and static shared memory (bytes)."""
    build()
    usage, name = {}, None
    for line in ptxas_log_path().read_text().splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1) if kernel in entry.group(1) else None
            if name:
                usage[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0,
                               "stack": 0, "static_smem": 0}
            continue
        if name is None:
            continue
        for key, pattern in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem", r"(\d+) bytes smem")):
            found = re.search(pattern, line)
            if found:
                usage[name][key] = int(found.group(1))
    return usage


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gsm_sad_wta_body.argtypes = [_I, _I]
        lib.gsm_sad_wta_body.restype = _I
        lib.gsm_sad_key_body.argtypes = [_I, _I, _I]
        lib.gsm_sad_key_body.restype = _I
        lib.gsm_sad_volume_body.argtypes = [_I, _I]
        lib.gsm_sad_volume_body.restype = _I
        lib.gsm_median_body.argtypes = [_I]
        lib.gsm_median_body.restype = _I
        lib.gsm_gray_body.argtypes = [_P, _P]
        lib.gsm_gray_body.restype = _I
        lib.gsm_error_string.argtypes = [ctypes.c_int]
        lib.gsm_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def require_cuda(t, what: str) -> None:
    """Raise unless tensor ``t`` is on a CUDA device: a wrapper given a
    tensor off the CPU launches its kernel or raises, never falls back."""
    if t.device.type != "cuda":
        raise RuntimeError(
            f"{what}: no kernel for device {t.device}; "
            "pass CPU tensors for the plain version or CUDA tensors for the kernel"
        )


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.gsm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
