"""Build the CUDA sources under ``csrc/`` at first use and load them.

The sources are compiled with ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers), keyed by a hash of the sources and flags,
into ``_build/`` beside this file (git-ignored), and loaded with ``ctypes``.
The first call in a process pays the build; later calls in the same
checkout reuse the library. Nothing here runs at import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libkernel_matvec_<hash>.so csrc/kernel_matvec.cu

No ``--use_fast_math``: the kernels hold IEEE fp32 against the reference.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCE = "kernel_matvec.cu"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every C entry point; each returns a cudaError_t as int
_SIGNATURES = {
    "rt_tile_smem_bytes": [],
    "rt_sweep_grid": [_I, _I, ctypes.POINTER(_I)],
    "rt_fused_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _F, _F, _F, _F, _I,
                       _I, _I, _I, _I, _P, _P, _P, _P],
    "rt_kernel_matmul": [_P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "rt_pairwise": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P, _P],
}


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (searched PATH and /usr/local/cuda/bin); the CUDA "
        "kernels need the CUDA toolkit to build")


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path.

    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside the library as ``<name>.log``.
    """
    lib = BUILD_DIR / f"libkernel_matvec_{_sources_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent builder never loads a partial file
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load().rt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
