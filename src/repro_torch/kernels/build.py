"""Build the CUDA sources under ``csrc/`` at first use and load them.

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface (no PyTorch headers), keyed by a hash of the sources and flags,
into ``_build/`` beside this file (git-ignored), and loaded with ``ctypes``.
Each source compiles to an object in its own ``nvcc``, all started
together, and one more ``nvcc`` links the objects. The first call in a
process pays the build; later calls in the same checkout reuse the library.
Nothing here runs at import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
         -Xcompiler -fPIC -o _build/<name>_<hash>.o csrc/<name>.cu   # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libfalkon_kernels_<hash>.so _build/*_<hash>.o

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
SOURCES = ("kernel_matvec.cu", "blocked_cholesky.cu")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every C entry point; each returns a cudaError_t as int
_SIGNATURES = {
    # kernel_matvec.cu: B1-B3
    "rt_tile_smem_bytes": [],
    "rt_sweep_grid": [_I, _I, ctypes.POINTER(_I)],
    "rt_fused_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _F, _F, _F, _F, _I,
                       _I, _I, _I, _I, _P, _P, _P, _P],
    "rt_kernel_matmul": [_P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "rt_pairwise": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P, _P],
    # blocked_cholesky.cu: B5-B7
    "rb_potrf": [_P, _P, _I, _P],
    "rb_trsm": [_P, _P, _P, _I, _I, _P],
    "rb_update": [_P, _P, _P, _P, _I, _I, _I, _P],
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


def _run(procs: list) -> None:
    """Wait for every (cmd, log path, Popen); keep each one's output in its
    log and raise with every failure."""
    failed = []
    for cmd, log, proc in procs:
        out, err = proc.communicate()
        log.write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _start(cmd: list, log: Path) -> tuple:
    return cmd, log, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path.

    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside each object as ``<name>_<hash>.log``.
    """
    key = _sources_hash()
    lib = BUILD_DIR / f"libfalkon_kernels_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{Path(src).stem}_{key}.{tag}.o" for src in SOURCES]
    _run([_start([nvcc, *NVCC_FLAGS, "-o", str(obj), str(CSRC / src)],
                 BUILD_DIR / f"{Path(src).stem}_{key}.log")
          for src, obj in zip(SOURCES, objs)])
    tmp = lib.with_suffix(f".{tag}")
    _run([_start([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                 lib.with_suffix(".log"))])
    for obj in objs:
        obj.unlink()
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
