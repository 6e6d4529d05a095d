"""Build the CUDA sources under ``csrc/`` at first use and load them.

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface (no PyTorch headers), keyed by a hash of the sources and flags,
into ``_build/`` beside this file (git-ignored), and loaded with ``ctypes``.
Each source compiles to an object in its own ``nvcc``, all started
together, and one more ``nvcc`` links the objects. The first call in a
checkout pays the build, under a file lock that makes processes arriving
together compile once; later calls reuse the library. Nothing here runs at
import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
         -Xcompiler -fPIC -o _build/<name>_<hash>.o csrc/<name>.cu   # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libfalkon_kernels_<hash>.so _build/*_<hash>.o

No ``--use_fast_math``: the kernels hold IEEE fp32 against the reference.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: kernel_matvec.cu holds the fp32 B1/B2, B3 and the entry points; the
#: compensated B1/B2 builds compile beside it, each in its own nvcc
SOURCES = ("kernel_matvec.cu", "kernel_matvec_f32c.cu", "kernel_matvec_bf16c.cu",
           "kernel_matvec_f16c.cu", "blocked_cholesky.cu")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every C entry point; each returns a cudaError_t as int, but
#: ``rt_matmul_slices`` (a count) and ``rt_pairwise_range`` (0)
_SIGNATURES = {
    # kernel_matvec.cu: B1-B3
    "rt_sweep_grid": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "rt_fused_sweep": [_I, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                       _I, _F, _F, _F, _F, _I,
                       _I, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    "rt_matmul_slots": [_I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "rt_matmul_slices": [_I, _I, _I],
    "rt_kernel_matmul": [_I, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                         _I, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P, _I, _P],
    "rt_pairwise_slots": [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "rt_pairwise_range": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
    "rt_pairwise": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P],
    # blocked_cholesky.cu: B5-B7
    "rb_potrf": [_P, _P, _I, _P],
    "rb_trsm": [_P, _P, _P, _I, _I, _P],
    "rb_update": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
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


def _compile(key: str, lib: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link into
    ``lib``; objects and the library are written under this process's
    temporary names and the library renamed into place."""
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


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path.

    Processes that reach first use together (the ranks of a multi-device
    fit) compile once: the build holds an exclusive ``flock`` on
    ``_build/build.lock`` and looks for the library again once it has it,
    so the others wait and load what the first one built. The kernel
    releases the lock with its holder, so a killed build leaves nothing to
    clear. The compiler's report (``-Xptxas -v``: registers, shared memory
    and spills per kernel) is kept beside each object as
    ``<name>_<hash>.log``.
    """
    lib = library()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if not lib.exists():
            _compile(_sources_hash(), lib)
    return lib


def library() -> Path:
    """Where the library of the current sources is (or will be) built."""
    return BUILD_DIR / f"libfalkon_kernels_{_sources_hash()}.so"


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
