"""The kernel build under concurrent first use (``repro_torch.kernels.build``).

There is no ``nvcc`` here, so the compile step is replaced by a stub that
records its caller, sleeps and writes a stand-in library; the locking and
the second look for the library are the code under test.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_RANK = """
import os, sys, time
from pathlib import Path
from repro_torch.kernels import build

build.BUILD_DIR = Path(sys.argv[1])

def compile_stub(key, lib):
    with open(build.BUILD_DIR / "compiles", "a") as fh:
        fh.write("%d\\n" % os.getpid())
    time.sleep(1.0)
    tmp = lib.with_suffix(".%d.tmp" % os.getpid())
    tmp.write_bytes(b"built by %d" % os.getpid())
    os.replace(tmp, lib)

build._compile = compile_stub
while time.time() < float(sys.argv[2]):   # start together
    time.sleep(0.001)
print(build.build())
"""


def test_processes_reaching_first_use_together_compile_once(tmp_path):
    """Four processes call ``build()`` at the same instant on an empty build
    directory: one compiles, the others wait for it and return the same
    library."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    go = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp_path), repr(go)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1, paths
    lib = Path(paths.pop())
    compiles = (tmp_path / "compiles").read_text().split()
    assert len(compiles) == 1, compiles
    assert lib.read_bytes() == b"built by " + compiles[0].encode()
    assert not list(tmp_path.glob("*.tmp"))
