"""Run one cell of the benchmark once on one H100 and print its result.

    python3 bench/run.py --workload susy.fit --seed 7 --seconds 10 --trace 0

Prints, last on standard output, one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; the compared numbers beside their limits come last, under
``checks``, and again as the last lines of standard error. Exits non-zero
with no result when there is no card, and when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (Linux: /proc)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
# the package by its name, never this folder's modules by theirs
sys.path[:] = [str(REPO / "src"), str(REPO)] + [
    p for p in sys.path if Path(p or ".").resolve() != BENCH]


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from bench import harness

    spec = harness.load_spec()
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, notes = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                   bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(line))
    sys.stdout.flush()
    for note in notes:
        print(note, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
