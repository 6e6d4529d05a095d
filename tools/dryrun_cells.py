"""Every dry-run cell, each its own process, several at a time, and a table
of their artifacts.

    PYTHONPATH=src python3 tools/dryrun_cells.py [--jobs 8] [--timeout 900]
        [--mesh single|multi|both] [--out artifacts/dryrun] [--arch A ...]

Runs ``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M
--force --out DIR`` for every architecture, runnable shape and mesh (the
config's ``skip_shapes`` left out) and the FALKON solver cells, ``--jobs``
processes at once, each stopped after ``--timeout`` seconds (its cell then
has no artifact and is listed as timed out). Prints one line a cell: its
status, seconds, per-device flops, bytes, collective bytes, memory total,
fits_hbm and bottleneck, or its error.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "dryrun"))
    ap.add_argument("--arch", nargs="*", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config

    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[args.mesh]
    out = Path(args.out)
    (out / "logs").mkdir(parents=True, exist_ok=True)
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--force", "--out", str(out)]
    cells = [(a, s, m) for a in (args.arch or ARCH_IDS) for s in get_config(a).runnable_shapes()
             for m in meshes]
    cells += [("falkon-solver", "solve", m) for m in meshes]
    # the cheap cells first: decode, the solver, prefill, then training
    order = {"decode": 0, "solve": 1, "prefill": 2, "train": 3}
    kind = {s: c.kind for s, c in SHAPES.items()}
    cells.sort(key=lambda c: (order[kind.get(c[1], "solve")], c[2] == "multi"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

    def run(cell):
        arch, shape, mesh = cell
        cmd = base + (["--falkon"] if arch == "falkon-solver" else ["--arch", arch, "--shape",
                                                                      shape])
        log = out / "logs" / f"{arch}__{shape}__{mesh}.log"
        t0 = time.perf_counter()
        with open(log, "w") as fh:
            try:
                code = subprocess.run(cmd + ["--mesh", mesh], stdout=fh, stderr=subprocess.STDOUT,
                                      env=env, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                code = "timeout"
        return cell, code, time.perf_counter() - t0

    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(run, cells))
    bad = 0
    for (arch, shape, mesh), code, secs in results:
        path = out / f"{arch}__{shape}__{mesh}.json"
        res = json.loads(path.read_text()) if path.exists() and code != "timeout" else None
        if res is None or res.get("status") != "ok":
            bad += 1
            why = f"timed out after {args.timeout:.0f} s" if code == "timeout" else (
                res or {}).get("error", f"exit {code}, no artifact")
            print(f"{arch} x {shape} x {mesh}: NOT OK ({secs:.1f} s): {why}", flush=True)
            continue
        r, mem = res["roofline"], res["memory"]
        print(f"{arch} x {shape} x {mesh}: ok ({secs:.1f} s): flops {r['flops_per_device']:.4e}"
              f", bytes {r['bytes_per_device']:.4e}, collective "
              + json.dumps({k: f"{v:.3e}" for k, v in r["collective_bytes"].items()})
              + f", memory {mem['total_per_device'] / 1e9:.3f} GB, fits_hbm {res['fits_hbm']}, "
              f"bottleneck {r['bottleneck']} (compute {r['compute_s']:.4e} s, memory "
              f"{r['memory_s']:.4e} s, collective {r['collective_s']:.4e} s), useful "
              f"{r['useful_flops_ratio']:.4f}", flush=True)
    print(f"{len(results) - bad} of {len(results)} cells ok")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
