"""Read the compared numbers of a cell for its limits, in one process.

    python3 bench/calibrate.py --workload susy.fit --seeds 1,2,3 --control-seeds 7,8,9

For each ``--seeds`` seed: the cell's rows, one window's worth of the
program (one fit, or a short run of batches; no warm-up, so the first
seed's reads cold) and the cell's check, as a run makes them: the lower
readings. For each ``--control-seeds`` seed: the control, the plain
reference computed in float32 with TF32 products put in the program's
place, through the same check: the upper readings. ``--numbers`` reads
only some of the cell's numbers. One JSON line a seed on standard output (and ``--out``).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
sys.path[:] = [str(REPO / "src"), str(REPO)] + [
    p for p in sys.path if Path(p or ".").resolve() != BENCH]


def calibrate(spec, workload: str, seed: int, control: bool, *, device="cuda",
              ops_impl="cuda", dirs=None, root=None, numbers=None) -> dict:
    import torch

    from bench import harness
    dirs = dirs or (harness.HERE,)
    c = harness.cell_of(spec, workload, root or harness.REPO, dirs)
    want = [k for k in c["limits"] if numbers is None or k in numbers]
    loop = harness.load_kind(dirs, c["mix"]["kind"])(c["cfg"], c["mix"], seed, device,
                                                      ops_impl, False, want)
    loop.setup(warm=False)
    t0 = time.perf_counter()
    if control:
        try:
            loop.control()
        except RuntimeError as exc:        # a failed factor: no number
            return {"workload": workload, "seed": seed, "control": True,
                    "error": str(exc)[:300]}
    else:
        loop.window(0.05)                  # the shortest: one fit, or a few batches
    t1 = time.perf_counter()
    got = loop.check()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"workload": workload, "seed": seed, "control": control, "numbers": got,
            "answer_s": t1 - t0, "check_s": time.perf_counter() - t1, "info": loop.info}


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from bench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--numbers", default="", help="comma-separated; default: all")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.load_spec()
    out = open(args.out, "a") if args.out else None
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        line = json.dumps(calibrate(spec, args.workload, seed, control,
                                    numbers=set(args.numbers.split(",")) - {""} or None))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
