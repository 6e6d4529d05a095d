"""How far the order of the sums alone moves the SUSY fit's test error.

At SUSY's lam = 1e-6 the solve amplifies rounding, so two correct solves of
one system that add the same terms in other orders land on other test
errors. This script fits the SUSY shape once (n = 4x10^6, M = 10^4, the
smoke's data and seed), then solves the same system on the same centers and
preconditioner with X's rows rolled (the in-core solve) and with X streamed
from the host in chunks of several heights, under the fp32 and the bf16
policy, and prints each solve's test error beside the card's name and power
limit. Needs a CUDA card. From the repository root:

    python3 tools/order_spread.py [--seed 0] [--rolls 1,262144,786432,1000003]
                                  [--chunks 262144,131072,65536]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rolls", default="1,262144,786432,1000003",
                    help="comma-separated row shifts of the in-core solves")
    ap.add_argument("--chunks", default="262144,131072,65536",
                    help="comma-separated chunk heights of the streamed solves")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("order_spread: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import FalkonConfig, falkon_fit, falkon_solve, falkon_solve_streaming
    from repro_torch.data import ArrayChunkSource, StreamingLoader

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    task, X, y, Xt, yt = cs.make_susy(torch, args.seed, 4_000_000, 500_000)
    Xh, yh = X.cpu().numpy(), y.cpu().numpy()
    t = 20
    for prec in ("fp32", "bf16"):
        cfg = cs.susy_config(FalkonConfig, task, precision=prec)
        est, state = falkon_fit(args.seed, X, y, cfg)
        C, pre = est.centers, state.precond

        def err(alpha):
            return cs.sign_err(torch, cfg.make_ops().apply(Xt, C, alpha), yt)

        def solve_rolled(shift):
            Xr, yr = torch.roll(X, shift, 0), torch.roll(y, shift, 0)
            return falkon_solve(Xr, yr, C, pre, est.kernel, task.lam, t, estimate_cond=False,
                                ops=cfg.make_ops())

        def solve_streamed(rows):
            loader = StreamingLoader(ArrayChunkSource(Xh, yh, chunk_rows=rows))
            return falkon_solve_streaming(loader, C, pre, task.lam, t, ops=cfg.make_ops())

        errs = [("in-core fit (with the cond estimate)", err(state.alpha))]
        errs += [(f"in-core solve, rows rolled by {r}", err(solve_rolled(int(r)).alpha))
                 for r in args.rolls.split(",")]
        errs += [(f"streamed solve, chunks of {c} rows", err(solve_streamed(int(c)).alpha))
                 for c in args.chunks.split(",")]
        for tag, e in errs:
            print(f"{prec} {tag}: test error {e:.6f} ({card})", flush=True)
        vals = [e for _, e in errs]
        print(f"{prec}: spread {max(vals) - min(vals):.6f} over {len(vals)} orders ({card})",
              flush=True)
        del est, state, pre
    return 0


if __name__ == "__main__":
    sys.exit(main())
