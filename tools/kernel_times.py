"""Time the Gram-tile kernels at the main path's shapes on one GPU, on random data.

B1 (``fused_sweep``) at the SUSY and MillionSongs sweep shapes, B2
(``kernel_matmul``) at SUSY's predict and at one launch of B4's transposed
pass, B3 (``pairwise_kernel``) at both fits' K_MM (one tensor passed twice,
as the fit passes its centers) and at a 65,536-row K_nM-cache block against
SUSY's centers, and B4 (``sharded_sweep``) at the MillionSongs shape:
medians of CUDA events, each line with the card's name and power limit.
``--hash`` also prints the sha256 of each B1, B2 and B3 result's bytes.
``--bf16`` also times the bf16 compensated builds of B1, B2 and B4 (the bf16
policy's: X and C in bf16, u in fp32, B4's t spilled in bf16) on the same
inputs, rounded to bf16; only a checkout that has them takes it. ``--p``
times B1 and B2 (SUSY's sweep and predict shapes) at each listed number of
right-hand-side columns (the lam path stacks L * p of them; past 4 they run
in column groups of 4, one launch each). Rows are
``torch.randn`` from ``--seed`` and the centers a random subset of them;
gaussian sigma as the paper's tasks (4 for d = 18, 6 for d = 90). Meant for
comparing two checkouts in turns on one card: ``--tree`` imports the kernels
of another checkout (default: this one), on the same inputs. Needs a CUDA
card. From the repository root:

    python3 tools/kernel_times.py [--only b1,b2,b3,b4] [--reps 5] [--seed 0]
                                  [--tree DIR] [--hash] [--bf16] [--p 1,4,8]
"""
from __future__ import annotations

import argparse
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path


def sha256(K) -> str:
    """sha256 of a device tensor's bytes, copied to the host in row chunks."""
    h = hashlib.sha256()
    for r0 in range(0, K.shape[0], 4096):
        h.update(K[r0:r0 + 4096].cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="b1,b2,b3,b4",
                    help="comma-separated subset of b1,b2,b3,b4")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose src/repro_torch is timed (default: this one)")
    ap.add_argument("--hash", action="store_true",
                    help="print the sha256 of each B1, B2 and B3 result")
    ap.add_argument("--bf16", action="store_true",
                    help="also time the bf16 compensated builds of B1, B2 and B4")
    ap.add_argument("--p", default="1",
                    help="comma-separated column widths of B1 and B2 at the SUSY shapes")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import make_kernel
    from repro_torch.kernels import kernel_matvec as km

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(args.seed)

    def data(n, M, d):
        X = torch.randn(n, d, generator=g, device="cuda")
        return X, X[torch.randperm(n, generator=g, device="cuda")[:M]].contiguous()

    def time_ms(fn):
        fn()
        out = []
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    def report(name, fn):
        print(f"{name}: {time_ms(fn):.4f} ms ({card})", flush=True)
        if args.hash and not name.startswith("B4"):
            out = fn()
            print(f"{name} sha256 {sha256(out.reshape(out.shape[0], -1))}", flush=True)

    bf = torch.bfloat16

    only = set(args.only.split(","))
    # widths past 1 (p = 1 is the vector u every run times)
    widths = [int(w) for w in args.p.split(",") if int(w) > 1]
    for n, M, d, sigma in ((4_000_000, 10_000, 18, 4.0), (463_715, 50_000, 90, 6.0)):
        X, C = data(n, M, d)
        spec = make_kernel("gaussian", sigma=sigma).spec
        u = torch.randn(M, generator=g, device="cuda")
        if "b1" in only:
            report(f"B1 n={n} M={M} d={d}", lambda: km.fused_sweep(X, C, u, spec=spec))
        for p in (widths if "b1" in only and d == 18 else ()):
            U = torch.randn(M, p, generator=g, device="cuda")
            report(f"B1 n={n} M={M} d={d} p={p}", lambda: km.fused_sweep(X, C, U, spec=spec))
        if "b1" in only and args.bf16:
            Xq, Cq = X.to(bf), C.to(bf)
            report(f"B1 bf16 n={n} M={M} d={d}",
                   lambda: km.fused_sweep(Xq, Cq, u, spec=spec, compensated=True))
        if "b2" in only and d == 18:
            Xt = torch.randn(500_000, d, generator=g, device="cuda")
            report(f"B2 m={Xt.shape[0]} n={M} d={d}", lambda: km.kernel_matmul(Xt, C, u, spec=spec))
            for p in widths:
                V = torch.randn(M, p, generator=g, device="cuda")
                report(f"B2 m={Xt.shape[0]} n={M} d={d} p={p}",
                       lambda: km.kernel_matmul(Xt, C, V, spec=spec))
            if args.bf16:
                Xtq, Cq = Xt.to(bf), C.to(bf)
                report(f"B2 bf16 m={Xt.shape[0]} n={M} d={d}",
                       lambda: km.kernel_matmul(Xtq, Cq, u, spec=spec, compensated=True))
        if "b3" in only:
            gram = lambda: km.pairwise_kernel(C, C, spec=spec)
            report(f"B3 m=n={M} d={d} (K_MM, one tensor twice)", gram)
        if "b3" in only and d == 18:
            Xr = X[:65_536]
            report(f"B3 m={Xr.shape[0]} n={M} d={d} (a K_nM-cache row block)",
                   lambda: km.pairwise_kernel(Xr, C, spec=spec))
        if "b2" in only and d == 90:
            Cj, Xr = C[:17_280], X[:km.SHARD_ROW_CHUNK]
            t = torch.randn(Xr.shape[0], 1, generator=g, device="cuda")
            w = torch.randn(Cj.shape[0], 1, generator=g, device="cuda")
            report(f"B2 m={Cj.shape[0]} n={Xr.shape[0]} d={d}",
                   lambda: km.kernel_matmul(Cj, Xr, t, w, spec=spec))
        if "b4" in only and d == 90:
            report(f"B4 n={n} M={M} d={d} shard_m=17280",
                   lambda: km.sharded_sweep(X, C, u, spec=spec, shard_m=17_280))
            if args.bf16:
                Xq, Cq = X.to(bf), C.to(bf)
                report(f"B4 bf16 n={n} M={M} d={d} shard_m=17280",
                       lambda: km.sharded_sweep(Xq, Cq, u, spec=spec, shard_m=17_280,
                                                compensated=True, t_dtype=bf,
                                                out_dtype=torch.float32))
        del X, C
    return 0


if __name__ == "__main__":
    sys.exit(main())
