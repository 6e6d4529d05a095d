"""How far each sweep implementation rounds from a float64 sweep, on one GPU.

At the MillionSongs sweep shape (n = 463,715 synthetic rows, d = 90,
M = 5x10^4 centers drawn from them, gaussian sigma = 6, one random u) it
prints, for the float32 plain twin, B1 (``fused_sweep``) and B4
(``sharded_sweep``, with its transposed pass in one chain over all n rows
and in ``SHARD_ROW_CHUNK``-row chunks), the normwise distance
||w - w64|| / ||w64|| and the largest |w_j - w64_j| / (1e-7 S_j), S =
K^T K |u| (the limit ``chip_smoke.py`` holds each sweep to). Needs a CUDA
card; run from the repository root:

    python3 tools/sweep_rounding.py [--n 463715] [--M 50000]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=463_715)
    ap.add_argument("--M", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import make_kernel
    from repro_torch.data.synthetic import PAPER_TASKS, make_kernel_dataset
    from repro_torch.kernels import kernel_matvec as km

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(args.seed)
    X, _ = make_kernel_dataset(g, PAPER_TASKS["millionsongs"], args.n,
                               fn_generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    C = X[torch.randperm(args.n, generator=g, device=dev)[:args.M]].contiguous()
    spec = make_kernel("gaussian", sigma=6.0).spec
    u = torch.randn(args.M, generator=g, device=dev)
    w64 = km.fused_sweep_plain(X.double(), C.double(), u.double()[:, None], None,
                               spec=spec)[0][:, 0]
    limit = 1e-7 * km.fused_sweep_plain(X, C, u.abs()[:, None], None,
                                        spec=spec)[0][:, 0].double() + 1e-12

    def report(name, w):
        d = w.double() - w64
        print(f"{name:34s} normwise {float(d.norm() / w64.norm()):.3e}  "
              f"max |w - w64| / (1e-7 S) {float((d.abs() / limit).max()):.4f}", flush=True)

    print(f"n={args.n} M={args.M} d={X.shape[1]} on {torch.cuda.get_device_name(0)}")
    report("float32 twin", km.fused_sweep_plain(X, C, u[:, None], None, spec=spec)[0][:, 0])
    report("B1 fused_sweep", km.fused_sweep(X, C, u, spec=spec))
    chunk = km.SHARD_ROW_CHUNK
    report(f"B4 sharded_sweep, {chunk}-row chunks", km.sharded_sweep(X, C, u, spec=spec,
                                                                     shard_m=17_280))
    km.SHARD_ROW_CHUNK = args.n
    report("B4 sharded_sweep, one chain", km.sharded_sweep(X, C, u, spec=spec, shard_m=17_280))
    return 0


if __name__ == "__main__":
    sys.exit(main())
