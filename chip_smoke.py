"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, fit.

    python3 chip_smoke.py [--seed 0] [--n 4000000] [--n-test 500000] [--checks-only]

Phases, each printed as it runs; any failure exits non-zero before the
result line:

1. device   — needs a CUDA card; prints its name and power limit.
2. build    — compiles the CUDA sources of ``src/repro_torch/kernels/csrc``,
               one ``nvcc`` per source, all started together, into one
               library.
3. kernels  — every kernel (sweep B1, kernel matmul B2, pairwise Gram B3,
               sharded sweep B4) against its plain PyTorch twin on the
               card, for all five kernel kinds, ragged shapes, p = 1 to 4,
               ``v=None``, ``row_mask`` (masked rows must give exactly the
               prefix result) and ``add=``; B1 also at M = 5000 (p = 3) and
               M = 20500 (p = 1), where its w partials live in global
               memory; B4 also against B1, with ragged shards.
4. blocked  — the blocked Cholesky's tile kernels B5-B7 against their
               twins at the ragged test shapes, a 1280 tile and the last
               80-wide panel's update (k = 1280); B5 on an indefinite tile
               (NaN); ``blocked_cholesky`` on the "cuda" engine against the
               "torch" engine and a float64 factor.
5. main     — the port's in-core fit (``falkon_fit``, ops_impl="cuda") on
               synthetic SUSY-shape data (d = 18, gaussian sigma = 4,
               lam = 1e-6, M = 10^4 centers, t = 20) with n training rows,
               then ``predict`` on n-test rows; the kernel launch counts of
               that run (sweep 47, pairwise 1, kernel matmul >= 1); a
               small fit against the plain "torch" backend (and, at
               lam = 1e-6 over 4 center draws, against float64 fits); a
               sweep at that shape against float32 and float64 twins.
6. msd      — the large-M fit at the paper's MillionSongs size (synthetic
               YearPredictionMSD split: 463,715 / 51,630 rows, d = 90,
               gaussian sigma = 6, lam = 1e-6, M = 5x10^4, t = 20): the
               factor on the blocked route (block 1280, 40 panels) with its
               device peak against the plan's ceiling and the exact launch
               counts (B5 80, B6 78, B7 1560, B3 1, B1 47); test MSE against
               the label variance; a second solve with the sweep forced onto
               B4 (``REPRO_SWEEP_BUDGET_MB``) against the first; two small
               forced-blocked fits (M = 320 and 1024) against in-core and
               float64 fits.
7. times    — the full-size sweeps (SUSY: B1; MillionSongs: B1 and B4) and
               the predict-shape kernel matmul against float32 and float64
               twins; the MillionSongs fit's blocked T and A against
               in-core float32 (cuSOLVER) and float64 factors of the same
               matrices; B6 and B7 at the first panel's shapes against their
               twins; each kernel at its path's shapes (CUDA events) beside
               its plain twin, its bound and its library call, then one
               ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

FP32_PEAK = 67e12        # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12       # H100 SXM device memory, bytes/s
TOL = dict(rtol=1e-4, atol=1e-4)   # fp32, summation order differs from the twin
KINDS = [
    ("gaussian", dict(sigma=1.3)),
    ("laplacian", dict(sigma=1.1)),
    ("matern32", dict(sigma=1.7)),
    ("linear", dict(scale=1.5)),
    ("polynomial", dict(degree=2, c=0.5, scale=2.0)),
]
SHAPES = [(300, 97, 13), (513, 129, 33)]
#: (n, M, d, p) of sweeps whose w partials overflow shared memory
SWEEP_GLOBAL = [(40_000, 5_000, 18, 3), (40_000, 20_500, 18, 1)]
#: (n, M, d, shard_m) of the sharded sweep B4: ragged shards; the last
#: spans two of its transposed pass's row chunks
SHARDED = [(300, 333, 13, 128), (513, 129, 33, 64), (70_000, 333, 13, 128)]
#: MillionSongs (Sect. 5 of the paper): M = 5x10^4 uniform centers on the
#: YearPredictionMSD split of 463,715 training and 51,630 test rows
MSD_CENTERS = 50_000
MSD_N, MSD_N_TEST = 463_715, 51_630
#: REPRO_SWEEP_BUDGET_MB that forces the MillionSongs sweep onto B4 in
#: three C-shards (shard_m = 17280)
MSD_SHARD_BUDGET_MB = 6
#: the j_sharded solve may stand at most this many times as far from the
#: planner-route solve (alpha, predictions) as a plain float32 solve does
AGREE_FACTOR = 2.0
#: forced-blocked vs in-core fit predictions (the reference's bound)
BLOCKED_FIT_TOL = 1e-4
#: normwise bound of a factor against its twin or a float64 factor (the
#: reference's blocked-vs-in-core bound)
FACTOR_TOL = 1e-5
#: the MillionSongs fit's blocked factors may stand at most this many times
#: as far (normwise) from float64 factors of the same matrices as in-core
#: float32 cuSOLVER factors do: two correct fp32 factorizations that sum in
#: other orders round alike to within a small factor, while a wrong panel
#: or update moves the factor by O(1)
FACTOR_AGREE = 4.0
#: (n, d, M) of the small forced-blocked fits: the reference test's problem
#: (tests/test_blocked_cholesky.py, 2 panels of 256) and one with 4 panels
#: and three rounds of trailing updates
SMALL_BLOCKED = [(1500, 6, 320), (20_000, 6, 1024)]
#: limit of a float32 result's error per unit of the sum of the magnitudes
#: of its terms (predict: max_i sum_j |K_ij alpha_j|; sweep: K^T K |u|):
#: about two fp32 unit roundoffs (2^-24 = 6.0e-8)
PRED_RTOL = 1e-7
#: center draws of the small lam = 1e-6 fits held against float64 fits
SMALL_SEEDS = 4
SOURCE = "src/repro_torch/kernels/csrc/kernel_matvec.cu"
SOURCE_BLOCKED = "src/repro_torch/kernels/csrc/blocked_cholesky.cu"
DEVICE = "cuda"
REPLACES = {
    "fused_sweep": "src/repro/kernels/kernel_matvec.py:361",
    "kernel_matmul": "src/repro/kernels/kernel_matvec.py:174",
    "pairwise_kernel": "src/repro/kernels/kernel_matvec.py:559",
    "sharded_sweep": "src/repro/kernels/kernel_matvec.py:474",
    "potrf_tile": "src/repro/kernels/blocked_cholesky.py:212",
    "trsm_panel": "src/repro/kernels/blocked_cholesky.py:225",
    "trailing_update": "src/repro/kernels/blocked_cholesky.py:246",
}
SOURCES = {name: SOURCE for name in ("fused_sweep", "kernel_matmul", "pairwise_kernel")}
#: B4 is B2's launches in a loop; its source is the wrapper that composes them
SOURCES["sharded_sweep"] = "src/repro_torch/kernels/kernel_matvec.py"
SOURCES.update({name: SOURCE_BLOCKED for name in ("potrf_tile", "trsm_panel",
                                                  "trailing_update")})


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


def close_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max |got - ref| / (atol + rtol * max |ref|)); the
    second must stay <= 1. The kernel and its twin sum in different orders,
    so the fp32 rounding scales with the magnitudes of the whole result, not
    with each entry (an entry near 0 by cancellation keeps the error of its
    terms)."""
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / (TOL["atol"] + TOL["rtol"] * float(ref.double().abs().max()))


def phase_device(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    say(f"[device] nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain twins in IEEE fp32
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from repro_torch.kernels import build, kernel_matvec as km
    t0 = time.perf_counter()
    lib_path = build.build()      # one nvcc per source, started together, then a link
    km._lib()
    build_s = time.perf_counter() - t0
    say(f"[build] {lib_path.name} in {build_s:.3f} s")
    for log in sorted(lib_path.parent.glob(f"*_{build._sources_hash()}.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"[build] {line.strip()}")
    return build_s


def check_sweep(torch, km, spec, X, C, u, v, res: dict, tag: str) -> None:
    """B1 against its twin with v, without v and under ``row_mask``; the tile
    counter; masked junk rows giving exactly the valid prefix's result."""
    n, M = X.shape[0], C.shape[0]
    p = u.numel() // M
    u2 = u.reshape(M, p)
    v2 = v.reshape(n, p)
    w, cnt = km.fused_sweep(X, C, u, v, spec=spec, return_tile_count=True)
    ref, _ = km.fused_sweep_plain(X, C, u2, v2, spec=spec)
    res["sweep"] = close_err(w.reshape(M, p), ref)
    nbi, nbj = km.sweep_tile_grid(n, M)
    check(int(cnt) == 2 * nbi * nbj, f"{tag}: tile count {int(cnt)} != {2 * nbi * nbj}")
    w0 = km.fused_sweep(X, C, u, None, spec=spec)
    res["sweep v=None"] = close_err(w0.reshape(M, p),
                                    km.fused_sweep_plain(X, C, u2, None, spec=spec)[0])
    keep = n - 20
    Xj = X.clone()
    Xj[keep:] = 123.0
    mask = torch.zeros(n, device=X.device)
    mask[:keep] = 1.0
    got_m = km.fused_sweep(Xj, C, u, v, spec=spec, row_mask=mask)
    got_p = km.fused_sweep(X[:keep].contiguous(), C, u, v[:keep].contiguous(), spec=spec)
    torch.cuda.synchronize()
    check(torch.equal(got_m, got_p), f"{tag}: masked rows changed the sweep "
          f"(max diff {float((got_m - got_p).abs().max())})")
    res["sweep row_mask"] = close_err(
        got_m.reshape(M, p), km.fused_sweep_plain(Xj, C, u2, v2, spec=spec, row_mask=mask)[0])


def tally(res: dict, tag: str) -> float:
    worst = 0.0
    for name, (abs_err, ratio) in res.items():
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"{name} {tag}: max abs err {abs_err:.3e} exceeds "
              f"atol 1e-4 + rtol 1e-4 (ratio {ratio:.3f})")
    say(f"[kernels] {tag}: " + ", ".join(f"{k} {a:.2e}" for k, (a, _) in res.items()))
    return worst


def phase_kernels(torch):
    from repro_torch.core.kernels import make_kernel
    from repro_torch.kernels import kernel_matvec as km
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    worst = 0.0
    cases = 0
    for kind, params in KINDS:
        spec = make_kernel(kind, **params).spec
        for n, M, d in SHAPES:
            for p in (1, 2, 3, 4):   # compiled widths P = 1 and 4; 2 and 3 pad to 4
                cols = () if p == 1 else (p,)
                X, C = randn(n, d), randn(M, d)
                u, v = randn(M, *cols), randn(n, *cols)
                u2, v2 = u.reshape(M, p), v.reshape(n, p)
                res = {}
                tag = f"{kind:10s} n,M,d={n},{M},{d} p={p}"
                check_sweep(torch, km, spec, X, C, u, v, res, tag)
                # B2: plain and with add=
                res["matmul"] = close_err(km.kernel_matmul(X, C, u, spec=spec).reshape(n, p),
                                          km.kernel_matmul_plain(X, C, u2, spec=spec))
                res["matmul add"] = close_err(
                    km.kernel_matmul(X, C, u, v, spec=spec).reshape(n, p),
                    km.kernel_matmul_plain(X, C, u2, v2, spec=spec))
                # B3
                res["pairwise"] = close_err(km.pairwise_kernel(X, C, spec=spec),
                                            km.pairwise_kernel_plain(X, C, spec=spec))
                torch.cuda.synchronize()
                cases += len(res)
                worst = max(worst, tally(res, tag))
        # B1 with its w partials in global scratch (too large for shared
        # memory), more row blocks than resident blocks, at both widths
        for n, M, d, p in SWEEP_GLOBAL:
            smem, in_smem = km.sweep_smem_bytes(M, p)
            check(not in_smem, f"sweep M={M} p={p} keeps its w partial in shared memory")
            cols = () if p == 1 else (p,)
            X, C = randn(n, d), randn(M, d)
            res = {}
            tag = f"{kind:10s} n,M,d={n},{M},{d} p={p} (w partial in global memory)"
            check_sweep(torch, km, spec, X, C, randn(M, *cols), randn(n, *cols), res, tag)
            cases += len(res)
            worst = max(worst, tally(res, tag))
        # B4 against its twin and against B1: ragged shards, p = 1 to 4
        for n, M, d, shard in SHARDED:
            for p in (1, 2, 3, 4):
                cols = () if p == 1 else (p,)
                X, C = randn(n, d), randn(M, d)
                res = {}
                tag = f"{kind:10s} n,M,d={n},{M},{d} shard_m={shard} p={p} (B4)"
                check_sharded(torch, km, spec, X, C, randn(M, *cols), randn(n, *cols), shard,
                              res, tag)
                cases += len(res)
                worst = max(worst, tally(res, tag))
    say(f"[kernels] {cases} checks pass; worst max|diff|/(1e-4 + 1e-4 max|ref|) = {worst:.4f} (bound 1)")


def check_sharded(torch, km, spec, X, C, u, v, shard: int, res: dict, tag: str) -> None:
    """B4 against its twin and against B1, with v, without v and under
    ``row_mask``; masked junk rows give exactly the valid prefix's result."""
    n, M = X.shape[0], C.shape[0]
    p = u.numel() // M
    u2, v2 = u.reshape(M, p), v.reshape(n, p)
    w = km.sharded_sweep(X, C, u, v, spec=spec, shard_m=shard).reshape(M, p)
    res["sharded"] = close_err(w, km.sharded_sweep_plain(X, C, u2, v2, spec=spec, shard_m=shard))
    res["sharded vs fused"] = close_err(w, km.fused_sweep(X, C, u2, v2, spec=spec))
    w0 = km.sharded_sweep(X, C, u, None, spec=spec, shard_m=shard).reshape(M, p)
    res["sharded v=None"] = close_err(
        w0, km.sharded_sweep_plain(X, C, u2, None, spec=spec, shard_m=shard))
    keep = n - 20
    Xj = X.clone()
    Xj[keep:] = 123.0
    mask = torch.zeros(n, device=X.device)
    mask[:keep] = 1.0
    got_m = km.sharded_sweep(Xj, C, u, v, spec=spec, row_mask=mask, shard_m=shard)
    got_p = km.sharded_sweep(X[:keep].contiguous(), C, u, v[:keep].contiguous(), spec=spec,
                             shard_m=shard)
    torch.cuda.synchronize()
    check(torch.equal(got_m, got_p), f"{tag}: masked rows changed the sharded sweep "
          f"(max diff {float((got_m - got_p).abs().max())})")
    res["sharded row_mask"] = close_err(
        got_m.reshape(M, p),
        km.sharded_sweep_plain(Xj, C, u2, v2, spec=spec, row_mask=mask, shard_m=shard))


def rel(a, b) -> float:
    """Normwise relative distance ||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def phase_blocked(torch):
    """B5-B7 against their twins on the card, at the ragged test shapes and
    at this slice's widths (a 1280 tile; the last, 80-wide panel's update
    with k = 1280); B5 on an indefinite tile; the blocked factorization on
    the "cuda" engine against the "torch" engine and a float64 factor."""
    from repro_torch.kernels import blocked_cholesky as bc
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)

    def spd(M):
        A = torch.tensor(rng.standard_normal((M, M)), dtype=torch.float32, device=dev)
        return A @ A.T / M + torch.eye(M, device=dev)

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    worst = 0.0
    for b in (256, 192, 80, 1280):
        A = spd(b)
        L = bc.potrf_tile(A)
        e5 = rel(L, bc.potrf_plain(A))
        Ap = randn(3 * b + 17, b)
        e6 = rel(bc.trsm_panel(L, Ap), bc.trsm_plain(L, Ap))
        say(f"[blocked] b={b}: B5 vs twin {e5:.3e}, B6 (r={3 * b + 17}) vs twin {e6:.3e} "
            f"(bound {FACTOR_TOL:g} normwise)")
        check(e5 <= FACTOR_TOL and e6 <= FACTOR_TOL, f"B5/B6 off their twins at b={b}")
        worst = max(worst, e5 / FACTOR_TOL, e6 / FACTOR_TOL)
    # B7 at the ragged shapes: (r, b, k) of the last update of M = 5x10^4
    # (80, 80, 1280), of (M, block) = (300, 256) and (500, 192), and a full
    # first-panel tile
    for r, b, k in ((80, 80, 1280), (44, 44, 256), (116, 116, 192), (4000, 1280, 1280)):
        C, P, Q = randn(r, b), randn(r, k), randn(b, k)
        ref = bc.update_plain(C, P, Q)
        out = bc.trailing_update(C, P, Q)
        abs_err, ratio = close_err(out, ref)
        inplace = bc.trailing_update(C, P, Q, out=C)
        torch.cuda.synchronize()
        check(torch.equal(inplace, out), f"B7 in place differs at r,b,k={r},{b},{k}")
        say(f"[blocked] B7 r,b,k={r},{b},{k}: max abs err {abs_err:.3e}, ratio {ratio:.4f}")
        check(ratio <= 1.0, f"B7 off its twin at r,b,k={r},{b},{k} (ratio {ratio})")
        worst = max(worst, ratio)
    A = spd(96)
    A[48, 48] = -100.0
    check(bool(torch.isnan(bc.potrf_tile(A)).any()), "B5 gave a finite factor of an indefinite tile")
    check(bool(torch.isnan(bc.potrf_plain(A)).any()), "B5's twin gave a finite factor")
    say("[blocked] B5 and its twin give NaN on an indefinite tile")
    for M, block in ((300, 256), (500, 192), (260, 256), (3000, 1280)):
        K = spd(M).cpu()
        T64 = torch.linalg.cholesky(K.double()).mT
        stats = bc.FactorStats()
        Tc = bc.blocked_cholesky(K, block, tile_impl="cuda", device=dev, stats=stats)
        Tt = bc.blocked_cholesky(K, block, tile_impl="torch", device=dev)
        ec, et = rel(Tc, T64), rel(Tt, T64)
        eg = rel(Tc, Tt)
        say(f"[blocked] M={M} block={block}: cuda engine vs float64 {ec:.3e}, torch engine vs "
            f"float64 {et:.3e}, cuda vs torch {eg:.3e} (bound {FACTOR_TOL:g}); device peak "
            f"{stats.measured_peak_device_bytes} B measured, {stats.peak_device_bytes} B "
            f"accounted, panels {stats.panels}, updates {stats.tiles_updated}")
        check(max(ec, eg) <= FACTOR_TOL, f"blocked cholesky M={M} block={block} off")
        check(stats.current_device_bytes == 0, "blocked cholesky left device buffers")
        worst = max(worst, ec / FACTOR_TOL, eg / FACTOR_TOL)
    say(f"[blocked] all checks pass; worst error / bound = {worst:.4f}")


def make_susy(torch, seed: int, n: int, n_test: int):
    from repro_torch.data.synthetic import PAPER_TASKS, make_kernel_dataset
    task = PAPER_TASKS["susy"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    X, y = make_kernel_dataset(g, task, n,
                               fn_generator=torch.Generator(device=DEVICE).manual_seed(seed + 1))
    Xt, yt = make_kernel_dataset(g, task, n_test,
                                 fn_generator=torch.Generator(device=DEVICE).manual_seed(seed + 1))
    return task, X, y, Xt, yt


def susy_config(FalkonConfig, task, **kw):
    base = dict(kernel="gaussian", kernel_params=(("sigma", task.sigma),), lam=task.lam,
                num_centers=10_000, iterations=20, ops_impl="cuda", device=DEVICE)
    base.update(kw)
    return FalkonConfig(**base)


def phase_main(torch, args):
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.kernels import kernel_matvec as km
    t0 = time.perf_counter()
    task, X, y, Xt, yt = make_susy(torch, args.seed, args.n, args.n_test)
    torch.cuda.synchronize()
    say(f"[main] SUSY-shape data n={args.n} n_test={args.n_test} d={task.d} "
        f"in {time.perf_counter() - t0:.3f} s")
    if args.n != 4_000_000:
        say(f"[main] n cut from 4000000 to {args.n} (only n; d, M, sigma, lam, t kept)")
    config = susy_config(FalkonConfig, task)

    km.reset_launch_counts()
    times: dict[str, float] = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est, state = falkon_fit(args.seed, X, y, config, stage_times=times)
    t1 = time.perf_counter()
    pred = est.predict(Xt)
    torch.cuda.synchronize()
    times["predict"] = time.perf_counter() - t1
    counts = km.launch_counts()
    fit_s = t1 - t0
    say("[main] stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f}; factor route {times['factor_path']}")
    say(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    say(f"[main] kernel launches in the main path: {counts}")
    check(counts["fused_sweep"] == 47, f"sweep kernel launched {counts['fused_sweep']} times, not 47")
    check(counts["pairwise_kernel"] == 1, f"pairwise kernel launched {counts['pairwise_kernel']} times")
    check(counts["kernel_matmul"] >= 1, "kernel matmul never launched by predict")

    res = state.residual_norms.cpu()
    cond = float(state.cond_estimate)
    say("[main] residual norms: " + " ".join(f"{float(r):.4e}" for r in res))
    say(f"[main] cond_estimate {cond:.6g}")
    check(state.alpha.shape == (config.num_centers,), f"alpha shape {tuple(state.alpha.shape)}")
    check(pred.shape == (args.n_test,), f"prediction shape {tuple(pred.shape)}")
    check(bool(torch.isfinite(state.alpha).all() and torch.isfinite(pred).all()),
          "non-finite alpha or predictions")
    check(bool(torch.isfinite(res).all()) and float(res[-1]) < float(res[0]),
          "CG residual did not decrease")
    check(np.isfinite(cond) and cond > 0, f"cond_estimate {cond}")
    err = float((torch.sign(pred) != yt).float().mean())
    err_train = float((torch.sign(est.predict(X[:args.n_test])) != y[:args.n_test]).float().mean())
    say(f"[main] test error {err:.6f} (train-subset error {err_train:.6f}; label noise 0.1)")
    check(err < 0.4, f"test error {err} no better than chance")

    # the same fit, small, on the kernels and on the plain "torch" backend.
    # At lam = 1e-3 the two agree to 1e-3. At the slice's lam = 1e-6 the
    # solve amplifies fp32 rounding, so there each float32 fit is held
    # against a float64 "torch" fit over SMALL_SEEDS center draws, each
    # fit's alpha scored in float64 so that only the fit is compared: the
    # kernels' fits may stand at most 1.5x as far (summed over the draws) as
    # the plain float32 fits do.
    ns, ms = 20_000, 500
    Xs, ys, Xts = X[:ns], y[:ns], Xt[:ns]

    def small_fit(seed, impl, lam, dtype="float32"):
        cfg = susy_config(FalkonConfig, task, num_centers=ms, ops_impl=impl, lam=lam,
                          dtype=dtype)
        return falkon_fit(seed, Xs, ys, cfg)[0]

    def scored64(e):
        return km.kernel_matmul_plain(Xts.double(), e.centers.double(),
                                      e.alpha.double()[:, None], spec=e.kernel.spec)[:, 0]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    r3 = rel(small_fit(args.seed, "cuda", 1e-3).predict(Xts).double(),
             small_fit(args.seed, "torch", 1e-3).predict(Xts).double())
    say(f"[main] small fit n={ns} M={ms} lam=1e-3: cuda vs torch backend predictions "
        f"rel {r3:.3e} (bound 1e-3)")
    check(r3 <= 1e-3, f"cuda fit disagrees with the torch backend: {r3}")
    rc, rt = [], []
    for seed in range(args.seed, args.seed + SMALL_SEEDS):
        ref = scored64(small_fit(seed, "torch", task.lam, "float64"))
        rc.append(rel(scored64(small_fit(seed, "cuda", task.lam)), ref))
        rt.append(rel(scored64(small_fit(seed, "torch", task.lam)), ref))
    say(f"[main] small fit n={ns} M={ms} lam={task.lam:g}, {SMALL_SEEDS} center draws: "
        f"rel distance of the float32 fits from the float64 torch fit: cuda "
        + " ".join(f"{r:.3e}" for r in rc) + "; torch " + " ".join(f"{r:.3e}" for r in rt)
        + f"; sums {sum(rc):.4e} vs {sum(rt):.4e} (bound 1.5x the latter)")
    check(sum(rc) <= 1.5 * sum(rt), f"cuda fits at lam={task.lam:g} stand {sum(rc):.4e} "
          f"from the float64 fits, more than 1.5x the float32 torch fits' {sum(rt):.4e}")
    # one sweep at this shape against a float64 twin
    e = small_fit(args.seed, "cuda", task.lam)
    u = torch.randn(ms, generator=torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    sweep_witness(torch, km, e.kernel.spec, Xs, e.centers, u, f"n={ns} M={ms}")
    return dict(X=X, Xt=Xt, centers=est.centers, alpha=est.alpha, spec=est.kernel.spec,
                counts=counts, fit_s=fit_s)


def sweep_witness(torch, km, spec, X, C, u, tag: str, kernels=None):
    """Sweep kernels against a float64 twin, entry by entry (gaussian).

    fp32 rounding in w = K^T (K u) scales with S = K^T K |u| (K >= 0), which
    bounds the magnitudes of the terms of both sums: w cancels to far below
    S, and a per-center rounding (of ||c_j||^2, say) moves every term of
    that center together. Each |w_j - w64_j| is held to PRED_RTOL * S_j.
    ``kernels`` maps a name to a callable giving that kernel's w (default:
    B1). Returns ({name: kernel result}, float32 twin result)."""
    check(spec.kind == "gaussian", f"sweep witness needs K >= 0, not {spec.kind}")
    if kernels is None:
        kernels = {"B1": lambda: km.fused_sweep(X, C, u, spec=spec)}
    ws = {name: fn() for name, fn in kernels.items()}
    w32 = km.fused_sweep_plain(X, C, u[:, None], None, spec=spec)[0][:, 0]
    w64 = km.fused_sweep_plain(X.double(), C.double(), u.double()[:, None], None,
                               spec=spec)[0][:, 0]
    S = km.fused_sweep_plain(X, C, u.abs()[:, None], None, spec=spec)[0][:, 0].double()
    limit = PRED_RTOL * S + 1e-12
    rt = float(((w32.double() - w64).abs() / limit).max())
    for name, w in ws.items():
        rk = float(((w.double() - w64).abs() / limit).max())
        say(f"[sweep] {tag} {name}: max|w| {float(w64.abs().max()):.4e}, max S "
            f"{float(S.max()):.4e}; max |w - w64| / ({PRED_RTOL:g} S): kernel {rk:.4f}, "
            f"float32 twin {rt:.4f} (bound 1); max abs err kernel "
            f"{float((w.double() - w64).abs().max()):.4e}, twin "
            f"{float((w32.double() - w64).abs().max()):.4e}")
        check(rk <= 1.0, f"sweep {tag} {name}: off a float64 twin by {rk:.3f} x its limit")
    return ws, w32


def make_msd(torch, seed: int, n: int, n_test: int):
    """The YearPredictionMSD split (463,715 / 51,630 rows, d = 90), made
    synthetic from ``seed`` with the port's MillionSongs task."""
    from repro_torch.data.synthetic import PAPER_TASKS, make_kernel_dataset
    task = PAPER_TASKS["millionsongs"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    fg = lambda: torch.Generator(device=DEVICE).manual_seed(seed + 1)
    X, y = make_kernel_dataset(g, task, n, fn_generator=fg())
    Xt, yt = make_kernel_dataset(g, task, n_test, fn_generator=fg())
    return task, X, y, Xt, yt


def host_peak_rss_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20   # KiB on Linux


def phase_msd(torch, args):
    """The large-M path at the paper's MillionSongs size: blocked factor on
    B5-B7, the planner's sweep route, a second solve forced onto B4, predict."""
    from repro_torch.core import FalkonConfig, falkon_fit, falkon_solve
    from repro_torch.kernels import kernel_matvec as km
    from repro_torch.ops import FactorPlanWarning, SweepPlanWarning, get_ops, plan_factor
    t0 = time.perf_counter()
    task, X, y, Xt, yt = make_msd(torch, args.seed, MSD_N, MSD_N_TEST)
    torch.cuda.synchronize()
    n, d = X.shape
    M = MSD_CENTERS
    say(f"[msd] MillionSongs-shape data n={n} n_test={Xt.shape[0]} d={d} in "
        f"{time.perf_counter() - t0:.3f} s")
    plan = plan_factor(M)
    nb = -(-M // plan.block)
    say(f"[msd] factor plan: {plan.path}, block {plan.block}, {nb} panels (last "
        f"{M - (nb - 1) * plan.block} wide), device ceiling {plan.device_ceiling_bytes} B, "
        f"dense factor {plan.dense_bytes} B")
    check((plan.path, plan.block, nb) == ("blocked", 1280, 40), f"factor plan {plan}")
    config = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", task.sigma),),
                          lam=task.lam, num_centers=M, iterations=20, ops_impl="cuda",
                          device=DEVICE)
    ops = get_ops("cuda", config.make_kernel())
    splan = ops.plan(n, M, d)
    say(f"[msd] sweep plan: {splan.path} — {splan.reason}")
    # the planner models B1's grid without a card; the launch queries it
    smem, _ = km.sweep_smem_bytes(M, 1)
    grid_q = km._sweep_grid(km._pad_p(1), smem, torch.cuda.current_device())
    say(f"[msd] B1 grid: planner's model {km.sweep_grid_model(M, 1)}, occupancy query {grid_q}")
    check(km.sweep_grid_model(M, 1) >= grid_q, "the planner's grid model is below the card's")

    km.reset_launch_counts()
    times: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        est, state = falkon_fit(args.seed, X, y, config, stage_times=times)
    fit_s = time.perf_counter() - t0
    counts = km.launch_counts()
    check(any(isinstance(w.message, FactorPlanWarning) for w in rec),
          "no FactorPlanWarning: the factor did not take the blocked route")
    check(not any(isinstance(w.message, SweepPlanWarning) for w in rec),
          "the planner-route solve left the fused sweep")
    say("[msd] stage seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items() if isinstance(v, float))
        + f"; fit total {fit_s:.4f}")
    fstats = times["factor_stats"]
    peak = fstats.measured_peak_device_bytes
    say(f"[msd] factor route {times['factor_path']} block {times['factor_block']}; device "
        f"peak during the blocked factorizations {peak} B ({peak / 2**30:.3f} GiB) against "
        f"the plan's ceiling {plan.device_ceiling_bytes} B; peak device memory of the fit "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; host peak RSS "
        f"{host_peak_rss_gib():.3f} GiB")
    say(f"[msd] blocked factor stage: {fstats.bytes_transferred} B moved host<->device; "
        f"{fstats.copy_seconds:.4f} s in copies (with the host gathers of strided "
        f"panels), {fstats.tile_seconds:.4f} s in tile operations (B5-B7 and the "
        f"T T^T products), of the stage's {times['factor']:.4f} s; "
        f"{fstats.panels} panels, {fstats.tiles_updated} trailing updates")
    check((times["factor_path"], times["factor_block"]) == ("blocked", 1280),
          "the fit's factor did not route blocked at 1280")
    check(0 < peak <= plan.device_ceiling_bytes, f"factor device peak {peak} B")
    say(f"[msd] kernel launches in the fit: {counts}")
    want = dict(potrf_tile=2 * nb, trsm_panel=2 * (nb - 1),
                trailing_update=2 * nb * (nb - 1) // 2, pairwise_kernel=1, fused_sweep=47,
                sharded_sweep=0, kernel_matmul=0)
    check(counts == want, f"launch counts {counts} != {want}")

    t1 = time.perf_counter()
    pred = est.predict(Xt)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    res = state.residual_norms.cpu()
    cond = float(state.cond_estimate)
    mse = float(((pred - yt) ** 2).mean())
    var = float(yt.var())
    say("[msd] residual norms: " + " ".join(f"{float(r):.4e}" for r in res))
    say(f"[msd] cond_estimate {cond:.6g}; predict {Xt.shape[0]} rows {predict_s:.4f} s; "
        f"test MSE {mse:.6f}, label variance {var:.6f}, ratio {mse / var:.4f} "
        f"(noise variance {task.noise ** 2:g})")
    check(bool(torch.isfinite(state.alpha).all() and torch.isfinite(pred).all()),
          "non-finite alpha or predictions")
    check(bool(torch.isfinite(res).all()) and float(res[-1]) < float(res[0]),
          "CG residual did not decrease")
    check(mse < var, f"test MSE {mse} not below the label variance {var}")

    # the same solve on the same preconditioner, the sweep forced onto B4
    budget = MSD_SHARD_BUDGET_MB
    old = os.environ.get("REPRO_SWEEP_BUDGET_MB")
    os.environ["REPRO_SWEEP_BUDGET_MB"] = str(budget)
    try:
        jplan = ops.plan(n, M, d)
        check(jplan.path == "j_sharded", f"forced plan {jplan}")
        km.reset_launch_counts()
        t1 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            st2 = falkon_solve(X, y, est.centers, state.precond, est.kernel, task.lam, 20,
                               ops=ops)
        torch.cuda.synchronize()
        solve2_s = time.perf_counter() - t1
        jcounts = km.launch_counts()
    finally:
        if old is None:
            os.environ.pop("REPRO_SWEEP_BUDGET_MB")
        else:
            os.environ["REPRO_SWEEP_BUDGET_MB"] = old
    shards = -(-M // jplan.shard_m)
    check(any(isinstance(w.message, SweepPlanWarning) and w.message.plan.path == "j_sharded"
              for w in rec), "the forced solve did not warn j_sharded")
    say(f"[msd] forced j_sharded solve (REPRO_SWEEP_BUDGET_MB={budget}: {shards} shards of "
        f"{jplan.shard_m}): {solve2_s:.4f} s, launches {jcounts}")
    chunks = -(-n // km.SHARD_ROW_CHUNK)
    jwant = dict(sharded_sweep=47, kernel_matmul=47 * (1 + shards * chunks), fused_sweep=0)
    check(all(jcounts[k] == v for k, v in jwant.items()), f"forced launches {jcounts}")
    # The yardstick: the same solve on the plain float32 "torch" backend. At
    # lam = 1e-6 alpha = T^-1 A^-1 beta, and T (cond ~ sqrt(cond K_MM)) turns
    # fp32 rounding of the sweeps into large differences of alpha along the
    # near-null directions of K_MM; B4 must stand no farther from B1 than a
    # second correct fp32 sweep does.
    t1 = time.perf_counter()
    st3 = falkon_solve(X, y, est.centers, state.precond, est.kernel, task.lam, 20,
                       ops=get_ops("torch", est.kernel))
    torch.cuda.synchronize()
    solve3_s = time.perf_counter() - t1
    pred2 = km.kernel_matmul(Xt, est.centers, st2.alpha, spec=est.kernel.spec)
    pred3 = km.kernel_matmul(Xt, est.centers, st3.alpha, spec=est.kernel.spec)
    ra, rp, rb = rel(st2.alpha, state.alpha), rel(pred2, pred), rel(st2.beta, state.beta)
    ya, yp, yb = rel(st3.alpha, state.alpha), rel(pred3, pred), rel(st3.beta, state.beta)
    say(f"[msd] residuals of the j_sharded solve: "
        + " ".join(f"{float(r):.4e}" for r in st2.residual_norms.cpu()))
    say(f"[msd] plain float32 torch-backend solve on the same preconditioner: "
        f"{solve3_s:.4f} s")
    say(f"[msd] distance from the planner-route (B1) solve, j_sharded (B4) vs plain "
        f"float32: alpha {ra:.3e} vs {ya:.3e}, beta {rb:.3e} vs {yb:.3e}, predictions "
        f"{rp:.3e} vs {yp:.3e} (bound {AGREE_FACTOR:g}x the plain solve's)")
    check(ra <= AGREE_FACTOR * ya and rp <= AGREE_FACTOR * yp,
          "the j_sharded solve stands farther from the planner-route solve than "
          f"{AGREE_FACTOR:g}x a plain float32 solve does")

    for ns, ds, ms in SMALL_BLOCKED:
        small_blocked_fit(torch, args.seed, ns, ds, ms)
    return dict(X=X, centers=est.centers, spec=est.kernel.spec, counts=counts,
                jcounts=jcounts, shard_m=jplan.shard_m, plan=plan, fit_s=fit_s,
                factor_s=times["factor"], T=state.precond.T, A=state.precond.A,
                lam=task.lam)


def small_blocked_fit(torch, seed: int, n: int, d: int, M: int) -> None:
    """A fit forced onto the blocked factor (``REPRO_FACTOR_BUDGET_MB``)
    against the in-core fit on the card, gaussian sigma = 1, jitter and lam
    1e-3. Alpha of such an fp32 problem moves at the 1e-4 scale with the
    rounding of either route, so alpha is held against a float64 fit: the
    blocked fit no farther from it than 2x the in-core fit; predictions
    within BLOCKED_FIT_TOL of the in-core fit's."""
    from repro_torch.core import FalkonConfig, falkon_fit
    from repro_torch.ops import FactorPlanWarning
    g = np.random.default_rng(seed + 7)
    Xs = torch.tensor(g.standard_normal((n, d)), dtype=torch.float32, device=DEVICE)
    ys = Xs @ torch.tensor(g.standard_normal(d), dtype=torch.float32, device=DEVICE)
    ys = ys + 0.05 * torch.tensor(g.standard_normal(n), dtype=torch.float32, device=DEVICE)
    scfg = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", 1.0),), lam=1e-3,
                        jitter=1e-3, num_centers=M, iterations=30, device=DEVICE)
    est_in, _ = falkon_fit(seed, Xs, ys, scfg)
    os.environ["REPRO_FACTOR_BUDGET_MB"] = "0.2"
    try:
        stimes: dict = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FactorPlanWarning)
            est_bl, _ = falkon_fit(seed, Xs, ys, scfg, stage_times=stimes)
    finally:
        os.environ.pop("REPRO_FACTOR_BUDGET_MB")
    est_64, _ = falkon_fit(seed, Xs.double(), ys.double(),
                           dataclasses.replace(scfg, dtype="float64", ops_impl="torch"))
    rb, ri = rel(est_bl.alpha, est_64.alpha), rel(est_in.alpha, est_64.alpha)
    ra = rel(est_bl.alpha, est_in.alpha)
    rp = rel(est_bl.predict(Xs[:100]), est_in.predict(Xs[:100]))
    panels = -(-M // stimes["factor_block"])
    say(f"[msd] small forced-blocked fit (n={n} d={d} M={M}, {stimes['factor_path']} block "
        f"{stimes['factor_block']}, {panels} panels) vs in-core: alpha rel {ra:.3e}, "
        f"predictions rel {rp:.3e} (bound {BLOCKED_FIT_TOL:g}); alpha from a float64 fit: "
        f"blocked {rb:.3e}, in-core {ri:.3e} (bound 2x the in-core)")
    check(stimes["factor_path"] == "blocked", f"small fit M={M} did not route blocked")
    check(rp <= BLOCKED_FIT_TOL and rb <= 2 * ri, f"forced-blocked fit M={M} disagrees")


def time_cuda(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_times(torch, main, msd) -> list[dict]:
    from repro_torch.kernels import kernel_matvec as km
    X, Xt, Cc, alpha, spec = main["X"], main["Xt"], main["centers"], main["alpha"], main["spec"]
    n, d = X.shape
    M = Cc.shape[0]
    m = Xt.shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(7)
    u = torch.randn(M, generator=g, device=DEVICE)
    rows = []

    # B1 at the CG sweep's shape: full X, width 1, v=None
    ws, w_ref = sweep_witness(torch, km, spec, X, Cc, u, f"n={n} M={M} (a CG sweep)")
    abs_err, ratio = close_err(ws["B1"], w_ref)
    say(f"[times] full-size sweep vs plain twin: max abs err {abs_err:.3e}, ratio {ratio:.4f}")
    check(ratio <= 1.0, f"full-size sweep disagrees with its twin (ratio {ratio})")
    ms = time_cuda(torch, lambda: km.fused_sweep(X, Cc, u, spec=spec), 5)
    plain = time_cuda(torch, lambda: km.fused_sweep_plain(X, Cc, u[:, None], None, spec=spec), 2)
    b, by = bound(n * M * (2 * d + 10 + 4), 4 * (n * d + M * d + 2 * M))
    rows.append(dict(name="fused_sweep", ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     max_abs_err=abs_err, shape=f"n={n} M={M} d={d} p=1"))

    # B2 at predict's shape. Predictions are O(1) sums of M = 1e4 terms
    # K * alpha with |alpha| far larger (lam = 1e-6): fp32 rounding scales
    # with S = max_i sum_j |K_ij alpha_j| (K >= 0 for the gaussian), not with
    # |prediction|. The kernel is held to PRED_RTOL * S against its float32
    # twin and a float64 twin; that limit must stay under 5% of the largest
    # prediction, so a kernel off by a typical prediction fails.
    out = km.kernel_matmul(Xt, Cc, alpha, spec=spec).double()
    S = float(km.kernel_matmul_plain(Xt, Cc, alpha.abs()[:, None], spec=spec).max())
    ref32 = km.kernel_matmul_plain(Xt, Cc, alpha[:, None], spec=spec)[:, 0].double()
    ref64 = km.kernel_matmul_plain(Xt.double(), Cc.double(), alpha.double()[:, None],
                                   spec=spec)[:, 0]
    limit = PRED_RTOL * S
    top = float(ref64.abs().max())
    abs_err = float((out - ref32).abs().max())
    err64 = float((out - ref64).abs().max())
    twin64 = float((ref32 - ref64).abs().max())
    say(f"[times] predict-shape kernel matmul: max abs err {abs_err:.3e} vs float32 twin, "
        f"{err64:.3e} vs float64 twin (float32 twin vs float64: {twin64:.3e}); limit "
        f"{PRED_RTOL:g} x max sum|terms| {S:.3e} = {limit:.3e}; largest |prediction| {top:.4f}")
    check(limit <= 0.05 * top, f"predict limit {limit:.3e} is not under 5% of the "
          f"largest prediction {top:.4f}")
    check(abs_err <= limit and err64 <= limit,
          f"predict-shape kernel matmul off its twins ({abs_err:.3e}, {err64:.3e} > {limit:.3e})")
    ms = time_cuda(torch, lambda: km.kernel_matmul(Xt, Cc, alpha, spec=spec), 10)
    plain = time_cuda(torch, lambda: km.kernel_matmul_plain(Xt, Cc, alpha[:, None], spec=spec), 3)
    b, by = bound(m * M * (2 * d + 10 + 2), 4 * (m * d + M * d + M + m))
    rows.append(dict(name="kernel_matmul", ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     max_abs_err=abs_err, shape=f"m={m} n={M} d={d} p=1"))

    # B3 at K_MM's shape
    K = km.pairwise_kernel(Cc, Cc, spec=spec)
    abs_err, ratio = close_err(K, km.pairwise_kernel_plain(Cc, Cc, spec=spec))
    check(ratio <= 1.0, f"K_MM disagrees with its twin (ratio {ratio})")
    del K
    ms = time_cuda(torch, lambda: km.pairwise_kernel(Cc, Cc, spec=spec), 10)
    plain = time_cuda(torch, lambda: km.pairwise_kernel_plain(Cc, Cc, spec=spec), 3)
    b, by = bound(M * M * (2 * d + 10), 4 * (2 * M * d + M * M))
    rows.append(dict(name="pairwise_kernel", ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     max_abs_err=abs_err, shape=f"m={M} n={M} d={d}"))

    rows += msd_times(torch, msd)
    counts = {**main["counts"], **{k: msd["counts"][k] for k in
                                   ("potrf_tile", "trsm_panel", "trailing_update")},
              "sharded_sweep": msd["jcounts"]["sharded_sweep"]}
    kernels = []
    for r in rows:
        lib = r.get("library_ms")
        say(f"[times] {r['name']:15s} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches per fit {counts[r['name']]}, library "
            + ("none" if lib is None else f"{lib:.4f} ms ({r['library']})"))
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[r["name"]], "launches": counts[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": lib,
        })
    return kernels


def msd_times(torch, msd) -> list[dict]:
    """B1 and B4 at the MillionSongs sweep shape (against float32 and float64
    twins), and B5-B7 at the blocked factor's largest shapes (b = 1280, the
    first panel's 48720 rows), each beside its plain twin and its library
    call."""
    from repro_torch.kernels import blocked_cholesky as bc
    from repro_torch.kernels import kernel_matvec as km
    X, C, spec, shard = msd["X"], msd["centers"], msd["spec"], msd["shard_m"]
    n, d = X.shape
    M = C.shape[0]
    u = torch.randn(M, generator=torch.Generator(device=DEVICE).manual_seed(8), device=DEVICE)
    rows = []
    fused = lambda: km.fused_sweep(X, C, u, spec=spec)
    sharded = lambda: km.sharded_sweep(X, C, u, spec=spec, shard_m=shard)
    ws, w32 = sweep_witness(torch, km, spec, X, C, u, f"n={n} M={M} d={d} (MillionSongs)",
                            kernels={"B1": fused, f"B4 shard_m={shard}": sharded})
    w1, w4 = ws["B1"], ws[f"B4 shard_m={shard}"]
    e1, r1 = close_err(w1, w32)
    e4, r4 = close_err(w4, w32)
    say(f"[times] MillionSongs sweeps vs float32 twin: B1 {e1:.3e} (ratio {r1:.4f}), "
        f"B4 {e4:.3e} (ratio {r4:.4f}); B4 vs B1 {close_err(w4, w1)[0]:.3e}")
    check(max(r1, r4) <= 1.0, "MillionSongs sweep off its twin")
    b, by = bound(n * M * (2 * d + 10 + 4), 4 * (n * d + M * d + 2 * M))
    ms1 = time_cuda(torch, fused, 3)
    ms4 = time_cuda(torch, sharded, 3)
    plain4 = time_cuda(torch, lambda: km.sharded_sweep_plain(X, C, u[:, None], spec=spec,
                                                             shard_m=shard), 1)
    say(f"[times] MillionSongs sweep n={n} M={M} d={d}: B1 {ms1:.4f} ms, B4 "
        f"({-(-M // shard)} shards of {shard}) {ms4:.4f} ms, bound {b:.4f} ms ({by})")
    rows.append(dict(name="sharded_sweep", ms=ms4, plain_ms=plain4, bound_ms=b, bound_by=by,
                     max_abs_err=e4, shape=f"n={n} M={M} d={d} p=1 shard_m={shard}"))

    factor_witness(torch, msd)

    g = np.random.default_rng(9)
    blk = msd["plan"].block
    r = M - blk

    def randn(*shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.float32, device=DEVICE)

    A = randn(blk, blk)
    A = A @ A.T / blk + torch.eye(blk, device=DEVICE)
    L = bc.potrf_tile(A)
    e5 = float((L - bc.potrf_plain(A)).abs().max())
    b5, by5 = bound(blk ** 3 / 3, 4 * 2 * blk * blk)
    rows.append(dict(name="potrf_tile", ms=time_cuda(torch, lambda: bc.potrf_tile(A), 10),
                     plain_ms=time_cuda(torch, lambda: bc.potrf_plain(A), 2),
                     library_ms=time_cuda(torch, lambda: torch.linalg.cholesky(A), 10),
                     library="torch.linalg.cholesky", bound_ms=b5, bound_by=by5,
                     max_abs_err=e5, shape=f"b={blk}"))
    # B6 and B7 at the first panel's shapes, held like the tiles in phase 4
    P = randn(r, blk)
    X6, X6p = bc.trsm_panel(L, P), bc.trsm_plain(L, P)
    e6, n6 = float((X6 - X6p).abs().max()), rel(X6, X6p)
    del X6, X6p
    b6, by6 = bound(r * blk * blk, 4 * (blk * blk + 2 * r * blk))
    rows.append(dict(name="trsm_panel", ms=time_cuda(torch, lambda: bc.trsm_panel(L, P), 5),
                     plain_ms=time_cuda(torch, lambda: bc.trsm_plain(L, P), 1),
                     library_ms=time_cuda(torch, lambda: torch.linalg.solve_triangular(
                         L.mT, P, upper=True, left=False), 5),
                     library="torch.linalg.solve_triangular", bound_ms=b6, bound_by=by6,
                     max_abs_err=e6, shape=f"r={r} b={blk}"))
    Cu, Pu, Qu = randn(r, blk), randn(r, blk), randn(blk, blk)
    O7, O7p = bc.trailing_update(Cu, Pu, Qu), bc.update_plain(Cu, Pu, Qu)
    e7, n7 = float((O7 - O7p).abs().max()), rel(O7, O7p)
    del O7, O7p
    say(f"[times] B6 r={r} b={blk} vs twin {n6:.3e}, B7 r={r} b=k={blk} vs twin {n7:.3e} "
        f"(normwise, bound {FACTOR_TOL:g})")
    check(n6 <= FACTOR_TOL and n7 <= FACTOR_TOL, f"B6/B7 off their twins at r={r} b={blk}")
    b7, by7 = bound(2 * r * blk * blk, 4 * (2 * r * blk + r * blk + blk * blk))
    rows.append(dict(name="trailing_update",
                     ms=time_cuda(torch, lambda: bc.trailing_update(Cu, Pu, Qu), 5),
                     plain_ms=time_cuda(torch, lambda: bc.update_plain(Cu, Pu, Qu), 5),
                     library_ms=time_cuda(torch, lambda: torch.addmm(Cu, Pu, Qu.mT, alpha=-1), 5),
                     library="torch.addmm", bound_ms=b7, bound_by=by7, max_abs_err=e7,
                     shape=f"r={r} b={blk} k={blk}"))
    return rows


def rel_rows(a, b, rows: int = 2048) -> float:
    """``rel`` of two large matrices, in float64 row chunks."""
    num = den = 0.0
    for i in range(0, b.shape[0], rows):
        bi = b[i:i + rows].double()
        num += float((a[i:i + rows].double() - bi).norm() ** 2)
        den += float(bi.norm() ** 2)
    return (num / max(den, 1e-300)) ** 0.5


def factor_witness(torch, msd) -> None:
    """The MillionSongs fit's blocked factors against in-core factors of the
    same matrices. T: the jittered K_MM (D = I for uniform centers) factored
    by ``torch.linalg.cholesky_ex`` in float32 (timed: the route the factor
    budget keeps this fit off) and in float64. A: T T^T / M + lam I, from
    the fit's own T, likewise. Each blocked factor may stand at most
    FACTOR_AGREE x as far from the float64 factor as the float32 library
    factor does. Device memory peaks near 70 GB (T and A stay on the card)."""
    from repro_torch.kernels import kernel_matvec as km
    C, spec, T, A = msd["centers"], msd["spec"], msd.pop("T"), msd.pop("A")
    M = C.shape[0]
    K = km.pairwise_kernel(C, C, spec=spec)
    K.diagonal().add_(float(torch.finfo(torch.float32).eps) * M)
    held = {}

    def chol32():
        held["L"], held["info"] = torch.linalg.cholesky_ex(K)

    chol_ms = time_cuda(torch, chol32, 1)
    L32 = held.pop("L")
    check(int(held.pop("info")) == 0, "in-core float32 cholesky of K_MM failed")
    K64 = K.double()
    del K
    L64, info = torch.linalg.cholesky_ex(K64)
    del K64
    check(int(info) == 0, "float64 cholesky of K_MM failed")
    tb, tl, td = rel_rows(T, L64.mT), rel_rows(L32.mT, L64.mT), rel_rows(T, L32.mT)
    del L32, L64
    say(f"[times] in-core torch.linalg.cholesky of the jittered K_MM (M={M}): {chol_ms:.4f} ms; "
        f"the blocked factor stage took {msd['factor_s']:.4f} s for two factorizations "
        "and T T^T")
    # A from the fit's T: float64 first, then float32 through cuBLAS and
    # cuSOLVER (TF32 off); one (M, M) float64 and two float32 matrices at most
    lam = msd["lam"]
    T64 = T.double()
    S = T64 @ T64.mT
    del T64
    S /= M
    S.diagonal().add_(lam)
    A64, info = torch.linalg.cholesky_ex(S)
    del S
    check(int(info) == 0, "float64 cholesky of T T^T / M + lam I failed")
    S32 = T @ T.mT
    S32 /= M
    S32.diagonal().add_(lam)
    A32, info = torch.linalg.cholesky_ex(S32)
    del S32
    check(int(info) == 0, "float32 cholesky of T T^T / M + lam I failed")
    ab, al, ad = rel_rows(A, A64.mT), rel_rows(A32.mT, A64.mT), rel_rows(A, A32.mT)
    del A32, A64
    say(f"[times] MillionSongs factors, normwise distance from float64 factors of the same "
        f"matrices: T blocked {tb:.3e}, cuSOLVER float32 {tl:.3e} (blocked vs cuSOLVER "
        f"{td:.3e}); A blocked {ab:.3e}, cuSOLVER float32 {al:.3e} (blocked vs cuSOLVER "
        f"{ad:.3e}); bound {FACTOR_AGREE:g}x the cuSOLVER factor's")
    check(tb <= FACTOR_AGREE * tl and ab <= FACTOR_AGREE * al,
          "a blocked MillionSongs factor stands farther from float64 than "
          f"{FACTOR_AGREE:g}x the in-core float32 factor")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4_000_000, help="training rows (SUSY: 4e6)")
    ap.add_argument("--n-test", type=int, default=500_000, help="rows to predict")
    ap.add_argument("--checks-only", action="store_true",
                    help="build and run the kernel checks only; prints no result line")
    args = ap.parse_args(argv)
    try:
        import torch
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    card = phase_device(torch)
    build_s = phase_build()
    phase_kernels(torch)
    phase_blocked(torch)
    if args.checks_only:
        say(f"[done] checks only, {time.perf_counter() - t_start:.1f} s")
        return 0
    main_res = phase_main(torch, args)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the SUSY phase")
    msd_res = phase_msd(torch, args)
    say(f"[time] {time.perf_counter() - t_start:.1f} s after the MillionSongs phase")
    kernels = phase_times(torch, main_res, msd_res)
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all, {build_s:.1f} s of it the build")
    say(f"card: {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
