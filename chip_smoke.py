"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, fit.

    python3 chip_smoke.py [--seed 0] [--n 4000000] [--n-test 500000]

Phases, each printed as it runs; any failure exits non-zero before the
result line:

1. device   — needs a CUDA card; prints its name and power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels  — every kernel (sweep B1, kernel matmul B2, pairwise Gram B3)
               against its plain PyTorch twin on the card, for all five
               kernel kinds, ragged shapes, p = 1 to 4, ``v=None``,
               ``row_mask`` (masked rows must give exactly the prefix
               result) and ``add=``; the sweep also at M = 5000 (p = 3)
               and M = 20500 (p = 1), where its w partials live in
               global memory.
4. main     — the port's in-core fit (``falkon_fit``, ops_impl="cuda") on
               synthetic SUSY-shape data (d = 18, gaussian sigma = 4,
               lam = 1e-6, M = 10^4 centers, t = 20) with n training rows,
               then ``predict`` on n-test rows; the kernel launch counts of
               that run (sweep 47, pairwise 1, kernel matmul >= 1); a
               small fit against the plain "torch" backend (and, at
               lam = 1e-6 over 4 center draws, against float64 fits); a
               sweep at that shape against float32 and float64 twins.
5. times    — the full-size sweep and the predict-shape kernel matmul
               against their float32 and float64 twins; each kernel at the
               main path's shapes (CUDA events) beside its plain twin and
               its bound, then one ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
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
#: limit of a float32 result's error per unit of the sum of the magnitudes
#: of its terms (predict: max_i sum_j |K_ij alpha_j|; sweep: K^T K |u|):
#: about two fp32 unit roundoffs (2^-24 = 6.0e-8)
PRED_RTOL = 1e-7
#: center draws of the small lam = 1e-6 fits held against float64 fits
SMALL_SEEDS = 4
SOURCE = "src/repro_torch/kernels/csrc/kernel_matvec.cu"
DEVICE = "cuda"
REPLACES = {
    "fused_sweep": "src/repro/kernels/kernel_matvec.py:361",
    "kernel_matmul": "src/repro/kernels/kernel_matvec.py:174",
    "pairwise_kernel": "src/repro/kernels/kernel_matvec.py:559",
}


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
    lib_path = build.build()
    km._lib()
    say(f"[build] {lib_path.name} in {time.perf_counter() - t0:.3f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[build] {line.strip()}")


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
    say(f"[kernels] {cases} checks pass; worst max|diff|/(1e-4 + 1e-4 max|ref|) = {worst:.4f} (bound 1)")


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
    say(f"[main] stage seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; fit total {fit_s:.4f}")
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


def sweep_witness(torch, km, spec, X, C, u, tag: str):
    """The gaussian sweep kernel against a float64 twin, entry by entry.

    fp32 rounding in w = K^T (K u) scales with S = K^T K |u| (K >= 0), which
    bounds the magnitudes of the terms of both sums: w cancels to far below
    S, and a per-center rounding (of ||c_j||^2, say) moves every term of
    that center together. Each |w_j - w64_j| is held to PRED_RTOL * S_j.
    Returns (kernel result, float32 twin result)."""
    check(spec.kind == "gaussian", f"sweep witness needs K >= 0, not {spec.kind}")
    w = km.fused_sweep(X, C, u, spec=spec)
    w32 = km.fused_sweep_plain(X, C, u[:, None], None, spec=spec)[0][:, 0]
    w64 = km.fused_sweep_plain(X.double(), C.double(), u.double()[:, None], None,
                               spec=spec)[0][:, 0]
    S = km.fused_sweep_plain(X, C, u.abs()[:, None], None, spec=spec)[0][:, 0].double()
    limit = PRED_RTOL * S + 1e-12
    rk = float(((w.double() - w64).abs() / limit).max())
    rt = float(((w32.double() - w64).abs() / limit).max())
    say(f"[sweep] {tag}: max|w| {float(w64.abs().max()):.4e}, max S {float(S.max()):.4e}; "
        f"max |w - w64| / ({PRED_RTOL:g} S): kernel {rk:.4f}, float32 twin {rt:.4f} "
        f"(bound 1); max abs err kernel {float((w.double() - w64).abs().max()):.4e}, "
        f"twin {float((w32.double() - w64).abs().max()):.4e}")
    check(rk <= 1.0, f"sweep {tag}: kernel off a float64 twin by {rk:.3f} x its limit")
    return w, w32


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


def phase_times(torch, main) -> list[dict]:
    from repro_torch.kernels import kernel_matvec as km
    X, Xt, Cc, alpha, spec = main["X"], main["Xt"], main["centers"], main["alpha"], main["spec"]
    n, d = X.shape
    M = Cc.shape[0]
    m = Xt.shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(7)
    u = torch.randn(M, generator=g, device=DEVICE)
    rows = []

    # B1 at the CG sweep's shape: full X, width 1, v=None
    w, w_ref = sweep_witness(torch, km, spec, X, Cc, u, f"n={n} M={M} (a CG sweep)")
    abs_err, ratio = close_err(w, w_ref)
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

    kernels = []
    for r in rows:
        say(f"[times] {r['name']:15s} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches per fit {main['counts'][r['name']]}, library none")
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[r["name"]], "launches": main["counts"][r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=4_000_000, help="training rows (SUSY: 4e6)")
    ap.add_argument("--n-test", type=int, default=500_000, help="rows to predict")
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
    phase_build()
    phase_kernels(torch)
    main_res = phase_main(torch, args)
    kernels = phase_times(torch, main_res)
    say(f"[done] {time.perf_counter() - t_start:.1f} s in all")
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
