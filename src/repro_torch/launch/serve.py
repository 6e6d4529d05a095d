"""Serving launcher: fit a FALKON predictor, then serve a ragged request trace.

Counterpart of the FALKON mode of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --falkon \
        --batch 256 --requests 200

fits a kernel estimator on synthetic rows (on the card unless ``--device
cpu``) and serves a pre-generated trace through the batch-coalescing server
(``repro_torch.serve``): requests are packed into a power-of-two bucket
ladder, one CUDA graph captured per rung at warmup, so steady-state serving
captures nothing and one replay serves many requests. ``--per-request``
serves the trace one ``predict`` a request instead (the single-stream
baseline); ``--stream-chunk N`` fits from host chunks of N rows
(``falkon_fit_streaming``). The LM mode of the reference is not ported yet
(ROADMAP.md item A15).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serve_lm() -> None:
    raise NotImplementedError("the LM serving mode is not ported yet: ROADMAP.md item A15 "
                              "(pass --falkon to serve a FALKON predictor)")


def make_request_trace(n_requests: int, max_batch: int, d: int, seed: int = 0) -> list:
    """Pre-generated ragged request batches (host float32 arrays of 1 to
    ``max_batch`` rows), made before any serving timer starts. The sizes are
    the reference's draw from the same seed; the rows come from the same
    numpy generator (the reference draws them with ``jax.random``)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_batch + 1, size=n_requests)
    return [rng.standard_normal((int(s), d), dtype=np.float32) for s in sizes]


def serve_per_request(est, trace: list) -> list[float]:
    """The single-stream baseline: one ``predict`` a request, each read back
    to the host before the next starts. Returns each request's seconds
    (after one untimed predict at the first request's shape)."""
    dev = est.centers.device
    est.predict(torch.from_numpy(trace[0]).to(dev)).cpu()
    secs = []
    for xb in trace:
        t0 = time.perf_counter()
        est.predict(torch.from_numpy(xb).to(dev)).cpu()
        secs.append(time.perf_counter() - t0)
    return secs


def serve_falkon(args) -> None:
    """Fit once, then serve a ragged request trace: coalesced by default,
    the per-request loop behind ``--per-request``."""
    from repro_torch.core import FalkonConfig, falkon_fit, falkon_fit_streaming, resolve_device
    from repro_torch.data import ArrayChunkSource

    device = resolve_device(args.device)
    g = torch.Generator(device=device).manual_seed(0)
    n, d = args.n, args.d
    X = torch.randn(n, d, generator=g, device=device)
    w = torch.randn(d, generator=g, device=device)
    y = torch.sin(X @ w) + 0.05 * torch.randn(n, generator=g, device=device)

    cfg = FalkonConfig(kernel="gaussian", kernel_params=(("sigma", 2.0),), lam=1e-5,
                       num_centers=args.centers, iterations=15,
                       block_size=max(args.batch, 128), ops_impl=args.ops_impl,
                       precision=args.precision, device=args.device)
    plan = cfg.make_ops().plan(n, min(args.centers, n), d)
    print(f"sweep plan: {plan.path} ({plan.reason})")
    t0 = time.perf_counter()
    if args.stream_chunk > 0:
        src = ArrayChunkSource(X.cpu().numpy(), y.cpu().numpy(), chunk_rows=args.stream_chunk)
        est, state = falkon_fit_streaming(1, src, cfg)
    else:
        est, state = falkon_fit(1, X, y, cfg)
    est.alpha.cpu()
    t_fit = time.perf_counter() - t0
    # a streamed solve runs no cond(W) power iteration
    cond = "n/a" if args.stream_chunk > 0 else f"{float(state.cond_estimate):.1f}"
    print(f"falkon[{cfg.ops_impl}/{cfg.precision}]: fit n={n} M={est.centers.shape[0]} "
          f"in {t_fit:.2f}s; cond(W)={cond}")

    trace = make_request_trace(args.requests, args.batch, d)
    rows = sum(b.shape[0] for b in trace)
    if args.per_request:
        dt = sum(serve_per_request(est, trace))
        print(f"per-request: {len(trace)} requests ({rows} rows) in {dt:.3f}s — "
              f"{rows / dt:.0f} rows/s, {dt / len(trace) * 1e3:.2f} ms/request")
        return
    from repro_torch.serve import CoalescingPredictServer

    server = CoalescingPredictServer(est, max_batch=args.batch)
    warm_s = server.warmup()
    what = "graph captures" if device.type == "cuda" else "rungs warmed"
    print(f"coalescing server: ladder {server.ladder}, warmup {sum(warm_s.values()):.2f}s "
          f"({server.trace_count} {what})")
    t0 = time.perf_counter()
    server.predict_many(trace)
    dt = time.perf_counter() - t0
    s = server.stats
    print(f"coalesced: {len(trace)} requests ({rows} rows) in {dt:.3f}s — {rows / dt:.0f} "
          f"rows/s, {s.dispatches} dispatches, pad fraction {s.pad_fraction:.1%}, "
          f"retraces after warmup: {server.retraces_since_warmup()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--falkon", action="store_true",
                    help="serve a FALKON predictor (the LM mode is not ported: A15)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ops-impl", default="cuda", choices=("cuda", "torch"),
                    help="KernelOps backend for fit and serving")
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--centers", type=int, default=256)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--per-request", action="store_true",
                    help="serve the trace one request per predict (the single-stream "
                         "baseline) instead of coalescing")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="fit from host chunks of this many rows (0 = in-core fit)")
    # the reference's LM options (--arch, --prompt-len, --gen) reach the
    # refusal below instead of an argparse error
    args, unknown = ap.parse_known_args(argv)
    if not args.falkon:
        serve_lm()
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    serve_falkon(args)


if __name__ == "__main__":
    main()
