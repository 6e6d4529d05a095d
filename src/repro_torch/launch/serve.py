"""Serving launcher: a batched LM prefill + decode loop, or a FALKON predictor.

Counterpart of ``repro/launch/serve.py``. LM mode (the default):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 4 --gen 32

builds the architecture's model with random weights (seed 0) on the card
(``--device cpu`` for the CPU), prefills a random prompt of
``--prompt-len`` tokens and decodes ``--gen`` tokens greedily, one eager
step a token, then prints the prefill time and the decode time per token.
As in the reference, ``--reduced`` is on by default and cannot be turned
off from the command line: the CLI runs the reduced config, and a full-size
run calls ``serve_lm`` with ``reduced=False``.

FALKON mode:

    PYTHONPATH=src python -m repro_torch.launch.serve --falkon \
        --batch 256 --requests 200

fits a kernel estimator on synthetic rows and serves a pre-generated trace
through the batch-coalescing server (``repro_torch.serve``): requests are
packed into a power-of-two bucket ladder, one CUDA graph captured per rung
at warmup, so steady-state serving captures nothing and one replay serves
many requests. ``--per-request`` serves the trace one ``predict`` a request
instead (the single-stream baseline); ``--stream-chunk N`` fits from host
chunks of N rows (``falkon_fit_streaming``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args) -> dict:
    """Prefill ``args.batch`` random prompts of ``args.prompt_len`` tokens,
    then decode ``args.gen`` tokens greedily (the first step untimed, as the
    reference's compile step). The weights come from seed ``args.seed``
    (default 0, the reference's), the prompts from the next seed. Prints the
    reference's two lines and returns the seconds (``prefill_s``,
    ``decode_s`` a token), the sampled tokens, the model and its config."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import resolve_device
    from repro_torch.models import decode_step, model_params, prefill

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.frontend == "embeds":
        cfg = dataclasses.replace(cfg, frontend="tokens")
    device = resolve_device(getattr(args, "device", "cuda"))
    seed = getattr(args, "seed", 0)
    model = model_params(torch.Generator(device=device).manual_seed(seed), cfg)

    B, P, G = args.batch, args.prompt_len, args.gen
    g = torch.Generator(device=device).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=g, device=device,
                                     dtype=torch.int32)}
    if cfg.frontend == "tokens+vision":
        batch["vision_embeds"] = torch.randn(B, cfg.n_image_tokens, cfg.d_vision,
                                             generator=g, device=device) * .05

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, batch, S_max=P + G)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, -1)
    out = [tok]
    logits, cache = decode_step(model, cfg, cache, {"token": tok})   # untimed first step
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(G - 2):
        tok = torch.argmax(logits, -1)
        out.append(tok)
        logits, cache = decode_step(model, cfg, cache, {"token": tok})
    _sync(device)
    t_decode = (time.perf_counter() - t0) / max(G - 2, 1)
    sample = torch.stack(out, 1)
    print(f"{cfg.name}: prefill {B}x{P} in {t_prefill*1e3:.0f}ms; "
          f"decode {t_decode*1e3:.1f}ms/token/batch")
    print("sample:", sample[0, :12].tolist())
    return {"prefill_s": t_prefill, "decode_s": t_decode, "tokens": sample, "model": model,
            "cfg": cfg}


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
                    help="serve a FALKON predictor instead of an LM")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    # FALKON-mode knobs
    ap.add_argument("--ops-impl", default="cuda", choices=("cuda", "torch"),
                    help="KernelOps backend for fit and serving")
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"))
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--centers", type=int, default=256)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--per-request", action="store_true",
                    help="serve the trace one request per predict (the single-stream "
                         "baseline) instead of coalescing")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="fit from host chunks of this many rows (0 = in-core fit)")
    args, rest = ap.parse_known_args(argv)
    if args.falkon:                       # the LM options are not read here
        if rest:
            ap.error(f"unrecognized arguments: {' '.join(rest)}")
        serve_falkon(args)
        return
    lm = argparse.ArgumentParser(description="LM mode options")
    lm.add_argument("--arch", default="gemma3-1b")
    lm.add_argument("--reduced", action="store_true", default=True)
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--gen", type=int, default=32)
    lm.parse_args(rest, namespace=args)
    from repro_torch.configs import ARCH_IDS
    if args.arch not in ARCH_IDS:
        raise SystemExit(f"unknown arch {args.arch}; have {ARCH_IDS}")
    serve_lm(args)


if __name__ == "__main__":
    main()
