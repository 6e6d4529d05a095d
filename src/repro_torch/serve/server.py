"""Batch-coalescing predict server over ``KernelOps.apply``.

Counterpart of ``repro/serve/server.py``. A fitted FALKON model is O(M)
state (centers and coefficients) and a prediction one (batch, M) kernel
matmul (on the card one B2 launch per column group), so one device serves
heavy traffic if the serving layer does not throw that away:

* **Coalescing** — pending requests are packed row-wise into dispatches of
  up to ``max_batch`` rows (``repro_torch.serve.coalesce.plan_dispatches``),
  so one device call serves many requests.
* **One CUDA graph per bucket rung** — each dispatch is padded to a
  power-of-two bucket shape. On the card ``warmup()`` captures one
  ``torch.cuda.CUDAGraph`` per rung over ``ops.apply(static_x,
  static_centers, static_alpha)`` (after one eager run on a side stream,
  which also builds the kernels and fills the launch caches the capture
  must not query), and a dispatch is a copy into the rung's static input,
  a replay and a copy of the static output, all on the stream: a replay
  runs no Python, so launch counters do not move and the host pays one
  graph launch a dispatch. ``trace_count`` counts captures and must not
  move after warmup. On the CPU there are no graphs: the apply runs
  eagerly and ``trace_count`` counts the rungs warmed. Pad rows are zeros;
  ``apply`` is row-local, so they are dropped on scatter-back.
* **Hot swap** — the centers and coefficients are the server's own static
  buffers; ``swap_model`` copies a refreshed model of the same geometry
  into them (what ``FalkonEstimator.partial_fit`` returns), so the graphs
  serve it with no capture.
* **Multi-model tier** — a :class:`FalkonPathResult` (L estimators sharing
  centers) is served through one stacked apply per bucket: the (L, M[, p])
  coefficients as (M, L*p) columns.
* **Pipelined dispatch** — at most ``pipeline_depth`` dispatches are in
  flight: packing dispatch k+1 on the host overlaps the device's work on
  dispatch k; each replay's output is copied out on the stream before the
  rung's next replay can overwrite it.

The server is synchronous and single-threaded: ``submit`` queues,
``flush`` coalesces, runs and scatters.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import trace

from .coalesce import Dispatch, bucket_ladder, plan_dispatches

Tensor = torch.Tensor


#: dispatches whose latency ``ServeStats.dispatch_seconds`` keeps
LATENCY_WINDOW = 100_000


@dataclasses.dataclass
class ServeStats:
    """Counters read off the server. ``rung_dispatches`` counts dispatches
    by bucket rung (on the card, each one replay of that rung's graph).
    ``dispatch_seconds`` holds the host time of the last LATENCY_WINDOW
    dispatches, each from the start of its packing to the end of its
    scatter-back, which is also the span ``serve.dispatch`` while tracing
    is on (``repro_torch.trace``)."""

    dispatches: int = 0
    rung_dispatches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    rows_valid: int = 0
    rows_padded: int = 0
    requests: int = 0
    dispatch_seconds: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW))

    @property
    def pad_fraction(self) -> float:
        total = self.rows_valid + self.rows_padded
        return self.rows_padded / total if total else 0.0


@dataclasses.dataclass
class _Rung:
    """One bucket shape: its static input and, on the card, its graph and
    the static output each replay writes."""

    x: Tensor
    graph: torch.cuda.CUDAGraph | None = None
    out: Tensor | None = None


class CoalescingPredictServer:
    """Serve a ``FalkonEstimator`` or ``FalkonPathResult``.

    ``ops`` defaults to the estimator's own backend (``est.ops``, the object
    ``predict`` uses, so bucketed and direct predictions run the same kernel
    code). ``max_batch`` bounds the rows of a dispatch; the bucket ladder
    spans ``min_bucket .. max_batch`` in powers of two.
    """

    def __init__(self, model, *, max_batch: int = 256, min_bucket: int = 8, ops=None,
                 pipeline_depth: int = 2):
        est, alpha, unstack = _resolve_model(model)
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self._ladder = bucket_ladder(max_batch, min_bucket)
        self._deployed = est.centers         # the scoring cache's identity check
        self._centers = est.centers.clone()  # static graph inputs; swap_model copies in
        self._alpha = alpha.clone()          # (M,), (M, p) or stacked (M, L*p)
        self._unstack = unstack              # (L, p) to reshape path outputs, or None
        self._ops = est.ops if ops is None else ops
        self._dim = int(est.centers.shape[1])
        self._device = est.centers.device
        self._np_dtype = torch.empty((), dtype=est.centers.dtype).numpy().dtype
        self._graphs = self._device.type == "cuda"
        self._depth = pipeline_depth
        self._traces = 0
        self._warm_traces: int | None = None
        self._rungs: dict[int, _Rung] = {}
        self.stats = ServeStats()
        self._pending: list[np.ndarray] = []
        self._scoring_cache = None

    # -- introspection -----------------------------------------------------
    @property
    def ladder(self) -> tuple[int, ...]:
        return self._ladder

    @property
    def max_batch(self) -> int:
        return self._ladder[-1]

    @property
    def trace_count(self) -> int:
        """Graphs captured so far (one per rung); on the CPU, rungs warmed."""
        return self._traces

    def retraces_since_warmup(self) -> int:
        if self._warm_traces is None:
            raise RuntimeError("warmup() has not run")
        return self._traces - self._warm_traces

    # -- lifecycle ---------------------------------------------------------
    def _build_rung(self, rung: int) -> _Rung:
        x = torch.zeros((rung, self._dim), dtype=self._centers.dtype, device=self._device)
        self._traces += 1
        if not self._graphs:
            self._ops.apply(x, self._centers, self._alpha)
            return _Rung(x)
        with torch.cuda.device(self._device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):   # eager first: builds, queries and caches
                self._ops.apply(x, self._centers, self._alpha)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self._ops.apply(x, self._centers, self._alpha)
        return _Rung(x, graph, out)

    def warmup(self) -> dict[int, float]:
        """Capture one graph per ladder rung (on the CPU: run each once);
        returns rung -> seconds. After this any request mix replays the
        captured graphs: ``retraces_since_warmup()`` staying 0 is the
        steady-state contract."""
        secs: dict[int, float] = {}
        for rung in self._ladder:
            t0 = time.perf_counter()
            if rung not in self._rungs:
                self._rungs[rung] = self._build_rung(rung)
            if self._graphs:
                torch.cuda.synchronize(self._device)
            secs[rung] = time.perf_counter() - t0
        self._warm_traces = self._traces
        return secs

    def swap_model(self, model) -> None:
        """Copy a refreshed model's centers and coefficients into the served
        buffers: no capture. A model of another geometry (shapes, types,
        device, path stacking) is refused: it needs a new server. An
        attached scoring cache (tiles of K(X_eval, old centers)) is
        invalidated and dropped."""
        est, alpha, unstack = _resolve_model(model)
        same = (est.centers.shape == self._centers.shape
                and est.centers.dtype == self._centers.dtype
                and est.centers.device == self._device
                and alpha.shape == self._alpha.shape and alpha.dtype == self._alpha.dtype
                and alpha.device == self._device and unstack == self._unstack)
        if not same:
            raise ValueError(
                f"swap_model needs the warmed geometry: centers "
                f"{tuple(self._centers.shape)}/{self._centers.dtype} and alpha "
                f"{tuple(self._alpha.shape)}/{self._alpha.dtype} on {self._device}, got "
                f"{tuple(est.centers.shape)}/{est.centers.dtype} and "
                f"{tuple(alpha.shape)}/{alpha.dtype} on {alpha.device} — a different "
                f"geometry needs new graphs; build a new server instead")
        self._centers.copy_(est.centers)
        self._alpha.copy_(alpha)
        self._deployed = est.centers
        if self._scoring_cache is not None:
            self._scoring_cache.invalidate()
            self._scoring_cache = None

    def attach_scoring_cache(self, cache) -> None:
        """Pin a :class:`repro_torch.ops.KernelCache` over a fixed evaluation
        set, built against the deployed model's centers (identity check):
        ``predict_scoring_set`` then scores it as GEMMs over the stored
        entries. ``swap_model`` invalidates and detaches it."""
        cache.check_serves(self._deployed)
        self._scoring_cache = cache

    def predict_scoring_set(self) -> np.ndarray:
        """Score the attached evaluation set against the deployed model."""
        if self._scoring_cache is None:
            raise RuntimeError("no scoring cache attached; call attach_scoring_cache first")
        self._scoring_cache.check_serves(self._deployed)
        out = self._scoring_cache.apply(self._alpha).cpu().numpy()
        return self._finalize(out, out.shape[0])

    # -- request path ------------------------------------------------------
    def submit(self, x) -> int:
        """Queue one request of (rows, d) feature rows; returns its ticket
        (its position in the next ``flush`` result list)."""
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != self._dim:
            raise ValueError(f"request must be (rows, {self._dim}), got {x.shape}")
        self._pending.append(x.astype(self._np_dtype, copy=False))
        return len(self._pending) - 1

    def flush(self) -> list[np.ndarray]:
        """Coalesce, run and scatter every queued request, in submit order.

        Single model: request k -> (rows_k,) or (rows_k, p) predictions.
        Path model: request k -> (rows_k, L) or (rows_k, L, p), one column
        block per lam, all from the same stacked applies.
        """
        batches, self._pending = self._pending, []
        if not batches:
            return []
        if self._warm_traces is None:
            self.warmup()
        sizes = [b.shape[0] for b in batches]
        plan = plan_dispatches(sizes, self._ladder)
        outs: list[np.ndarray | None] = [None] * len(batches)

        inflight: collections.deque = collections.deque()
        for disp in plan:
            t0, span = time.perf_counter(), trace.start("serve.dispatch")
            buf = np.zeros((disp.bucket, self._dim), self._np_dtype)
            for s in disp.segments:
                buf[s.buf_offset:s.buf_offset + s.rows] = \
                    batches[s.request][s.req_offset:s.req_offset + s.rows]
            inflight.append((disp, self._run(disp.bucket, buf), t0, span))
            self.stats.dispatches += 1
            self.stats.rung_dispatches[disp.bucket] += 1
            self.stats.rows_valid += disp.rows
            self.stats.rows_padded += disp.pad_rows
            # scatter one dispatch behind: the host copy blocks on the OLDEST
            # result while the device runs the newest
            while len(inflight) >= self._depth + 1:
                self._scatter(*inflight.popleft(), sizes, outs)
        while inflight:
            self._scatter(*inflight.popleft(), sizes, outs)
        self.stats.requests += len(batches)
        return [self._finalize(out, size) for out, size in zip(outs, sizes)]

    def predict_many(self, batches: Sequence) -> list[np.ndarray]:
        """submit() every batch, flush(), return predictions in order."""
        for b in batches:
            self.submit(b)
        return self.flush()

    __call__ = predict_many

    # -- internals ---------------------------------------------------------
    def _run(self, rung: int, buf: np.ndarray) -> Tensor:
        """One dispatch at ``rung`` rows: on the card the rung's graph
        replayed on its static input, its output copied out on the stream
        (the next replay of the rung overwrites it); on the CPU the apply."""
        r = self._rungs[rung]
        xt = torch.from_numpy(buf)
        if r.graph is None:
            return self._ops.apply(xt.to(self._device), self._centers, self._alpha)
        r.x.copy_(xt, non_blocking=True)
        r.graph.replay()
        return r.out.clone()

    def _scatter(self, disp: Dispatch, dev: Tensor, t0: float, span, sizes, outs) -> None:
        host = dev.cpu().numpy()                      # blocks until ready
        for s in disp.segments:
            out = outs[s.request]
            if out is None:
                out = outs[s.request] = np.empty((sizes[s.request],) + host.shape[1:],
                                                 host.dtype)
            out[s.req_offset:s.req_offset + s.rows] = host[s.buf_offset:s.buf_offset + s.rows]
        self.stats.dispatch_seconds.append(time.perf_counter() - t0)
        span.end()

    def _finalize(self, out: np.ndarray | None, size: int) -> np.ndarray:
        if out is None:                               # zero-row request
            trail = () if self._alpha.ndim == 1 else (int(self._alpha.shape[1]),)
            out = np.empty((0,) + trail, np.dtype("float32"))
        if self._unstack is None:
            return out
        L, p = self._unstack
        out = out.reshape(out.shape[0], L, p)
        return out[..., 0] if p == 1 else out


def _resolve_model(model):
    """(estimator, alpha or stack, unstack) for either model tier.

    A path result's (L, M[, p]) coefficients are flattened to (M, L*p)
    columns: estimator i's predictions are columns [i*p, (i+1)*p) of the
    stacked apply. That is valid only when the estimators share centers,
    which the path fit guarantees; a hand-built result whose centers differ
    in shape is refused (values are trusted, not compared).
    """
    if hasattr(model, "estimators") and hasattr(model, "state"):
        ests = model.estimators
        if not ests:
            raise ValueError("path result has no estimators")
        first = ests[0]
        for e in ests[1:]:
            if not (e.centers is first.centers or e.centers.shape == first.centers.shape):
                raise ValueError("path estimators must share centers")
        alphas = model.state.alphas                   # (L, M) or (L, M, p)
        L, M = alphas.shape[0], alphas.shape[1]
        p = alphas.shape[2] if alphas.ndim > 2 else 1
        flat = alphas.reshape(L, M, p).permute(1, 0, 2).reshape(M, L * p)
        return first, flat.to(first.alpha.dtype).contiguous(), (L, p)
    if hasattr(model, "centers") and hasattr(model, "alpha"):
        return model, model.alpha, None
    raise TypeError(f"expected a FalkonEstimator or FalkonPathResult, got {type(model)}")
