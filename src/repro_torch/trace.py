"""Spans and counters of the port's layers, on the profiler's clock.

``span(name, device=...)`` marks a stretch of the port's work: the fit and
its stages, the solve's phases and sweeps, the preconditioner's solves,
the kernel wrappers, the blocked factor's copies and tiles, a server
dispatch. Tracing is off by default; off, a span is one flag check and
returns a shared no-op, with no allocation, no CUDA event and no profiler
call. Turn it on with the operator's switch::

    from repro_torch import trace

    with trace.recording():
        est, state = falkon_fit(0, X, y, cfg)
        est.predict(X_test)
    print(trace.totals())      # after the work: it waits for device spans
    trace.reset()

or run the work inside any ``torch.profiler`` session, which turns it on
for exactly the session. On, a span records its name, its parent (the
enclosing span of the same thread), a request id (a span with no parent
opens one, its descendants share it, so one fit's or one prediction's
spans can be told apart), its host start and end
(``time.perf_counter_ns``) and, with a CUDA ``device``, a pair of CUDA
events on that device's current stream, resolved only when ``totals()`` is
read. Under the profiler it also stands on the profiler's timeline as a
plain CPU event of its own name, on the clock of the kernels and copies it
launched, so the exported trace names the layer the host was in while the
card sat idle.

The spans of a fit and a prediction ("device" spans carry CUDA events, the
others are host time)::

    fit (device)                 one per falkon_fit* call, its root
      fit.centers fit.cache fit.gram fit.factor fit.solve fit.score
        factor.copy factor.tile  the blocked factor's blocks (fit.factor)
        solve.rhs solve.cg solve.cond solve.coeffs   the solve's phases
          ops.sweep              one pass over the data (device)
            kernel.launch        a wrapper's checks to its C call's return
          precond.solve          one triangular solve (device)
        minibatch.step minibatch.projection          a mini-batch solve
    estimator.predict            one per FalkonEstimator.predict (host)
      kernel.launch
    serve.dispatch               a server dispatch, packing to scatter-back

``count(name, k)`` adds to a counter while tracing is on. ``totals()``
sums the records by span name (count, host seconds, host self seconds and,
for device spans, device and device self seconds; self time is a span's
less what its child spans cover) with the counters; ``spans()`` lists the
records; ``reset()`` clears both. Records are kept until ``reset()``:
call it after each profiling session that reads them. Past
``MAX_RECORDS`` a span is no longer kept, only counted as
``trace.dropped``, so a long session that nobody resets stays bounded.

A caller that reads a span's time itself (the fits' ``stage_times``,
``FactorStats``, the mini-batch split) passes ``clock=``: the span is then
measured whether or not tracing is on, its ``seconds`` read from that
clock at both ends.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Callable

import torch
import torch.autograd.profiler as _profiler

__all__ = ["MAX_RECORDS", "Span", "count", "recording", "reset", "span", "spans", "start",
           "synced_clock", "totals"]

#: depth of open ``recording()`` blocks (tracing is on while > 0)
_recording = 0
_records: list["Span"] = []
#: records kept until ``reset()``; later spans only add to ``trace.dropped``
MAX_RECORDS = 1 << 20
_counters: collections.Counter = collections.Counter()
_requests = itertools.count(1)
_local = threading.local()


@functools.cache
def _cuda() -> bool:
    return torch.cuda.is_available()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Off:
    """The span of tracing off: does nothing, measures nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self) -> None:
        pass


_OFF = _Off()


class Span:
    """One measured stretch. Made by :func:`span` (a context manager, the
    parent of the spans opened inside it) or :func:`start` (ended by
    ``end()``, never a parent, for stretches that overlap others)."""

    __slots__ = ("name", "parent", "request", "start_ns", "end_ns", "child_ns",
                 "_device", "_events", "_clock", "_c0", "_c1", "_rf", "_kept", "_pushed",
                 "_device_s")

    def __init__(self, name: str, device, clock: Callable[[], float] | None, kept: bool):
        self.name, self._clock, self._kept = name, clock, kept
        self._device = None if device is None else torch.device(device)
        self.parent = self.request = self._rf = self._events = self._device_s = None
        self.child_ns = 0
        self._pushed = False

    def _begin(self, push: bool) -> None:
        if self._kept:
            st = _stack()
            self.parent = st[-1] if st else None
            self.request = self.parent.request if self.parent is not None else next(_requests)
            if push:   # nested, so it also stands on the profiler's timeline
                st.append(self)
                self._pushed = True
                if _profiler._is_profiler_enabled:
                    self._rf = torch._C._profiler._RecordFunctionFast(self.name)
                    self._rf.__enter__()
        if self._clock is not None:
            self._c0 = self._clock()
        self.start_ns = time.perf_counter_ns()
        dev = self._device
        if dev is not None and dev.type == "cuda" and _cuda():
            # torch.Event records on its device's current stream from C++
            self._events = (torch.Event(dev, enable_timing=True),
                            torch.Event(dev, enable_timing=True))
            self._events[0].record()

    def end(self) -> None:
        """Close the span (a span from :func:`start`)."""
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.perf_counter_ns()
        if self._clock is not None:
            self._c1 = self._clock()
        if not self._kept:
            return
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self._pushed:
            _stack().pop()
        if self.parent is not None:
            self.parent.child_ns += self.end_ns - self.start_ns
        if len(_records) < MAX_RECORDS:
            _records.append(self)
        else:
            _counters["trace.dropped"] += 1

    def __enter__(self) -> "Span":
        self._begin(push=True)
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    @property
    def host_seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def seconds(self) -> float:
        """The span's length on its ``clock`` (the host's, without one)."""
        if self._clock is not None:
            return self._c1 - self._c0
        return self.host_seconds

    @property
    def device_seconds(self) -> float | None:
        """The device's time between the span's ends: its CUDA events'
        (waiting for the end event), the host's on another device, None for
        a host span."""
        if self._device_s is None and self._device is not None:
            if self._events is None:
                self._device_s = self.seconds
            else:
                start, end = self._events
                end.synchronize()
                self._device_s = start.elapsed_time(end) / 1e3
                self._events = None
        return self._device_s


def synced_clock(device: torch.device | None = None) -> float:
    """The host clock (``time.perf_counter``) once ``device``'s queued work
    has finished: a ``clock`` that times a span's device work to its end."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def span(name: str, *, device=None, clock: Callable[[], float] | None = None):
    """A context manager around one stretch of the port's work, recorded
    while tracing is on.

    ``device``: the device whose work the span times (CUDA events on its
    current stream), or None for a host span. ``clock``: for a caller that
    reads the span's ``seconds`` itself: the span is measured whether or not
    tracing is on, ``seconds`` read from this clock at both ends (one that
    synchronises the device first times the device's work to its end)."""
    kept = _recording or _profiler._is_profiler_enabled
    if not kept and clock is None:
        return _OFF
    return Span(name, device, clock, bool(kept))


def start(name: str, *, device=None, clock: Callable[[], float] | None = None):
    """:func:`span`, begun now and closed by its ``end()``; it is never the
    parent of another span, so such stretches may overlap (and, for that,
    are kept off the profiler's timeline)."""
    s = span(name, device=device, clock=clock)
    if s is not _OFF:
        s._begin(push=False)
    return s


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` while tracing is on."""
    if _recording or _profiler._is_profiler_enabled:
        _counters[name] += k


@contextlib.contextmanager
def recording():
    """Trace everything inside the block (nesting allowed)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list[Span]:
    """The closed spans recorded since the last ``reset()``, in the order
    they closed (a child before its parent)."""
    return list(_records)


def totals() -> dict:
    """``{"spans": {name: {"count", "host_s", "host_self_s"[, "device_s",
    "device_self_s"]}}, "counters": {name: value}}``. Resolving a device
    span's events waits for its end: read this outside a measured stretch."""
    recs = list(_records)
    child_dev: dict[int, float] = collections.defaultdict(float)
    for r in recs:
        if r.device_seconds is None:
            continue
        a = r.parent
        while a is not None and a._device is None:
            a = a.parent
        if a is not None:
            child_dev[id(a)] += r.device_seconds
    out: dict = {}
    for r in recs:
        t = out.setdefault(r.name, {"count": 0, "host_s": 0.0, "host_self_s": 0.0})
        t["count"] += 1
        t["host_s"] += r.host_seconds
        t["host_self_s"] += (r.end_ns - r.start_ns - r.child_ns) / 1e9
        if r._device is not None:
            t["device_s"] = t.get("device_s", 0.0) + r.device_seconds
            t["device_self_s"] = (t.get("device_self_s", 0.0) + r.device_seconds
                                  - child_dev.get(id(r), 0.0))
    return {"spans": out, "counters": dict(_counters)}


def reset() -> None:
    """Forget every record and counter."""
    _records.clear()
    _counters.clear()
