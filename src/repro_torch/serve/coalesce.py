"""Request coalescing: pack ragged predict requests into fixed shape buckets.

Counterpart of ``repro/serve/coalesce.py``; pure host arithmetic, the same
code. Every distinct batch shape the server meets would cost its own
captured CUDA graph (the reference: its own XLA trace), so requests are
packed into a small LADDER of power-of-two bucket shapes, each captured once
at warmup:

* requests are packed row-wise, in arrival order, into dispatches of at
  most ``ladder[-1]`` rows (a request larger than the ladder top is split
  across dispatches);
* each dispatch runs at the smallest rung >= its valid rows, the rest of
  the rows zero-padded (``apply`` is row-local, so pad rows never perturb
  valid rows and are dropped on scatter-back);
* every dispatch therefore replays one of ``len(ladder)`` graphs: no
  capture after warmup, which the server's counter proves.

``plan_dispatches`` is the whole coalescing policy; the server
(``repro_torch.serve.server``) executes its plan.
"""
from __future__ import annotations

import dataclasses


def _ceil_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def bucket_ladder(max_batch: int, min_bucket: int = 8) -> tuple[int, ...]:
    """Power-of-two bucket shapes ``min_bucket .. >= max_batch``.

    Both ends are rounded UP to powers of two (a ladder of pow2 rungs keeps
    the capture count at log2(max/min) + 1 while bounding pad waste at 2x).
    The top rung is the dispatch row capacity.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
    top = _ceil_pow2(max(max_batch, min_bucket))
    rung = _ceil_pow2(min_bucket)
    rungs = []
    while rung <= top:
        rungs.append(rung)
        rung *= 2
    return tuple(rungs)


def pick_bucket(rows: int, ladder: tuple[int, ...]) -> int:
    """Smallest ladder rung that holds ``rows`` valid rows."""
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    for b in ladder:
        if rows <= b:
            return b
    raise ValueError(
        f"{rows} rows exceed the ladder top {ladder[-1]} — plan_dispatches "
        "should have split this request")


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous run of rows: request slice -> dispatch-buffer slice."""

    request: int     # index into the submitted request list
    req_offset: int  # first row within the request
    buf_offset: int  # first row within the dispatch buffer
    rows: int


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One device call: ``rows`` valid rows packed into a ``bucket``-row
    buffer (pad rows zero, dropped on scatter-back)."""

    bucket: int
    rows: int
    segments: tuple[Segment, ...]

    @property
    def pad_rows(self) -> int:
        return self.bucket - self.rows


def plan_dispatches(sizes, ladder: tuple[int, ...]) -> tuple[Dispatch, ...]:
    """Greedy in-order packing of request ``sizes`` into bucket dispatches.

    Arrival order is preserved (request k's rows never land after request
    k+1's — FIFO fairness, no starvation) and dispatches are filled to the
    ladder top before a new one opens; a request crossing the boundary is
    split. Zero-size requests produce no segments (the server returns an
    empty prediction for them).
    """
    max_rows = ladder[-1]
    dispatches: list[Dispatch] = []
    segs: list[Segment] = []
    filled = 0

    def close():
        nonlocal segs, filled
        if filled:
            dispatches.append(Dispatch(bucket=pick_bucket(filled, ladder),
                                       rows=filled, segments=tuple(segs)))
        segs, filled = [], 0

    for req, size in enumerate(sizes):
        size = int(size)
        if size < 0:
            raise ValueError(f"request {req} has negative size {size}")
        off = 0
        while size > 0:
            take = min(size, max_rows - filled)
            segs.append(
                Segment(request=req, req_offset=off, buf_offset=filled, rows=take)
            )
            filled += take
            off += take
            size -= take
            if filled == max_rows:
                close()
    close()
    return tuple(dispatches)
