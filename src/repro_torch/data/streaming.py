"""Host-streamed X: FALKON on n that need never be resident on the device.

Counterpart of ``repro/data/streaming.py``. The sweep ``w = K(X,C)^T
(K(X,C) u + v)`` is additive over row chunks of X, so the CG data pass never
needs all of X on the device: chunks live on the host and stream through a
host-to-device feed while the device sweeps the chunk before. The device
holds the paper's O(M^2) state plus a few chunks, whatever n is.

* ``ChunkSource``      — a re-iterable source of (X_chunk, y_chunk | None)
                         host arrays: ``ArrayChunkSource`` (in-memory or
                         memory-mapped arrays), ``ShardedChunkSource`` (a
                         row range of another source), ``ShuffledChunkSource``
                         (a windowed reshuffle, fresh every pass). Pure
                         numpy, the reference's classes.
* ``StreamingLoader``  — the host-to-device feed. On the card a producer
                         thread fills a ring of page-locked staging buffers
                         (allocated once per loader; the dtype conversion
                         happens in that fill, so bf16 chunks cross the bus
                         at 2 bytes) and copies each chunk to the device on a
                         side stream, ``prefetch`` chunks ahead; the
                         consumer's stream waits on each copy's event.
* ``streaming_sweep`` / ``streaming_apply`` — the ``KernelOps`` primitives
  over the chunks, every chunk at one X shape (a ragged tail is padded and
  swept with a ``row_mask``).
* ``streaming_uniform_centers`` — exact uniform Nystrom centers gathered in
  one host pass.

The reference's ``JittedOps`` (a ``jax.jit`` facade, so that chunks of one
shape compile once) has no counterpart: the CUDA kernels do not compile per
shape.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator

import numpy as np
import torch

Tensor = torch.Tensor

_END = object()


def default_prefetch(device: str | torch.device = "cuda") -> int:
    """Chunks in flight when the caller does not say: 2 (double-buffered)
    on the card, 0 (inline transfers) on the CPU, where "host" and "device"
    share one memory and an overlap thread only contends for the cores."""
    return 0 if torch.device(device).type == "cpu" else 2


class ChunkSource:
    """Re-iterable source of ``(X_chunk, y_chunk | None)`` host arrays.

    Subclasses set ``n_rows``, ``dim`` and ``chunk_rows`` and implement
    ``chunks()``; every call to ``chunks()`` starts a fresh pass over the
    data (the CG solve replays the source once per iteration).
    """

    n_rows: int
    dim: int
    chunk_rows: int

    def chunks(self) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        raise NotImplementedError

    @property
    def num_chunks(self) -> int:
        return -(-self.n_rows // self.chunk_rows)


class ArrayChunkSource(ChunkSource):
    """Chunk view over in-memory (or memory-mapped) host arrays.

    ``X``: (n, d); ``y``: (n,) or (n, p) or None. Slices are views: no copy
    until the loader's fill.
    """

    def __init__(self, X, y=None, *, chunk_rows: int = 8192):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.X = np.asarray(X)
        self.y = None if y is None else np.asarray(y)
        if self.y is not None and self.y.shape[0] != self.X.shape[0]:
            raise ValueError(f"X has {self.X.shape[0]} rows but y has {self.y.shape[0]}")
        self.n_rows, self.dim = self.X.shape
        self.chunk_rows = int(chunk_rows)

    def chunks(self) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        for i0 in range(0, self.n_rows, self.chunk_rows):
            i1 = min(i0 + self.chunk_rows, self.n_rows)
            yield self.X[i0:i1], None if self.y is None else self.y[i0:i1]


class ShardedChunkSource(ChunkSource):
    """Row-range view: shard ``index`` of ``num_shards`` over a parent source.

    Shard i streams rows ``[i * ceil(n/s), (i+1) * ceil(n/s))`` of the
    parent, sliced at the range's ends so that its chunk grid aligns with
    the parent's (``chunk_rows`` is inherited); the parent is re-walked each
    pass and rows outside the range are skipped without a copy.
    """

    def __init__(self, source: ChunkSource, index: int, num_shards: int):
        if not 0 < num_shards:
            raise ValueError(f"num_shards must be positive, got {num_shards}")
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index must be in [0, {num_shards}), got {index}")
        self.source = source
        self.index = index
        self.num_shards = num_shards
        rows_per = -(-source.n_rows // num_shards)
        self.row_start = min(index * rows_per, source.n_rows)
        self.row_stop = min(self.row_start + rows_per, source.n_rows)
        self.n_rows = self.row_stop - self.row_start
        self.dim = source.dim
        self.chunk_rows = source.chunk_rows

    def chunks(self) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        offset = 0
        for xc, yc in self.source.chunks():
            lo = max(self.row_start - offset, 0)
            hi = min(self.row_stop - offset, xc.shape[0])
            if hi > lo:
                yield xc[lo:hi], None if yc is None else yc[lo:hi]
            offset += xc.shape[0]
            if offset >= self.row_stop:
                return


def shard_chunk_sources(source: ChunkSource, num_shards: int) -> tuple[ShardedChunkSource, ...]:
    """All ``num_shards`` row-range views of ``source``, in shard order."""
    return tuple(ShardedChunkSource(source, i, num_shards) for i in range(num_shards))


class ShuffledChunkSource(ChunkSource):
    """Epoch-reshuffling view over any ``ChunkSource``.

    A windowed shuffle: up to ``buffer_chunks`` chunks are buffered and
    emitted in uniformly random order (an exact chunk-order shuffle when
    ``buffer_chunks >= num_chunks``), and each emitted chunk's rows are
    permuted (``shuffle_rows``). Every ``chunks()`` call folds a pass
    counter into ``seed`` (``np.random.default_rng((seed, pass))``, the
    reference's draws), so two passes differ and two sources built with the
    same seed replay alike.
    """

    def __init__(self, source: ChunkSource, *, seed: int = 0, buffer_chunks: int = 8,
                 shuffle_rows: bool = True):
        if buffer_chunks < 1:
            raise ValueError(f"buffer_chunks must be >= 1, got {buffer_chunks}")
        self.source = source
        self.seed = int(seed)
        self.buffer_chunks = int(buffer_chunks)
        self.shuffle_rows = shuffle_rows
        self.n_rows = source.n_rows
        self.dim = source.dim
        self.chunk_rows = source.chunk_rows
        self._passes = 0

    def chunks(self) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        rng = np.random.default_rng((self.seed, self._passes))
        self._passes += 1

        def emit(chunk):
            xc, yc = chunk
            if self.shuffle_rows and xc.shape[0] > 1:
                perm = rng.permutation(xc.shape[0])
                xc = np.asarray(xc)[perm]
                yc = None if yc is None else np.asarray(yc)[perm]
            return xc, yc

        buf: list = []
        for chunk in self.source.chunks():
            buf.append(chunk)
            if len(buf) > self.buffer_chunks:
                yield emit(buf.pop(int(rng.integers(len(buf)))))
        while buf:
            yield emit(buf.pop(int(rng.integers(len(buf)))))


class _Slot:
    """One page-locked staging buffer pair of the ring and the event of the
    last copy that read it."""

    def __init__(self):
        self.x: Tensor | None = None
        self.y: Tensor | None = None
        self.copied: torch.cuda.Event | None = None


def _staged(buf: Tensor | None, a: np.ndarray, dtype: torch.dtype, rows: int) -> Tensor:
    """``buf`` (grown, page-locked, to ``rows`` when short) holding ``a`` at
    ``dtype`` in its first rows."""
    if buf is None or buf.shape[0] < rows or buf.shape[1:] != a.shape[1:] or buf.dtype != dtype:
        buf = torch.empty((rows,) + a.shape[1:], dtype=dtype, pin_memory=True)
    buf[:a.shape[0]].copy_(torch.from_numpy(a))
    return buf


class StreamingLoader:
    """Host-to-device chunk feed over a ``ChunkSource``.

    Iterating yields ``(X_dev, y_dev | None)`` in source order, each at
    ``dtype`` (default: the source arrays' own type) on ``device`` (default
    ``"cuda"``: without a card it raises unless the caller passes
    ``"cpu"``). Re-iterable: each ``iter()`` is an independent pass.

    On the card, with ``prefetch`` >= 1 (default 2), a producer thread fills
    a ring of ``prefetch + 1`` page-locked staging buffers, allocated once
    per loader, converting to ``dtype`` in that fill, and copies each chunk
    to the device on a side stream; at most ``prefetch`` copied chunks wait
    in its queue. The consumer's stream waits on each copy's event before
    it uses the chunk, a staging buffer is refilled only once its last copy
    has completed, and each device chunk is recorded on the consumer's
    stream, so that no chunk is overwritten while a sweep reads it. With
    ``prefetch=0`` there is no thread: each chunk is filled into one staging
    buffer and copied on the consumer's stream, behind the work before it.
    On the CPU the same thread and queue run without streams or pinning.
    Source errors reach the consumer; an early ``break`` stops the thread
    and leaves no copy in flight.
    """

    def __init__(self, source: ChunkSource, *, device: str | torch.device = "cuda",
                 prefetch: int | None = None, dtype: torch.dtype | None = None):
        from repro_torch.core.falkon import resolve_device   # core.falkon imports this module
        self.device = resolve_device(device)
        if prefetch is None:
            prefetch = default_prefetch(self.device)
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.source = source
        self.prefetch = prefetch
        self.dtype = dtype
        self._rings: list[list[_Slot]] = []   # free rings; one taken per pass

    @property
    def n_rows(self) -> int:
        return self.source.n_rows

    @property
    def dim(self) -> int:
        return self.source.dim

    @property
    def chunk_rows(self) -> int | None:
        """The source's chunk height (None when it declares none): what
        ``streaming_sweep`` pads a ragged tail up to."""
        return getattr(self.source, "chunk_rows", None)

    def __iter__(self):
        return self.iter_chunks()

    def _type(self, a: np.ndarray) -> torch.dtype:
        t = torch.from_numpy(np.empty(0, a.dtype)).dtype
        return self.dtype if self.dtype is not None and t.is_floating_point else t

    def _host(self, a: np.ndarray) -> Tensor:
        """A CPU "transfer": a fresh tensor at the loader's type."""
        return torch.from_numpy(np.asarray(a)).to(self._type(a), copy=True)

    def _copy(self, slot: _Slot, xc, yc, stream) -> tuple[Tensor, Tensor | None, object]:
        """Fill ``slot`` (after its last copy completed) and copy it to the
        device on ``stream``; returns the device chunk and the copy's event."""
        xc, yc = np.asarray(xc), None if yc is None else np.asarray(yc)
        rows = max(xc.shape[0], self.chunk_rows or 0)
        if slot.copied is not None:
            slot.copied.synchronize()
        slot.x = _staged(slot.x, xc, self._type(xc), rows)
        if yc is not None:
            slot.y = _staged(slot.y, yc, self._type(yc), rows)
        nc = xc.shape[0]
        with torch.cuda.stream(stream):
            xd = torch.empty((nc,) + xc.shape[1:], dtype=slot.x.dtype, device=self.device)
            xd.copy_(slot.x[:nc], non_blocking=True)
            yd = None
            if yc is not None:
                yd = torch.empty((nc,) + yc.shape[1:], dtype=slot.y.dtype, device=self.device)
                yd.copy_(slot.y[:nc], non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(stream)
        return xd, yd, slot.copied

    def iter_chunks(self, *, with_targets: bool = True):
        """Iterate (X_dev, y_dev | None) pairs; ``with_targets=False`` skips
        y's fill and transfer (every CG pass but the right-hand side's)."""
        card = self.device.type == "cuda"
        ring = self._rings.pop() if self._rings else [_Slot() for _ in range(self.prefetch + 1)]
        try:
            if self.prefetch == 0:
                for xc, yc in self.source.chunks():
                    yc = yc if with_targets else None
                    if not card:
                        yield self._host(xc), None if yc is None else self._host(yc)
                        continue
                    xd, yd, _ = self._copy(ring[0], xc, yc, torch.cuda.current_stream(self.device))
                    yield xd, yd
                return
            yield from self._threaded(ring, with_targets, card)
        finally:
            for slot in ring:     # no copy from a staging buffer left in flight
                if slot.copied is not None:
                    slot.copied.synchronize()
            self._rings.append(ring)

    def _threaded(self, ring: list[_Slot], with_targets: bool, card: bool):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        side = torch.cuda.Stream(self.device) if card else None

        def put(item) -> bool:
            while not stop.is_set():      # the consumer may be gone (early break)
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                with torch.cuda.device(self.device) if card else contextlib.nullcontext():
                    for k, (xc, yc) in enumerate(self.source.chunks()):
                        yc = yc if with_targets else None
                        if card:
                            item = self._copy(ring[k % len(ring)], xc, yc, side)
                        else:
                            item = (self._host(xc), None if yc is None else self._host(yc), None)
                        if not put(item):
                            return
                put(_END)
            except Exception as e:   # noqa: BLE001 - every source error reaches the consumer
                put(e)

        thread = threading.Thread(target=work, daemon=True, name="StreamingLoader")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                xd, yd, copied = item
                if card:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(copied)
                    for t in (xd, yd):
                        if t is not None:
                            t.record_stream(cur)
                yield xd, yd
        finally:
            stop.set()
            try:                     # unblock a producer parked on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join()


def _pad_rows(a: Tensor, rows: int) -> Tensor:
    return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 1) + (0, rows - a.shape[0]))


def streaming_sweep(ops, loader, C: Tensor, u: Tensor, *, use_targets: bool = True,
                    pad_ragged: bool = True) -> Tensor:
    """``K(X,C)^T (K(X,C) u + v)`` accumulated over streamed chunks of X.

    ``use_targets=True`` feeds each chunk's y as the sweep's v (the
    right-hand side of Alg. 1); ``False`` runs the matvec (v = 0) and skips
    the targets' transfer. With ``pad_ragged`` (when the loader declares
    ``chunk_rows``) a short tail chunk is zero-padded to ``chunk_rows`` and
    swept with a ``row_mask`` that zeroes the pad rows' contribution
    exactly, so every chunk sweep sees one X shape; full chunks pass no
    mask. Reduced-storage chunk results accumulate in float32 across chunks
    and come back at the chunks' type.
    """
    if use_targets or not hasattr(loader, "iter_chunks"):
        it = iter(loader)
    else:
        it = loader.iter_chunks(with_targets=False)
    chunk_rows = getattr(loader, "chunk_rows", None) if pad_ragged else None
    w = out_dtype = None
    for xc, yc in it:
        if use_targets and yc is None:
            raise ValueError(
                "streaming_sweep(use_targets=True): the source yielded a chunk without "
                "targets; v would silently be 0 and the right-hand side a zero solution")
        vc = yc if use_targets else None
        nc = xc.shape[0]
        if chunk_rows and nc < chunk_rows:
            mask = (torch.arange(chunk_rows, device=xc.device) < nc).to(torch.float32)
            wc = ops.sweep(_pad_rows(xc, chunk_rows), C, u,
                           None if vc is None else _pad_rows(vc, chunk_rows), row_mask=mask)
        else:
            wc = ops.sweep(xc, C, u, vc)
        if out_dtype is None:
            out_dtype = wc.dtype
        if wc.dtype.itemsize < 4:
            wc = wc.float()
        w = wc if w is None else w + wc
    if w is None:
        raise ValueError("streaming_sweep: the loader yielded no chunks")
    return w.to(out_dtype)


def streaming_apply(ops, loader, C: Tensor, u: Tensor, *, pad_ragged: bool = True) -> Tensor:
    """``K(X,C) u`` over streamed chunks of X, concatenated in order. The
    targets are not transferred; a ragged tail is padded to the loader's
    ``chunk_rows`` and its pad rows sliced off (apply is row-local), so
    every chunk is applied at one shape."""
    it = loader.iter_chunks(with_targets=False) if hasattr(loader, "iter_chunks") else iter(loader)
    chunk_rows = getattr(loader, "chunk_rows", None) if pad_ragged else None
    outs = []
    for xc, _ in it:
        nc = xc.shape[0]
        if chunk_rows and nc < chunk_rows:
            outs.append(ops.apply(_pad_rows(xc, chunk_rows), C, u)[:nc])
        else:
            outs.append(ops.apply(xc, C, u))
    if not outs:
        raise ValueError("streaming_apply: the loader yielded no chunks")
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _uniform_indices(seed: int, n: int, M: int) -> np.ndarray:
    """M sorted row indices of n, uniform without replacement, from ``seed``
    (the reference's numpy draw)."""
    return np.sort(np.random.default_rng(seed).choice(n, size=M, replace=False))


def streaming_uniform_centers(generator: torch.Generator, source: ChunkSource, M: int):
    """Uniform (without replacement) Nystrom centers from a chunk source.

    ``source.n_rows`` is known up front, so the sampling is exact: M sorted
    global indices are drawn with numpy from a seed that ``generator``
    gives, and the matching rows gathered as the chunks stream past (one
    host pass, no device transfer). Returns (centers, indices) as host
    arrays.
    """
    n = source.n_rows
    if not 0 < M <= n:
        raise ValueError(f"need 0 < M <= n rows, got M={M}, n={n}")
    seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,), generator=generator,
                             device=generator.device)[0])
    idx = _uniform_indices(seed, n, M)
    rows = []
    offset = 0
    for xc, _ in source.chunks():
        lo = np.searchsorted(idx, offset)
        hi = np.searchsorted(idx, offset + xc.shape[0])
        if hi > lo:
            rows.append(np.asarray(xc)[idx[lo:hi] - offset])
        offset += xc.shape[0]
    return np.concatenate(rows, axis=0), idx
