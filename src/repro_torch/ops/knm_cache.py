"""Materialized K_nM cache: evaluate the kernel entries once, run CG on GEMMs.

Counterpart of ``repro/ops/knm_cache.py``. A fit at t iterations evaluates
K_nM once per sweep on the recompute path (on the card B1 evaluates each
entry twice a sweep). A :class:`KernelCache` evaluates each (block_size, M)
row tile once (``ops.materialize``: one ``gram`` a tile, on the card one B3
launch), stores the entries at the policy's storage type (a 16-bit policy
halves the bytes) and serves every later sweep and apply as GEMMs over them
(``ops.gemm_sweep`` / ``gemm_apply``, ``repro_torch.ops.gemm``): the
right-hand side, every CG matvec, the cond(W) power iteration, all L systems
of a lam path, a fixed scoring set's predictions.

Residency is a :func:`~repro_torch.ops.base.plan_cache` decision:

* ``device`` — K lives on the card; a sweep is GEMMs over the stored strips.
* ``host``   — the tiles live in host memory and stream through a
  :class:`~repro_torch.data.streaming.StreamingLoader` (the chunk feed of the
  streamed fits: a K tile is a (block_size, M) chunk), one GEMM sweep a tile,
  summed across tiles in fp32. numpy has no bfloat16, so bf16 tiles are held
  as an int16 view of their bits and viewed back on the device.
* ``off``    — no cache; the caller takes the recompute path.

Under ``DistributedOps`` each rank stores only its row block of K (the
global K padded to a multiple of shards * block_size rows): the cache
keeps the global padded row count and hands the rank its slice of v and of
the mask; ``apply`` returns every row on every rank.

Staleness: a cache pins the exact centers (and X) tensors it was built from,
by identity. ``check_serves`` refuses an ``invalidate()``-d cache, other
centers (a ``.to()`` of the estimator makes new ones) and other rows.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import CachePlan, plan_cache

Tensor = torch.Tensor


def _shard_of(ops) -> tuple[int, int]:
    """(this rank's row-shard index, the shard count) behind an ops facade
    chain, (0, 1) when not distributed: the first ``num_shards`` found
    walking ``.inner`` / ``.ops``, with its ``shard_index``."""
    seen: set[int] = set()
    o = ops
    while o is not None and id(o) not in seen:
        seen.add(id(o))
        ns = getattr(o, "num_shards", None)
        if ns is not None:
            return int(getattr(o, "shard_index", 0)), int(ns)
        o = getattr(o, "inner", None) or getattr(o, "ops", None)
    return 0, 1


def data_shards(ops) -> int:
    """Row shards behind an ops facade chain (1 when not distributed)."""
    return _shard_of(ops)[1]


class KernelCache:
    """One materialized K(X, C), served as GEMM sweeps and applies.

    ``plan`` defaults to the auto-routed :func:`plan_cache`; a forced-tier
    plan pins the residency. A plan whose tier is ``"off"`` is refused: the
    caller owns the decision not to cache.
    """

    def __init__(self, ops, X: Tensor, C: Tensor, *, plan: CachePlan | None = None):
        n, M = int(X.shape[0]), int(C.shape[0])
        if plan is None:
            plan = plan_cache(n, M, policy=ops.policy)
        if plan.tier == "off":
            raise ValueError(
                f"refusing to build a KernelCache from an 'off'-tier plan "
                f"({plan.reason}); the caller should take the recompute path")
        if plan.tier == "host" and data_shards(ops) > 1:
            raise ValueError(
                "host-tier K_nM cache is not supported under DistributedOps: each "
                "shard's block either fits the device (tier 'device') or the fit "
                "should recompute (tier 'off')")
        self.ops = ops
        self.X = X            # identity only: which rows the tiles cover
        self.C = C
        self.n = n
        self.M = M
        self.plan = plan
        self._invalidated = False
        self._loader = None
        self.K = None
        if plan.tier == "device":
            # under DistributedOps: this rank's row block of the padded K
            self.K = ops.materialize(X, C)
            index, shards = _shard_of(ops)
            rows = int(self.K.shape[0])
            self.n_pad = rows * shards
            self._block = slice(index * rows, (index + 1) * rows)
        else:
            self._build_host(X, C)
            self._block = slice(0, self.n_pad)
        # pad rows contribute exactly zero, as the recompute sweep's padding
        self._pad_mask = (torch.arange(self.n_pad, device=X.device) < n).to(torch.float32)

    def _build_host(self, X: Tensor, C: Tensor) -> None:
        """Materialize into host memory in slabs of 8 tiles (the device holds
        one slab at a time) and stand up the tile loader (its default
        prefetch: 2 tiles ahead on the card)."""
        from repro_torch.data.streaming import ArrayChunkSource, StreamingLoader

        bs = self.ops.block_size
        self.n_pad = -(-self.n // bs) * bs
        host = None
        slab = 8 * bs
        for i0 in range(0, self.n_pad, slab):
            Ks = self.ops.materialize(X[i0:min(i0 + slab, self.n)], C).cpu()
            self._tile_dtype = Ks.dtype
            if Ks.dtype == torch.bfloat16:
                Ks = Ks.view(torch.int16)      # numpy has no bfloat16: its bits
            Ks = Ks.numpy()
            if host is None:
                host = np.empty((self.n_pad, self.M), Ks.dtype)
            host[i0:i0 + Ks.shape[0]] = Ks
        self.K_host = host
        self._loader = StreamingLoader(ArrayChunkSource(host, chunk_rows=bs),
                                       device=X.device)

    def _tiles(self):
        """The host tier's tiles on the device, in row order, at their type."""
        for Kt, _ in self._loader.iter_chunks(with_targets=False):
            yield Kt.view(self._tile_dtype) if Kt.dtype != self._tile_dtype else Kt

    # -- staleness ---------------------------------------------------------
    def invalidate(self) -> None:
        """Mark the cache unusable (the model behind it was swapped)."""
        self._invalidated = True

    def matches(self, centers) -> bool:
        """True iff this cache serves exactly ``centers`` (identity check)."""
        return (not self._invalidated) and centers is self.C

    def check_serves(self, centers, n: int | None = None, X=None) -> None:
        """Refuse to serve a swapped or foreign model or another row set."""
        if self._invalidated:
            raise ValueError(
                "stale KernelCache: the model behind it was swapped (invalidate() "
                "was called); rebuild the cache against the new centers")
        if centers is not self.C:
            raise ValueError(
                "KernelCache was built against a different centers array (identity "
                "check); a cache cannot serve a swapped model — rebuild it")
        if n is not None and n != self.n:
            raise ValueError(f"KernelCache covers {self.n} rows but the request has {n}")
        if X is not None and X is not self.X:
            raise ValueError(
                "KernelCache was built over a different X (identity check); its "
                "stored tiles are K(X_cache, C), not K of this scoring set — rebuild "
                "the cache for the new rows")

    # -- served primitives -------------------------------------------------
    def _mask(self, row_mask: Tensor | None) -> Tensor | None:
        if row_mask is None:
            # aligned (n == n_pad, no caller mask): no rows to zero
            return None if self.n_pad == self.n else self._pad_mask
        m = row_mask.to(torch.float32)
        return torch.nn.functional.pad(m, (0, self.n_pad - self.n)) * self._pad_mask

    def _pad_v(self, v: Tensor | None) -> Tensor | None:
        if v is None:
            return None
        return torch.nn.functional.pad(v, (0, 0) * (v.ndim - 1) + (0, self.n_pad - self.n))

    def sweep(self, u: Tensor, v: Tensor | None = None,
              row_mask: Tensor | None = None) -> Tensor:
        """K^T (K u + v) from stored entries: ``ops.sweep(X, C, u, v,
        row_mask)`` over the cached rows."""
        mask = self._mask(row_mask)
        vp = self._pad_v(v)
        if self._loader is None:
            # this rank's rows of v and of the mask (all of them on one device)
            return self.ops.gemm_sweep(self.K, u, None if vp is None else vp[self._block],
                                       None if mask is None else mask[self._block])
        return self._host_sweep(u, vp, mask)

    def apply(self, u: Tensor) -> Tensor:
        """K u from stored entries: ``ops.apply(X, C, u)``."""
        if self._loader is None:
            return self.ops.gemm_apply(self.K, u)[:self.n]
        outs = [self.ops.gemm_apply(Kt, u) for Kt in self._tiles()]
        return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=0))[:self.n]

    def _host_sweep(self, u: Tensor, vp: Tensor | None, mask: Tensor | None) -> Tensor:
        """One streamed pass over the host tiles, each a GEMM sweep, summed
        across tiles in fp32 and returned at the tiles' result type."""
        tr = self.ops.block_size
        w = out_dtype = None
        for i, Kt in enumerate(self._tiles()):
            s = slice(i * tr, (i + 1) * tr)
            wc = self.ops.gemm_sweep(Kt, u, None if vp is None else vp[s],
                                     None if mask is None else mask[s])
            if out_dtype is None:
                out_dtype = wc.dtype
            if wc.dtype.itemsize < 4:
                wc = wc.float()
            w = wc if w is None else w + wc
        return w.to(out_dtype)

    # -- introspection -----------------------------------------------------
    @property
    def tier(self) -> str:
        return self.plan.tier

    @property
    def num_tiles(self) -> int:
        """ceil(n / block_size): the ``gram_tile_evals`` a cached fit charges
        for K_nM."""
        return self.n_pad // self.ops.block_size
