"""Mesh-sharded ``KernelOps``: the data-parallel FALKON every fit inherits.

Counterpart of ``repro/ops/distributed_backend.py``. FALKON's O(nM) cost is
the sweep ``w = K(X,C)^T (K(X,C) u + v)``, additive over the rows of X.
:class:`DistributedOps` wraps any registered backend (or a ``CountingOps``
around one) and runs its primitives on this rank's rows:

* ``sweep``  — the rank sweeps its row block of X (and of v and the mask)
  on the wrapped backend (on the card one B1 launch a column group), then
  ONE ``all_reduce`` over the data group merges the (M, p) partials. That
  is the sweep's only traffic: the CG state is M-sized and the same on
  every rank, so an iteration moves M * p floats however large n grows; a
  lam-path fit reduces one (M, L*p) block.
* ``apply``  — row-local: the rank computes its rows, and one more
  collective (counted as ``gathers``, never as ``psums``) hands every rank
  all n rows, the reference's contract. It is an ``all_reduce`` of a
  zero-filled (n_pad, p) buffer holding the rank's block: adding zeros
  keeps each row's bits, and gloo carries CUDA tensors for ``all_reduce``
  and ``broadcast`` only.
* ``gram``   — (M, M) work on the same operands everywhere: delegated, no
  collective.
* ``plan``   — the wrapped planner at ceil(n / shards) rows.
* ``materialize`` / ``gemm_sweep`` / ``gemm_apply`` — the K_nM cache: a
  rank stores only its row block of K_nM (X padded to a multiple of
  shards * block_size, as the reference pads), a cached sweep is the
  rank's GEMMs and one ``all_reduce``. ``KernelCache`` knows the global
  padded rows and hands each rank its slice of v and of the mask.

A ragged n is padded here, once for every caller, to a multiple of the
shard count, and the pad rows are masked: every shard always carries a
float mask (all ones where nothing is padded), and a masked row
contributes exactly zero, so padding never changes the result.

**One program on every rank.** The reference is one controller over a
mesh; here every rank runs the whole fit on the same global X with the
same seed, so every rank draws the same centers (a generator seeded alike;
pass an int seed, or generators in the same state) and, after each
all-reduce, holds the same CG state. The mesh fit's alpha is the same bits
on every rank.

**Communication accounting.** ``psums`` / ``psum_floats`` count the
all-reduces the sweeps issue and the elements they move; ``gathers`` /
``gather_floats`` the reassembly of ``apply``. PyTorch runs eagerly, so
these are executed calls (a fit's t CG sweeps count t), where the
reference counts program points at trace time.

**Wire compression (opt-in).** ``compress="int8"`` sends each rank's
(M, p) partial through the int8 round trip of
``repro_torch.distributed.compression`` before the all-reduce, which still
sums in the accumulate type: the hook bounds the precision each partial
crosses the wire with (at most ``max|w_local| / 127`` a rank).

    ops = DistributedOps(get_ops("cuda", kernel), mesh, ("data",))
    est, _ = falkon_fit(seed, X, y, FalkonConfig(mesh=mesh))

``FalkonConfig(mesh=...)`` routes every fit variant through this wrapper
(``make_ops`` and the fits' backend resolution); none of them has mesh code
of its own.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.distributed.mesh import data_group, data_shard, mesh_shape

from .base import KernelOps, SweepPlan

Tensor = torch.Tensor

#: wire formats ``compress=`` accepts (None: the accumulate type)
COMPRESSIONS = (None, "int8")


def _pad_rows(a: Tensor, rows: int) -> Tensor:
    """``a`` with zero rows appended up to ``rows`` (as it is when there)."""
    if a.shape[0] == rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))])


class DistributedOps:
    """Data-parallel :class:`KernelOps` over the mesh's data axes.

    Wraps ``inner`` (any registered backend, or a ``CountingOps`` around
    one) and runs its primitives on this rank's rows: one rank sweeps one
    row shard, one all-reduce merges the (M, p) partials. Not registered by
    name (an instance needs a live mesh): construct it, or let
    ``FalkonConfig(mesh=..., data_axes=...)`` do it.
    """

    def __init__(self, inner: KernelOps, mesh, data_axes=("data",), *,
                 compress: str | None = None):
        data_axes = tuple(data_axes)
        if not data_axes:
            raise ValueError("data_axes must name at least one mesh axis")
        shape = mesh_shape(mesh)
        missing = [a for a in data_axes if a not in shape]
        if missing:
            raise ValueError(f"data axes {missing} not in mesh axes {tuple(shape)}")
        if compress not in COMPRESSIONS:
            raise ValueError(f"unknown compress {compress!r}; supported: {COMPRESSIONS}")
        self.inner = inner
        self.mesh = mesh
        self.data_axes = data_axes
        self.compress = compress
        self.shard_index, self._shards = data_shard(mesh, data_axes)
        self.group = data_group(mesh, data_axes)
        self.reset_comm_stats()

    # -- delegated static attributes (the KernelOps surface) ---------------
    @property
    def kernel(self):
        return self.inner.kernel

    @property
    def block_size(self) -> int:
        return self.inner.block_size

    @property
    def precision(self):
        return self.inner.precision

    @property
    def policy(self):
        return self.inner.policy

    @property
    def num_shards(self) -> int:
        """Ranks along the data axes (the row-shard count)."""
        return self._shards

    def reset_comm_stats(self) -> None:
        self.psums = 0          # sweep all-reduces issued (executed calls)
        self.psum_floats = 0    # elements they moved
        self.gathers = 0        # apply reassemblies issued
        self.gather_floats = 0

    # -- this rank's rows and the collectives ------------------------------
    def _rows(self, n: int, rows: int) -> slice:
        """This rank's [r0, r1) of n rows in blocks of ``rows`` (empty past n)."""
        r0 = min(self.shard_index * rows, n)
        return slice(r0, min(r0 + rows, n))

    def _wire(self, w: Tensor) -> Tensor:
        """The opt-in wire-compression round trip of a local partial."""
        if self.compress is None:
            return w
        q, scale = quantize_int8(w)
        return dequantize_int8(q, scale, w.dtype)

    def _psum(self, w: Tensor, floats: int) -> Tensor:
        """The sweep's one all-reduce, in at least float32."""
        self.psums += 1
        self.psum_floats += floats
        w = self._wire(w)
        acc = (w if w.dtype.itemsize >= 4 else w.float()).contiguous()
        dist.all_reduce(acc, group=self.group)
        return acc.to(w.dtype)

    def _gather(self, local: Tensor, rows: int) -> Tensor:
        """Every shard's ``rows``-row block, in shard order, on every rank."""
        full = local.new_zeros((rows * self._shards,) + tuple(local.shape[1:]))
        full[self.shard_index * rows:(self.shard_index + 1) * rows] = local
        self.gathers += 1
        self.gather_floats += full.numel()
        dist.all_reduce(full, group=self.group)
        return full

    # -- the three primitives ------------------------------------------------
    def sweep(self, X: Tensor, C: Tensor, u: Tensor, v: Tensor | None = None,
              row_mask: Tensor | None = None) -> Tensor:
        """This rank's row-block sweep and ONE (M, p) all-reduce.

        X, v and ``row_mask`` are global and split by rows here; C and u are
        the same on every rank. A ragged n is zero-padded to the next
        multiple of the shard count with the pad rows masked, and every
        shard carries a mask (all ones when nothing is padded and no caller
        mask was given)."""
        n = X.shape[0]
        rows = -(-n // self._shards)
        s = self._rows(n, rows)
        if row_mask is None:
            mask = (torch.arange(rows, device=X.device) < s.stop - s.start).to(torch.float32)
        else:
            mask = _pad_rows(row_mask[s].to(torch.float32), rows)
        Xl = _pad_rows(X[s], rows)
        vl = None if v is None else _pad_rows(v[s], rows)
        p = u.shape[1] if u.ndim > 1 else 1
        return self._psum(self.inner.sweep(Xl, C, u, vl, row_mask=mask), C.shape[0] * p)

    def apply(self, X: Tensor, C: Tensor, u: Tensor) -> Tensor:
        """K(X, C) u: this rank's rows on the wrapped backend, then all n
        rows on every rank (one reassembly, counted in ``gathers``). Each
        output row depends only on its own X row, so pad rows are sliced
        off and the valid rows keep their bits."""
        n = X.shape[0]
        rows = -(-n // self._shards)
        local = self.inner.apply(_pad_rows(X[self._rows(n, rows)], rows), C, u)
        return self._gather(local, rows)[:n]

    def gram(self, A: Tensor, B: Tensor) -> Tensor:
        """K(A, B) on operands every rank holds: delegated, no collective (so
        Gram counts match a single device's)."""
        return self.inner.gram(A, B)

    # -- K_nM cache primitives -------------------------------------------------
    def materialize(self, X: Tensor, C: Tensor) -> Tensor:
        """This rank's row block of K_nM only.

        X is padded to a multiple of shards * block_size rows, so that each
        block is whole tiles and the wrapped ``materialize`` pads nothing:
        the blocks, in shard order, are the single-device K's rows. Returns
        (n_pad / shards, M); no collective."""
        n = X.shape[0]
        unit = self._shards * self.block_size
        rows = -(-n // unit) * unit // self._shards
        return self.inner.materialize(_pad_rows(X[self._rows(n, rows)], rows), C)

    def gemm_sweep(self, K: Tensor, u: Tensor, v: Tensor | None = None,
                   row_mask: Tensor | None = None) -> Tensor:
        """This rank's GEMM sweep over its cached block and ONE (M, p)
        all-reduce, counted as ``sweep``'s. ``K`` is this rank's block from
        :meth:`materialize`; ``v`` and ``row_mask`` are this rank's slices
        (``KernelCache`` cuts them)."""
        rows = K.shape[0]
        if rows % self.block_size != 0:
            raise ValueError(
                f"cached K block has {rows} rows, not a multiple of block_size = "
                f"{self.block_size}; build it with this wrapper's materialize()")
        mask = (torch.ones(rows, dtype=torch.float32, device=K.device) if row_mask is None
                else row_mask.to(torch.float32))
        p = u.shape[1] if u.ndim > 1 else 1
        return self._psum(self.inner.gemm_sweep(K, u, v, mask), K.shape[1] * p)

    def gemm_apply(self, K: Tensor, u: Tensor) -> Tensor:
        """K u over the sharded cache: every cached row, pad rows included,
        on every rank (the cache slices back to n)."""
        return self._gather(self.inner.gemm_apply(K, u), K.shape[0])

    def plan(self, n: int, M: int, d: int, p: int = 1, systems: int = 1) -> SweepPlan:
        """The wrapped backend's route for ONE shard's ceil(n / shards) rows."""
        return self.inner.plan(-(-max(n, 1) // self._shards), M, d, p, systems)
