"""Materialized-K_nM GEMM primitives shared by both backends.

Counterpart of ``repro/ops/gemm.py``. The recompute sweep evaluates all of
K_nM once per CG iteration (on the card B1 evaluates each entry twice). The
:class:`~repro_torch.ops.knm_cache.KernelCache` path calls ``materialize``
once, each (block_size, M) row tile evaluated a single time by the
backend's ``gram`` (on the card, B3), and serves every later sweep and
apply as GEMMs over the stored entries:

    materialize(X, C) -> K        (n_pad, M) at the policy's storage type
    gemm_sweep(K, u, v, mask)  =  (K*mask)^T ((K*mask) u + v*mask)
    gemm_apply(K, u)           =  K u        (the caller slices [:n])

The GEMMs were never Pallas in the reference and are not kernels here:
they are ``torch.matmul`` (cuBLAS on the card) in IEEE fp32, and a call on
the card refuses to run with TF32 matmuls allowed.

Numerical contract, the reference's: ``gemm_sweep`` replays the "torch"
backend's recompute sweep over stored entries: the same (block_size, M)
strips in the same order, the same mask multiply, the same Kahan carry
across strips under a ``compensated`` policy. Under the fp32 policy the
stored entries are the ones the recompute sweep evaluates, so on the
"torch" backend the two are bit-equal. A reduced-storage policy stores the
entries at its 16-bit type (half the bytes: one more rounding of each
entry) and widens each strip to fp32 before its products.

``materialize`` fills one preallocated (n_pad, M) tensor tile by tile,
never a concatenation of tiles, which would hold K twice: an fp32 tile is
written by the backend's ``_gram_into`` into its row slice (on the card B3
writes it there itself), a 16-bit tile is evaluated in fp32 and copied into
its slice, rounded to nearest even. X is zero-padded to a multiple of
block_size rows (row i of K is row i of the padded X; pad rows hold K(0, C)
and are masked or sliced away by every consumer).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kernel_matvec import two_sum

from .base import quantize_coeffs, quantize_storage

Tensor = torch.Tensor


def _compute_dtype(K: Tensor) -> torch.dtype:
    """fp32 floor for the GEMMs; stored fp64 stays fp64."""
    return K.dtype if K.dtype.itemsize >= 4 else torch.float32


def require_ieee_fp32_matmul(t: Tensor) -> None:
    """Refuse a GEMM on the card while TF32 matmuls are allowed: the cached
    sweeps must run in IEEE fp32, as the kernels they replace do."""
    if t.device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                    or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the K_nM cache's GEMMs run in IEEE fp32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') (got allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, precision "
            f"{torch.get_float32_matmul_precision()!r})")


def _check_rows(K: Tensor, block_size: int) -> None:
    if K.shape[0] % block_size != 0:
        raise ValueError(
            f"cached K has {K.shape[0]} rows, not a multiple of block_size={block_size} — "
            "materialize() pads; hand-built caches must too")


class GemmCacheMixin:
    """The three cache primitives, mixed into both backends. Uses only
    ``self.block_size``, ``self.policy``, ``self.gram`` and
    ``self._gram_into``."""

    def _gram_into(self, A: Tensor, B: Tensor, out: Tensor) -> None:
        """K(A, B) into ``out`` (rounded to its type): one ``gram``."""
        out.copy_(self.gram(A, B))

    def materialize(self, X: Tensor, C: Tensor) -> Tensor:
        """Evaluate K(X, C) once, tile by tile, at the policy's storage type.

        Returns (n_pad, M), n_pad = ceil(n / block_size) * block_size. Each
        row tile is one ``gram`` evaluation (what ``CountingOps`` charges as
        ``gram_tile_evals``). Float32 storage keeps ``gram``'s output type
        (fp64 inputs give fp64 entries).
        """
        pol = self.policy
        Cq = quantize_storage(pol, C)
        bs = self.block_size
        n, d = X.shape
        nb = -(-n // bs)
        if pol.storage == "float32":
            dt = torch.promote_types(torch.promote_types(X.dtype, Cq.dtype), torch.float32)
        else:
            dt = getattr(torch, pol.storage)
        K = torch.empty((nb * bs, Cq.shape[0]), dtype=dt, device=X.device)
        for i in range(nb):
            r0, r1 = i * bs, min((i + 1) * bs, n)
            Xt = quantize_storage(pol, X[r0:r1])
            if r1 - r0 < bs:      # the tail tile: zero-padded rows
                Xt = torch.nn.functional.pad(Xt, (0, 0, 0, bs - (r1 - r0)))
            self._gram_into(Xt.contiguous(), Cq, K[i * bs:(i + 1) * bs])
        return K

    def gemm_sweep(self, K: Tensor, u: Tensor, v: Tensor | None = None,
                   row_mask: Tensor | None = None) -> Tensor:
        """K^T (K u + v) over stored entries, strip by strip.

        ``K`` (rows, M) from ``materialize`` (rows % block_size == 0);
        ``v`` and ``row_mask`` already padded to ``rows``. A strip whose mask
        is all ones skips the multiply (x * 1.0 is exact: the same bits);
        telling which strips those are reads the (rows / block_size) flags
        back once a call.
        """
        pol = self.policy
        bs = self.block_size
        rows, M = K.shape
        _check_rows(K, bs)
        if v is not None and v.shape[0] != rows:
            raise ValueError(f"v has {v.shape[0]} rows but cached K has {rows}; pad v "
                             "(and mask the pad rows) to the cache's row count")
        require_ieee_fp32_matmul(K)
        u = quantize_coeffs(pol, u)
        v = quantize_storage(pol, v)
        cd = _compute_dtype(K)
        nb = rows // bs
        mask, ones = None, [True] * nb
        if row_mask is not None:
            mask = row_mask.to(cd)
            ones = (mask.reshape(nb, bs) == 1).all(dim=1).tolist()
        w = torch.zeros((M,) + tuple(u.shape[1:]), dtype=cd, device=K.device)
        comp = torch.zeros_like(w) if pol.compensated else None
        for i in range(nb):
            s = slice(i * bs, (i + 1) * bs)
            Kf = K[s].to(cd)              # a 16-bit strip widened; fp32 as it is
            m = None if ones[i] else mask[s]
            if m is not None:
                Kf = Kf * m[:, None]
            t = Kf @ u
            if v is not None:
                vb = v[s]
                t = t + (vb if m is None else vb * (m[:, None] if vb.ndim > 1 else m))
            if comp is None:
                w = w + Kf.T @ t
            else:   # the recompute sweep's cross-strip two-sum
                w, comp = two_sum(w, comp, Kf.T @ t)
        co = pol.buffer_dtype("coeffs")
        return w if co == "float32" else w.to(getattr(torch, co))

    def gemm_apply(self, K: Tensor, u: Tensor) -> Tensor:
        """K u over stored entries, strip by strip: all ``K.shape[0]`` rows,
        pad rows included (the cache slices back to n)."""
        bs = self.block_size
        _check_rows(K, bs)
        require_ieee_fp32_matmul(K)
        u = quantize_coeffs(self.policy, u)
        cd = _compute_dtype(K)
        out = torch.empty((K.shape[0],) + tuple(u.shape[1:]),
                          dtype=torch.promote_types(cd, u.dtype), device=K.device)
        for r0 in range(0, K.shape[0], bs):
            out[r0:r0 + bs] = K[r0:r0 + bs].to(cd) @ u
        return out
