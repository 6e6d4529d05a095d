"""Blocked K_nM matvecs: the functional face of ``repro_torch.ops``.

Counterpart of ``repro/core/matvec.py``. The primitive (paper Alg. 1
``KnM_times_vector``) is, for row block b of X,

    w += K(X_b, C)^T (K(X_b, C) u + v_b)

so one sweep over the data computes ``K_nM^T (K_nM u + v)`` without ever
materializing K_nM. The implementations are the ``KernelOps`` backends:
``"cuda"`` (the hand-written kernels B1 and B2, the default) and
``"torch"`` (the plain blocked row scan). ``knm_matvec`` and ``knm_apply``
are one-line delegates to them.

``streaming_knm_matvec`` and ``streaming_knm_apply`` are the same
delegates over host-streamed chunks of X (``repro_torch.data.streaming``).

``make_knm_cache`` / ``cached_knm_matvec`` / ``cached_knm_apply`` are the
functional face of the materialized K_nM cache (``repro_torch.ops.
KernelCache``): evaluate the kernel entries once (on the card, one B3
launch a row tile), then answer every later matvec and apply over the same
(X, C) pair as GEMMs over the stored entries.
"""
from __future__ import annotations

import torch

from repro_torch.data.streaming import streaming_apply, streaming_sweep
from repro_torch.ops import KernelCache, PrecisionPolicy, get_ops, plan_cache

from .kernels import KernelFn

Tensor = torch.Tensor


def knm_matvec(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None, kernel: KernelFn, *,
               block_size: int = 2048, impl: str = "cuda",
               precision: "str | PrecisionPolicy" = "fp32") -> Tensor:
    """``K_nM^T (K_nM u + v)``; ``u`` (M,) or (M, p), ``v`` (n,) or (n, p)
    or None (treated as 0)."""
    return get_ops(impl, kernel, block_size=block_size, precision=precision).sweep(X, C, u, v)


def knm_apply(X: Tensor, C: Tensor, u: Tensor, kernel: KernelFn, *,
              block_size: int = 2048, impl: str = "cuda",
              precision: "str | PrecisionPolicy" = "fp32") -> Tensor:
    """``K_nM u`` (the prediction path)."""
    return get_ops(impl, kernel, block_size=block_size, precision=precision).apply(X, C, u)


def streaming_knm_matvec(loader, C: Tensor, u: Tensor, kernel: KernelFn, *,
                         use_targets: bool = False, block_size: int = 2048,
                         impl: str = "cuda",
                         precision: "str | PrecisionPolicy" = "fp32") -> Tensor:
    """``K_nM^T (K_nM u + v)`` with X streamed chunk by chunk from the host
    through ``loader``; with ``use_targets=True`` the chunks' targets are v."""
    ops = get_ops(impl, kernel, block_size=block_size, precision=precision)
    return streaming_sweep(ops, loader, C, u, use_targets=use_targets)


def streaming_knm_apply(loader, C: Tensor, u: Tensor, kernel: KernelFn, *,
                        block_size: int = 2048, impl: str = "cuda",
                        precision: "str | PrecisionPolicy" = "fp32") -> Tensor:
    """``K_nM u`` over streamed chunks of X, concatenated in order."""
    ops = get_ops(impl, kernel, block_size=block_size, precision=precision)
    return streaming_apply(ops, loader, C, u)


def make_knm_cache(X: Tensor, C: Tensor, kernel: KernelFn, *, block_size: int = 2048,
                   impl: str = "cuda", precision: "str | PrecisionPolicy" = "fp32",
                   tier: str | None = None) -> KernelCache:
    """Materialize K(X, C) once; later sweeps and applies are GEMMs.

    ``tier`` forces the residency ("device" / "host"); None routes by the
    ``plan_cache`` budgets, and a plan that says "off" raises: at this call
    site the caller has asked to cache."""
    ops = get_ops(impl, kernel, block_size=block_size, precision=precision)
    plan = plan_cache(int(X.shape[0]), int(C.shape[0]), policy=ops.policy, tier=tier)
    return KernelCache(ops, X, C, plan=plan)


def cached_knm_matvec(cache: KernelCache, u: Tensor, v: Tensor | None = None) -> Tensor:
    """``K_nM^T (K_nM u + v)`` from a cache's stored entries (no kernel
    evaluation): the cached twin of :func:`knm_matvec`."""
    return cache.sweep(u, v)


def cached_knm_apply(cache: KernelCache, u: Tensor) -> Tensor:
    """``K_nM u`` from stored entries: the cached twin of :func:`knm_apply`."""
    return cache.apply(u)
