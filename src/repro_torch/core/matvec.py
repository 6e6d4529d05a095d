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

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP.md item: the materialized K_nM cache (``make_knm_cache``,
``cached_knm_matvec``, ``cached_knm_apply``: A11).
"""
from __future__ import annotations

import torch

from repro_torch.data.streaming import streaming_apply, streaming_sweep
from repro_torch.ops import PrecisionPolicy, get_ops

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


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md item {item}")
    fn.__name__ = fn.__qualname__ = name
    return fn


def _not_ported_class(name: str, item: str) -> type:
    """A class whose construction raises, naming the ROADMAP.md item."""
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md item {item}")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"Not ported yet: ROADMAP.md item {item}."})


make_knm_cache = _not_ported("make_knm_cache", "A11")
cached_knm_matvec = _not_ported("cached_knm_matvec", "A11")
cached_knm_apply = _not_ported("cached_knm_apply", "A11")
