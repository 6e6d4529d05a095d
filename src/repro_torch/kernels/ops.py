"""Kernel-object wrappers around the CUDA kernels.

Counterpart of ``repro/kernels/ops.py``: the thin waist between a kernel
object (anything carrying a ``KernelSpec``) and the raw wrappers of
``kernel_matvec.py``. A CUDA tensor runs the hand-written kernel, a CPU
tensor its plain twin.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels import spec_of

from .kernel_matvec import fused_sweep
from .kernel_matvec import kernel_matmul as _kernel_matmul
from .kernel_matvec import pairwise_kernel as _pairwise_kernel

Tensor = torch.Tensor


def fused_knm_matvec(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None, kernel) -> Tensor:
    """w = K(X,C)^T (K(X,C) u + v) in one launch (each tile evaluated twice)."""
    return fused_sweep(X, C, u, v, spec=spec_of(kernel))


def two_pass_knm_matvec(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None,
                        kernel) -> Tensor:
    """The sweep as two kernel matmuls, K(X,C) @ u then K(C,X) @ t, with
    K^T(X,C) = K(C,X) and t = K u + v fused through ``add``."""
    spec = spec_of(kernel)
    t = _kernel_matmul(X, C, u, v, spec=spec)
    return _kernel_matmul(C, X, t, spec=spec)


def kernel_matmul(A: Tensor, B: Tensor, V: Tensor, kernel) -> Tensor:
    """out = K(A, B) @ V (the prediction path's primitive)."""
    return _kernel_matmul(A, B, V, spec=spec_of(kernel))


def pairwise_kernel(A: Tensor, B: Tensor, kernel) -> Tensor:
    """K(A, B) materialized (preconditioner's K_MM builder)."""
    return _pairwise_kernel(A, B, spec=spec_of(kernel))
