"""Dense PyTorch oracles for the CUDA kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``. Kernel math comes from the same
``tile_eval`` the plain twins use, so an oracle/kernel mismatch is a
tiling or masking fault, never a formula drift.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels import KernelSpec, tile_eval

Tensor = torch.Tensor


def _spec(kind: str, scale: float) -> KernelSpec:
    if kind in ("gaussian", "laplacian", "matern32"):
        return KernelSpec(kind, (("sigma", scale),))
    raise ValueError(
        f"legacy (kind, scale) interface supports only the sigma kernels; "
        f"use tile_eval with a full KernelSpec for {kind!r}")


def kernel_tile(A: Tensor, B: Tensor, kind: str, scale: float) -> Tensor:
    """K(A, B) for a sigma kernel kind."""
    return tile_eval(_spec(kind, scale), A, B)


def kernel_matmul_ref(A: Tensor, B: Tensor, V: Tensor, kind: str, scale: float) -> Tensor:
    """out = K(A, B) @ V."""
    return kernel_tile(A, B, kind, scale) @ V


def fused_knm_matvec_ref(X: Tensor, C: Tensor, u: Tensor, v: Tensor | None,
                         kind: str, scale: float) -> Tensor:
    """w = K(X,C)^T (K(X,C) u + v) — one full FALKON CG sweep."""
    K = kernel_tile(X, C, kind, scale)
    t = K @ u if v is None else K @ u + v
    return K.T @ t


def pairwise_kernel_ref(A: Tensor, B: Tensor, kind: str, scale: float) -> Tensor:
    return kernel_tile(A, B, kind, scale)
