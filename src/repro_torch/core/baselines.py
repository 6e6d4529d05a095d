"""Baselines the paper compares against (Table 1 / Sect. 2).

Counterpart of ``repro/core/baselines.py``:

* ``krr_direct``       — exact KRR, O(n^3) direct solve of (K_nn + lam n I) a = y.
* ``krr_gradient``     — Eq. (6) gradient iteration on the exact problem.
* ``nystrom_direct``   — basic Nystrom (Eq. 8), direct solve of H a = z.
* ``nystrom_gradient`` — NYTRO-style [23]: gradient iteration on the Nystrom
                         problem *without* FALKON's preconditioner.

Each returns a :class:`KernelPredictor`. In float64 they are the oracles the
port's solvers are held against. They compute on their inputs' device with
IEEE fp32 matmuls (TF32 off); ``nystrom_gradient`` sweeps through
``knm_matvec`` (B1 on the card) and ``KernelPredictor.predict`` through
``knm_apply`` (B2). ``nystrom_direct`` is singular on centers with
duplicate rows (its H has repeated rows): never use it as an oracle there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.blocked_cholesky import _fp32_matmul

from .kernels import KernelFn
from .matvec import knm_apply, knm_matvec

Tensor = torch.Tensor


class KernelPredictor(NamedTuple):
    centers: Tensor
    alpha: Tensor
    kernel: KernelFn

    def predict(self, X: Tensor, block_size: int = 2048) -> Tensor:
        return knm_apply(X, self.centers, self.alpha, self.kernel, block_size=block_size)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def krr_direct(X: Tensor, y: Tensor, kernel: KernelFn, lam: float) -> KernelPredictor:
    n = X.shape[0]
    with _fp32_matmul():
        Knn = kernel(X, X)
        alpha = torch.linalg.solve(Knn + lam * n * _eye(n, X), y)
    return KernelPredictor(centers=X, alpha=alpha, kernel=kernel)


def krr_gradient(X: Tensor, y: Tensor, kernel: KernelFn, lam: float, t: int,
                 tau: float | None = None) -> KernelPredictor:
    """Eq. (6): a_k = a_{k-1} - tau/n [ (K a - y) + lam n a ]."""
    n = X.shape[0]
    with _fp32_matmul():
        Knn = kernel(X, X)
        if tau is None:
            # ||Knn||/n + lam bounds the operator's largest eigenvalue
            tau = 1.0 / (torch.linalg.matrix_norm(Knn, ord=2) / n + lam)
        a = torch.zeros_like(y)
        for _ in range(t):
            a = a - tau * ((Knn @ a - y) / n + lam * a)
    return KernelPredictor(centers=X, alpha=a, kernel=kernel)


def nystrom_direct(X: Tensor, y: Tensor, centers: Tensor, kernel: KernelFn, lam: float,
                   jitter: float = 1e-9) -> KernelPredictor:
    """Eq. (8): (K_nM^T K_nM + lam n K_MM) a = K_nM^T y, dense direct solve."""
    n = X.shape[0]
    with _fp32_matmul():
        KnM = kernel(X, centers)
        KMM = kernel(centers, centers)
        H = KnM.T @ KnM + lam * n * KMM
        H = H + jitter * torch.trace(H) / H.shape[0] * _eye(H.shape[0], H)
        z = KnM.T @ y
        # LU, not Cholesky: H has a large dynamic range and an fp32 Cholesky
        # can fail even though H is PSD in exact arithmetic.
        alpha = torch.linalg.solve(H, z)
    return KernelPredictor(centers=centers, alpha=alpha, kernel=kernel)


def nystrom_gradient(X: Tensor, y: Tensor, centers: Tensor, kernel: KernelFn, lam: float,
                     t: int, block_size: int = 2048) -> KernelPredictor:
    """NYTRO-like: plain gradient descent on the (unpreconditioned) Nystrom
    objective. Needs O(cond(H)) iterations — the gap FALKON closes. The
    right-hand side K_nM^T y / n is swept once, not once per step as the
    reference's scan body does: the same value."""
    n = X.shape[0]
    M = centers.shape[0]
    with _fp32_matmul():
        KMM = kernel(centers, centers)
        ones = torch.ones(M, dtype=X.dtype, device=X.device) / M
        KnM_norm_sq = knm_matvec(X, centers, ones, None, kernel, block_size=block_size)
        op_bound = (torch.linalg.norm(KnM_norm_sq) * M / n
                    + lam * torch.linalg.matrix_norm(KMM, ord=2))
        tau = 1.0 / torch.clamp(op_bound, min=1e-30)
        a = torch.zeros((M,) + tuple(y.shape[1:]), dtype=X.dtype, device=X.device)
        z = knm_matvec(X, centers, torch.zeros_like(a), y, kernel, block_size=block_size) / n
        for _ in range(t):
            Ha = knm_matvec(X, centers, a, None, kernel, block_size=block_size) / n \
                + lam * (KMM @ a)
            a = a - tau * (Ha - z)
    return KernelPredictor(centers=centers, alpha=a, kernel=kernel)
