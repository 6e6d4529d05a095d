"""FALKON preconditioner (paper Sect. 3 Eq. 13 and Appendix A Def. 3).

Counterpart of the single-lam part of ``repro/core/preconditioner.py``:

    T = chol(K_MM + eps*M*I)        (upper triangular, K_MM = T^T T)
    A = chol(T T^T / M + lam * I)   (upper triangular)
    B = (1/sqrt(n)) T^{-1} A^{-1}

with the sampling-weight diagonal D (Def. 2) and the eigendecomposition
variant for a singular K_MM (``rank_deficient``, Appendix A Example 2):
D K_MM D = Q diag(s) Q^T, T = diag(sqrt(s)) restricted to s > tol.

Every factor is UPPER triangular: ``T = chol(...).mT``. A transposed solve
``T^{-T} v`` is ``solve_triangular(T.mT, v, upper=False)`` — the JAX
package's ``solve_triangular(T, v, trans=1)``.

Each Cholesky is routed by ``repro_torch.ops.plan_factor``, as in the
reference: in-core (``torch.linalg.cholesky`` on the device) while the dense
factor fits ``REPRO_FACTOR_BUDGET_MB`` (512 MB), else the blocked
out-of-core Cholesky (``repro_torch.kernels.blocked_cholesky``), announced
by a ``FactorPlanWarning``. On the blocked path the D-scaling, the jitter and
both O(M^3) products run on a host copy of K_MM that is factored in place,
T T^T stays on the host (only the lam stage reads it) and is factored in
place too; the finished T and A go to K_MM's device for the solves. The
lam path (``make_preconditioner_path``) is ROADMAP item A6.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.kernels.blocked_cholesky import (
    FactorStats,
    blocked_cholesky,
    blocked_syrk_tt,
)
from repro_torch.ops.base import FACTOR_PATHS, FactorPlan, FactorPlanWarning, plan_factor

Tensor = torch.Tensor


def _bcast(d: Tensor, v: Tensor) -> Tensor:
    return d[(...,) + (None,) * (v.ndim - 1)]


def _tri_solve(T: Tensor, v: Tensor, *, upper: bool) -> Tensor:
    """Triangular solve for a (q,) or (q, p) right-hand side."""
    vec = v.ndim == 1
    out = torch.linalg.solve_triangular(T, v[:, None] if vec else v, upper=upper)
    return out[:, 0] if vec else out


def _solve_T(T: Tensor, diag_T: bool, v: Tensor, trans: bool = False) -> Tensor:
    """T^{-1} v (or T^{-T} v) — diagonal fast path for the eig factorization."""
    if diag_T:
        return v / _bcast(torch.diagonal(T), v)
    if trans:
        return _tri_solve(T.mT, v, upper=False)
    return _tri_solve(T, v, upper=True)


@dataclasses.dataclass(frozen=True)
class Preconditioner:
    T: Tensor            # (q, q) upper triangular (diagonal in the eig path)
    A: Tensor            # (q, q) upper triangular
    Q: Tensor | None     # (M, q) partial isometry; None => identity (full rank)
    D: Tensor | None     # (M,) sampling-weight diagonal; None => ones
    n: Tensor            # number of training points (scalar)
    diag_T: bool = False

    @property
    def q(self) -> int:
        return self.T.shape[0]

    def _solve_T(self, v: Tensor, trans: bool = False) -> Tensor:
        return _solve_T(self.T, self.diag_T, v, trans)

    def right(self, u: Tensor) -> Tensor:
        """gamma = D Q T^{-1} A^{-1} u : (q,...) -> (M,...) (sqrt(n) * B u)."""
        v = _tri_solve(self.A, u, upper=True)
        v = self._solve_T(v)
        if self.Q is not None:
            v = self.Q @ v
        if self.D is not None:
            v = v * _bcast(self.D, v)
        return v

    def left(self, w: Tensor) -> Tensor:
        """A^{-T} T^{-T} Q^T D w : (M,...) -> (q,...)."""
        if self.D is not None:
            w = w * _bcast(self.D, w)
        if self.Q is not None:
            w = self.Q.T @ w
        w = self._solve_T(w, trans=True)
        return _tri_solve(self.A.mT, w, upper=False)

    def coeffs(self, beta: Tensor) -> Tensor:
        """alpha = D Q T^{-1} A^{-1} beta (Alg. 1's ``alpha = T\\(A\\beta)``)."""
        return self.right(beta)

    def beta_of_coeffs(self, alpha: Tensor) -> Tensor:
        """Inverse of ``coeffs``: beta = A T Q^T D^{-1} alpha (multiplies,
        not solves; exact on the full-rank path)."""
        v = alpha
        if self.D is not None:
            v = v / _bcast(self.D, v)
        if self.Q is not None:
            v = self.Q.T @ v
        if self.diag_T:
            v = _bcast(torch.diagonal(self.T), v) * v
        else:
            v = self.T @ v
        return self.A @ v

    def ridge(self, u: Tensor, lam) -> Tensor:
        """lam * A^{-T} A^{-1} u — the regularization term of W = B^T H B
        (the T^{-T} Q^T D K_MM D Q T^{-1} = I identity, Lemma 2 / Eq. 19)."""
        v = _tri_solve(self.A, u, upper=True)
        return lam * _tri_solve(self.A.mT, v, upper=False)


def _resolve_factor_plan(KMM: Tensor, factor_plan, rank_deficient: bool) -> FactorPlan:
    """Resolve ``factor_plan`` to a ``FactorPlan``: ``None`` plans from the
    factor budget, ``"incore"`` / ``"blocked"`` force that route, a
    ``FactorPlan`` is taken as it is. A blocked plan with
    ``rank_deficient=True`` raises; any other blocked plan warns."""
    M = KMM.shape[0]
    itemsize = max(KMM.dtype.itemsize, 4)
    if isinstance(factor_plan, FactorPlan):
        plan = factor_plan
    elif factor_plan is None:
        plan = plan_factor(M, itemsize=itemsize)
    elif factor_plan in FACTOR_PATHS:
        dense = M * M * itemsize
        plan = plan_factor(M, itemsize=itemsize,
                           factor_budget=dense if factor_plan == "incore" else dense - 1)
    else:
        raise ValueError(f"factor_plan must be None, a FactorPlan, or one of "
                         f"{FACTOR_PATHS}; got {factor_plan!r}")
    if plan.path == "blocked":
        if rank_deficient:
            raise ValueError(
                "rank_deficient=True is not supported on the blocked factor "
                "path: the eig fallback needs a dense (M, M) "
                "eigendecomposition that this tiling cannot express. Use "
                "the in-core path (raise REPRO_FACTOR_BUDGET_MB or pass "
                "factor_plan='incore'), or drop rank_deficient.")
        warnings.warn(FactorPlanWarning(plan), stacklevel=3)
    return plan


def _shared_factor(KMM: Tensor, D: Tensor | None, jitter: float | None,
                   rank_deficient: bool, rank_tol: float, plan: FactorPlan | None = None,
                   stats: FactorStats | None = None):
    """Stage 1 — everything lam never touches: (T, Q, TTt, diag_T).

    On a blocked ``plan`` the D-scaling, the jitter, ``blocked_cholesky``
    and ``blocked_syrk_tt`` run on a host copy of K_MM (factored in place,
    tiles on K_MM's device); T comes back on the device and TTt stays on
    the host."""
    M = KMM.shape[0]
    dt = KMM.dtype
    eps = jitter if jitter is not None else float(torch.finfo(dt).eps) * M

    if plan is not None and plan.path == "blocked":   # never rank_deficient (resolver)
        Kh = KMM.to("cpu", copy=True)                 # host working copy
        if D is not None:
            Dh = D.to("cpu", Kh.dtype)
            Kh *= Dh[:, None]
            Kh *= Dh[None, :]
        Kh.diagonal().add_(eps)
        Th = blocked_cholesky(Kh, plan.block, stats=stats, device=KMM.device,
                              overwrite=True)
        TTth = blocked_syrk_tt(Th, plan.block, stats=stats, device=KMM.device)
        return Th.to(KMM.device), None, TTth, False

    if D is not None:
        KMM = KMM * D[:, None] * D[None, :]

    if rank_deficient:
        s, U = torch.linalg.eigh(KMM)                       # ascending
        s = s.flip(0)
        U = U.flip(1)
        keep = s > (rank_tol * torch.clamp(s[0], min=1e-30))
        s_safe = torch.where(keep, s, torch.ones_like(s))
        T = torch.diag(torch.sqrt(s_safe))
        Q = U * keep[None, :].to(dt)
        TTt = torch.diag(torch.where(keep, s_safe, torch.zeros_like(s)))
        return T, Q, TTt, True

    eye = torch.eye(M, dtype=dt, device=KMM.device)
    T = torch.linalg.cholesky(KMM + eps * eye).mT               # upper
    return T, None, T @ T.mT, False


def _lam_factor(TTt: Tensor, lam, M: int, plan: FactorPlan | None = None,
                stats: FactorStats | None = None, device=None) -> Tensor:
    """Stage 2 — ``A = chol(T T^T / M + lam I)`` (upper). On a blocked
    ``plan`` TTt is the host tensor of stage 1, scaled and factored in
    place; A comes back on ``device``."""
    if plan is not None and plan.path == "blocked":
        TTt /= M
        TTt.diagonal().add_(float(lam))
        Ah = blocked_cholesky(TTt, plan.block, stats=stats, device=device, overwrite=True)
        return Ah.to(device)
    eye = torch.eye(TTt.shape[0], dtype=TTt.dtype, device=TTt.device)
    return torch.linalg.cholesky(TTt / M + lam * eye).mT


def make_preconditioner(KMM: Tensor, lam: float, n: int, *, D: Tensor | None = None,
                        jitter: float | None = None, rank_deficient: bool = False,
                        rank_tol: float = 1e-7, factor_plan=None,
                        factor_stats: FactorStats | None = None) -> Preconditioner:
    """Build the FALKON preconditioner from K_MM: 2 Cholesky factorizations
    plus one triangular product (paper Sect. 3 "Computations").

    ``factor_plan`` routes both factorizations: ``None`` plans in-core vs
    blocked from the factor budget (``REPRO_FACTOR_BUDGET_MB``),
    ``"incore"`` / ``"blocked"`` force a path, a ``FactorPlan`` is used as
    it is. ``factor_stats`` receives the blocked path's device residency
    (both factorizations and T T^T)."""
    M = KMM.shape[0]
    plan = _resolve_factor_plan(KMM, factor_plan, rank_deficient)
    T, Q, TTt, diag_T = _shared_factor(KMM, D, jitter, rank_deficient, rank_tol,
                                       plan=plan, stats=factor_stats)
    A = _lam_factor(TTt, lam, M, plan=plan, stats=factor_stats, device=KMM.device)
    return Preconditioner(T=T, A=A, Q=Q, D=D,
                          n=torch.tensor(n, dtype=KMM.dtype, device=KMM.device),
                          diag_T=diag_T)
