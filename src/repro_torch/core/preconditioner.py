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
place too; the finished T and A go to K_MM's device for the solves.

The lam path (``make_preconditioner_path``) runs the shared stage once and
the lam stage once per value of a grid of L, into a :class:`PreconditionerPath`
whose A is an (L, q, q) stack on K_MM's device, acting on (q, L*p) blocks:
L systems stacked along the column axis, so that one data sweep serves them
all. The stack is built one lam at a time on both routes: in-core, each A
is one ``torch.linalg.cholesky`` copied into its slot of the stack (the
device holds the stack, T T^T and two (q, q) temporaries, not a second
stack); blocked, each lam factors its own host copy of T T^T, since the
blocked Cholesky factors in place (the copies' bytes go to
``FactorStats.host_copy_bytes``). The stack itself stays L dense factors on
the device on either route.
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


def _from_q(T: Tensor, diag_T: bool, Q: Tensor | None, D: Tensor | None, v: Tensor) -> Tensor:
    """D Q T^{-1} v: (q, ...) -> (M, ...), the shared half of ``right``."""
    v = _solve_T(T, diag_T, v)
    if Q is not None:
        v = Q @ v
    if D is not None:
        v = v * _bcast(D, v)
    return v


def _to_q(T: Tensor, diag_T: bool, Q: Tensor | None, D: Tensor | None, w: Tensor) -> Tensor:
    """T^{-T} Q^T D w: (M, ...) -> (q, ...), the shared half of ``left``."""
    if D is not None:
        w = w * _bcast(D, w)
    if Q is not None:
        w = Q.T @ w
    return _solve_T(T, diag_T, w, trans=True)


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

    def right(self, u: Tensor) -> Tensor:
        """gamma = D Q T^{-1} A^{-1} u : (q,...) -> (M,...) (sqrt(n) * B u)."""
        return _from_q(self.T, self.diag_T, self.Q, self.D, _tri_solve(self.A, u, upper=True))

    def left(self, w: Tensor) -> Tensor:
        """A^{-T} T^{-T} Q^T D w : (M,...) -> (q,...)."""
        return _tri_solve(self.A.mT, _to_q(self.T, self.diag_T, self.Q, self.D, w), upper=False)

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


@dataclasses.dataclass(frozen=True)
class PreconditionerPath:
    """L preconditioners sharing T, Q and D, differing only in the
    lam-ridge A (counterpart of the reference's ``PreconditionerPath``).

    The maps act on stacked column blocks: a (q, L*p) tensor whose column
    group ``[l*p:(l+1)*p]`` belongs to system l (lam = ``lams[l]``). The
    shared factors apply to the whole block in one solve; only the per-system
    A solves run over the (L, q, q) stack, batched."""

    T: Tensor            # (q, q) shared factor (diagonal in the eig path)
    A: Tensor            # (L, q, q) per-lam upper-triangular stack
    Q: Tensor | None     # (M, q) shared partial isometry
    D: Tensor | None     # (M,) shared sampling-weight diagonal
    lams: Tensor         # (L,) the grid: A[l] = chol(T T^T / M + lams[l] I)
    n: Tensor            # number of training points (scalar)
    diag_T: bool = False

    @property
    def q(self) -> int:
        return self.T.shape[0]

    @property
    def L(self) -> int:
        return self.A.shape[0]

    def _group(self, U: Tensor) -> Tensor:
        """(q, L*p) -> (L, q, p): split the column axis into systems."""
        q, cols = U.shape
        return U.reshape(q, self.L, cols // self.L).permute(1, 0, 2)

    @staticmethod
    def _ungroup(G: Tensor) -> Tensor:
        """(L, q, p) -> (q, L*p): inverse of ``_group``."""
        L, q, p = G.shape
        return G.permute(1, 0, 2).reshape(q, L * p)

    def solve_A(self, U: Tensor, trans: bool = False) -> Tensor:
        """Per-system A_l^{-1} (or A_l^{-T}) over the column groups of U:
        one batched triangular solve over the stack."""
        A = self.A.mT if trans else self.A
        return self._ungroup(torch.linalg.solve_triangular(A, self._group(U), upper=not trans))

    def col_lams(self, U: Tensor) -> Tensor:
        """lams broadcast to U's columns: lam_l repeated p times."""
        return self.lams.repeat_interleave(U.shape[1] // self.L)

    def right(self, U: Tensor) -> Tensor:
        """gamma_l = D Q T^{-1} A_l^{-1} u_l, stacked: (q, L*p) -> (M, L*p)."""
        return _from_q(self.T, self.diag_T, self.Q, self.D, self.solve_A(U))

    def left(self, W: Tensor) -> Tensor:
        """A_l^{-T} T^{-T} Q^T D w_l, stacked: (M, L*p) -> (q, L*p)."""
        return self.solve_A(_to_q(self.T, self.diag_T, self.Q, self.D, W), trans=True)

    def coeffs(self, beta: Tensor) -> Tensor:
        """alpha_l = D Q T^{-1} A_l^{-1} beta_l, stacked over columns."""
        return self.right(beta)

    def ridge(self, U: Tensor, lams=None) -> Tensor:
        """lam_l * A_l^{-T} A_l^{-1} u_l per column group of U. ``lams`` is
        unused (the grid is part of the factorization); it keeps the
        ``Preconditioner.ridge`` calling convention."""
        return self.solve_A(self.solve_A(U), trans=True) * self.col_lams(U)[None, :]

    def expand_rhs(self, w: Tensor) -> Tensor:
        """The lam-independent right-hand side ``w = K_nM^T y / n``, (M,) or
        (M, p), expanded to the stacked (q, L*p) CG right-hand side: the
        shared D, Q and T^{-T} once, then each system's A_l^{-T}."""
        if w.ndim == 1:
            w = w[:, None]
        shared = _to_q(self.T, self.diag_T, self.Q, self.D, w)           # (q, p)
        per = torch.linalg.solve_triangular(self.A.mT, shared.expand(self.L, *shared.shape),
                                            upper=False)                  # (L, q, p)
        return self._ungroup(per)

    def split(self, stacked: Tensor) -> Tensor:
        """(rows, L*p) -> (L, rows, p): per-system views of a stacked block."""
        rows, cols = stacked.shape
        return stacked.reshape(rows, self.L, cols // self.L).permute(1, 0, 2)

    def system(self, index: int) -> Preconditioner:
        """The single-lam :class:`Preconditioner` of system ``index``."""
        return Preconditioner(T=self.T, A=self.A[index], Q=self.Q, D=self.D, n=self.n,
                              diag_T=self.diag_T)


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
    place (it is spoiled for another lam); A comes back on ``device``.
    In-core, lam is added to the diagonal of T T^T / M, which is the sum
    with lam I bit for bit, without an identity matrix."""
    if plan is not None and plan.path == "blocked":
        TTt /= M
        TTt.diagonal().add_(float(lam))
        Ah = blocked_cholesky(TTt, plan.block, stats=stats, device=device, overwrite=True)
        return Ah.to(device)
    B = TTt / M
    B.diagonal().add_(lam)
    return torch.linalg.cholesky(B).mT


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


def make_preconditioner_path(KMM: Tensor, lams, n: int, *, D: Tensor | None = None,
                             jitter: float | None = None, rank_deficient: bool = False,
                             rank_tol: float = 1e-7, factor_plan=None,
                             factor_stats: FactorStats | None = None) -> PreconditionerPath:
    """One shared factorization, then one A per lam of the grid ``lams``
    (1-D, non-empty, each > 0), routed as in :func:`make_preconditioner`.

    The stack is built one lam at a time on K_MM's device: L * q^2 floats
    (at M = 10^4, 400 MB a lam). On the blocked route every lam but the last
    factors a host copy of T T^T, because the blocked Cholesky factors its
    input in place; ``factor_stats.host_copy_bytes`` counts those copies."""
    M = KMM.shape[0]
    dt, dev = KMM.dtype, KMM.device
    lams = torch.as_tensor(lams, dtype=dt).to(dev)
    if lams.ndim != 1 or lams.shape[0] < 1:
        raise ValueError(f"lams must be a non-empty 1-D grid, got shape {tuple(lams.shape)}")
    lam_vals = lams.tolist()
    if any(lam <= 0.0 for lam in lam_vals):
        # a non-positive ridge makes T T^T / M + lam I indefinite
        raise ValueError(f"every lam in the path must be > 0, got {tuple(lam_vals)}")
    plan = _resolve_factor_plan(KMM, factor_plan, rank_deficient)
    T, Q, TTt, diag_T = _shared_factor(KMM, D, jitter, rank_deficient, rank_tol,
                                       plan=plan, stats=factor_stats)
    q = T.shape[0]
    L = len(lam_vals)
    Ls = torch.empty((L, q, q), dtype=T.dtype, device=dev)   # lower factors, A = Ls.mT
    blocked = plan.path == "blocked"
    for i, lam in enumerate(lam_vals):
        src = TTt
        if blocked and i < L - 1:
            src = TTt.clone()
            if factor_stats is not None:
                factor_stats.host_copy_bytes += src.numel() * src.element_size()
        Ls[i] = _lam_factor(src, lam, M, plan=plan, stats=factor_stats, device=dev).mT
    return PreconditionerPath(T=T, A=Ls.mT, Q=Q, D=D, lams=lams,
                              n=torch.tensor(n, dtype=dt, device=dev), diag_T=diag_T)
