"""Nystrom center selection (paper Appendix A).

Counterpart of ``repro/core/nystrom.py``. Two sampling schemes:

* **uniform**: M distinct rows of X, uniformly at random (Alg. 1); D = I.
* **approximate leverage scores** (Def. 1): M indices drawn with
  replacement with p_i proportional to approximate ridge leverage scores,
  and the Def. 2 diagonal ``D_jj = 1 / sqrt(n * p_{i_j})``. Duplicates stay
  repeated rows (Alg. 2's ``discrete_prob_sample``, each draw counted once).

The scalable estimator uses a uniform pilot subset S of M0 rows and the
Nystrom/Woodbury identity

    lhat_lambda(i) = k_{iS}^T (lambda n K_SS + K_Sn K_nS)^{-1} k_{iS}

in O(n M0^2) time, split into a lambda-independent pilot stage
(``build_leverage_pilot``: draw S, K_SS, K_Sn K_nS over row blocks) and a
per-lambda stage (``leverage_scores_from_pilot``), so a lambda grid builds
the pilot once (``approximate_leverage_scores_path``). Exact scores
(``exact_leverage_scores``, O(n^3)) are for tests.

Every draw comes from an explicit ``torch.Generator``: the uniform rows and
the pilot from ``torch.randperm``, the leverage draw by inverse CDF
(``torch.rand``, then ``torch.searchsorted`` on a float64 cumulative sum;
``torch.multinomial`` refuses more than 2^24 categories). They cannot match
``jax.random`` draws, so parity tests hand the reference's centers over.
The kernel blocks are evaluated with the plain ``KernelFn`` and IEEE fp32
matmuls (TF32 off), as the reference evaluates them outside any kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.blocked_cholesky import _fp32_matmul
from repro_torch.ops.torch_backend import _pad_blocks

from .kernels import KernelFn

Tensor = torch.Tensor


class NystromCenters(NamedTuple):
    centers: Tensor       # (M, d)
    indices: Tensor       # (M,) indices into X
    D: Tensor | None      # (M,) Def. 2 diagonal; None for uniform sampling


def _distinct_rows(generator: torch.Generator, n: int, M: int, device) -> Tensor:
    """M distinct indices in [0, n), uniformly at random."""
    return torch.randperm(n, generator=generator, device=generator.device)[:M].to(device)


def uniform_centers(generator: torch.Generator, X: Tensor, M: int) -> NystromCenters:
    """M distinct rows of X, uniformly at random (without replacement)."""
    idx = _distinct_rows(generator, X.shape[0], M, X.device)
    return NystromCenters(centers=X[idx], indices=idx, D=None)


def exact_leverage_scores(X: Tensor, kernel: KernelFn, lam: float) -> Tensor:
    """Exact ridge leverage scores ``diag(K (K + lam n I)^{-1})`` (O(n^3);
    for tests and small n only)."""
    n = X.shape[0]
    with _fp32_matmul():
        Knn = kernel(X, X)
        eye = torch.eye(n, dtype=Knn.dtype, device=Knn.device)
        return torch.diagonal(torch.linalg.solve(Knn + lam * n * eye, Knn))


class LeveragePilot(NamedTuple):
    """The lambda-independent half of the leverage-score estimator."""
    S: Tensor          # (M0, d) pilot subset
    KSS: Tensor        # (M0, M0) pilot Gram
    KSnKnS: Tensor     # (M0, M0) accumulated K_Sn K_nS (the O(n M0^2) pass)
    indices: Tensor    # (M0,) pilot row indices into X
    n: int             # rows the pilot was built over


def _blocked_rows(X: Tensor, block_size: int) -> tuple[Tensor, Tensor]:
    """(nb, block, d) row blocks of X, zero-padded, and the (nb, block)
    validity mask (the plain backend's row blocking)."""
    Xb, mask, _, _ = _pad_blocks(X, None, block_size)
    return Xb, mask


def build_leverage_pilot(generator: torch.Generator, X: Tensor, kernel: KernelFn, *,
                         pilot_size: int = 256, block_size: int = 4096) -> LeveragePilot:
    """Stage 1 — the pilot-Gram build, everything lambda never touches: one
    O(n M0^2) pass accumulates K_Sn K_nS = sum over row blocks of
    K_bS^T K_bS."""
    n = X.shape[0]
    M0 = min(pilot_size, n)
    pilot_idx = _distinct_rows(generator, n, M0, X.device)
    S = X[pilot_idx]
    with _fp32_matmul():
        KSS = kernel(S, S)
        Xb, mask = _blocked_rows(X, block_size)
        KSnKnS = torch.zeros((M0, M0), dtype=X.dtype, device=X.device)
        for xb, mb in zip(Xb, mask):
            Kb = kernel(xb, S) * mb[:, None]
            KSnKnS += Kb.T @ Kb
    return LeveragePilot(S=S, KSS=KSS, KSnKnS=KSnKnS, indices=pilot_idx, n=n)


def leverage_scores_from_pilot(pilot: LeveragePilot, X: Tensor, kernel: KernelFn, lam: float,
                               *, block_size: int = 4096) -> Tensor:
    """Stage 2 — score the rows at one ridge value from a built pilot: one
    O(M0^3) Cholesky of G = lam n K_SS + K_Sn K_nS and a blocked scoring
    pass; the pilot-Gram accumulation is not repeated."""
    M0 = pilot.S.shape[0]
    n = X.shape[0]
    with _fp32_matmul():
        G = lam * pilot.n * pilot.KSS + pilot.KSnKnS
        G = G + 1e-6 * torch.trace(G) / M0 * torch.eye(M0, dtype=G.dtype, device=G.device)
        chol = torch.linalg.cholesky(G)
        Xb, _ = _blocked_rows(X, block_size)
        scores = []
        for xb in Xb:
            KbS = kernel(xb, pilot.S)                        # (b, M0)
            sol = torch.cholesky_solve(KbS.T, chol)          # (M0, b)
            scores.append(torch.sum(KbS.T * sol, dim=0))     # (b,)
    return torch.clamp(torch.cat(scores)[:n], min=1e-12)


def approximate_leverage_scores(generator: torch.Generator, X: Tensor, kernel: KernelFn,
                                lam: float, *, pilot_size: int = 256,
                                block_size: int = 4096) -> Tensor:
    """Nystrom/Woodbury approximate ridge leverage scores, O(n M0^2): the
    single-lambda composition of the two stages."""
    pilot = build_leverage_pilot(generator, X, kernel, pilot_size=pilot_size,
                                 block_size=block_size)
    return leverage_scores_from_pilot(pilot, X, kernel, lam, block_size=block_size)


def approximate_leverage_scores_path(generator: torch.Generator, X: Tensor, kernel: KernelFn,
                                     lams, *, pilot_size: int = 256,
                                     block_size: int = 4096) -> Tensor:
    """(L, n) leverage scores over a lambda grid from ONE pilot-Gram build."""
    pilot = build_leverage_pilot(generator, X, kernel, pilot_size=pilot_size,
                                 block_size=block_size)
    return torch.stack([leverage_scores_from_pilot(pilot, X, kernel, float(lam),
                                                   block_size=block_size)
                        for lam in lams])


def leverage_score_centers(generator: torch.Generator, X: Tensor, M: int,
                           scores: Tensor) -> NystromCenters:
    """Draw M centers with replacement, p_i = scores_i / sum(scores), by
    inverse CDF; D_jj = 1/sqrt(n p_{i_j}) (Def. 2 / Def. 6: the 1/M lives
    in G_M, so D itself is 1/sqrt(n p)). Duplicates stay repeated rows."""
    n = X.shape[0]
    p = scores / torch.sum(scores)
    cdf = torch.cumsum(p.double(), dim=0)
    r = torch.rand(M, generator=generator, device=generator.device, dtype=torch.float64)
    r = r.to(cdf.device) * cdf[-1]
    idx = torch.searchsorted(cdf, r, right=True).clamp_(max=n - 1).to(X.device)
    D = 1.0 / torch.sqrt(n * p[idx])
    return NystromCenters(centers=X[idx], indices=idx, D=D.to(X.dtype))


def select_centers(generator: torch.Generator, X: Tensor, M: int, *,
                   kernel: KernelFn | None = None, lam: float | None = None,
                   scheme: str = "uniform", pilot_size: int = 256) -> NystromCenters:
    """Nystrom centers by ``scheme``. ``"leverage"`` takes its two draws,
    the pilot and the centers, in turn from the one ``generator``."""
    if scheme == "uniform":
        return uniform_centers(generator, X, M)
    if scheme == "leverage":
        if kernel is None or lam is None:
            raise ValueError("leverage-score centers need the kernel and lam")
        scores = approximate_leverage_scores(generator, X, kernel, lam, pilot_size=pilot_size)
        return leverage_score_centers(generator, X, M, scores)
    raise ValueError(f"unknown center-selection scheme {scheme!r}")
