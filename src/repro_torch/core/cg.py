"""Conjugate gradient for the FALKON preconditioned system.

Counterpart of ``repro/core/cg.py`` (the paper's Alg. 2 ``conjgrad``).
Multiple right-hand sides (b of shape (q,) or (q, p)) keep per-column
scalars, and converged columns become masked no-ops (``_masked_cg_update``).

Both drivers share one core (``_cg_solve``) and differ only in the loop:

* ``conjugate_gradient`` always runs all ``t`` matvecs — converged columns
  are masked, never skipped — so ``residual_norms`` is (t+1[, p]), exactly
  as the JAX package's fixed-length scan. It never reads a value back to
  the host inside the loop.
* ``conjugate_gradient_host`` may stop early once every column converged
  (one host read per iteration), truncating ``residual_norms`` to
  ``iterations + 1`` entries.

The reduced-storage iterates of the bf16 policy are ROADMAP item A7.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor


class CGResult(NamedTuple):
    x: Tensor
    residual_norms: Tensor  # (t+1,) or (t+1, p): ||r||_2 after each iteration
    iterations: Tensor      # scalar int: iterations actually applied (tol-aware)


def col_dot(u: Tensor, v: Tensor) -> Tensor:
    """Per-column inner products: (q,) -> scalar, (q, p) -> (p,)."""
    return torch.sum(u * v, dim=0)


def active_columns(rs: Tensor, tol_sq: Tensor) -> Tensor:
    """The per-column "still iterating" mask: rs above tol_sq (floored at
    1e-30 so a tol of 0 still masks exact zeros)."""
    return rs > torch.clamp(tol_sq, min=1e-30)


def _masked_cg_update(x, r, p, rs, Ap, tol_sq):
    """One CG update with PER-COLUMN convergence masking; returns the
    updated (x, r, p, rs, active) with ``active`` the pre-update mask."""
    active = active_columns(rs, tol_sq)
    denom = col_dot(p, Ap)
    a = torch.where(active & (denom > 1e-38), rs / torch.clamp(denom, min=1e-38),
                    torch.zeros_like(rs))
    x_new = x + a * p
    r_new = r - a * Ap
    rs_new = col_dot(r_new, r_new)
    beta = torch.where(active, rs_new / torch.clamp(rs, min=1e-38), torch.zeros_like(rs))
    p_new = r_new + beta * p
    x, r, p, rs = (torch.where(active, new, old) for new, old in
                   ((x_new, x), (r_new, r), (p_new, p), (rs_new, rs)))
    return x, r, p, rs, active


def _cg_init(matvec, b, x0):
    """Shared iterate/residual initialization; ``x0=None`` spends no matvec."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    return x, r, r, col_dot(r, r)


def _fixed_driver(matvec, state, t, tol_sq, res0):
    """All ``t`` matvecs, converged columns masked."""
    x, r, p, rs = state
    residuals = [res0]
    it = torch.zeros((), dtype=torch.int32, device=res0.device)
    for _ in range(t):
        Ap = matvec(p)
        x, r, p, rs, active = _masked_cg_update(x, r, p, rs, Ap, tol_sq)
        it = it + active.any().to(torch.int32)
        residuals.append(torch.sqrt(torch.clamp(rs, min=0.0))[None])
    return CGResult(x=x, residual_norms=torch.cat(residuals, dim=0), iterations=it)


def _host_driver(matvec, state, t, tol_sq, res0):
    """Stops early once every column has converged (each skipped iteration
    is a full data pass saved)."""
    x, r, p, rs = state
    residuals = [res0]
    it = 0
    for _ in range(t):
        if not bool(active_columns(rs, tol_sq).any()):
            break
        Ap = matvec(p)
        x, r, p, rs, _ = _masked_cg_update(x, r, p, rs, Ap, tol_sq)
        residuals.append(torch.sqrt(torch.clamp(rs, min=0.0))[None])
        it += 1
    return CGResult(x=x, residual_norms=torch.cat(residuals, dim=0),
                    iterations=torch.tensor(it, dtype=torch.int32))


def _cg_solve(matvec, b, t, tol, x0, driver):
    """Initialization, tolerance scaling and the ||b|| history head, shared
    by both drivers."""
    state = _cg_init(matvec, b, x0)
    bb = col_dot(b, b)
    tol_sq = (tol * tol) * torch.clamp(bb, min=1e-38)
    res0 = torch.sqrt(torch.clamp(bb, min=0.0))[None]
    return driver(matvec, state, t, tol_sq, res0)


def conjugate_gradient(matvec: Callable[[Tensor], Tensor], b: Tensor, t: int, *,
                       tol: float = 0.0, x0: Tensor | None = None) -> CGResult:
    """Run ``t`` CG iterations on ``matvec(x) = b``; with ``tol > 0`` columns
    whose residual dropped below ``tol * ||b||`` become masked no-ops."""
    return _cg_solve(matvec, b, t, tol, x0, _fixed_driver)


def conjugate_gradient_host(matvec: Callable[[Tensor], Tensor], b: Tensor, t: int, *,
                            tol: float = 0.0, x0: Tensor | None = None) -> CGResult:
    """Early-stopping twin of ``conjugate_gradient``: ``residual_norms`` has
    ``iterations + 1`` entries."""
    return _cg_solve(matvec, b, t, tol, x0, _host_driver)
