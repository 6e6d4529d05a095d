"""FALKON solver (paper Alg. 1) — the in-core fit, the lam path and predictions.

Counterpart of the in-core part of ``repro/core/falkon.py``. The fit is the
same five-stage pipeline — select -> gram -> precondition -> solve -> wrap —
with every kernel evaluation on a ``KernelOps`` backend
(``FalkonConfig.ops_impl``): ``"cuda"`` (the hand-written Hopper kernels,
the default) or ``"torch"`` (the plain blocked reference). Entry points run
on ``FalkonConfig.device`` (default ``"cuda"``); on a machine without a
card that default raises rather than dropping to the CPU — pass
``device="cpu"`` to run there.

``FalkonConfig(precision="bf16")`` runs the reference's end-to-end policy:
X, the centers the sweeps read, y and the CG iterates stored bfloat16 (X
quantized once per solve), every sweep accumulated in float32 with Kahan
carries, and K_MM, the factors and the coefficients float32.

``falkon_fit_path`` fits a grid of L regularizers at the data cost of one
fit: the L systems share the centers, K_MM and T, and are stacked as L*p
columns of every CG sweep (``falkon_solve_path``), which the "cuda" backend
runs in column groups of at most 4, one launch each. Centers may be drawn
by approximate leverage scores (``center_selection="leverage"``).

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP.md item: storage types other than float32 and bfloat16 (A7), the
K_nM cache (A11), a mesh (A14), streaming fits and solves (A8) and
mini-batch fits (A12). A large M routes the factor to the blocked
out-of-core Cholesky and the sweep off the fused route, as planned by
``plan_factor`` and ``plan_sweep``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.blocked_cholesky import FactorStats
from repro_torch.ops import KernelOps, available_ops, get_ops, plan_factor, resolve_precision
from repro_torch.ops.base import require_supported_policy

from .cg import CGResult, conjugate_gradient
from .kernels import KernelFn, make_kernel
from .matvec import _not_ported
from .nystrom import NystromCenters, select_centers
from .preconditioner import (Preconditioner, PreconditionerPath, make_preconditioner,
                             make_preconditioner_path)

Tensor = torch.Tensor

CENTER_SELECTIONS = ("uniform", "leverage")
KNM_CACHE_MODES = ("off", "auto", "device", "host")
DTYPES = ("float32", "float64")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device a fit runs on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class FalkonConfig:
    kernel: str = "gaussian"
    kernel_params: tuple = (("sigma", 1.0),)
    lam: float = 1e-6
    num_centers: int = 1024
    iterations: int = 20
    center_selection: str = "uniform"      # "uniform" | "leverage"
    pilot_size: int = 256                  # leverage-score pilot subset
    block_size: int = 2048
    jitter: float | None = None
    rank_deficient: bool = False
    ops_impl: str = "cuda"                 # KernelOps backend: "cuda" | "torch"
    precision: str = "fp32"                # "fp32" | "bf16" (end-to-end bf16 storage)
    tol: float = 0.0
    dtype: str = "float32"
    estimate_cond: bool = True             # power-iteration cond(W) diagnostic
    knm_cache: str = "off"                 # "off" (others: A11)
    mesh: object | None = None             # data-parallel mesh (A14)
    device: str = "cuda"

    def __post_init__(self):
        """Fail at config time on an unknown or unported option."""
        if self.ops_impl not in available_ops():
            raise ValueError(
                f"unknown ops_impl {self.ops_impl!r}; registered KernelOps "
                f"backends: {available_ops()}")
        require_supported_policy(resolve_precision(self.precision))   # A7
        if self.knm_cache not in KNM_CACHE_MODES:
            raise ValueError(f"unknown knm_cache {self.knm_cache!r}; "
                             f"supported: {KNM_CACHE_MODES}")
        if self.knm_cache != "off":
            raise NotImplementedError(
                f"knm_cache={self.knm_cache!r}: the K_nM cache is not ported "
                "yet: ROADMAP.md item A11")
        if self.center_selection not in CENTER_SELECTIONS:
            raise ValueError(f"unknown center_selection {self.center_selection!r}; "
                             f"supported: {CENTER_SELECTIONS}")
        if self.mesh is not None:
            raise NotImplementedError(
                "multi-device fits are not ported yet: ROADMAP.md item A14")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; supported: {DTYPES}")

    def make_kernel(self) -> KernelFn:
        return make_kernel(self.kernel, **dict(self.kernel_params))

    def make_ops(self, kernel: KernelFn | None = None) -> KernelOps:
        return get_ops(self.ops_impl,
                       kernel if kernel is not None else self.make_kernel(),
                       block_size=self.block_size, precision=self.precision)


class FalkonState(NamedTuple):
    """Everything needed to run / resume the iterative solve."""
    centers: Tensor
    precond: Preconditioner
    beta: Tensor
    alpha: Tensor
    residual_norms: Tensor
    cond_estimate: Tensor


class FalkonPathState(NamedTuple):
    """The lam-path twin of :class:`FalkonState`: one CG run, L systems."""
    centers: Tensor
    precond: PreconditionerPath
    beta: Tensor            # (q, L*p) stacked CG solution
    alphas: Tensor          # (L, M) or (L, M, p): per-lam coefficients
    residual_norms: Tensor  # (t+1, L*p) per-column residual history
    lams: Tensor            # (L,) the regularization grid


class FalkonEstimator(torch.nn.Module):
    """A fitted model: ``centers`` and ``alpha`` are buffers (they follow
    ``.to()`` and ``state_dict``); ``predict`` is one ``ops.apply``.

    ``precond`` and ``lam`` keep the fit-time factorization for the
    incremental path (``partial_fit``, ROADMAP item A12); they are plain
    attributes and do not follow ``.to()``.
    """

    def __init__(self, centers: Tensor, alpha: Tensor, kernel: KernelFn, *,
                 block_size: int = 2048, ops_impl: str = "cuda",
                 precision: str = "fp32", precond: Preconditioner | None = None,
                 lam: float | None = None):
        super().__init__()
        self.register_buffer("centers", centers)
        self.register_buffer("alpha", alpha)
        self.kernel = kernel
        self.block_size = block_size
        self.ops_impl = ops_impl
        self.precision = precision
        self.precond = precond
        self.lam = None if lam is None else float(lam)
        self.ops = get_ops(ops_impl, kernel, block_size=block_size, precision=precision)

    def predict(self, X) -> Tensor:
        """Score X: K(X, centers) @ alpha on the estimator's backend."""
        X = torch.as_tensor(X, dtype=self.centers.dtype, device=self.centers.device)
        return self.ops.apply(X, self.centers, self.alpha)

    def forward(self, X) -> Tensor:
        return self.predict(X)


class FalkonPathResult(NamedTuple):
    """Per-lam estimators, the shared solve's state and the validation
    selection."""
    estimators: tuple[FalkonEstimator, ...]
    state: FalkonPathState
    lams: tuple[float, ...]
    val_scores: Tensor | None   # (L,) validation MSE per lam (None: no val set)
    best_index: int | None      # argmin of val_scores (None: no val set)

    @property
    def best(self) -> FalkonEstimator | None:
        """The validation-selected estimator (None without a val set)."""
        return None if self.best_index is None else self.estimators[self.best_index]


# ----------------------------------------------------------------------------
# The solve
# ----------------------------------------------------------------------------
def _falkon_operator(matvec: Callable, precond: Preconditioner | PreconditionerPath, lam,
                     n: int) -> Callable[[Tensor], Tensor]:
    """W(u) = B^T H B u via Alg. 1's nested-solve composition:
    W u = left(K_nM^T (K_nM gamma) / n) + lam-ridge(u), gamma = right(u).
    With a :class:`PreconditionerPath` the same composition runs on the
    stacked (q, L*p) block, and the one sweep is lam-independent."""
    def W(u: Tensor) -> Tensor:
        u = u.to(precond.T.dtype)                 # a bf16 CG iterate, widened
        gamma = precond.right(u)
        w = matvec(gamma) / n                     # K_nM^T K_nM gamma / n
        return precond.left(w) + precond.ridge(u, lam)

    return W


def _cg_storage(ops: KernelOps) -> torch.dtype | None:
    """The CG iterates' storage type under the backend's policy: None (full
    precision) under float32 storage, else the storage type (x/r/p bf16,
    every scalar float32). The reference's ``_cg_storage``."""
    pol = getattr(ops, "policy", None)
    if pol is None or pol.storage == "float32":
        return None
    return getattr(torch, pol.storage)


def _stored(ops: KernelOps, *tensors: Tensor) -> tuple[Tensor, ...]:
    """The tensors every sweep reads, quantized once to the policy's storage
    type (under float32 storage: as they are), so that no sweep casts them
    again."""
    storage = _cg_storage(ops)
    if storage is None:
        return tensors
    return tuple(a.to(storage).contiguous() for a in tensors)


def falkon_solve(X: Tensor, y: Tensor, centers: Tensor, precond: Preconditioner,
                 kernel: KernelFn, lam: float, t: int, *, block_size: int = 2048,
                 ops_impl: str = "cuda", precision: str = "fp32", tol: float = 0.0,
                 estimate_cond: bool = True, ops: KernelOps | None = None) -> FalkonState:
    """Run t preconditioned-CG iterations; return coefficients + diagnostics.

    One right-hand-side sweep, t CG sweeps and, with ``estimate_cond``, the
    power iteration's 2 x (12 + 1) = 26 width-1 sweeps: 47 sweeps at t = 20.
    Under a reduced-storage policy X, the centers and y are quantized to
    storage once here, so that no sweep casts them again, and the CG
    iterates are stored at that width (``beta`` comes back at it).
    """
    n = X.shape[0]
    if ops is None:
        ops = get_ops(ops_impl, kernel, block_size=block_size, precision=precision)
    dt = precond.T.dtype   # the solve's type: K_MM's, the coefficients'
    storage = _cg_storage(ops)
    Xs, Cs, ys = _stored(ops, X, centers, y)

    def matvec(g):
        return ops.sweep(Xs, Cs, g, None)

    W = _falkon_operator(matvec, precond, lam, n)
    zeros = torch.zeros((centers.shape[0],) + tuple(y.shape[1:]), dtype=dt, device=X.device)
    b = precond.left(ops.sweep(Xs, Cs, zeros, ys) / n)   # r = B^T z / n (Alg. 1)
    cg = conjugate_gradient(W, b, t, tol=tol, storage_dtype=storage)
    alpha = precond.coeffs(cg.x.to(dt))

    cond = torch.zeros((), dtype=dt, device=X.device)
    if estimate_cond:
        # power iteration on W, then on lam_max I - W, for cond(W) (Thm 2)
        q = precond.q
        shape = (q,) + (1,) * (b.ndim - 1)

        def power(mv, iters=12):
            v = torch.ones(q, dtype=b.dtype, device=b.device) / math.sqrt(q)
            for _ in range(iters):
                w = mv(v)
                v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
            return torch.dot(v, mv(v))

        lam_max = power(lambda v: W(v.reshape(shape)).reshape(q))
        lam_min = lam_max - power(lambda v: lam_max * v - W(v.reshape(shape)).reshape(q))
        cond = torch.abs(lam_max) / torch.clamp(torch.abs(lam_min), min=1e-30)

    return FalkonState(centers=centers, precond=precond, beta=cg.x, alpha=alpha,
                       residual_norms=cg.residual_norms, cond_estimate=cond)


def _solve_path_core(matvec: Callable, rhs_sweep: Callable, precond: PreconditionerPath,
                     n: int, t: int, *, tol: float,
                     storage: torch.dtype | None) -> tuple[CGResult, Tensor]:
    """The shared lam-path solve: ONE right-hand-side sweep and t stacked
    CG sweeps serve all L systems; returns the CG result and the (M, L*p)
    coefficients."""
    b = precond.expand_rhs(rhs_sweep() / n)   # (q, L*p): per-system A^{-T} only
    W = _falkon_operator(matvec, precond, None, n)
    cg = conjugate_gradient(W, b, t, tol=tol, storage_dtype=storage)
    return cg, precond.coeffs(cg.x.to(precond.T.dtype))


def falkon_solve_path(X: Tensor, y: Tensor, centers: Tensor, precond: PreconditionerPath,
                      t: int, *, ops: KernelOps, tol: float = 0.0) -> FalkonPathState:
    """Solve the FALKON system for every lam in ``precond.lams`` at the data
    cost of ONE solve: per CG iteration a single ``ops.sweep`` of column
    width L*p (on the "cuda" backend ceil(L*p / 4) launches) instead of L
    sweeps of width p, plus one right-hand-side sweep of width p: t + 1
    sweeps for any L. Per-column convergence masking (``tol``) masks each
    system on its own. Under a reduced-storage policy X, the centers and y
    are quantized once and the CG iterates stored at that width, as in
    :func:`falkon_solve`."""
    n = X.shape[0]
    dt = precond.T.dtype
    Xs, Cs, ys = _stored(ops, X, centers, y)

    def matvec(G):
        return ops.sweep(Xs, Cs, G, None)

    def rhs_sweep():
        zeros = torch.zeros((centers.shape[0],) + tuple(y.shape[1:]), dtype=dt,
                            device=X.device)
        return ops.sweep(Xs, Cs, zeros, ys)

    cg, alpha_flat = _solve_path_core(matvec, rhs_sweep, precond, n, t, tol=tol,
                                      storage=_cg_storage(ops))
    alphas = precond.split(alpha_flat)             # (L, M, p)
    if y.ndim == 1:
        alphas = alphas[..., 0]
    return FalkonPathState(centers=centers, precond=precond, beta=cg.x, alphas=alphas,
                           residual_norms=cg.residual_norms, lams=precond.lams)


# ----------------------------------------------------------------------------
# The fit pipeline: select -> gram -> precondition -> solve -> wrap
# ----------------------------------------------------------------------------
def _stage_select(generator: torch.Generator, X: Tensor, config: FalkonConfig,
                  kernel: KernelFn, *, lam: float | None = None) -> NystromCenters:
    """Stage 1 — Nystrom center selection. ``lam`` overrides ``config.lam``
    for leverage scoring (the path fit scores at the grid's geometric
    mean)."""
    M = min(config.num_centers, X.shape[0])
    return select_centers(generator, X, M, kernel=kernel,
                          lam=config.lam if lam is None else lam,
                          scheme=config.center_selection, pilot_size=config.pilot_size)


def _stage_gram(ops: KernelOps, centers: Tensor) -> Tensor:
    """Stage 2 — the M x M Gram block (the paper's memory budget)."""
    return ops.gram(centers, centers)


def _stage_precondition(KMM: Tensor, lam, n: int, config: FalkonConfig, *,
                        D: Tensor | None = None,
                        report: dict | None = None) -> Preconditioner | PreconditionerPath:
    """Stage 3 — factorization, routed in-core or blocked by the factor
    budget: a scalar ``lam`` builds the single :class:`Preconditioner`, a
    grid (a sequence) the :class:`PreconditionerPath`. ``report``, when
    given, receives the plan's path and block and the blocked path's
    ``FactorStats`` (device peak, bytes moved, copy and tile seconds, host
    copies of T T^T; all zero in-core)."""
    plan = plan_factor(KMM.shape[0], itemsize=max(KMM.dtype.itemsize, 4))
    stats = FactorStats()
    build = make_preconditioner if isinstance(lam, (int, float)) else make_preconditioner_path
    precond = build(KMM, lam, n, D=D, jitter=config.jitter,
                    rank_deficient=config.rank_deficient, factor_plan=plan,
                    factor_stats=stats)
    if report is not None:
        report.update(factor_path=plan.path, factor_block=plan.block, factor_stats=stats)
    return precond


def _stage_wrap(centers: Tensor, alpha: Tensor, kernel: KernelFn, config: FalkonConfig,
                *, precond: Preconditioner | None = None,
                lam: float | None = None) -> FalkonEstimator:
    """Stage 5 — bind coefficients + backend knobs into the estimator."""
    return FalkonEstimator(centers, alpha, kernel, block_size=config.block_size,
                           ops_impl=config.ops_impl, precision=config.precision,
                           precond=precond, lam=lam)


@contextlib.contextmanager
def _timed(times: dict | None, name: str, device: torch.device):
    """Record the stage's wall time, synchronised, when ``times`` is given."""
    if times is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = time.perf_counter() - t0


def _fit_front(generator, X, y, config: FalkonConfig, ops: KernelOps | None, lam,
               stage_times: dict | None, select_lam: float | None = None):
    """The stages both fits share: X and y to ``config.device`` at
    ``config.dtype``, the centers (drawn by ``generator``, an int seeding a
    new one on the device; leverage scores at ``select_lam``, default
    ``config.lam``), X and y quantized once to a reduced storage type after
    the centers are drawn from the full-precision X (K_MM stays float32),
    K_MM, and the factorization at ``lam`` (a scalar or a grid). Returns
    (device, kernel, ops, X, y, centers, preconditioner)."""
    device = resolve_device(config.device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    kernel = config.make_kernel()
    if ops is None:
        ops = config.make_ops(kernel)
    dt = getattr(torch, config.dtype)
    X = torch.as_tensor(X, dtype=dt, device=device)
    y = torch.as_tensor(y, dtype=dt, device=device)

    with _timed(stage_times, "centers", device):
        sel = _stage_select(generator, X, config, kernel, lam=select_lam)
    storage = _cg_storage(ops)
    if storage is not None:
        X, y = X.to(storage), y.to(storage)
    with _timed(stage_times, "gram", device):
        KMM = _stage_gram(ops, sel.centers)
    with _timed(stage_times, "factor", device):
        precond = _stage_precondition(KMM, lam, X.shape[0], config, D=sel.D,
                                      report=stage_times)
    del KMM   # O(M^2) on the device; the solve needs only T and A
    return device, kernel, ops, X, y, sel, precond


def falkon_fit(generator: torch.Generator | int, X, y, config: FalkonConfig, *,
               ops: KernelOps | None = None,
               stage_times: dict | None = None) -> tuple[FalkonEstimator, FalkonState]:
    """Select centers, build the preconditioner, run the solve.

    ``generator`` draws the centers (an int seeds a new generator on
    ``config.device``). X and y (tensors or numpy arrays) are moved to
    ``config.device`` at ``config.dtype``; under ``precision="bf16"`` they
    are quantized to bfloat16 once the centers are drawn. ``ops`` replaces
    the configured backend (e.g. a ``CountingOps``). ``stage_times``, when
    given, receives
    the synchronised wall time of each stage: centers, gram, factor, solve,
    and the factor plan's ``factor_path`` and ``factor_block`` with the
    blocked path's ``factor_stats``.
    """
    device, kernel, ops, X, y, sel, precond = _fit_front(generator, X, y, config, ops,
                                                         config.lam, stage_times)
    with _timed(stage_times, "solve", device):
        state = falkon_solve(X, y, sel.centers, precond, kernel, config.lam,
                             config.iterations, tol=config.tol,
                             estimate_cond=config.estimate_cond, ops=ops)
    est = _stage_wrap(sel.centers, state.alpha, kernel, config, precond=precond,
                      lam=config.lam)
    return est, state


def _score_path(ops: KernelOps, centers: Tensor, alphas: Tensor, X_val: Tensor,
                y_val: Tensor) -> tuple[Tensor, int]:
    """Validation MSE per lam with ONE stacked apply over the val set: the
    (L, M[, p]) alphas as M x L*p columns (on the "cuda" backend
    ceil(L*p / 4) launches of B2)."""
    L, M = alphas.shape[:2]
    p = alphas.shape[2] if alphas.ndim > 2 else 1
    flat = alphas.reshape(L, M, p).permute(1, 0, 2).reshape(M, L * p)
    preds = ops.apply(X_val, centers, flat).reshape(X_val.shape[0], L, p)
    yv = y_val.reshape(y_val.shape[0], 1, p).to(preds.dtype)
    scores = torch.mean((preds - yv) ** 2, dim=(0, 2))   # (L,)
    return scores, int(torch.argmin(scores))


def _check_lams(lams) -> tuple[float, ...]:
    vals = tuple(float(lam) for lam in lams)
    if not vals:
        raise ValueError("lams must be a non-empty grid of regularizers")
    if any(lam <= 0.0 for lam in vals):
        raise ValueError(f"every lam in the path must be > 0, got {vals}")
    return vals


def falkon_fit_path(generator: torch.Generator | int, X, y, config: FalkonConfig, lams, *,
                    X_val=None, y_val=None, ops: KernelOps | None = None,
                    stage_times: dict | None = None) -> FalkonPathResult:
    """Fit the whole regularization path ``lams`` in one fit's data sweeps.

    The pipeline of :func:`falkon_fit` (``config.lam`` is replaced by the
    grid): the centers (and under ``center_selection="leverage"`` the
    diagonal D, scored at the grid's geometric-mean lam) are shared by every
    lam, which is what makes the sweep lam-independent; stage 3 builds the
    :class:`PreconditionerPath` and stage 4 runs :func:`falkon_solve_path`,
    t + 1 sweeps of width L*p. With ``X_val`` and ``y_val`` every estimator
    is scored by one stacked apply and ``result.best`` is the argmin-MSE
    model. ``stage_times`` receives what :func:`falkon_fit` records, and
    ``score`` with a val set."""
    lam_vals = _check_lams(lams)
    if (X_val is None) != (y_val is None):
        raise ValueError("X_val and y_val must be given together")
    lam_ref = math.exp(sum(math.log(lam) for lam in lam_vals) / len(lam_vals))
    device, kernel, ops, X, y, sel, precond = _fit_front(generator, X, y, config, ops,
                                                         lam_vals, stage_times, lam_ref)
    with _timed(stage_times, "solve", device):
        state = falkon_solve_path(X, y, sel.centers, precond, config.iterations, ops=ops,
                                  tol=config.tol)
    ests = tuple(_stage_wrap(sel.centers, state.alphas[i], kernel, config,
                             precond=precond.system(i), lam=lam)
                 for i, lam in enumerate(lam_vals))
    val_scores = best = None
    if X_val is not None:
        with _timed(stage_times, "score", device):
            dt = getattr(torch, config.dtype)
            val_scores, best = _score_path(
                ops, sel.centers, state.alphas,
                torch.as_tensor(X_val, dtype=dt, device=device),
                torch.as_tensor(y_val, dtype=dt, device=device))
    return FalkonPathResult(estimators=ests, state=state, lams=lam_vals,
                            val_scores=val_scores, best_index=best)


falkon_fit_streaming = _not_ported("falkon_fit_streaming", "A8")
falkon_solve_streaming = _not_ported("falkon_solve_streaming", "A8")
falkon_fit_path_streaming = _not_ported("falkon_fit_path_streaming", "A8")
falkon_solve_path_streaming = _not_ported("falkon_solve_path_streaming", "A8")
falkon_fit_minibatch = _not_ported("falkon_fit_minibatch", "A12")
