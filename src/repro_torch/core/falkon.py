"""FALKON solver (paper Alg. 1) — the in-core fit and its predictions.

Counterpart of the in-core part of ``repro/core/falkon.py``. The fit is the
same five-stage pipeline — select -> gram -> precondition -> solve -> wrap —
with every kernel evaluation on a ``KernelOps`` backend
(``FalkonConfig.ops_impl``): ``"cuda"`` (the hand-written Hopper kernels,
the default) or ``"torch"`` (the plain blocked reference). Entry points run
on ``FalkonConfig.device`` (default ``"cuda"``); on a machine without a
card that default raises rather than dropping to the CPU — pass
``device="cpu"`` to run there.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP.md item: the bf16 policy (A7), leverage-score centers and the
lam-path fit (A6), the K_nM cache (A11), a mesh (A14), streaming fits
(A8) and mini-batch fits (A12). A large M routes the factor to the blocked
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
from repro_torch.ops.base import require_fp32_policy

from .cg import conjugate_gradient
from .kernels import KernelFn, make_kernel
from .nystrom import NystromCenters, select_centers
from .preconditioner import Preconditioner, make_preconditioner

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
    center_selection: str = "uniform"      # "uniform" ("leverage": A6)
    block_size: int = 2048
    jitter: float | None = None
    rank_deficient: bool = False
    ops_impl: str = "cuda"                 # KernelOps backend: "cuda" | "torch"
    precision: str = "fp32"                # "fp32" ("bf16": A7)
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
        require_fp32_policy(resolve_precision(self.precision))   # A7
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
        if self.center_selection != "uniform":
            raise NotImplementedError(
                "leverage-score center selection is not ported yet: "
                "ROADMAP.md item A6")
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


# ----------------------------------------------------------------------------
# The solve
# ----------------------------------------------------------------------------
def _falkon_operator(matvec: Callable, precond: Preconditioner, lam,
                     n: int) -> Callable[[Tensor], Tensor]:
    """W(u) = B^T H B u via Alg. 1's nested-solve composition:
    W u = left(K_nM^T (K_nM gamma) / n) + lam-ridge(u), gamma = right(u)."""
    def W(u: Tensor) -> Tensor:
        gamma = precond.right(u)
        w = matvec(gamma) / n                     # K_nM^T K_nM gamma / n
        return precond.left(w) + precond.ridge(u, lam)

    return W


def falkon_solve(X: Tensor, y: Tensor, centers: Tensor, precond: Preconditioner,
                 kernel: KernelFn, lam: float, t: int, *, block_size: int = 2048,
                 ops_impl: str = "cuda", precision: str = "fp32", tol: float = 0.0,
                 estimate_cond: bool = True, ops: KernelOps | None = None) -> FalkonState:
    """Run t preconditioned-CG iterations; return coefficients + diagnostics.

    One right-hand-side sweep, t CG sweeps and, with ``estimate_cond``, the
    power iteration's 2 x (12 + 1) = 26 width-1 sweeps: 47 sweeps at t = 20.
    """
    n = X.shape[0]
    if ops is None:
        ops = get_ops(ops_impl, kernel, block_size=block_size, precision=precision)

    def matvec(g):
        return ops.sweep(X, centers, g, None)

    W = _falkon_operator(matvec, precond, lam, n)
    zeros = torch.zeros((centers.shape[0],) + tuple(y.shape[1:]), dtype=X.dtype,
                        device=X.device)
    b = precond.left(ops.sweep(X, centers, zeros, y) / n)   # r = B^T z / n (Alg. 1)
    cg = conjugate_gradient(W, b, t, tol=tol)
    alpha = precond.coeffs(cg.x)

    cond = torch.zeros((), dtype=X.dtype, device=X.device)
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


# ----------------------------------------------------------------------------
# The fit pipeline: select -> gram -> precondition -> solve -> wrap
# ----------------------------------------------------------------------------
def _stage_select(generator: torch.Generator, X: Tensor,
                  config: FalkonConfig) -> NystromCenters:
    """Stage 1 — Nystrom center selection."""
    M = min(config.num_centers, X.shape[0])
    return select_centers(generator, X, M, scheme=config.center_selection)


def _stage_gram(ops: KernelOps, centers: Tensor) -> Tensor:
    """Stage 2 — the M x M Gram block (the paper's memory budget)."""
    return ops.gram(centers, centers)


def _stage_precondition(KMM: Tensor, lam: float, n: int, config: FalkonConfig, *,
                        D: Tensor | None = None,
                        report: dict | None = None) -> Preconditioner:
    """Stage 3 — factorization (single lam; the lam path is A6), routed
    in-core or blocked by the factor budget. ``report``, when given,
    receives the plan's path and block and the blocked path's
    ``FactorStats`` (device peak, bytes moved, copy and tile seconds; all
    zero in-core)."""
    plan = plan_factor(KMM.shape[0], itemsize=max(KMM.dtype.itemsize, 4))
    stats = FactorStats()
    precond = make_preconditioner(KMM, lam, n, D=D, jitter=config.jitter,
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


def falkon_fit(generator: torch.Generator | int, X, y, config: FalkonConfig, *,
               ops: KernelOps | None = None,
               stage_times: dict | None = None) -> tuple[FalkonEstimator, FalkonState]:
    """Select centers, build the preconditioner, run the solve.

    ``generator`` draws the centers (an int seeds a new generator on
    ``config.device``). X and y (tensors or numpy arrays) are moved to
    ``config.device`` at ``config.dtype``. ``ops`` replaces the configured
    backend (e.g. a ``CountingOps``). ``stage_times``, when given, receives
    the synchronised wall time of each stage: centers, gram, factor, solve,
    and the factor plan's ``factor_path`` and ``factor_block`` with the
    blocked path's ``factor_stats``.
    """
    device = resolve_device(config.device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    kernel = config.make_kernel()
    if ops is None:
        ops = config.make_ops(kernel)
    dt = getattr(torch, config.dtype)
    X = torch.as_tensor(X, dtype=dt, device=device)
    y = torch.as_tensor(y, dtype=dt, device=device)
    n = X.shape[0]

    with _timed(stage_times, "centers", device):
        sel = _stage_select(generator, X, config)
    with _timed(stage_times, "gram", device):
        KMM = _stage_gram(ops, sel.centers)
    with _timed(stage_times, "factor", device):
        precond = _stage_precondition(KMM, config.lam, n, config, D=sel.D,
                                      report=stage_times)
    del KMM   # O(M^2) on the device; the solve needs only T and A
    with _timed(stage_times, "solve", device):
        state = falkon_solve(X, y, sel.centers, precond, kernel, config.lam,
                             config.iterations, tol=config.tol,
                             estimate_cond=config.estimate_cond, ops=ops)
    est = _stage_wrap(sel.centers, state.alpha, kernel, config, precond=precond,
                      lam=config.lam)
    return est, state


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP.md item {item}")
    fn.__name__ = fn.__qualname__ = name
    return fn


falkon_fit_path = _not_ported("falkon_fit_path", "A6")
falkon_fit_streaming = _not_ported("falkon_fit_streaming", "A8")
falkon_fit_minibatch = _not_ported("falkon_fit_minibatch", "A12")
