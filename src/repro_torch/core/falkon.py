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
carries, and K_MM, the factors and the coefficients float32. A
``PrecisionPolicy`` with float16 storage runs the same way.

``FalkonConfig(knm_cache=...)`` trades memory for time: ``"device"`` or
``"host"`` (forced) or ``"auto"`` (routed by ``plan_cache``'s budgets, with
a ``CachePlanWarning`` off the device tier) materializes K_nM once
(``repro_torch.ops.KernelCache``: on the card one B3 launch a row tile),
and the right-hand side, every CG matvec, the cond(W) power iteration and
all L systems of a path fit are GEMMs over the stored entries.
``FalkonEstimator.build_knm_cache`` does the same for a fixed scoring set.

``falkon_fit_path`` fits a grid of L regularizers at the data cost of one
fit: the L systems share the centers, K_MM and T, and are stacked as L*p
columns of every CG sweep (``falkon_solve_path``), which the "cuda" backend
runs in column groups of at most 4, one launch each. Centers may be drawn
by approximate leverage scores (``center_selection="leverage"``).

``falkon_fit_streaming`` and ``falkon_fit_path_streaming`` fit from a
host ``ChunkSource`` (``repro_torch.data.streaming``): X is never resident
on the device at once, every CG pass streams its chunks through a
``StreamingLoader``, and ``FalkonEstimator.predict_stream`` scores a
stream the same way.

``falkon_fit_minibatch`` and ``falkon_fit_minibatch_streaming`` solve by
stochastic preconditioned chunk sweeps with delayed projections
(``repro_torch.core.minibatch``: on the card one B1 launch a step), and
``FalkonEstimator.partial_fit`` refreshes a fitted model from a tail of new
rows the same way, warm-started from its alpha, keeping its centers.

``FalkonConfig(mesh=..., data_axes=...)`` (a ``DeviceMesh``,
``repro_torch.launch.mesh.make_mesh``) fits data-parallel: the backend is
wrapped in ``repro_torch.ops.DistributedOps``, which sweeps this rank's
rows and all-reduces the (M, p) partials once a sweep. Every fit variant
inherits it through ``make_ops`` / ``_resolve_ops``, with no mesh code of
its own. Every rank runs the same fit on the same global X with the same
seed (one process a rank: ``torchrun`` or ``mp.spawn``).

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP.md item: storage types other than float32, bfloat16 and float16
(A7).
A large M routes the factor to the blocked out-of-core Cholesky and the
sweep off the fused route, as planned by ``plan_factor`` and
``plan_sweep``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import warnings
from typing import TYPE_CHECKING, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.data.streaming import (ChunkSource, ShuffledChunkSource, StreamingLoader,
                                       streaming_apply, streaming_sweep,
                                       streaming_uniform_centers)
from repro_torch.distributed.mesh import mesh_shape
from repro_torch.kernels.blocked_cholesky import FactorStats
from repro_torch.ops import (CachePlanWarning, DistributedOps, KernelCache, KernelOps,
                             available_ops, data_shards, get_ops, plan_cache, plan_factor,
                             resolve_precision)
from repro_torch.ops.base import require_supported_policy

from .cg import CGResult, conjugate_gradient, conjugate_gradient_host
from .kernels import KernelFn, make_kernel
from .minibatch import MinibatchConfig, MinibatchResult, minibatch_solve, minibatch_solve_stream
from .nystrom import NystromCenters, select_centers
from .preconditioner import (Preconditioner, PreconditionerPath, make_preconditioner,
                             make_preconditioner_path)

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

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
    precision: str = "fp32"                # "fp32" | "bf16" | a PrecisionPolicy
    tol: float = 0.0
    dtype: str = "float32"
    estimate_cond: bool = True             # power-iteration cond(W) diagnostic
    knm_cache: str = "off"                 # "off" | "auto" | "device" | "host"
    mesh: DeviceMesh | None = None         # data-parallel mesh (None = one device);
                                           # make_ops wraps the backend in DistributedOps
    data_axes: tuple[str, ...] = ("data",)  # mesh axes the rows shard over
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
        if self.center_selection not in CENTER_SELECTIONS:
            raise ValueError(f"unknown center_selection {self.center_selection!r}; "
                             f"supported: {CENTER_SELECTIONS}")
        if self.mesh is not None:
            shape = mesh_shape(self.mesh)
            missing = [a for a in self.data_axes if a not in shape]
            if missing:
                raise ValueError(f"data_axes {missing} not in mesh axes {tuple(shape)}")
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; supported: {DTYPES}")

    def make_kernel(self) -> KernelFn:
        return make_kernel(self.kernel, **dict(self.kernel_params))

    def make_ops(self, kernel: KernelFn | None = None) -> KernelOps:
        """The backend every stage of a fit runs on, wrapped in
        :class:`DistributedOps` when a ``mesh`` is configured."""
        ops = get_ops(self.ops_impl, kernel if kernel is not None else self.make_kernel(),
                      block_size=self.block_size, precision=self.precision)
        if self.mesh is not None:
            ops = DistributedOps(ops, self.mesh, self.data_axes)
        return ops


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
    incremental path (``partial_fit``); they are plain attributes and do not
    follow ``.to()``.
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

    def build_knm_cache(self, X, *, tier: str | None = None) -> KernelCache:
        """Materialize K(X, centers) once for repeated scoring of the same X.

        Every later ``predict(X, cache=...)`` is GEMMs over the stored
        entries. The cache is also held by the estimator, so a plain
        ``predict(X)`` with the same X object uses it; any other X
        recomputes. ``tier`` forces the residency; None routes by
        ``plan_cache``, and raises when that says "off" (a scoring set too
        large for both budgets should stream: ``predict_stream``).
        """
        X = torch.as_tensor(X, dtype=self.centers.dtype, device=self.centers.device)
        plan = plan_cache(int(X.shape[0]), int(self.centers.shape[0]),
                          policy=self.ops.policy, tier=tier)
        cache = KernelCache(self.ops, X, self.centers, plan=plan)
        self._knm_cache = cache
        return cache

    def predict(self, X, *, cache: KernelCache | None = None) -> Tensor:
        """Score X: K(X, centers) @ alpha on the estimator's backend, or
        from a cache's stored entries when one covers exactly this (X,
        centers) pair. An explicit ``cache`` must serve: a stale,
        foreign-centers or wrong-X cache raises. The held one
        (``build_knm_cache``) is only a fast path, skipped when it does not
        match."""
        with trace.span("estimator.predict"):
            if cache is None:
                held = getattr(self, "_knm_cache", None)
                if held is None or not held.matches(self.centers) or X is not held.X:
                    X = torch.as_tensor(X, dtype=self.centers.dtype,
                                        device=self.centers.device)
                    return self.ops.apply(X, self.centers, self.alpha)
                cache = held
            cache.check_serves(self.centers, int(X.shape[0]), X=X)
            return cache.apply(self.alpha)

    def predict_stream(self, loader, *, cache: KernelCache | None = None) -> Tensor:
        """Score a ``StreamingLoader`` (or any re-iterable of (X_chunk, _)
        device pairs) chunk by chunk: X need never be on the device at once.
        With a ``cache`` built over the loader's rows, in order, the stream
        is not read: the prediction is the cache's GEMM apply (the cache
        must serve this model and cover the loader's row count)."""
        if cache is not None:
            cache.check_serves(self.centers, getattr(loader, "n_rows", None))
            return cache.apply(self.alpha)
        return streaming_apply(self.ops, loader, self.centers, self.alpha)

    def partial_fit(self, X_tail, y_tail, minibatch: MinibatchConfig | None = None, *,
                    generator: torch.Generator | int | None = None) -> "FalkonEstimator":
        """Refresh the model from a tail of new rows without a refit.

        Reuses the centers, the fit-time factorization and the deployed
        alpha, pulled back to the preconditioned space by
        ``Preconditioner.beta_of_coeffs`` as the warm start; the tail then
        trains by the delayed-projection mini-batch rule (on the card one B1
        launch a step). ``generator`` draws the epoch shuffles (an int seeds
        a new one on the centers' device; default seed 0). Returns a NEW
        estimator holding the SAME centers tensor, with alpha of the same
        shape, dtype and device, so that a server can swap it in behind its
        captured graphs (``CoalescingPredictServer.swap_model``).
        """
        if self.precond is None or self.lam is None:
            raise ValueError(
                "partial_fit needs the fit-time preconditioner, but this estimator does "
                "not carry one (it was built by hand). Refit with falkon_fit / "
                "falkon_fit_minibatch / falkon_fit_streaming, which attach precond and "
                "lam to the estimator.")
        mb = minibatch if minibatch is not None else MinibatchConfig()
        dev = self.centers.device
        if generator is None or isinstance(generator, int):
            generator = torch.Generator(device=dev).manual_seed(generator or 0)
        dt = self.precond.T.dtype
        X_tail = torch.as_tensor(X_tail, dtype=self.centers.dtype, device=dev)
        y_tail = torch.as_tensor(y_tail, dtype=self.centers.dtype, device=dev)
        want = (self.precond.q,) + tuple(y_tail.shape[1:])
        beta0 = self.precond.beta_of_coeffs(self.alpha.to(dt))
        if tuple(beta0.shape) != want:
            raise ValueError(
                f"y_tail implies a {want} iterate but the deployed alpha warm-starts a "
                f"{tuple(beta0.shape)} one — the tail's output width must match the "
                "fitted model's")
        Xs, ys, Cs = _stored(self.ops, X_tail, y_tail, self.centers)
        result = minibatch_solve(Xs, ys, Cs, self.precond, self.lam, mb, ops=self.ops,
                                 generator=generator, beta0=beta0)
        return FalkonEstimator(self.centers, result.alpha.to(self.alpha.dtype), self.kernel,
                               block_size=self.block_size, ops_impl=self.ops_impl,
                               precision=self.precision, precond=self.precond, lam=self.lam)

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


def _sweep_span(sweep: Callable, device: torch.device) -> Callable:
    """``sweep`` inside the device span ``ops.sweep``: one pass over a
    solve's data, whether a backend, a cache's GEMMs or a stream makes it."""
    def run(*args):
        with trace.span("ops.sweep", device=device):
            return sweep(*args)
    return run


def _solve_sweeps(ops: KernelOps, X: Tensor, y: Tensor, centers: Tensor,
                  cache: KernelCache | None, dt: torch.dtype) -> tuple[Callable, Callable]:
    """The matvec and the right-hand-side sweep of an in-core solve: GEMMs
    over a cache's stored entries when one is given (it must cover exactly
    this X and these centers), else recompute sweeps on X quantized to the
    policy's storage once."""
    zeros = torch.zeros((centers.shape[0],) + tuple(y.shape[1:]), dtype=dt, device=X.device)
    if cache is not None:
        cache.check_serves(centers, X.shape[0])
        sweep, v = cache.sweep, y
    else:
        Xs, Cs, v = _stored(ops, X, centers, y)
        sweep = functools.partial(ops.sweep, Xs, Cs)
    sweep = _sweep_span(sweep, X.device)
    return sweep, (lambda: sweep(zeros, v))


def falkon_solve(X: Tensor, y: Tensor, centers: Tensor, precond: Preconditioner,
                 kernel: KernelFn, lam: float, t: int, *, block_size: int = 2048,
                 ops_impl: str = "cuda", precision: str = "fp32", tol: float = 0.0,
                 estimate_cond: bool = True, ops: KernelOps | None = None,
                 cache: KernelCache | None = None) -> FalkonState:
    """Run t preconditioned-CG iterations; return coefficients + diagnostics.

    One right-hand-side sweep, t CG sweeps and, with ``estimate_cond``, the
    power iteration's 2 x (12 + 1) = 26 width-1 sweeps: 47 sweeps at t = 20.
    Under a reduced-storage policy X, the centers and y are quantized to
    storage once here, so that no sweep casts them again, and the CG
    iterates are stored at that width (``beta`` comes back at it). With a
    ``cache`` (a ``KernelCache`` over exactly this X and these centers) all
    47 are GEMMs over its stored entries; a host-tier cache runs the
    host-driven CG loop, as a streamed solve does.
    """
    n = X.shape[0]
    if ops is None:
        ops = get_ops(ops_impl, kernel, block_size=block_size, precision=precision)
    dt = precond.T.dtype   # the solve's type: K_MM's, the coefficients'
    storage = _cg_storage(ops)
    matvec, rhs_sweep = _solve_sweeps(ops, X, y, centers, cache, dt)
    W = _falkon_operator(matvec, precond, lam, n)
    with trace.span("solve.rhs", device=X.device):
        b = precond.left(rhs_sweep() / n)   # r = B^T z / n (Alg. 1)
    cg_fn = (conjugate_gradient_host if cache is not None and cache.tier == "host"
             else conjugate_gradient)
    with trace.span("solve.cg", device=X.device):
        cg = cg_fn(W, b, t, tol=tol, storage_dtype=storage)
    with trace.span("solve.coeffs", device=X.device):
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

        with trace.span("solve.cond", device=X.device):
            lam_max = power(lambda v: W(v.reshape(shape)).reshape(q))
            lam_min = lam_max - power(lambda v: lam_max * v - W(v.reshape(shape)).reshape(q))
            cond = torch.abs(lam_max) / torch.clamp(torch.abs(lam_min), min=1e-30)

    return FalkonState(centers=centers, precond=precond, beta=cg.x, alpha=alpha,
                       residual_norms=cg.residual_norms, cond_estimate=cond)


def _solve_path_core(matvec: Callable, rhs_sweep: Callable, precond: PreconditionerPath,
                     n: int, t: int, *, tol: float, storage: torch.dtype | None,
                     host: bool = False) -> tuple[CGResult, Tensor]:
    """The shared lam-path solve: ONE right-hand-side sweep and t stacked
    CG sweeps serve all L systems; returns the CG result and the (M, L*p)
    coefficients. ``host`` runs the early-stopping CG driver (a streamed
    solve: each skipped iteration saves a pass over the data)."""
    device = precond.T.device
    with trace.span("solve.rhs", device=device):
        b = precond.expand_rhs(rhs_sweep() / n)   # (q, L*p): per-system A^{-T} only
    W = _falkon_operator(matvec, precond, None, n)
    cg_fn = conjugate_gradient_host if host else conjugate_gradient
    with trace.span("solve.cg", device=device):
        cg = cg_fn(W, b, t, tol=tol, storage_dtype=storage)
    with trace.span("solve.coeffs", device=device):
        return cg, precond.coeffs(cg.x.to(precond.T.dtype))


def falkon_solve_path(X: Tensor, y: Tensor, centers: Tensor, precond: PreconditionerPath,
                      t: int, *, ops: KernelOps, tol: float = 0.0,
                      cache: KernelCache | None = None) -> FalkonPathState:
    """Solve the FALKON system for every lam in ``precond.lams`` at the data
    cost of ONE solve: per CG iteration a single ``ops.sweep`` of column
    width L*p (on the "cuda" backend ceil(L*p / 4) launches) instead of L
    sweeps of width p, plus one right-hand-side sweep of width p: t + 1
    sweeps for any L. Per-column convergence masking (``tol``) masks each
    system on its own. Under a reduced-storage policy X, the centers and y
    are quantized once and the CG iterates stored at that width, as in
    :func:`falkon_solve`. A ``cache`` serves every sweep as GEMMs over its
    stored entries, so one kernel pass covers the whole grid."""
    matvec, rhs_sweep = _solve_sweeps(ops, X, y, centers, cache, precond.T.dtype)
    cg, alpha_flat = _solve_path_core(matvec, rhs_sweep, precond, X.shape[0], t, tol=tol,
                                      storage=_cg_storage(ops),
                                      host=cache is not None and cache.tier == "host")
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


def _stage_cache(ops: KernelOps, X: Tensor, centers: Tensor,
                 config: FalkonConfig) -> KernelCache | None:
    """Stage 1.5 — the optional materialized K_nM (the reference's).

    ``knm_cache="auto"`` routes by :func:`~repro_torch.ops.plan_cache`
    (per-shard device and host budgets) and warns with a
    :class:`CachePlanWarning` whenever the route leaves the device tier;
    ``"device"`` / ``"host"`` force a tier. An ``"off"`` route returns None:
    the fit recomputes, as without a cache.
    """
    if config.knm_cache == "off":
        return None
    shards = data_shards(ops)
    tier = None if config.knm_cache == "auto" else config.knm_cache
    plan = plan_cache(int(X.shape[0]), int(centers.shape[0]), policy=ops.policy,
                      shards=shards, tier=tier)
    if tier is None and plan.tier == "host" and shards > 1:
        plan = dataclasses.replace(
            plan, tier="off", reason=f"host tier unsupported under {shards}-way row sharding")
    if tier is None and plan.tier != "device":
        warnings.warn(CachePlanWarning(plan), stacklevel=4)
    if plan.tier == "off":
        return None
    return KernelCache(ops, X, centers, plan=plan)


def _stage_precondition(KMM: Tensor, lam, n: int, config: FalkonConfig, *,
                        D: Tensor | None = None,
                        report: dict | None = None) -> Preconditioner | PreconditionerPath:
    """Stage 3 — factorization, routed in-core or blocked by the factor
    budget: a scalar ``lam`` builds the single :class:`Preconditioner`, a
    grid (a sequence) the :class:`PreconditionerPath`. ``report``, when
    given, receives the plan's path and block and the blocked path's
    ``FactorStats`` (device peak, bytes moved, copy and tile seconds, host
    copies of T T^T; all zero in-core); only then are the blocked path's
    copies and tiles timed, each to a synchronised end."""
    plan = plan_factor(KMM.shape[0], itemsize=max(KMM.dtype.itemsize, 4))
    stats = FactorStats(timing=report is not None)
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


def _resolve_ops(config: FalkonConfig, kernel: KernelFn, ops: KernelOps | None) -> KernelOps:
    """The one place every fit variant resolves its backend.

    ``ops=None`` builds from the config (mesh-wrapped when configured). An
    explicit ``ops`` (e.g. a ``CountingOps``) is wrapped in
    :class:`DistributedOps` when the config names a mesh and the caller has
    not distributed it already, so counting facades compose with sharding
    on either side. "Already distributed" walks the whole facade chain
    (``.inner`` / ``.ops``): ``CountingOps(DistributedOps(...))`` must not
    get a second wrapper (two all-reduces a sweep).
    """
    if ops is None:
        return config.make_ops(kernel)
    if config.mesh is not None and not _wraps_distributed(ops):
        return DistributedOps(ops, config.mesh, config.data_axes)
    return ops


def _wraps_distributed(ops: KernelOps) -> bool:
    """True if ``ops`` is, or anywhere down its facade chain wraps, a
    :class:`DistributedOps`."""
    seen: set[int] = set()
    o: object | None = ops
    while o is not None and id(o) not in seen:
        if isinstance(o, DistributedOps):
            return True
        seen.add(id(o))
        o = getattr(o, "inner", None) or getattr(o, "ops", None)
    return False


@contextlib.contextmanager
def _timed(times: dict | None, name: str, device: torch.device):
    """The stage's span ``fit.<name>``; with ``times``, also its wall time
    to a synchronised end, as ``times[name]``."""
    clock = None if times is None else functools.partial(trace.synced_clock, device)
    with trace.span(f"fit.{name}", device=device, clock=clock) as span:
        yield
    if times is not None:
        times[name] = span.seconds


def _fit_front(generator, X, y, config: FalkonConfig, ops: KernelOps | None, lam,
               stage_times: dict | None, select_lam: float | None = None, centers=None):
    """The stages both fits share: X and y to ``config.device`` at
    ``config.dtype``, the centers (drawn by ``generator``, an int seeding a
    new one on the device; leverage scores at ``select_lam``, default
    ``config.lam``), X and y quantized once to a reduced storage type after
    the centers are drawn from the full-precision X (K_MM stays float32),
    the K_nM cache when ``config.knm_cache`` asks for one (timed as
    "cache"), K_MM, and the factorization at ``lam`` (a scalar or a grid).
    ``centers``, when given, replace the draw (no D). Returns (device,
    kernel, ops, X, y, centers, preconditioner, cache)."""
    device = resolve_device(config.device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    kernel = config.make_kernel()
    ops = _resolve_ops(config, kernel, ops)
    dt = getattr(torch, config.dtype)
    X = torch.as_tensor(X, dtype=dt, device=device)
    y = torch.as_tensor(y, dtype=dt, device=device)

    with _timed(stage_times, "centers", device):
        if centers is None:
            sel = _stage_select(generator, X, config, kernel, lam=select_lam)
        else:
            C = torch.as_tensor(centers, dtype=dt, device=device)
            sel = NystromCenters(centers=C, indices=None, D=None)
    storage = _cg_storage(ops)
    if storage is not None:
        X, y = X.to(storage), y.to(storage)
    cache = None
    if config.knm_cache != "off":
        with _timed(stage_times, "cache", device):
            cache = _stage_cache(ops, X, sel.centers, config)
    with _timed(stage_times, "gram", device):
        KMM = _stage_gram(ops, sel.centers)
    with _timed(stage_times, "factor", device):
        precond = _stage_precondition(KMM, lam, X.shape[0], config, D=sel.D,
                                      report=stage_times)
    del KMM   # O(M^2) on the device; the solve needs only T and A
    return device, kernel, ops, X, y, sel, precond, cache


def falkon_fit(generator: torch.Generator | int, X, y, config: FalkonConfig, *,
               mesh: DeviceMesh | None = None, data_axes: tuple[str, ...] = ("data",),
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
    blocked path's ``factor_stats`` (and "cache" with a K_nM cache). With
    ``config.knm_cache`` other than "off" the fit builds one ``KernelCache``
    for its solve and drops it with the fit's other temporaries. With a mesh
    (``config.mesh``, or the ``mesh=`` / ``data_axes=`` keywords, which
    override the config) every sweep runs on this rank's rows and one
    all-reduce a sweep merges them (``repro_torch.ops.DistributedOps``).
    """
    if mesh is not None:
        config = dataclasses.replace(config, mesh=mesh, data_axes=tuple(data_axes))
    with trace.span("fit", device=torch.device(config.device)):
        device, kernel, ops, X, y, sel, precond, cache = _fit_front(
            generator, X, y, config, ops, config.lam, stage_times)
        with _timed(stage_times, "solve", device):
            state = falkon_solve(X, y, sel.centers, precond, kernel, config.lam,
                                 config.iterations, tol=config.tol,
                                 estimate_cond=config.estimate_cond, ops=ops, cache=cache)
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
    ``score`` with a val set. A ``config.knm_cache`` cache is built once and
    serves all L systems."""
    lam_vals = _check_lams(lams)
    if (X_val is None) != (y_val is None):
        raise ValueError("X_val and y_val must be given together")
    lam_ref = math.exp(sum(math.log(lam) for lam in lam_vals) / len(lam_vals))
    with trace.span("fit", device=torch.device(config.device)):
        device, kernel, ops, X, y, sel, precond, cache = _fit_front(
            generator, X, y, config, ops, lam_vals, stage_times, lam_ref)
        with _timed(stage_times, "solve", device):
            state = falkon_solve_path(X, y, sel.centers, precond, config.iterations, ops=ops,
                                      tol=config.tol, cache=cache)
        del cache   # the path's scoring recomputes on the val rows
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


# ----------------------------------------------------------------------------
# Out-of-core fits: X streamed from the host, never resident on the device
# ----------------------------------------------------------------------------
def _streamed_solve_parts(loader, centers: Tensor, ops: KernelOps, out_dim: tuple,
                          dt: torch.dtype) -> tuple[Callable, Callable]:
    """The matvec and the right-hand-side sweep of a streamed solve, each one
    pass over ``loader``; the centers quantized to the policy's storage once
    per solve, not per chunk."""
    (Cs,) = _stored(ops, centers)

    def matvec(g):
        return streaming_sweep(ops, loader, Cs, g, use_targets=False)

    def rhs_sweep():
        zeros = torch.zeros((centers.shape[0],) + tuple(out_dim), dtype=dt,
                            device=centers.device)
        return streaming_sweep(ops, loader, Cs, zeros, use_targets=True)

    return _sweep_span(matvec, centers.device), _sweep_span(rhs_sweep, centers.device)


def falkon_solve_streaming(loader, centers: Tensor, precond: Preconditioner, lam: float,
                           t: int, *, ops: KernelOps, out_dim: tuple = (),
                           tol: float = 0.0) -> FalkonState:
    """:func:`falkon_solve` with every data sweep streamed through ``loader``
    (a re-iterable of (X_chunk, y_chunk) device pairs, e.g. a
    ``StreamingLoader``): t + 1 passes over the stream, the chunk sweeps
    accumulated on the device, O(chunk + M^2) device memory for any n. The
    CG recurrence is the early-stopping host driver; there is no cond
    estimate (``cond_estimate`` is 0). ``out_dim`` is y's trailing shape:
    () for one output, (p,) for p."""
    dt = precond.T.dtype
    matvec, rhs_sweep = _streamed_solve_parts(loader, centers, ops, out_dim, dt)
    n = loader.n_rows
    W = _falkon_operator(matvec, precond, lam, n)
    with trace.span("solve.rhs", device=centers.device):
        b = precond.left(rhs_sweep() / n)
    with trace.span("solve.cg", device=centers.device):
        cg = conjugate_gradient_host(W, b, t, tol=tol, storage_dtype=_cg_storage(ops))
    with trace.span("solve.coeffs", device=centers.device):
        alpha = precond.coeffs(cg.x.to(dt))
    return FalkonState(centers=centers, precond=precond, beta=cg.x, alpha=alpha,
                       residual_norms=cg.residual_norms,
                       cond_estimate=torch.zeros((), dtype=dt, device=centers.device))


def falkon_solve_path_streaming(loader, centers: Tensor, precond: PreconditionerPath, t: int,
                                *, ops: KernelOps, out_dim: tuple = (),
                                tol: float = 0.0) -> FalkonPathState:
    """:func:`falkon_solve_path` with every stacked sweep streamed from the
    host: one pass over the stream per CG iteration serves all L systems
    (each chunk sweep carries the (M, L*p) block). The host CG driver stops
    early once every column has converged."""
    matvec, rhs_sweep = _streamed_solve_parts(loader, centers, ops, out_dim, precond.T.dtype)
    cg, alpha_flat = _solve_path_core(matvec, rhs_sweep, precond, loader.n_rows, t, tol=tol,
                                      storage=_cg_storage(ops), host=True)
    alphas = precond.split(alpha_flat)
    if not tuple(out_dim):
        alphas = alphas[..., 0]
    return FalkonPathState(centers=centers, precond=precond, beta=cg.x, alphas=alphas,
                           residual_norms=cg.residual_norms, lams=precond.lams)


def _streaming_front(generator, source: ChunkSource, config: FalkonConfig, lam, *,
                     prefetch: int | None, centers, ops: KernelOps | None,
                     stage_times: dict | None):
    """The stages both streamed fits share, timed as :func:`falkon_fit`'s:
    the centers (uniform, drawn in one host pass by ``generator``, an int
    seeding a new one on the device, unless given), K_MM and the
    factorization at ``lam`` (a scalar or a grid), y's trailing shape, and a
    loader that moves chunks at the policy's storage type (a bf16 policy's
    chunks cross the bus in bf16). Leverage-score centers need a
    pilot Gram pass that is not chunk-additive, and are refused; so is a
    K_nM cache, with the reference's message."""
    if config.knm_cache != "off":
        raise ValueError(
            "streaming fits do not support knm_cache (got "
            f"{config.knm_cache!r}): the point of streaming X is that "
            "O(n*M) state never materializes — cache the kernel with an "
            "in-core fit, or set knm_cache='off'")
    device = resolve_device(config.device)
    if config.center_selection != "uniform" and centers is None:
        raise ValueError("a streamed fit draws center_selection='uniform' centers only "
                         f"(got {config.center_selection!r}); pass centers= to use others")
    kernel = config.make_kernel()
    ops = _resolve_ops(config, kernel, ops)
    dt = getattr(torch, config.dtype)
    with _timed(stage_times, "centers", device):
        if centers is None:
            if isinstance(generator, int):
                generator = torch.Generator(device=device).manual_seed(generator)
            centers, _ = streaming_uniform_centers(generator, source,
                                                   min(config.num_centers, source.n_rows))
        if not isinstance(centers, Tensor):
            centers = np.array(centers)     # a writable host copy
        centers = torch.as_tensor(centers, dtype=dt, device=device)
    # y's trailing shape, from the host, after the centers' pass (a shuffled
    # source replays the reference's pass order)
    out_dim: tuple = ()
    for _, yc in source.chunks():
        if yc is None:
            raise ValueError("a streamed fit needs targets in the source")
        out_dim = tuple(yc.shape[1:])
        break
    with _timed(stage_times, "gram", device):
        KMM = _stage_gram(ops, centers)
    with _timed(stage_times, "factor", device):
        precond = _stage_precondition(KMM, lam, source.n_rows, config, report=stage_times)
    del KMM
    loader = StreamingLoader(source, device=device, prefetch=prefetch,
                             dtype=_cg_storage(ops) or dt)
    return device, kernel, ops, centers, loader, out_dim, precond


def falkon_fit_streaming(generator: torch.Generator | int, source: ChunkSource,
                         config: FalkonConfig, *, prefetch: int | None = None, centers=None,
                         ops: KernelOps | None = None,
                         stage_times: dict | None = None) -> tuple[FalkonEstimator, FalkonState]:
    """Fit FALKON from a host ``ChunkSource`` without X on the device.

    :func:`falkon_fit`'s pipeline with the select and solve stages swapped
    for streamed ones: uniform centers from one host pass (``centers``
    overrides them), K_MM and the factors in-core (the paper's memory
    budget), then :func:`falkon_solve_streaming`: t + 1 passes over the
    chunks through a ``StreamingLoader`` (``prefetch`` chunks ahead; default
    2 on the card, 0 on the CPU), no cond estimate. ``ops`` replaces the
    configured backend; ``stage_times`` receives what :func:`falkon_fit`
    records."""
    with trace.span("fit", device=torch.device(config.device)):
        device, kernel, ops, centers, loader, out_dim, precond = _streaming_front(
            generator, source, config, config.lam, prefetch=prefetch, centers=centers, ops=ops,
            stage_times=stage_times)
        with _timed(stage_times, "solve", device):
            state = falkon_solve_streaming(loader, centers, precond, config.lam, config.iterations,
                                           ops=ops, out_dim=out_dim, tol=config.tol)
        est = _stage_wrap(centers, state.alpha, kernel, config, precond=precond, lam=config.lam)
        return est, state


def falkon_fit_path_streaming(generator: torch.Generator | int, source: ChunkSource,
                              config: FalkonConfig, lams, *, prefetch: int | None = None,
                              centers=None, ops: KernelOps | None = None,
                              stage_times: dict | None = None) -> FalkonPathResult:
    """:func:`falkon_fit_path` for a host ``ChunkSource``: the L-lam path at
    the stream passes of one fit (t + 1), each chunk sweep carrying the
    stacked (M, L*p) block. No validation scoring (the val set would need
    its own stream): score the estimators with
    :meth:`FalkonEstimator.predict_stream`."""
    lam_vals = _check_lams(lams)
    with trace.span("fit", device=torch.device(config.device)):
        device, kernel, ops, centers, loader, out_dim, precond = _streaming_front(
            generator, source, config, lam_vals, prefetch=prefetch, centers=centers, ops=ops,
            stage_times=stage_times)
        with _timed(stage_times, "solve", device):
            state = falkon_solve_path_streaming(loader, centers, precond, config.iterations,
                                                ops=ops, out_dim=out_dim, tol=config.tol)
        ests = tuple(_stage_wrap(centers, state.alphas[i], kernel, config,
                                 precond=precond.system(i), lam=lam)
                     for i, lam in enumerate(lam_vals))
        return FalkonPathResult(estimators=ests, state=state, lams=lam_vals, val_scores=None,
                                best_index=None)


# ----------------------------------------------------------------------------
# Mini-batch fits: delayed-projection stochastic solves (core/minibatch.py)
# ----------------------------------------------------------------------------
def falkon_fit_minibatch(generator: torch.Generator | int, X, y, config: FalkonConfig,
                         minibatch: MinibatchConfig | None = None, *, centers=None,
                         ops: KernelOps | None = None, beta0: Tensor | None = None,
                         stage_times: dict | None = None
                         ) -> tuple[FalkonEstimator, MinibatchResult]:
    """Fit by stochastic preconditioned chunk sweeps with delayed projections.

    :func:`falkon_fit`'s select -> gram -> precondition pipeline (the factors
    built once, routed in-core or blocked as ever) with the solve stage
    swapped for :func:`~repro_torch.core.minibatch.minibatch_solve`: one
    chunk sweep a step (on the card one B1 launch), a projection every
    ``minibatch.project_every`` steps, epoch reshuffling and tail averaging.
    ``config.iterations`` and ``config.tol`` are CG knobs and are ignored.
    ``generator`` draws the centers, then the epoch permutations (an int
    seeds a new one on ``config.device``); ``centers`` overrides the draw,
    ``ops`` the backend, ``beta0`` warm-starts. ``stage_times`` receives
    :func:`falkon_fit`'s stages and the solve's ``steps`` and
    ``projections`` seconds and counts. A K_nM cache is refused: each step
    sweeps a fresh chunk.
    """
    mb = minibatch if minibatch is not None else MinibatchConfig()
    if config.knm_cache != "off":
        raise ValueError(
            "the mini-batch solver does not support knm_cache (got "
            f"{config.knm_cache!r}): each step sweeps a fresh shuffled "
            "chunk, so there is no fixed tile set to materialize — use "
            "falkon_fit for cached sweeps, or set knm_cache='off'")
    device = resolve_device(config.device)
    with trace.span("fit", device=device):
        if isinstance(generator, int):
            generator = torch.Generator(device=device).manual_seed(generator)
        device, kernel, ops, X, y, sel, precond, _ = _fit_front(
            generator, X, y, config, ops, config.lam, stage_times, centers=centers)
        (Cs,) = _stored(ops, sel.centers)
        with _timed(stage_times, "solve", device):
            result = minibatch_solve(X, y, Cs, precond, config.lam, mb, ops=ops,
                                     generator=generator, beta0=beta0, split_times=stage_times)
        est = _stage_wrap(sel.centers, result.alpha, kernel, config, precond=precond,
                          lam=config.lam)
        return est, result


def falkon_fit_minibatch_streaming(generator: torch.Generator | int, source: ChunkSource,
                                   config: FalkonConfig,
                                   minibatch: MinibatchConfig | None = None, *,
                                   prefetch: int | None = None, centers=None,
                                   ops: KernelOps | None = None,
                                   beta0: Tensor | None = None,
                                   stage_times: dict | None = None
                                   ) -> tuple[FalkonEstimator, MinibatchResult]:
    """:func:`falkon_fit_minibatch` for a host ``ChunkSource``.

    The front half of :func:`falkon_fit_streaming` (uniform centers in one
    host pass, K_MM and the factors in-core), then
    :func:`~repro_torch.core.minibatch.minibatch_solve_stream` over a
    ``StreamingLoader``: each update costs ``project_every`` chunk transfers
    and sweeps. With ``minibatch.shuffle`` the source is wrapped in a
    ``ShuffledChunkSource`` seeded from ``generator``, so every epoch is a
    fresh windowed shuffle. ``stage_times`` as in
    :func:`falkon_fit_minibatch`.
    """
    mb = minibatch if minibatch is not None else MinibatchConfig()
    with trace.span("fit", device=torch.device(config.device)):
        if mb.shuffle:
            device = resolve_device(config.device)
            if isinstance(generator, int):
                generator = torch.Generator(device=device).manual_seed(generator)
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                     device=generator.device)[0])
            source = ShuffledChunkSource(source, seed=seed)
        device, kernel, ops, centers, loader, out_dim, precond = _streaming_front(
            generator, source, config, config.lam, prefetch=prefetch, centers=centers, ops=ops,
            stage_times=stage_times)
        (Cs,) = _stored(ops, centers)
        with _timed(stage_times, "solve", device):
            result = minibatch_solve_stream(loader, Cs, precond, config.lam, mb, ops=ops,
                                            out_dim=out_dim, beta0=beta0, split_times=stage_times)
        est = _stage_wrap(centers, result.alpha, kernel, config, precond=precond, lam=config.lam)
        return est, result
