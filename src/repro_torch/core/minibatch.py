"""Mini-batch FALKON with delayed projections.

Counterpart of ``repro/core/minibatch.py``: the preconditioned iteration run
stochastically over row chunks, projected back through the preconditioner
only every few steps ("Fast training of large kernel models with delayed
projections", PAPERS.md).

* **One chunk-sized sweep per stochastic step.** A step over the chunk
  ``(X_c, y_c)`` is exactly ``ops.sweep(X_c, C, gamma, -y_c) = K_cM^T (K_cM
  gamma - y_c)`` (on the card one B1 launch). Ragged chunks ride the
  ``row_mask`` contract: pad rows add exactly zero and are left out of the
  row count that normalizes the gradient.
* **Delayed projection.** gamma is held fixed for ``project_every`` chunks
  while their sweeps accumulate; one projection then applies the
  preconditioned gradient ``g = left(acc) / rows + ridge(beta, lam)``, a
  heavy-ball step, tail averaging and one gamma refresh. A period that covers
  all rows is full-batch preconditioned gradient descent, so an exact solve
  is its fixed point.
* **The state stays on the device.** :class:`MinibatchState` holds beta,
  the momentum buffer, the tail average, gamma and the sweep accumulator;
  the counters (``acc_rows``, ``num_avg``, ``step``, ``projections``) are
  0-d tensors, so a step or a projection never reads a value back to the
  host.
* **Step size.** ``step_size=None`` estimates lam_max(W) by power iteration
  on one pilot chunk (``power_iters`` chunk sweeps) and takes
  ``step_safety / lam_max``.

The reference's nested ``lax.scan`` (epochs -> projection periods ->
chunks) is a Python loop over the same three levels here, each step and
projection eager. Its epoch permutation is drawn from an explicit
``torch.Generator`` (``torch.randperm``); ``jax.random.permutation`` cannot
be reproduced, so the port matches the reference bit for bit only with
``shuffle=False``. The reference's ``jit_update`` switch of the streamed
driver has no counterpart: every step is already eager.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import torch

from repro_torch import trace

from .cg import active_columns, col_dot
from .preconditioner import Preconditioner

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MinibatchConfig:
    """Knobs of the delayed-projection update rule.

    ``chunk_rows`` rows per stochastic step; ``project_every`` steps between
    projections (the delay); ``epochs`` passes over the data. ``step_size``
    of None estimates ``step_safety / lam_max(W)`` by ``power_iters``
    pilot-chunk power iterations. ``momentum`` is the heavy-ball coefficient;
    ``avg_start`` the fraction of projections after which tail averaging
    begins. ``tol`` freezes a column once its projected-gradient norm drops
    below ``tol`` times its first value. ``shuffle`` draws a fresh row order
    every epoch (a permutation in-core, a ``ShuffledChunkSource`` pass when
    streamed).
    """

    chunk_rows: int = 2048
    project_every: int = 4
    epochs: int = 2
    step_size: float | None = None
    step_safety: float = 0.95
    power_iters: int = 8
    momentum: float = 0.8
    avg_start: float = 0.9
    tol: float = 0.0
    shuffle: bool = True

    def __post_init__(self):
        if self.chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {self.chunk_rows}")
        if self.project_every <= 0:
            raise ValueError(f"project_every must be positive, got {self.project_every}")
        if self.epochs <= 0:
            raise ValueError(f"epochs must be positive, got {self.epochs}")
        if self.step_size is not None and not self.step_size > 0.0:
            raise ValueError(f"step_size must be positive (or None to auto-estimate), "
                             f"got {self.step_size}")
        if not 0.0 < self.step_safety <= 2.0:
            raise ValueError(f"step_safety must be in (0, 2] (gradient descent diverges "
                             f"past 2/lam_max), got {self.step_safety}")
        if self.power_iters <= 0:
            raise ValueError(f"power_iters must be positive, got {self.power_iters}")
        if not 0.0 <= self.momentum < 1.0:
            raise ValueError(f"momentum must be in [0, 1), got {self.momentum}")
        if not 0.0 <= self.avg_start <= 1.0:
            raise ValueError(f"avg_start must be in [0, 1], got {self.avg_start}")
        if self.tol < 0.0:
            raise ValueError(f"tol must be >= 0, got {self.tol}")


class MinibatchState(NamedTuple):
    """The iteration state, every field a tensor on the device.

    ``beta`` lives in the preconditioned space (like the CG iterate);
    ``gamma = right(beta)`` is the coefficient vector the chunk sweeps read,
    refreshed only at projections. ``acc`` / ``acc_rows`` accumulate the
    chunk sweeps and their valid rows since the last projection. ``g0_sq`` is
    the first projection's per-column squared gradient norm, the reference
    of the relative ``tol`` (negative until the first projection sets it).
    """

    beta: Tensor         # (q,) or (q, p) preconditioned iterate
    velocity: Tensor     # heavy-ball momentum buffer, like beta
    beta_bar: Tensor     # tail average of beta, like beta
    num_avg: Tensor      # 0-d float32: projections averaged so far
    gamma: Tensor        # (M, ...) = right(beta), refreshed at projections
    acc: Tensor          # (M, ...) sum of chunk sweeps at the stale gamma
    acc_rows: Tensor     # 0-d float32: valid rows behind ``acc``
    g0_sq: Tensor        # per-column reference ||g||^2 for tol masking
    step: Tensor         # 0-d int32: chunk steps taken
    projections: Tensor  # 0-d int32: projections applied


class MinibatchResult(NamedTuple):
    """What a mini-batch solve returns beside the estimator."""

    state: MinibatchState
    alpha: Tensor        # coeffs(solution): the tail-averaged beta when averaging ran
    grad_norms: Tensor   # (projections,) or (projections, p) per-column ||g||
    step_size: Tensor    # the step size used (estimated or given)
    pilot_sweeps: int    # chunk sweeps spent estimating the step size
    rows_swept: float    # rows through sweeps (pads and pilot included)


def minibatch_init(precond: Preconditioner, beta0: Tensor) -> MinibatchState:
    """A fresh state at ``beta0`` (zeros for a cold start, or
    ``precond.beta_of_coeffs(alpha)`` to warm-start from a deployed model)."""
    gamma = precond.right(beta0)
    dev = beta0.device
    return MinibatchState(
        beta=beta0, velocity=torch.zeros_like(beta0), beta_bar=torch.zeros_like(beta0),
        num_avg=torch.zeros((), dtype=torch.float32, device=dev), gamma=gamma,
        acc=torch.zeros_like(gamma), acc_rows=torch.zeros((), dtype=torch.float32, device=dev),
        g0_sq=-torch.ones(beta0.shape[1:], dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        projections=torch.zeros((), dtype=torch.int32, device=dev))


def _rows(xc: Tensor, row_mask: Tensor | None):
    """The chunk's valid rows: a Python float without a mask, else the mask's
    sum as a 0-d float32 tensor (never read back to the host)."""
    if row_mask is None:
        return float(xc.shape[0])
    return row_mask.sum(dtype=torch.float32)


def minibatch_step(ops, centers: Tensor, state: MinibatchState, xc: Tensor, yc: Tensor,
                   row_mask: Tensor | None = None) -> MinibatchState:
    """One stochastic step: exactly one chunk sweep.

    ``sweep(X_c, C, gamma, -y_c) = K_cM^T (K_cM gamma - y_c)`` folds the
    chunk's residual into the one pass; the result is only accumulated here,
    all O(M^2) preconditioner work waits for the projection. ``row_mask``
    rows at 0 contribute exactly zero and are not counted.
    """
    wc = ops.sweep(xc, centers, state.gamma, -yc, row_mask=row_mask)
    return state._replace(acc=state.acc + wc.to(state.acc.dtype),
                          acc_rows=state.acc_rows + _rows(xc, row_mask),
                          step=state.step + 1)


def minibatch_project(precond: Preconditioner, lam, state: MinibatchState, *, step_size,
                      momentum: float, avg_after: int,
                      tol: float) -> tuple[MinibatchState, Tensor]:
    """The delayed projection: the accumulated sweeps become one update.

    ``g = left(acc) / rows + ridge(beta, lam)`` is the preconditioned
    residual ``W beta - b`` on the rows behind ``acc``. Then a heavy-ball
    step, per-column tol masking (the CG helpers), tail averaging once
    ``projections >= avg_after``, and the one gamma refresh. Returns (state,
    per-column ||g||).
    """
    denom = torch.clamp(state.acc_rows, min=1.0)
    g = precond.left(state.acc) / denom + precond.ridge(state.beta, lam)
    rs = col_dot(g, g)
    ref = torch.where(state.g0_sq < 0.0, rs, state.g0_sq)
    active = active_columns(rs, (tol * tol) * ref)

    vel_new = momentum * state.velocity - step_size * g
    beta_new = state.beta + vel_new
    beta = torch.where(active, beta_new, state.beta)
    velocity = torch.where(active, vel_new, state.velocity)

    take = (state.projections >= avg_after).to(torch.float32)
    num = state.num_avg + take
    beta_bar = torch.where(take > 0.0,
                           (state.beta_bar * state.num_avg + beta) / torch.clamp(num, min=1.0),
                           state.beta_bar)
    new_state = state._replace(
        beta=beta, velocity=velocity, beta_bar=beta_bar, num_avg=num,
        gamma=precond.right(beta), acc=torch.zeros_like(state.acc),
        acc_rows=torch.zeros_like(state.acc_rows), g0_sq=ref,
        projections=state.projections + 1)
    return new_state, torch.sqrt(rs)


def minibatch_solution(state: MinibatchState) -> Tensor:
    """The iterate to read out: the tail average when averaging ran, else
    the last beta."""
    return torch.where(state.num_avg > 0.0, state.beta_bar, state.beta)


def estimate_step_size(ops, centers: Tensor, precond: Preconditioner, lam, xc: Tensor,
                       row_mask: Tensor | None, *, iters: int = 8,
                       safety: float = 0.95) -> Tensor:
    """``safety / lam_max(W_pilot)`` by power iteration on ONE pilot chunk.

    ``W_pilot`` is the operator the projection descends with its data term
    subsampled to the pilot chunk. ``iters`` chunk sweeps, eager (a
    ``CountingOps`` sees every one); lam_max is read off the last iterate's
    norm growth. Returns a 0-d tensor.
    """
    rows = _rows(xc, row_mask)
    if isinstance(rows, Tensor):
        rows = torch.clamp(rows, min=1.0)

    def w_pilot(u):
        w = ops.sweep(xc, centers, precond.right(u), None, row_mask=row_mask)
        return precond.left(w) / rows + precond.ridge(u, lam)

    q = precond.q
    dt = precond.T.dtype
    v = torch.ones(q, dtype=dt, device=centers.device) / math.sqrt(q)
    lam_max = torch.ones((), dtype=dt, device=centers.device)
    for _ in range(iters):
        w = w_pilot(v)
        lam_max = torch.clamp(torch.linalg.norm(w), min=1e-30)
        v = w / lam_max
    return torch.full_like(lam_max, safety) / lam_max


def _pad_to(a: Tensor, rows: int) -> Tensor:
    return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 1) + (0, rows - a.shape[0]))


class _SplitTimer:
    """The solve's spans ``minibatch.step`` (the steps of one projection
    period) and ``minibatch.projection`` (``repro_torch.trace``). With
    ``times``, their seconds and counts as "steps", "projections",
    "steps_count" and "projections_count", split without a host sync: on
    the card each span's CUDA events, summed once the solve has ended; on
    the CPU the wall clock."""

    NAMES = {"steps": "minibatch.step", "projections": "minibatch.projection"}

    def __init__(self, times: dict | None, device: torch.device):
        self.times, self.device = times, device
        self.spans: dict[str, list] = {"steps": [], "projections": []}

    def start(self, name: str):
        return trace.start(self.NAMES[name], device=self.device,
                           clock=None if self.times is None else time.perf_counter)

    def stop(self, name: str, span) -> None:
        span.end()
        if self.times is not None:
            self.spans[name].append(span)

    def finish(self) -> None:
        if self.times is None:
            return
        for name, spans in self.spans.items():
            self.times[name] = sum(s.device_seconds for s in spans)
            self.times[f"{name}_count"] = len(spans)


def minibatch_solve(X: Tensor, y: Tensor, centers: Tensor, precond: Preconditioner, lam,
                    mb: MinibatchConfig, *, ops, generator: torch.Generator | None = None,
                    beta0: Tensor | None = None,
                    split_times: dict | None = None) -> MinibatchResult:
    """In-core driver: epochs -> projection periods -> chunks.

    X / y are zero-padded to a whole number of projection periods and the
    pad rows masked out, so every chunk of every epoch has one shape. The
    fits pass X, y and the centers already at the policy's storage type, so
    that no sweep casts them again. With
    ``mb.shuffle`` each epoch draws a fresh row permutation from
    ``generator`` (pad rows travel with their mask entries; default: a
    generator seeded 0 on X's device). ``split_times``, when given,
    receives the seconds of the steps and of the projections and their
    counts (see :class:`_SplitTimer`).
    """
    n = X.shape[0]
    if y.shape[0] != n:
        raise ValueError(f"X has {n} rows but y has {y.shape[0]}")
    c = min(mb.chunk_rows, n)
    k = max(1, min(mb.project_every, -(-n // c)))
    period = k * c
    periods = -(-n // period)
    n_pad = periods * period

    X_pad = _pad_to(X, n_pad)
    y_pad = _pad_to(y, n_pad)
    mask = (torch.arange(n_pad, device=X.device) < n).to(torch.float32)

    if beta0 is None:
        beta0 = torch.zeros((precond.q,) + tuple(y.shape[1:]), dtype=precond.T.dtype,
                            device=X.device)
    state = minibatch_init(precond, beta0)

    pilot_sweeps = 0
    if mb.step_size is None:
        eta = estimate_step_size(ops, centers, precond, lam, X_pad[:c], mask[:c],
                                 iters=mb.power_iters, safety=mb.step_safety)
        pilot_sweeps = mb.power_iters
    else:
        eta = torch.full((), mb.step_size, dtype=precond.T.dtype, device=X.device)

    total_proj = mb.epochs * periods
    avg_after = int(mb.avg_start * total_proj)
    if mb.shuffle and generator is None:
        generator = torch.Generator(device=X.device).manual_seed(0)
    timer = _SplitTimer(split_times, X.device)
    gnorms = []
    for _ in range(mb.epochs):
        if mb.shuffle:
            perm = torch.randperm(n_pad, generator=generator,
                                  device=generator.device).to(X.device)
            xe, ye, me = X_pad[perm], y_pad[perm], mask[perm]
        else:
            xe, ye, me = X_pad, y_pad, mask
        for j in range(periods):
            t0 = timer.start("steps")
            for i in range(j * k, (j + 1) * k):
                s = slice(i * c, (i + 1) * c)
                state = minibatch_step(ops, centers, state, xe[s], ye[s], row_mask=me[s])
            timer.stop("steps", t0)
            t0 = timer.start("projections")
            state, gn = minibatch_project(precond, lam, state, step_size=eta,
                                          momentum=mb.momentum, avg_after=avg_after,
                                          tol=mb.tol)
            timer.stop("projections", t0)
            gnorms.append(gn)
    timer.finish()
    return MinibatchResult(state=state, alpha=precond.coeffs(minibatch_solution(state)),
                           grad_norms=torch.stack(gnorms), step_size=eta,
                           pilot_sweeps=pilot_sweeps,
                           rows_swept=float(mb.epochs * n_pad + pilot_sweeps * c))


def minibatch_solve_stream(loader, centers: Tensor, precond: Preconditioner, lam,
                           mb: MinibatchConfig, *, ops, out_dim: tuple = (),
                           beta0: Tensor | None = None,
                           split_times: dict | None = None) -> MinibatchResult:
    """Streamed driver: the same update functions over a loader's chunks.

    ``loader`` is a re-iterable of (X_chunk, y_chunk) device pairs that
    declares ``chunk_rows`` and ``n_rows`` (a ``StreamingLoader``; wrap its
    source in a ``ShuffledChunkSource`` for epoch reshuffling, as
    ``falkon_fit_minibatch_streaming`` does). A ragged tail is padded to
    ``chunk_rows`` under the ``row_mask`` contract, so every step sweeps one
    shape; each epoch ends with a projection of its last, possibly short,
    period. ``split_times`` as in :func:`minibatch_solve`.
    """
    n = loader.n_rows
    chunk_rows = loader.chunk_rows
    if not chunk_rows:
        raise ValueError("minibatch_solve_stream needs the loader's source to declare "
                         "chunk_rows (the one sweep shape every step shares)")
    num_chunks = -(-n // chunk_rows)
    k = max(1, min(mb.project_every, num_chunks))
    proj_per_epoch = -(-num_chunks // k)
    total_proj = mb.epochs * proj_per_epoch
    avg_after = int(mb.avg_start * total_proj)

    if beta0 is None:
        beta0 = torch.zeros((precond.q,) + tuple(out_dim), dtype=precond.T.dtype,
                            device=centers.device)
    state = minibatch_init(precond, beta0)
    full_mask = torch.ones(chunk_rows, dtype=torch.float32, device=centers.device)

    def padded(xc, yc):
        if yc is None:
            raise ValueError("minibatch_solve_stream needs targets in the source")
        nc = xc.shape[0]
        if nc == chunk_rows:
            return xc, yc, full_mask
        return (_pad_to(xc, chunk_rows), _pad_to(yc, chunk_rows),
                (torch.arange(chunk_rows, device=xc.device) < nc).to(torch.float32))

    pilot_sweeps = 0
    if mb.step_size is None:
        for xc, yc in loader:
            xp, _, mp = padded(xc, yc)
            eta = estimate_step_size(ops, centers, precond, lam, xp, mp, iters=mb.power_iters,
                                     safety=mb.step_safety)
            pilot_sweeps = mb.power_iters
            break
    else:
        eta = torch.full((), mb.step_size, dtype=precond.T.dtype, device=centers.device)

    timer = _SplitTimer(split_times, centers.device)
    gnorms = []
    rows_swept = float(pilot_sweeps * chunk_rows)

    def project(state):
        t0 = timer.start("projections")
        state, gn = minibatch_project(precond, lam, state, step_size=eta,
                                      momentum=mb.momentum, avg_after=avg_after, tol=mb.tol)
        timer.stop("projections", t0)
        gnorms.append(gn)
        return state

    for _ in range(mb.epochs):
        in_period = 0
        t0 = timer.start("steps")
        for xc, yc in loader:
            xp, yp, mp = padded(xc, yc)
            state = minibatch_step(ops, centers, state, xp, yp, row_mask=mp)
            rows_swept += float(chunk_rows)
            in_period += 1
            if in_period == k:
                timer.stop("steps", t0)
                state = project(state)
                in_period = 0
                t0 = timer.start("steps")
        if in_period:
            timer.stop("steps", t0)
            state = project(state)
    timer.finish()
    return MinibatchResult(state=state, alpha=precond.coeffs(minibatch_solution(state)),
                           grad_norms=torch.stack(gnorms), step_size=eta,
                           pilot_sweeps=pilot_sweeps, rows_swept=rows_swept)
