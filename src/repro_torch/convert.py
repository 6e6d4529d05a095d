"""Carry a fitted model's state across from the JAX package, as numpy.

The JAX package and this port cannot share random draws, so parity is held
by handing one package's state to the other. These functions take plain
numpy arrays keyed by the JAX package's field names — the caller converts
(``np.asarray``) on its side — and build the port's objects from them.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.falkon import (FalkonEstimator, FalkonPathResult, FalkonPathState,
                                     resolve_device)
from repro_torch.core.kernels import KernelSpec, kernel_from_spec
from repro_torch.core.minibatch import MinibatchState
from repro_torch.core.preconditioner import Preconditioner, PreconditionerPath


def _tensor(a, device, dtype=None):
    return None if a is None else torch.as_tensor(np.array(a), dtype=dtype,
                                                  device=device)


def preconditioner_from_numpy(d: Mapping, *, device: str = "cuda") -> Preconditioner:
    """A port ``Preconditioner`` from ``{"T", "A", "Q", "D", "n", "diag_T"}``
    (``Q``, ``D`` and ``diag_T`` optional), on ``device`` (the card unless
    the caller asks for the CPU; without a card the default raises)."""
    dev = resolve_device(device)
    T = _tensor(d["T"], dev)
    return Preconditioner(
        T=T, A=_tensor(d["A"], dev), Q=_tensor(d.get("Q"), dev),
        D=_tensor(d.get("D"), dev), n=_tensor(d["n"], dev, T.dtype),
        diag_T=bool(d.get("diag_T", False)))


def preconditioner_path_from_numpy(d: Mapping, *, device: str = "cuda") -> PreconditionerPath:
    """A port ``PreconditionerPath`` from ``{"T", "A", "Q", "D", "lams", "n",
    "diag_T"}`` (``A`` the (L, q, q) stack; ``Q``, ``D`` and ``diag_T``
    optional), on ``device`` (the card unless the caller asks for the CPU;
    without a card the default raises)."""
    dev = resolve_device(device)
    T = _tensor(d["T"], dev)
    return PreconditionerPath(
        T=T, A=_tensor(d["A"], dev), Q=_tensor(d.get("Q"), dev),
        D=_tensor(d.get("D"), dev), lams=_tensor(d["lams"], dev, T.dtype),
        n=_tensor(d["n"], dev, T.dtype), diag_T=bool(d.get("diag_T", False)))


def _kernel(spec):
    if not isinstance(spec, KernelSpec):
        kind, params = spec
        spec = KernelSpec(kind, tuple(sorted(dict(params).items())))
    return kernel_from_spec(spec)


def estimator_from_numpy(d: Mapping, spec, *, precond: Mapping | None = None,
                         lam: float | None = None, ops_impl: str = "cuda",
                         device: str = "cuda", block_size: int = 2048,
                         precision: str = "fp32") -> FalkonEstimator:
    """A port ``FalkonEstimator`` from ``{"centers", "alpha"}`` and the kernel
    spec, given as a ``KernelSpec`` or a ``(kind, params)`` pair with params
    a dict or a tuple of (name, value) pairs. ``precond`` is a dict for
    :func:`preconditioner_from_numpy`. Like every entry point of the port it
    runs on the card on the ``"cuda"`` backend unless asked otherwise;
    without a card the default ``device`` raises."""
    dev = resolve_device(device)
    return FalkonEstimator(
        _tensor(d["centers"], dev), _tensor(d["alpha"], dev), _kernel(spec),
        block_size=block_size, ops_impl=ops_impl, precision=precision,
        precond=None if precond is None else preconditioner_from_numpy(precond,
                                                                       device=device),
        lam=lam)


def path_result_from_numpy(d: Mapping, spec, *, ops_impl: str = "cuda",
                           device: str = "cuda", block_size: int = 2048,
                           precision: str = "fp32") -> FalkonPathResult:
    """A port ``FalkonPathResult`` from a dict of the reference's
    ``FalkonPathState`` fields (``centers``, ``precond`` as a dict for
    :func:`preconditioner_path_from_numpy`, ``beta``, ``alphas``,
    ``residual_norms``, ``lams``; ``val_scores`` and ``best_index``
    optional), the kernel spec as for :func:`estimator_from_numpy`. The
    estimators share one centers tensor and hold their own lam's system of
    the path preconditioner, as the port's path fit builds them."""
    dev = resolve_device(device)
    precond = preconditioner_path_from_numpy(d["precond"], device=device)
    dt = precond.T.dtype
    centers = _tensor(d["centers"], dev, dt)
    state = FalkonPathState(centers=centers, precond=precond, beta=_tensor(d["beta"], dev, dt),
                            alphas=_tensor(d["alphas"], dev, dt),
                            residual_norms=_tensor(d["residual_norms"], dev, dt),
                            lams=_tensor(d["lams"], dev, dt))
    lams = tuple(float(v) for v in np.asarray(d["lams"]))
    kernel = _kernel(spec)
    ests = tuple(FalkonEstimator(centers, state.alphas[i], kernel, block_size=block_size,
                                 ops_impl=ops_impl, precision=precision,
                                 precond=precond.system(i), lam=lam)
                 for i, lam in enumerate(lams))
    best = d.get("best_index")
    return FalkonPathResult(estimators=ests, state=state, lams=lams,
                            val_scores=_tensor(d.get("val_scores"), dev, dt),
                            best_index=None if best is None else int(best))


def minibatch_state_from_numpy(d: Mapping, *, device: str = "cuda") -> MinibatchState:
    """A port ``MinibatchState`` from a dict of the reference's
    ``MinibatchState`` fields (``state._asdict()``, each converted with
    ``np.asarray``), on ``device`` (the card unless the caller asks for the
    CPU; without a card the default raises): the counters keep their types
    (``step`` and ``projections`` int32, ``num_avg`` and ``acc_rows``
    float32), so that ``minibatch_step`` and ``minibatch_project`` can be
    held against the reference's from one state."""
    dev = resolve_device(device)
    ints = ("step", "projections")
    return MinibatchState(**{f: _tensor(d[f], dev, torch.int32 if f in ints else None)
                             for f in MinibatchState._fields})
