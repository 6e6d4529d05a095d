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

from repro_torch.core.falkon import FalkonEstimator, resolve_device
from repro_torch.core.kernels import KernelSpec, kernel_from_spec
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
    if not isinstance(spec, KernelSpec):
        kind, params = spec
        params = dict(params)
        spec = KernelSpec(kind, tuple(sorted(params.items())))
    dev = resolve_device(device)
    return FalkonEstimator(
        _tensor(d["centers"], dev), _tensor(d["alpha"], dev), kernel_from_spec(spec),
        block_size=block_size, ops_impl=ops_impl, precision=precision,
        precond=None if precond is None else preconditioner_from_numpy(precond,
                                                                       device=device),
        lam=lam)
