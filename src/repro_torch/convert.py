"""Carry a fitted model's state across from the JAX package, as numpy.

The JAX package and this port cannot share random draws, so parity is held
by handing one package's state to the other. These functions take plain
numpy arrays keyed by the JAX package's field names — the caller converts
(``np.asarray``) on its side — and build the port's objects from them.
An LM's parameters, decode caches and train state come as the
reference's trees, with its stacked periods (``model_params_from_numpy``,
``cache_from_numpy``, ``train_state_from_numpy``).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.falkon import (FalkonEstimator, FalkonPathResult, FalkonPathState,
                                     resolve_device)
from repro_torch.core.kernels import KernelSpec, kernel_from_spec
from repro_torch.core.minibatch import MinibatchState
from repro_torch.models.model import Model, split_periods
from repro_torch.core.preconditioner import Preconditioner, PreconditionerPath


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    a = np.array(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16 leaves: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype or torch.bfloat16)
    return torch.as_tensor(a, dtype=dtype, device=device)


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


# ---------------------------------------------------------------------------
# LM parameters and decode caches
# ---------------------------------------------------------------------------
def _np_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _np_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_map(fn, v) for v in tree]
    return fn(tree)


def layer_trees(tree: Mapping, cfg) -> list:
    """The reference's per-layer trees in pattern order, from a tree with
    stacked ``period`` slots and a ``tail``: period slot ``i`` at repeat
    ``r`` is layer ``r * len(period) + i``."""
    period, n_per, tail = split_periods(cfg.layer_pattern)
    if len(tree["period"]) != len(period) or len(tree["tail"]) != len(tail):
        raise ValueError(f"tree has {len(tree['period'])} period slots and "
                         f"{len(tree['tail'])} tail layers; {cfg.name} has "
                         f"{len(period)} and {len(tail)}")
    out = [_np_map(lambda a, r=r: np.asarray(a)[r], tree["period"][i])
           for r in range(n_per) for i in range(len(period))]
    return out + list(tree["tail"])


def model_params_from_numpy(tree: Mapping, cfg, *, device: str = "cuda") -> Model:
    """A port ``Model`` at ``cfg.dtype`` from the reference's parameter tree
    (numpy leaves, stacked periods): every parameter under its reference
    name, shapes checked, every leaf used. On ``device`` (the card unless
    the caller asks for the CPU; without a card the default raises)."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    flat = {k: v for k, v in tree.items() if k not in ("period", "tail")}
    flat["layers"] = layer_trees(tree, cfg)
    used = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            node = flat
            for part in name.split("."):
                node = node[int(part)] if isinstance(node, list) else node[part]
            value = np.asarray(node)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: reference shape {value.shape}, port "
                                 f"{tuple(param.shape)}")
            param.copy_(_tensor(value, dev, param.dtype))
            used += 1
    n_leaves = [0]
    _np_map(lambda a: n_leaves.__setitem__(0, n_leaves[0] + 1), flat)
    if used != n_leaves[0]:
        raise ValueError(f"{n_leaves[0] - used} reference leaves have no port parameter")
    return model


def cache_from_numpy(tree: Mapping, cfg, *, device: str = "cuda") -> dict:
    """A port decode cache (``{"pos", "layers"}``) from the reference's
    (``{"pos", "period", "tail"}``, numpy leaves, stacked periods); each
    leaf keeps its dtype (an SSM state written by a prefill is fp32)."""
    dev = resolve_device(device)
    layers = _np_map(lambda a: _tensor(a, dev), layer_trees(tree, cfg))
    return {"pos": _tensor(tree["pos"], dev, torch.int32),
            "layers": layers}


def train_state_from_numpy(tree, cfg, tcfg, *, device: str = "cuda"):
    """A port ``TrainState`` from the reference's (a ``TrainState`` or a
    dict of its fields, numpy leaves): the parameters through
    :func:`model_params_from_numpy` (so :func:`layer_trees`), the
    optimizer state and the residuals at the reference's leaf shapes (the
    port's, ``repro_torch.train.steps``), each leaf checked against the
    port's fresh state and keeping its dtype, the step as int32. On
    ``device`` (the card unless the caller asks for the CPU; without a card
    the default raises)."""
    from repro_torch.train.steps import TrainState, train_state_structs

    dev = resolve_device(device)
    d = tree._asdict() if hasattr(tree, "_asdict") else dict(tree)
    like = train_state_structs(cfg, tcfg)

    def leaves(sub, ref, what):
        if isinstance(ref, Mapping):
            if sorted(sub) != sorted(ref):
                raise ValueError(f"{what}: keys {sorted(sub)}, port {sorted(ref)}")
            return {k: leaves(sub[k], ref[k], f"{what}.{k}") for k in ref}
        if isinstance(ref, (list, tuple)):
            if len(sub) != len(ref):
                raise ValueError(f"{what}: {len(sub)} entries, port {len(ref)}")
            return [leaves(a, b, f"{what}[{i}]") for i, (a, b) in enumerate(zip(sub, ref))]
        value = np.asarray(sub)
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{what}: reference shape {value.shape}, port {tuple(ref.shape)}")
        return _tensor(value, dev)

    return TrainState(params=model_params_from_numpy(d["params"], cfg, device=device),
                      opt_state=leaves(d["opt_state"], like.opt_state, "opt_state"),
                      residuals=leaves(d["residuals"], like.residuals, "residuals"),
                      step=_tensor(d["step"], dev, torch.int32))
