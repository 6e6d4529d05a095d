"""The train step and the serve step.

Counterpart of ``repro/train/steps.py``. ``make_train_step(cfg, tcfg)``
returns ``train_step(state, batch) -> (state, metrics)``: loss -> grad ->
clip -> (optional) int8 error feedback -> optimizer, the reference's order.
``make_serve_step(cfg)`` returns ``(model, cache, batch) -> (logits,
cache)``.

The step is eager PyTorch, where the reference jits it and donates the
state: the model's parameters and the optimizer's state are updated in
place, and the returned ``TrainState`` holds the same model and state with
the step advanced. The gradients, the optimizer state and the error-feedback
residuals have the reference's leaf shapes (``models.param_tree``: a period
slot's gradient is the stack of its repeats' gradients), so Adafactor's
factored moments and ``quantize_int8``'s per-tensor scale span the same
tensors as the reference's.

On a mesh: ``place_train_state`` puts a state's model, optimizer state
and residuals on ``rules.mesh`` as DTensors (each layer's parameter at its
own descriptor's spec, the stacked state at the stack of those), the step
runs under ``use_rules(rules)``, and ``make_train_step(grad_shardings=
param_shardings(model, cfg))`` redistributes each gradient, and each fp32
microbatch accumulator, to its parameter's sharding. ``train_state_pspecs``
and ``batch_pspecs`` return the reference's specs, on its stacked trees.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import _tree_map, compressed_grads, init_residuals
from repro_torch.distributed.mesh import PartitionSpec, leaf_sharding, zeros_for
from repro_torch.models import (Model, decode_step, loss_fn, model_params, param_tree,
                                place_module, stacked_model_pd)
from repro_torch.models.params import PD, LeafGroup, param_pspecs, tree_map
from repro_torch.optim.optimizers import (clip_by_global_norm, is_param, make_optimizer,
                                         warmup_cosine)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    grad_compression: bool = False     # int8 error-feedback
    microbatch: int = 0                # 0 = no grad accumulation


class TrainState(NamedTuple):
    params: Model           # the model; its parameters are the trained leaves
    opt_state: Any          # the reference's leaf shapes
    residuals: Any          # error-feedback (empty dict if compression off)
    step: Tensor            # 0-d int32


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig) -> TrainState:
    """A fresh state: the model drawn from ``generator`` on its device, the
    optimizer's zero state, zero residuals under grad compression."""
    return _state_for(model_params(generator, cfg), cfg, tcfg)


def _state_for(model: Model, cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    tree = param_tree(model, cfg)
    device = model.ln_f.device
    return TrainState(
        params=model,
        opt_state=make_optimizer(cfg.optimizer).init(tree),
        residuals=init_residuals(tree) if tcfg.grad_compression else {},
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def train_state_structs(cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """The train state on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return _state_for(Model(cfg, device="meta"), cfg, tcfg)


def place_train_state(state: TrainState, cfg: ModelConfig, tcfg: TrainConfig,
                      rules) -> TrainState:
    """The state on ``rules.mesh``: the model placed in place
    (``place_module``), the optimizer state and the residuals as DTensors at
    the shardings the optimizer's ``init`` gives on the placed parameters,
    holding the state's values (every rank holds the same full state
    before). The step stays a plain tensor on every rank."""
    model = place_module(state.params, rules)
    fresh = _state_for(model, cfg, tcfg)

    def put(old, new):
        sh = leaf_sharding(new)
        return old if sh is None else sh.place(old.to(new.device))

    return TrainState(params=model, opt_state=_tree_map(put, state.opt_state, fresh.opt_state),
                      residuals=_tree_map(put, state.residuals, fresh.residuals),
                      step=state.step)


def param_shardings(model: Model, cfg: ModelConfig) -> dict:
    """The sharding of each leaf of ``param_tree(model, cfg)`` (None off a
    mesh): the ``grad_shardings`` of ``make_train_step``."""
    return _tree_map(leaf_sharding, param_tree(model, cfg), is_leaf=is_param)


def state_shardings(state: TrainState, cfg: ModelConfig) -> TrainState:
    """The sharding of each leaf of ``state_tree(state, cfg)`` (None for a
    plain tensor): what ``load_checkpoint(shardings=)`` places a restored
    state at."""
    return _tree_map(leaf_sharding, state_tree(state, cfg), is_leaf=is_param)


def state_tree(state: TrainState, cfg: ModelConfig) -> TrainState:
    """The state as a tree of the reference's layout (the parameters as
    ``param_tree``): what a checkpoint saves and restores."""
    return state._replace(params=param_tree(state.params, cfg))


def _grad_tree(model: Model, cfg: ModelConfig, loss: Tensor) -> dict:
    """d loss / d parameters in the reference's tree: a period slot's leaf
    the stack of its repeats' gradients; a parameter the loss does not
    read gets zeros (as the reference's)."""
    tree = param_tree(model, cfg)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g) for p, g in zip(params, grads)}
    del grads

    def leaf(p):
        if isinstance(p, LeafGroup):
            return torch.stack([by_id.pop(id(t)) for t in p])
        return by_id.pop(id(p))

    return _tree_map(leaf, tree, is_leaf=is_param)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, grad_shardings=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; metrics hold 0-d
    tensors: ``loss`` (and ``ppl_proxy`` without microbatches),
    ``grad_norm`` (before clipping) and ``lr``, whole on every rank.

    grad_shardings: optional tree of ``NamedSharding`` matching the
    parameter tree (``param_shardings``). Each gradient, and each fp32
    microbatch accumulator, is redistributed to it: otherwise an
    accumulator would follow the gradients' partial sums and reduce them
    in full every microbatch (the reference measured 10.5 TB a step a
    device on jamba-398B)."""
    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps)

    def constrain(tree):
        if grad_shardings is None:
            return tree
        return _tree_map(lambda g, sh: g if sh is None else sh.place(g), tree, grad_shardings)

    def compute_grads(model: Model, batch: dict):
        if tcfg.microbatch and tcfg.microbatch > 1:
            # gradient accumulation over the batch split: the reference's
            # scan, each microbatch's gradient divided by nb in its own
            # dtype and added into float32 buffers
            nb = tcfg.microbatch
            B = batch["labels"].shape[0]
            if B % nb:
                raise ValueError(f"batch {B} does not split into {nb} microbatches")
            g_acc = None
            l_acc = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
            for i in range(nb):
                mbatch = {k: v[i * (B // nb):(i + 1) * (B // nb)] for k, v in batch.items()}
                loss, _ = loss_fn(model, cfg, mbatch)
                g = constrain(_grad_tree(model, cfg, loss))
                if g_acc is None:
                    g_acc = _tree_map(lambda x: zeros_for(x, x.shape, torch.float32), g)
                _tree_map(lambda a, b: a.add_((b / nb).to(torch.float32)), g_acc, g)
                del g
                l_acc = l_acc + loss.detach() / nb
            return l_acc, {"loss": l_acc}, g_acc
        loss, metrics = loss_fn(model, cfg, batch)
        grads = constrain(_grad_tree(model, cfg, loss))
        return loss, {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: TrainState, batch: dict):
        model = state.params
        loss, metrics, grads = compute_grads(model, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        residuals = state.residuals
        if tcfg.grad_compression:
            grads, residuals = compressed_grads(grads, residuals)
        lr = lr_fn(state.step)
        _, opt_state = opt.update(grads, state.opt_state, param_tree(model, cfg), lr)
        metrics = {k: _whole(v) for k, v in dict(metrics, grad_norm=gnorm, lr=lr).items()}
        return TrainState(params=model, opt_state=opt_state, residuals=residuals,
                          step=state.step + 1), metrics

    return train_step


def _whole(t: Tensor) -> Tensor:
    """A metric as a plain tensor: a DTensor's full value."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def train_state_pspecs(cfg: ModelConfig, tcfg: TrainConfig, rules):
    """PartitionSpecs for the whole TrainState, on the reference's stacked
    trees (opt state inherits the param sharding — ZeRO for free;
    adafactor's factored moments drop the reduced dim's spec entry)."""
    pd_tree = stacked_model_pd(cfg)
    pspecs = param_pspecs(pd_tree, rules)
    if cfg.optimizer == "adamw":
        opt = {"mu": pspecs, "nu": pspecs, "step": PartitionSpec()}
    elif cfg.optimizer == "sgdm":
        opt = {"mu": pspecs, "step": PartitionSpec()}
    elif cfg.optimizer == "adafactor":
        def fac(pd: PD):
            if len(pd.shape) >= 2:
                return {"vr": rules.spec_for(pd.shape[:-1], pd.axes[:-1]),
                        "vc": rules.spec_for(pd.shape[:-2] + pd.shape[-1:],
                                             pd.axes[:-2] + pd.axes[-1:])}
            return {"v": rules.spec_for(pd.shape, pd.axes)}
        opt = {"f": tree_map(fac, pd_tree), "step": PartitionSpec()}
    else:
        raise ValueError(cfg.optimizer)
    residuals = pspecs if tcfg.grad_compression else {}
    return TrainState(params=pspecs, opt_state=opt, residuals=residuals, step=PartitionSpec())


def batch_pspecs(cfg: ModelConfig, batch_structs: dict, rules):
    """Batch inputs shard over the data axes when the batch dim divides."""
    return {k: rules.spec_for(v.shape, ("batch",) + (None,) * (len(v.shape) - 1))
            for k, v in batch_structs.items()}


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(model, cache, batch):
        return decode_step(model, cfg, cache, batch)
    return serve_step
