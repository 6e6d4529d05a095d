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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import _tree_map, compressed_grads, init_residuals
from repro_torch.models import Model, decode_step, loss_fn, model_params, param_tree
from repro_torch.models.params import LeafGroup
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
    ``grad_norm`` (before clipping) and ``lr``. ``grad_shardings`` waits
    for the sharding rules (ROADMAP.md item A15.3)."""
    if grad_shardings is not None:
        raise NotImplementedError("make_train_step(grad_shardings=...): the sharding rules "
                                  "are not ported (ROADMAP.md item A15.3)")
    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps)

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
                g = _grad_tree(model, cfg, loss)
                if g_acc is None:
                    g_acc = _tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                            device=x.device), g)
                _tree_map(lambda a, b: a.add_((b / nb).to(torch.float32)), g_acc, g)
                del g
                l_acc = l_acc + loss.detach() / nb
            return l_acc, {"loss": l_acc}, g_acc
        loss, metrics = loss_fn(model, cfg, batch)
        grads = _grad_tree(model, cfg, loss)
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
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(params=model, opt_state=opt_state, residuals=residuals,
                          step=state.step + 1), metrics

    return train_step


def train_state_pspecs(cfg: ModelConfig, tcfg: TrainConfig, rules):
    """Not ported: the sharding rules are ROADMAP.md item A15.3."""
    raise NotImplementedError("train_state_pspecs: the sharding rules are not ported "
                              "(ROADMAP.md item A15.3)")


def batch_pspecs(cfg: ModelConfig, batch_structs: dict, rules):
    """Not ported: the sharding rules are ROADMAP.md item A15.3."""
    raise NotImplementedError("batch_pspecs: the sharding rules are not ported "
                              "(ROADMAP.md item A15.3)")


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(model, cache, batch):
        return decode_step(model, cfg, cache, batch)
    return serve_step
