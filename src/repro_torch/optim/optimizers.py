"""Optimizers: AdamW, Adafactor, SGD-momentum, with the reference's update math.

Counterpart of ``repro/optim/optimizers.py``. An optimizer is the pair
``init(params) -> state`` and ``update(grads, state, params, lr) ->
(params, state)``. No ``torch.optim`` class: each update is the reference's
formula, term by term in float32, so that a step is held to the reference's.

Trees are nested dicts and lists. The state mirrors the parameter tree,
with the reference's leaf shapes: a ``LeafGroup`` parameter (the port's
tensors of one period slot, one a repeat) has its moments as one stacked
tensor, as the reference's stacked leaf does. That matters to Adafactor:
its update RMS is taken over the whole stacked leaf, and a per-layer 1-D
parameter is 2-D once stacked, so it gets factored moments whose column
factor averages over the repeats. ``grads`` has the state's leaf shapes.

The port updates in place: ``update`` writes the new values into
``params`` and into the state's tensors and returns both. The scalar math
(bias corrections, Adafactor's decay, the schedule) is taken in float32
tensors on the parameters' device, as the reference takes it in float32.

On a mesh (parameters that are DTensors) the state is DTensors too: a
moment at its parameter's sharding (a ``LeafGroup``'s stacked: the leading
dimension replicated), Adafactor's factored moments at it less the reduced
dimension, so that an update whose gradients carry their parameters'
sharding moves no data but the norms' scalars.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distributed.compression import _tree_map
from repro_torch.distributed.mesh import drop_dim, leaf_sharding, zeros_for
from repro_torch.models.params import LeafGroup, tree_flatten

Tensor = torch.Tensor


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Tensor], tuple[Any, Any]]
    # update(grads, state, params, lr) -> (params, state), both updated in place


def is_param(x) -> bool:
    """A parameter leaf: a tensor or a ``LeafGroup``."""
    return isinstance(x, (Tensor, LeafGroup))


def _value(p) -> Tensor:
    """A parameter leaf's value at the reference's leaf shape."""
    return p.stack() if isinstance(p, LeafGroup) else p.detach()


def _assign(dst, value: Tensor) -> None:
    """Write ``value`` into a parameter leaf or a state tensor, in place (on
    a mesh, at ``dst``'s sharding)."""
    sh = leaf_sharding(dst)
    dst.copy_(value if sh is None else sh.place(value))


def tree_leaves(tree) -> list[Tensor]:
    """The tensors of a tree in the reference's leaf order (``tree_flatten``);
    a ``LeafGroup`` gives its stacked value."""
    return [_value(x) for x in tree_flatten(tree)]


def _step_f32(state) -> tuple[Tensor, Tensor]:
    step = state["step"] + 1
    return step, step.to(torch.float32)


def global_norm(tree) -> Tensor:
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to ``max_norm`` if above it, the norm before). Each
    leaf is scaled in float32 and cast back to its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype=torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: zeros_for(p, p.shape, state_dtype)  # noqa: E731
        return {"mu": _tree_map(zeros, params, is_leaf=is_param),
                "nu": _tree_map(zeros, params, is_leaf=is_param),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step, t = _step_f32(state)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)

        def upd(p, g, m, v):
            g32 = g.to(state_dtype)
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
            mh = m_new / bc1
            vh = v_new / bc2
            pv = _value(p)
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pv.to(state_dtype)
            _assign(p, (pv.to(state_dtype) - lr * delta).to(pv.dtype))
            _assign(m, m_new)
            _assign(v, v_new)

        _tree_map(upd, params, grads, state["mu"], state["nu"], is_leaf=is_param)
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8, weight_decay=0.0) -> Optimizer:
    """Factored second moments for >= 2-D leaves (rows + cols), full for
    1-D: O(n + m) state instead of O(nm) (Shazeer & Stern 2018)."""
    def init(params):
        def f(p):
            shape, sh = tuple(p.shape), leaf_sharding(p)
            if len(shape) >= 2:
                def fac(dim, sub):
                    return zeros_for(p, sub, torch.float32,
                                     sh and drop_dim(sh, dim, len(shape)))
                return {"vr": fac(-1, shape[:-1]), "vc": fac(-2, shape[:-2] + shape[-1:])}
            return {"v": zeros_for(p, shape, torch.float32)}
        return {"f": _tree_map(f, params, is_leaf=is_param),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step, t = _step_f32(state)
        beta = 1.0 - torch.pow(t, -decay)

        def upd(p, g, s):
            g32 = g.to(torch.float32)
            g2 = g32 * g32 + eps
            if g.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                u = g32 / torch.sqrt((vr / denom)[..., None] * vc[..., None, :] + eps)
                _assign(s["vr"], vr)
                _assign(s["vc"], vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 / torch.sqrt(v + eps)
                _assign(s["v"], v)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pv = _value(p)
            delta = u + weight_decay * pv.to(torch.float32)
            _assign(p, (pv.to(torch.float32) - lr * delta).to(pv.dtype))

        _tree_map(upd, params, grads, state["f"], is_leaf=is_param)
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def sgdm(momentum=0.9, weight_decay=0.0) -> Optimizer:
    def init(params):
        return {"mu": _tree_map(lambda p: zeros_for(p, p.shape, torch.float32), params,
                                is_leaf=is_param),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params, lr):
        def upd(p, g, m):
            pv = _value(p)
            m_new = momentum * m + g.to(torch.float32) + weight_decay * pv.to(torch.float32)
            _assign(p, (pv.to(torch.float32) - lr * m_new).to(pv.dtype))
            _assign(m, m_new)

        _tree_map(upd, params, grads, state["mu"], is_leaf=is_param)
        state["step"] = state["step"] + 1
        return params, state

    return Optimizer(init, update)


def _device(params) -> torch.device:
    leaves = tree_flatten(params)
    return leaves[0].device if leaves else torch.device("cpu")


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](**kw)


# -- schedules ---------------------------------------------------------------
def warmup_cosine(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    """step -> learning rate, a float32 tensor on the step's device (a
    Python number gives one on the CPU): linear warmup to ``base_lr``, then
    a cosine to ``min_ratio * base_lr`` at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr
