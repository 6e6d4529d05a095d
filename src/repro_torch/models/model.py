"""Model assembly: the layer stack, loss, and prefill / decode.

Counterpart of ``repro/models/model.py``. The reference stacks the
parameters of the smallest repeating *period* of the layer pattern and
scans over them; the port keeps one module per layer in a plain
``ModuleList`` in pattern order and loops over it: the reference's period
slot ``i`` at repeat ``r`` is layer ``r * P + i``, then the tail
(``convert.model_params_from_numpy`` maps one onto the other;
``param_tree`` gives the model's parameters back in the reference's tree,
each period slot a ``LeafGroup`` of its repeats, for the optimizers and
checkpoints). With ``cfg.remat == "full"`` a differentiated forward runs
each layer and each cross-entropy chunk under
``torch.utils.checkpoint.checkpoint`` (the reference's ``jax.checkpoint``
of its period body, tail layers and CE chunks): their activations are
recomputed in the backward pass, and a chunk's logits live only inside it.
A stack of ``n_per >= 12`` periods whose count has a divisor
``a = _sqrt_factor(n_per) > 1`` is checkpointed on two levels, as the
reference's: ``a`` groups of ``n_per // a`` periods each run under an
outer checkpoint, so that the backward pass keeps O(a + n_per / a) layer
inputs live instead of O(n_per). It changes memory only.

Sharding: the reference's ``lshard`` annotations stand at the same places
with the same logical axes (no-ops without active rules).
``model_param_pspecs`` and ``cache_pspecs`` return the reference's specs,
on its stacked trees (``stacked_model_pd``, the period slots' leading
``"fsdp"`` axis included); ``models.place_module`` puts a model on a
mesh, each layer's parameter at the spec of its own, unstacked,
descriptor.

The public functions keep the reference's names and signatures with the
model in place of the parameter tree: ``forward(model, cfg, batch)``,
``loss_fn``, ``prefill``, ``decode_step``, ``init_cache``, ``cache_specs``,
``model_params(generator, cfg)`` and ``model_param_structs(cfg)``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig, torch_dtype
from repro_torch.distributed.mesh import (current_rules, local_apply, lshard, recompute_contexts,
                                          sharded_zeros, unshard)
from . import layers as L
from . import ssm as S
from .params import (PD, LeafGroup, ParamModule, init_module, init_params, param_pspecs,
                     param_shape_structs, stack_pds, tree_map)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Period decomposition
# ---------------------------------------------------------------------------
def split_periods(pattern: tuple[LayerSpec, ...]):
    """-> (period, n_periods, tail). Smallest p with pattern = period*k + tail
    and tail a prefix of the period; k maximal."""
    Lp = len(pattern)
    for p in range(1, Lp + 1):
        k = Lp // p
        period = pattern[:p]
        if period * k == pattern[: p * k] and pattern[p * k:] == period[: Lp - p * k]:
            if k >= 1:
                return period, k, pattern[p * k:]
    return pattern, 1, ()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def _mixer(cfg: ModelConfig, spec: LayerSpec, dtype, device) -> nn.Module:
    if spec.kind == "mamba":
        return S.Mamba2Mixer(cfg, dtype=dtype, device=device)
    if spec.kind == "cross":
        return L.Attention(cfg, cross=True, dtype=dtype, device=device)
    if cfg.use_mla:
        return L.MLA(cfg, dtype=dtype, device=device)
    return L.Attention(cfg, dtype=dtype, device=device)


def layer_pd(cfg: ModelConfig, spec: LayerSpec) -> dict:
    D = cfg.d_model
    d: dict[str, Any] = {"ln1": PD((D,), ("embed",), "ones")}
    if spec.kind == "mamba":
        d["mixer"] = S.ssm_pd(cfg)
    elif spec.kind == "cross":
        d["mixer"] = L.attn_pd(cfg, cross=True)
    elif cfg.use_mla:
        d["mixer"] = L.mla_pd(cfg)
    else:
        d["mixer"] = L.attn_pd(cfg)
    if spec.moe or cfg.d_ff > 0:
        d["ln2"] = PD((D,), ("embed",), "ones")
        d["mlp"] = L.moe_pd(cfg) if spec.moe else L.mlp_pd(cfg)
    return d


class Block(ParamModule):
    """One layer: ``ln1``, ``mixer`` (attention, MLA or Mamba-2) and, where
    the config has one, ``ln2`` and ``mlp`` (dense or MoE)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, dtype, device=None):
        pd = layer_pd(cfg, spec)
        super().__init__({k: v for k, v in pd.items() if k not in ("mixer", "mlp")},
                         dtype=dtype, device=device)
        self.mixer = _mixer(cfg, spec, dtype, device)
        if "mlp" in pd:
            self.mlp = (L.MoE if spec.moe else L.MLP)(cfg, dtype=dtype, device=device)

    def forward(self, x, cfg, spec, **kw):
        return layer_apply(self, x, cfg, spec, **kw)


def layer_apply(p: Block, x: Tensor, cfg: ModelConfig, spec: LayerSpec, *, positions,
                vision_kv=None, cache=None, pos_scalar=None):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    if spec.kind == "mamba":
        mix, new_cache = p.mixer(h, cfg, cache=cache)
    elif spec.kind == "cross":
        mix, new_cache = p.mixer(h, cfg, spec, positions=positions, kv_x=vision_kv,
                                 cache=cache, pos_scalar=pos_scalar)
    elif cfg.use_mla:
        mix, new_cache = p.mixer(h, cfg, positions=positions, cache=cache,
                                 pos_scalar=pos_scalar)
    else:
        mix, new_cache = p.mixer(h, cfg, spec, positions=positions, cache=cache,
                                 pos_scalar=pos_scalar)
    # the residual stream keeps the layer output's layout between the mixer
    # and the MLP (on a mesh the mixer's partial sums would otherwise leave
    # it sequence-sharded, and its gradient with it)
    x = lshard(x + mix, ("batch", None, "embed"))
    if hasattr(p, "mlp"):
        h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
        x = x + p.mlp(h2, cfg)
    x = lshard(x, ("batch", None, "embed"))
    return x, new_cache


# ---------------------------------------------------------------------------
# The model and its parameters
# ---------------------------------------------------------------------------
def model_pd(cfg: ModelConfig) -> dict:
    """The port's descriptor tree: the reference's, with ``layers`` (one
    tree a layer, in pattern order) in place of its stacked ``period`` and
    its ``tail``."""
    D, V = cfg.d_model, cfg.padded_vocab
    tree: dict[str, Any] = {}
    # the embed table always exists: "embeds" frontends (audio) use it for
    # decode (the EnCodec codebook is the vocab)
    tree["embed"] = PD((V, D), ("vocab", "embed"), "embed", scale=0.02)
    if cfg.frontend == "tokens+vision":
        tree["vision_proj"] = PD((cfg.d_vision, D), (None, "embed"))
    tree["layers"] = [layer_pd(cfg, spec) for spec in cfg.layer_pattern]
    tree["ln_f"] = PD((D,), ("embed",), "ones")
    tree["lm_head"] = PD((D, V), ("embed", "vocab"), scale=0.02)
    return tree


class Model(ParamModule):
    """The LM: ``embed``, ``vision_proj`` (vision frontends), ``layers``
    (a ``ModuleList`` of ``Block``s in pattern order), ``ln_f``, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, *, dtype=None, device=None):
        dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
        pd = model_pd(cfg)
        del pd["layers"]
        super().__init__(pd, dtype=dtype, device=device)
        self.layers = nn.ModuleList(Block(cfg, spec, dtype=dtype, device=device)
                                    for spec in cfg.layer_pattern)

    def forward(self, cfg: ModelConfig, batch: dict) -> Tensor:
        return forward(self, cfg, batch)


def model_params(generator: torch.Generator, cfg: ModelConfig, *,
                 device: str | torch.device | None = None) -> Model:
    """A ``Model`` at ``cfg.dtype`` with random weights from ``generator``,
    on the generator's device unless ``device`` says otherwise. The draws
    are torch's, at the reference's scales: a period layer's default scale
    is that of the reference's stacked leaf, whose fan-in counts the
    repeats (1/2 the per-layer scale at 4 repeats)."""
    device = generator.device if device is None else torch.device(device)
    model = Model(cfg, device=device)
    period, n_per, _ = split_periods(cfg.layer_pattern)
    for block in model.layers[:n_per * len(period)]:
        for sub in block.modules():
            if isinstance(sub, ParamModule):
                sub._stack = n_per
    return init_module(model, generator)


def model_param_structs(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` tensors at ``cfg.dtype``: no allocation."""
    return param_shape_structs(model_pd(cfg), torch_dtype(cfg.dtype))


def _named_tree(module: nn.Module, leaf) -> dict:
    """The module's parameters as a nested dict: ``leaf(name)`` for each
    parameter, under its dotted name's parts."""
    out: dict = {}
    for name, _ in module.named_parameters():
        node, parts = out, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf(name)
    return out


def param_tree(model: Model, cfg: ModelConfig) -> dict:
    """The model's parameters in the reference's tree: the top-level leaves
    (``embed``, ``vision_proj``, ``ln_f``, ``lm_head``), ``period`` (one
    tree a period slot, each leaf a ``LeafGroup`` of that slot's parameter
    in every repeat, repeat order) and ``tail`` (one tree a tail layer).
    The leaves are the model's own ``Parameter``s, not copies."""
    period, n_per, tail = split_periods(cfg.layer_pattern)
    P = len(period)
    params = dict(model.named_parameters())

    def slot(i: int) -> dict:
        return _named_tree(model.layers[i], lambda name: LeafGroup(
            params[f"layers.{r * P + i}.{name}"] for r in range(n_per)))

    def tail_layer(i: int) -> dict:
        return _named_tree(model.layers[i], lambda name: params[f"layers.{i}.{name}"])

    tree = dict(model.named_parameters(recurse=False))
    tree["period"] = [slot(i) for i in range(P)]
    tree["tail"] = [tail_layer(n_per * P + j) for j in range(len(tail))]
    return tree


def stacked_model_pd(cfg: ModelConfig) -> dict:
    """The reference's descriptor tree: ``period`` (one tree a period slot,
    stacked over its repeats with the leading ``"fsdp"`` axis) and
    ``tail`` in place of ``layers``."""
    period, n_per, tail = split_periods(cfg.layer_pattern)
    tree = model_pd(cfg)
    del tree["layers"]
    tree["period"] = [stack_pds(layer_pd(cfg, spec), n_per) for spec in period]
    tree["tail"] = [layer_pd(cfg, spec) for spec in tail]
    return tree


def model_param_pspecs(cfg: ModelConfig, rules):
    """The reference's PartitionSpecs of its parameter tree (stacked periods)."""
    return param_pspecs(stacked_model_pd(cfg), rules)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _embed_inputs(model: Model, cfg: ModelConfig, batch: dict) -> Tensor:
    if "embeds" in batch:
        return batch["embeds"].to(torch_dtype(cfg.dtype))
    return _lookup(model.embed, batch["tokens"])


def _lookup(table: Tensor, ids: Tensor) -> Tensor:
    """table[ids]; on a mesh each rank looks its batch rows up in the whole
    table (gathered, as DTensor's indexing rule gathers it on a 2-D mesh;
    that rule cannot plan a 3-D mesh on torch 2.11)."""
    axes = ("batch",) + (None,) * (ids.ndim - 1)
    return local_apply(lambda t, i: t[i.long()], (table, ids), ((None, None), axes),
                       axes + (None,))


def _vision_kv_src(model: Model, cfg: ModelConfig, batch: dict) -> Tensor | None:
    if cfg.frontend != "tokens+vision":
        return None
    return batch["vision_embeds"].to(torch_dtype(cfg.dtype)) @ model.vision_proj


def _stack_apply(model: Model, cfg: ModelConfig, x: Tensor, *, positions, vision_kv=None,
                 caches=None, pos_scalar=None):
    """Run the layers in order. caches: None or one cache a layer. Returns
    (x, new caches or None). Under ``remat == "full"`` a differentiated
    pass without caches checkpoints each layer, and a deep period stack
    its groups of periods too (two-level checkpointing)."""
    layers = list(zip(model.layers, cfg.layer_pattern))
    kw = dict(positions=positions, vision_kv=vision_kv)
    if _remat(cfg) and caches is None:
        period, n_per, _ = split_periods(cfg.layer_pattern)
        a = _sqrt_factor(n_per)
        if n_per >= 12 and a > 1:
            per_group = len(period) * (n_per // a)
            for g in range(a):
                x = checkpoint(_checkpointed_layers, layers[g * per_group:(g + 1) * per_group],
                               x, cfg, kw, use_reentrant=False, context_fn=recompute_contexts)
            layers = layers[a * per_group:]
        return _checkpointed_layers(layers, x, cfg, kw), None
    new_caches = None if caches is None else []
    for i, (block, spec) in enumerate(layers):
        x, nc = block(x, cfg, spec, cache=None if caches is None else caches[i],
                      pos_scalar=pos_scalar, **kw)
        if caches is not None:
            new_caches.append(nc)
    return x, new_caches


def _checkpointed_layers(layers, x: Tensor, cfg: ModelConfig, kw: dict) -> Tensor:
    """Run (block, spec) pairs in order, each under a checkpoint."""
    for block, spec in layers:
        x, _ = checkpoint(block, x, cfg, spec, use_reentrant=False,
                          context_fn=recompute_contexts, **kw)
    return x


def _sqrt_factor(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n)."""
    best = 1
    for a in range(2, int(n**0.5) + 1):
        if n % a == 0:
            best = a
    return best


def _remat(cfg: ModelConfig) -> bool:
    """Recompute in the backward pass: ``remat == "full"`` and autograd on."""
    return cfg.remat == "full" and torch.is_grad_enabled()


def _backbone(model: Model, cfg: ModelConfig, batch: dict) -> Tensor:
    """Embed -> stack -> final norm. Returns hidden states (B, S, D)."""
    x = _embed_inputs(model, cfg, batch)
    x = lshard(x, ("batch", None, "embed"))
    positions = torch.arange(x.shape[1], device=x.device)
    vkv = _vision_kv_src(model, cfg, batch)
    x, _ = _stack_apply(model, cfg, x, positions=positions, vision_kv=vkv)
    return L.rms_norm(x, model.ln_f, cfg.norm_eps)


def forward(model: Model, cfg: ModelConfig, batch: dict) -> Tensor:
    """Training/prefill forward -> logits (B, S, padded_vocab)."""
    x = _backbone(model, cfg, batch)
    logits = torch.einsum("bsd,dv->bsv", x, model.lm_head)
    return lshard(logits, ("batch", None, "vocab"))


def _ce_chunk(x_c: Tensor, labels_c: Tensor, lm_head: Tensor, cfg: ModelConfig) -> Tensor:
    """Summed CE over one sequence chunk (logits live only for the chunk)."""
    logits = torch.einsum("bsd,dv->bsv", x_c, lm_head)
    logits = lshard(logits, ("batch", None, "vocab"))
    V = cfg.padded_vocab
    if V != cfg.vocab:   # mask padded vocab entries out of the normalizer
        pad = torch.arange(V, device=logits.device) >= cfg.vocab
        logits = torch.where(pad[None, None, :], torch.finfo(logits.dtype).min, logits)
    m = torch.amax(logits, dim=-1).detach()
    sumexp = torch.sum(torch.exp((logits - m[..., None]).float()), dim=-1)
    lse = m.float() + torch.log(sumexp)
    # DTensor's gather over a vocab-sharded dim reduces its masked partial
    # wrongly (torch 2.13): the gather reads logits replicated on the vocab
    gold = torch.gather(unshard(logits, -1), -1, labels_c.long()[..., None])[..., 0]
    return torch.sum(lse - gold.float())


def loss_fn(model: Model, cfg: ModelConfig, batch: dict, *, ce_chunk: int = 512):
    """Mean next-token CE over the batch -> (loss, {"loss", "ppl_proxy"}).
    Differentiable; under ``remat == "full"`` each chunk's logits are
    recomputed in the backward pass."""
    x = _backbone(model, cfg, batch)                                 # (B,S,D)
    labels = batch["labels"]
    B, S_, _ = x.shape
    Sc = min(ce_chunk, S_)
    if S_ % Sc:
        Sc = S_                                                      # odd sizes: one chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(cfg)
    for c in range(0, S_, Sc):
        args = (x[:, c:c + Sc], labels[:, c:c + Sc], model.lm_head, cfg)
        total = total + (checkpoint(_ce_chunk, *args, use_reentrant=False,
                                    context_fn=recompute_contexts) if remat
                         else _ce_chunk(*args))
    loss = total / (B * S_)
    return loss, {"loss": loss, "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}


# ---------------------------------------------------------------------------
# Serving: cache specs and init, prefill, decode
# ---------------------------------------------------------------------------
def layer_cache_pd(cfg: ModelConfig, spec: LayerSpec, B: int, S_max: int) -> dict:
    if spec.kind == "mamba":
        H, N, P_, di, K = (cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.d_inner,
                           cfg.ssm_conv)
        return {
            "state": PD((B, H, N, P_), ("batch", "heads", None, None), "zeros"),
            "conv": PD((B, K - 1, di + 2 * N), ("batch", None, "ff"), "zeros"),
        }
    if spec.kind == "cross":
        shape = (B, cfg.n_image_tokens, cfg.n_kv_heads, cfg.d_head)
        axes = ("batch", None, "kv_heads", None)
        return {"k": PD(shape, axes, "zeros"), "v": PD(shape, axes, "zeros")}
    if cfg.use_mla:
        return {
            "c_kv": PD((B, S_max, cfg.kv_lora_rank), ("batch", "cache_seq", None), "zeros"),
            "k_rope": PD((B, S_max, cfg.qk_rope_dim), ("batch", "cache_seq", None), "zeros"),
        }
    seq_ax = "cache_seq" if B == 1 else "kv_seq"
    shape = (B, S_max, cfg.n_kv_heads, cfg.d_head)
    axes = ("batch", seq_ax, "kv_heads", None)
    return {"k": PD(shape, axes, "zeros"), "v": PD(shape, axes, "zeros")}


def cache_pd(cfg: ModelConfig, B: int, S_max: int) -> dict:
    """The decode cache: ``pos`` and one tree a layer, in pattern order."""
    return {"pos": PD((), (), "zeros"),
            "layers": [layer_cache_pd(cfg, spec, B, S_max) for spec in cfg.layer_pattern]}


def cache_specs(cfg: ModelConfig, B: int, S_max: int) -> dict:
    """The cache as ``meta`` tensors (``pos`` int32): no allocation."""
    structs = param_shape_structs(cache_pd(cfg, B, S_max), torch_dtype(cfg.dtype))
    structs["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return structs


def init_cache(cfg: ModelConfig, B: int, S_max: int, *,
               device: str | torch.device = "cuda") -> dict:
    """A zero cache on ``device``; under active rules with a mesh, each
    layer's leaf a DTensor at its descriptor's sharding, only this rank's
    shard allocated (``pos`` a plain tensor, the same on every rank)."""
    rules = current_rules()
    dt = torch_dtype(cfg.dtype)
    if rules.mesh is None:
        out = init_params(None, cache_pd(cfg, B, S_max), dt, device)
    else:
        out = tree_map(lambda pd: sharded_zeros(pd.shape, dt, rules.sharding_for(pd.shape,
                                                                                 pd.axes),
                                                device), cache_pd(cfg, B, S_max))
    out["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def stacked_cache_pd(cfg: ModelConfig, B: int, S_max: int) -> dict:
    """The reference's descriptor tree of its decode cache: ``pos``,
    ``period`` (one tree a slot, stacked over its repeats on an unnamed
    leading axis) and ``tail``."""
    period, n_per, tail = split_periods(cfg.layer_pattern)
    return {"pos": PD((), (), "zeros"),
            "period": [stack_pds(layer_cache_pd(cfg, spec, B, S_max), n_per, axis_name=None)
                       for spec in period],
            "tail": [layer_cache_pd(cfg, spec, B, S_max) for spec in tail]}


def cache_pspecs(cfg: ModelConfig, B: int, S_max: int, rules):
    """The reference's PartitionSpecs of its decode cache (``pos``
    replicated)."""
    return param_pspecs(stacked_cache_pd(cfg, B, S_max), rules)


@torch.no_grad()
def prefill(model: Model, cfg: ModelConfig, batch: dict, S_max: int):
    """Run the prompt through the stack, building a cache of capacity S_max.
    Returns (last-position logits (B, padded_vocab), cache)."""
    B, S_ = (batch["embeds"] if cfg.frontend == "embeds" else batch["tokens"]).shape[:2]
    x = _embed_inputs(model, cfg, batch)
    cache = init_cache(cfg, B, S_max, device=x.device)
    positions = torch.arange(S_, device=x.device)
    vkv = _vision_kv_src(model, cfg, batch)
    x, new_caches = _stack_apply(model, cfg, x, positions=positions, vision_kv=vkv,
                                 caches=cache["layers"])
    x = L.rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x[:, -1:], model.lm_head)
    return logits[:, 0], {"pos": torch.tensor(S_, dtype=torch.int32, device=x.device),
                          "layers": new_caches}


@torch.no_grad()
def decode_step(model: Model, cfg: ModelConfig, cache: dict, batch: dict):
    """One token step. batch: {"token": (B,)}. The new token's entries are
    written into the cache's tensors in place; the returned cache holds
    them and ``pos + 1``. Returns (logits (B, padded_vocab), cache)."""
    x = _lookup(model.embed, batch["token"])[:, None, :]
    x = lshard(x, ("batch", None, "embed"))
    pos = cache["pos"]
    x, new_caches = _stack_apply(model, cfg, x, positions=pos.reshape(1),
                                 caches=cache["layers"], pos_scalar=pos)
    x = L.rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, model.lm_head)[:, 0]
    return lshard(logits, ("batch", "vocab")), {"pos": pos + 1, "layers": new_caches}
