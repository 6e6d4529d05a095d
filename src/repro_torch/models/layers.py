"""Layers for the 10 assigned architectures.

Counterpart of ``repro/models/layers.py``, in plain torch ops. Each layer
kind is a module (``MLP``, ``MoE``, ``Attention``, ``MLA``) whose
parameters carry the reference's leaf names (``wq``, ``w_gate``, ...),
built from ``<layer>_pd(cfg)``; its computation is the reference's
``<layer>_apply`` with the module in place of the parameter dict. The
config is passed at each call, as in the reference, so one set of weights
runs under a changed config (e.g. another ``dense_attn_max_seq``).

The numerics follow the reference: scores and softmax in fp32, masks at
-1e30 (not -inf), softmax weights cast to the activation dtype before the
value product, ``rms_norm`` in fp32 cast back before the scale, half-split
RoPE with fp32 angles, and ``gelu`` as the tanh approximation.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.mesh import (PartitionSpec as P, current_rules, data_axes,
                                          local_apply, lshard, named_sizes, placements_for,
                                          replicated, unshard)
from .params import PD, ParamModule

Tensor = torch.Tensor

NEG = -1e30                       # the reference's mask value
INT32_MAX = 2**31 - 1             # padded key positions


def _inv_sqrt(n: int) -> float:
    """1/sqrt(n) rounded as the reference's fp32 ``1.0 / jnp.sqrt(n)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def _sqrt(n: int) -> float:
    return float(np.sqrt(np.float32(n)))


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------
def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def _act(name: str, gate: Tensor | None, up: Tensor) -> Tensor:
    if name == "swiglu":
        return F.silu(gate) * up
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if name == "gelu":
        return F.gelu(up, approximate="tanh")
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, dh) or (B, S, dh); positions: (S,). Half-split rotation
    with fp32 angles."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                      -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].float() * freqs                         # (S, half)
    ang = ang[None, :, None, :] if x.ndim == 4 else ang[None, :, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def mlp_pd(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PD((D, F_), ("embed", "ff")),
        "w_up": PD((D, F_), ("embed", "ff")),
        "w_down": PD((F_, D), ("ff", "embed")),
    }


class MLP(ParamModule):
    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__(mlp_pd(cfg), dtype=dtype, device=device)

    def forward(self, x: Tensor, cfg: ModelConfig) -> Tensor:
        h = _act(cfg.act, x @ self.w_gate, x @ self.w_up)
        h = lshard(h, ("batch", None, "ff"))
        return h @ self.w_down


# ---------------------------------------------------------------------------
# MoE (top-k, capacity-dropped, scatter dispatch)
# ---------------------------------------------------------------------------
def moe_pd(cfg: ModelConfig) -> dict:
    # expert dim padded to a shardable multiple; padded experts are masked
    # out of the router
    D, E, Fe = cfg.d_model, cfg.padded_experts, cfg.d_expert
    return {
        "router": PD((D, E), ("embed", "experts"), scale=0.02),
        "w_gate": PD((E, D, Fe), ("experts", "embed", None)),
        "w_up": PD((E, D, Fe), ("experts", "embed", None)),
        "w_down": PD((E, Fe, D), ("experts", None, "embed")),
    }


class MoE(ParamModule):
    """Token-dropping top-k MoE. Two paths, as in the reference:

    * expert parallelism (``_moe_sharded``): under rules whose mesh has a
      ``"model"`` axis, when the sequence splits over it, the batch over
      the data axes, and S > 1 (training and prefill). Tokens are sharded
      (batch over the data axes, sequence over ``"model"``), dispatched
      locally, sent to their experts' rank by one all-to-all, run through
      the local experts and sent back by a second;
    * local dispatch (``_moe_local``): everywhere else (one device, decode).
    """

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__(moe_pd(cfg), dtype=dtype, device=device)

    def forward(self, x: Tensor, cfg: ModelConfig) -> Tensor:
        mesh = current_rules().mesh
        sizes = {} if mesh is None else named_sizes(mesh)
        if "model" in sizes:
            mp = sizes["model"]
            dp = data_axes(mesh)
            dp_size = math.prod(sizes[a] for a in dp)
            B, S, _ = x.shape
            if S % mp == 0 and B % dp_size == 0 and S // mp >= 1 and S > 1:
                return _moe_sharded(self, x, cfg, mesh, mp, dp)
        return _moe_local(self, x, cfg)


def _dispatch(xf: Tensor, router: Tensor, cfg: ModelConfig, C: int):
    """Route the tokens xf (T, D) to their top-k experts at capacity C.
    Returns (xe (E, C, D) the experts' inputs, keep, slot, gate): an
    assignment past its expert's capacity is dropped (its slot the
    overflow row E * C)."""
    T, D = xf.shape
    E, K = cfg.padded_experts, cfg.top_k
    logits = (xf @ router).float()                                   # (T, E_pad)
    if E != cfg.n_experts:   # mask padded experts out of the routing
        pad = torch.arange(E, device=xf.device)[None, :] >= cfg.n_experts
        logits = torch.where(pad, NEG, logits)
    probs = torch.softmax(logits, -1)
    gate, eidx = torch.topk(probs, K, dim=-1)                        # (T, K)
    gate = (gate / torch.sum(gate, -1, keepdim=True)).to(xf.dtype)

    e_flat = eidx.reshape(-1)                                        # (T*K,)
    # position of each assignment within its expert (priority: token order)
    onehot = F.one_hot(e_flat, E).to(torch.int32)                    # (T*K, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot    # count before me
    pos = torch.gather(pos, 1, e_flat[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, e_flat * C + pos, E * C)               # overflow -> last row

    x_rep = torch.repeat_interleave(xf, K, dim=0)                    # (T*K, D)
    buf = torch.zeros(E * C + 1, D, dtype=xf.dtype, device=xf.device)
    buf = buf.index_add(0, slot, x_rep * keep[:, None].to(xf.dtype))
    return buf[:-1].reshape(E, C, D), keep, slot, gate


def _combine(ye: Tensor, keep: Tensor, slot: Tensor, gate: Tensor) -> Tensor:
    """The experts' outputs ye (E, C, D) back to their tokens, gate-weighted:
    (T, D)."""
    E, C, D = ye.shape
    T, K = gate.shape
    yf = ye.reshape(E * C, D)
    y_tok = torch.where(keep[:, None], yf[torch.clamp(slot, max=E * C - 1)],
                        torch.zeros((), dtype=yf.dtype, device=yf.device))
    return (y_tok.reshape(T, K, D) * gate[..., None]).sum(dim=1)


def _experts(xe: Tensor, wg: Tensor, wu: Tensor, wd: Tensor, cfg: ModelConfig) -> Tensor:
    h = _act(cfg.act, torch.einsum("ecd,edf->ecf", xe, wg), torch.einsum("ecd,edf->ecf", xe, wu))
    return torch.einsum("ecf,efd->ecd", h, wd)


def _moe_local(p: MoE, x: Tensor, cfg: ModelConfig) -> Tensor:
    B, S, D = x.shape
    T = B * S
    # capacity over this call's tokens: prefill and decode drop differently
    C = max(1, int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    # on a mesh every rank routes all the call's tokens (decode's few):
    # DTensor's rule for the dispatch's scatter of sharded tokens misplans
    # it (torch 2.11)
    xe, keep, slot, gate = _dispatch(replicated(x.reshape(T, D)), replicated(p.router), cfg, C)
    xe = lshard(xe, ("experts", "expert_cap", None))
    ye = lshard(_experts(xe, p.w_gate, p.w_up, p.w_down, cfg), ("experts", "expert_cap", None))
    # the combine reads any expert's slots: ye whole on every rank (DTensor
    # would replicate it too, from the strided shard its flattening makes)
    return _combine(replicated(ye), keep, slot, gate).reshape(B, S, D)


def _moe_sharded(p: MoE, x: Tensor, cfg: ModelConfig, mesh, mp: int, dp: tuple) -> Tensor:
    """Expert parallelism on local shards: the reference's ``shard_map``
    with in_specs (P(dp, "model"), P(), P("model") x 3). Each rank takes
    its (B/dp, S/mp) block of tokens, dispatches them at the capacity of
    its own T = B/dp * S/mp tokens, and exchanges (E, C, D) buffers with
    the ranks of its ``"model"`` group: expert ids are shard-major (expert
    j * E_loc + e is rank j's e-th), as ``P("model")`` splits the weights.
    Gradients: the router's and the experts' local gradients are partial
    sums over the ranks whose tokens they saw (``to_local``'s
    ``grad_placements``), the tokens' are their own shard's."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd
    from torch.distributed.tensor import DTensor, Partial, Replicate

    sizes = named_sizes(mesh)
    E, K = cfg.padded_experts, cfg.top_k
    E_loc = E // mp
    x_pl = placements_for(mesh, P(dp, "model"))
    w_pl = placements_for(mesh, P("model"))
    # a local gradient is a partial sum over the mesh dimensions whose ranks
    # saw other tokens (size-1 dimensions replicate, as in placements_for)
    summed = [Partial() if (a in dp or a == "model") and n > 1 else Replicate()
              for a, n in sizes.items()]
    w_grad = [w if a == "model" else g for a, w, g in zip(sizes, w_pl, summed)]

    def local(t, placements, grad=None):
        if not isinstance(t, DTensor):       # a plain tensor is replicated
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, placements).to_local(grad_placements=grad)

    x_loc = local(x, x_pl)
    router = local(p.router, [Replicate()] * mesh.ndim, summed)
    wg, wu, wd = (local(w, w_pl, w_grad) for w in (p.w_gate, p.w_up, p.w_down))
    group = mesh.get_group("model")

    def all_to_all(t):
        return all_to_all_single_autograd(t.contiguous(), None, None, group)

    Bl, Sl, D = x_loc.shape
    T = Bl * Sl
    C = max(1, int(-(-T * K * cfg.capacity_factor // cfg.n_experts)))
    xe, keep, slot, gate = _dispatch(x_loc.reshape(T, D), router, cfg, C)
    # (E, C, D) -> (src shard, E_loc, C, D) -> (E_loc, mp * C, D)
    xe = all_to_all(xe.reshape(mp, E_loc, C, D))
    xe = xe.transpose(0, 1).reshape(E_loc, mp * C, D)
    ye = _experts(xe, wg, wu, wd, cfg)                               # (E_loc, mp*C, D)
    # back to the source-local (E, C, D) layout
    ye = all_to_all(ye.reshape(E_loc, mp, C, D).transpose(0, 1))
    y = _combine(ye.reshape(E, C, D), keep, slot, gate).reshape(Bl, Sl, D)
    return DTensor.from_local(y, mesh, x_pl, run_check=False)


# ---------------------------------------------------------------------------
# Attention (GQA / sliding / cross) with a chunked online-softmax option
# ---------------------------------------------------------------------------
def attn_pd(cfg: ModelConfig, cross: bool = False) -> dict:
    D, Hkv, dh = cfg.d_model, cfg.n_kv_heads, cfg.d_head
    Hq = cfg.padded_heads     # dummy heads zeroed in attn_apply
    p = {
        "wq": PD((D, Hq, dh), ("embed", "heads", None)),
        "wk": PD((D, Hkv, dh), ("embed", "kv_heads", None)),
        "wv": PD((D, Hkv, dh), ("embed", "kv_heads", None)),
        "wo": PD((Hq, dh, D), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = PD((Hq, dh), ("heads", None), "zeros")
        p["bk"] = PD((Hkv, dh), ("kv_heads", None), "zeros")
        p["bv"] = PD((Hkv, dh), ("kv_heads", None), "zeros")
    if cross:
        p["q_norm"] = PD((dh,), (None,), "ones")
        p["k_norm"] = PD((dh,), (None,), "ones")
        p["gate"] = PD((1,), (None,), "zeros")   # zero-init cross gate
    return p


def _mask(si: Tensor, sj: Tensor, causal: bool, window: int) -> Tensor:
    """si: query positions (Sq,), sj: key positions (Sk,) -> bool (Sq, Sk)."""
    m = torch.ones((si.shape[0], sj.shape[0]), dtype=torch.bool, device=si.device)
    if causal:
        m &= sj[None, :] <= si[:, None]
    if window > 0:
        m &= sj[None, :] > si[:, None] - window
    return m


def _masked_write(cache: Tensor, new: Tensor, idx: Tensor) -> Tensor:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, Smax, ...) at position
    ``idx`` (a 0-d tensor on the cache's device), in place."""
    if _is_dtensor(cache):
        return _local_seq_write(cache, new, idx)
    return cache.index_copy_(1, idx.reshape(1).long(), new.to(cache.dtype))


def _block_write(cache: Tensor, new: Tensor) -> Tensor:
    """Write a length-S block at position 0 (prefill), in place."""
    if _is_dtensor(cache):
        return _local_seq_write(cache, new, 0)
    cache[:, :new.shape[1]] = new.to(cache.dtype)
    return cache


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


@torch.no_grad()
def _local_seq_write(cache: Tensor, new: Tensor, start) -> Tensor:
    """The cache writes on a mesh, in place on this rank's shard: ``new``
    (B, L, ...) at positions [start, start + L) of the cache DTensor's
    dimension 1 (``start`` an int, or a 0-d tensor with L = 1). ``new``
    comes to the cache's placements with dimension 1 whole; a rank whose
    sequence shard holds none of the positions writes nothing (a tensor
    position: its own entry back). DTensor's in-place ``index_copy_`` and
    slice assignment on a sequence-sharded cache do not keep the shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in cache.placements]
    new_l = new.redistribute(mesh, whole).to_local().to(cache.dtype)
    local = cache.to_local()
    coord = mesh.get_coordinate()
    shard = 0
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            shard = shard * mesh.shape[i] + coord[i]
    n_loc = local.shape[1]
    s0 = shard * n_loc
    if isinstance(start, int):
        a, b = max(start, s0), min(start + new_l.shape[1], s0 + n_loc)
        if a < b:
            local[:, a - s0:b - s0] = new_l[:, a - start:b - start]
        return cache
    li = start.reshape(1).long() - s0
    mine = (li >= 0) & (li < n_loc)
    li = torch.clamp(li, 0, n_loc - 1)
    old = local.index_select(1, li)
    keep = mine.reshape((1, 1) + (1,) * (local.ndim - 2))
    local.index_copy_(1, li, torch.where(keep, new_l, old))
    return cache


def _expand_kv(k: Tensor, groups: int) -> Tensor:
    """(B,S,Hkv,dh) -> (B,S,Hq,dh): query head h reads KV head h // G."""
    return torch.repeat_interleave(k, groups, dim=2) if groups > 1 else k


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor | None) -> Tensor:
    """q: (B,Sq,H,dh), k/v: (B,Sk,H,dh) -> (B,Sq,H,dh)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / _sqrt(dh)
    if mask is not None:
        scores = torch.where(mask[None, None], scores, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _chunked_sdpa(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                  causal: bool, window: int, chunk: int, q_block: int = 2048) -> Tensor:
    """Online-softmax attention: q in blocks of ``q_block``, KV in chunks of
    ``chunk``. Peak score tensor: (B, H, q_block, chunk)."""
    B, Sq, H, dh = q.shape
    if Sq > q_block and Sq % q_block == 0:
        outs = [_chunked_sdpa_core(q[:, i:i + q_block], k, v, q_pos[i:i + q_block], k_pos,
                                   causal, window, chunk)
                for i in range(0, Sq, q_block)]
        return torch.cat(outs, dim=1)
    return _chunked_sdpa_core(q, k, v, q_pos, k_pos, causal, window, chunk)


def _chunked_sdpa_core(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                       causal: bool, window: int, chunk: int) -> Tensor:
    """KV-chunk online softmax. q: (B,Sq,H,dh), k/v: (B,Sk,H,dh|dv).

    The running max starts at -inf and masked scores are -1e30, as in the
    reference: a KV chunk whose keys are all masked (a sliding window's
    past) gives p = 1 on every key until a chunk with a real key rescales
    it by exp(-1e30 - m) = 0; with -inf masks it would give NaN."""
    B, Sq, H, dh = q.shape
    dv = v.shape[-1]
    Sk = k.shape[1]
    nc = -(-Sk // chunk)
    pad = nc * chunk - Sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    kpos = F.pad(k_pos, (0, pad), value=INT32_MAX)
    scale = _inv_sqrt(dh)

    m = torch.full((B, H, Sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, dv), dtype=torch.float32, device=q.device)
    for c in range(nc):
        kb, vb = kp[:, c * chunk:(c + 1) * chunk], vp[:, c * chunk:(c + 1) * chunk]
        pb = kpos[c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        msk = _mask(q_pos, pb, causal, window) & (pb[None, :] < Sk)
        s = torch.where(msk[None, None], s, NEG)
        m_new = torch.maximum(m, torch.amax(s, -1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, -1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                           # (B,Sq,H,dv)


#: attention's operands and output, (B, S, H, dh): computed on each rank's
#: block of batch rows and heads (``local_apply``)
HEADS = ("batch", None, "heads", None)


def _self_attend(q, kf, vf, positions, cfg: ModelConfig, window: int) -> Tensor:
    """Train / prefill attention over fresh KV: dense up to
    ``cfg.dense_attn_max_seq`` query rows, chunked above."""
    if q.shape[1] <= cfg.dense_attn_max_seq:
        mask = _mask(positions, positions, True, window)
        return local_apply(lambda q, k, v: _sdpa(q, k, v, mask), (q, kf, vf), (HEADS,) * 3,
                           HEADS)
    return local_apply(lambda q, k, v: _chunked_sdpa(q, k, v, positions, positions, True,
                                                     window, cfg.attn_chunk),
                       (q, kf, vf), (HEADS,) * 3, HEADS)


def _project(x: Tensor, w: Tensor, heads: str) -> Tensor:
    """x (B, S, D) through a (D, H, dh) projection -> (B, S, H, dh). On a
    mesh each rank projects its batch rows onto its block of heads (the
    weight gathered whole along D): DTensor's own einsum may shard the
    flattened H * dh columns at a boundary inside a head, which the
    (H, dh) view cannot split."""
    return local_apply(lambda x, w: torch.einsum("bsd,dhk->bshk", x, w), (x, w),
                       (("batch", None, None), (None, heads, None)),
                       ("batch", None, heads, None))


def _heads_as_cache(q: Tensor, kc: Tensor) -> Tensor:
    """q (B, 1, Hq, dh) with its heads whole on every rank unless the cache
    kc (B, S, Hkv, dh) splits its kv heads: G query heads share a kv head,
    and a head split that is not a kv-head split cannot be regrouped."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(kc, DTensor) and not any(isinstance(p, Shard) and p.dim == 2
                                           for p in kc.placements):
        return unshard(q, 2)
    return q


def _grouped_decode(qg: Tensor, kc: Tensor, vc: Tensor, valid: Tensor, dh: int) -> Tensor:
    """Decode attention, each kv head against its G query heads: qg
    (B, 1, Hkv, G, dh) over the cache kc, vc (B, S, Hkv, dh) at the
    ``valid`` positions -> (B, 1, Hkv, G, dh)."""
    s = torch.einsum("bqngd,bknd->bngqk", qg, kc).float()
    s = s / _sqrt(dh)
    s = torch.where(valid[None, None, None, None, :], s, NEG)
    w = torch.softmax(s, -1).to(qg.dtype)
    return torch.einsum("bngqk,bknd->bqngd", w, vc)


def _local_kv_heads(fn, qg: Tensor, kc: Tensor, vc: Tensor) -> Tensor:
    """``fn(qg, kc, vc)`` (``_grouped_decode``'s operands) on this rank's
    block of batch rows and kv heads, when the cache is a DTensor sharded
    over them and whole along the sequence: qg comes to the cache's
    placements (its dimensions 0 and 2 are the cache's batch and kv heads,
    and a kv head's G query heads are contiguous), the cache's shards are
    used as they are, and the output, laid out as qg, is wrapped back. So
    each rank computes its block with the unsharded ops; DTensor's own
    einsum folds the sharded batch and head dimensions into one strided
    shard, as in training (``local_apply``). A sequence-sharded cache
    (flash-decoding) stays with DTensor, whose softmax reduces across the
    sequence shards."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(kc, DTensor) or any(isinstance(p, Shard) and p.dim not in (0, 2)
                                          for p in kc.placements):
        return fn(qg, kc, vc)
    mesh, placements = kc.device_mesh, tuple(kc.placements)
    out = fn(qg.redistribute(mesh, placements).to_local(), kc.to_local(),
             vc.redistribute(mesh, placements).to_local())
    return DTensor.from_local(out, mesh, placements, run_check=False)


def _zero_dummy_heads(o: Tensor, cfg: ModelConfig) -> Tensor:
    """Zero the padded heads' outputs (B,S,H,dh): the true-head model."""
    H = o.shape[2]
    if H == cfg.n_heads:
        return o
    keep = torch.arange(H, device=o.device) < cfg.n_heads
    return o * keep[None, None, :, None].to(o.dtype)


class Attention(ParamModule):
    """GQA attention: full, sliding (``spec.kind == "sliding"``) or cross
    (``cross=True``: keys and values from the vision embeddings, a tanh
    gate on the output)."""

    def __init__(self, cfg: ModelConfig, cross: bool = False, *, dtype, device=None):
        super().__init__(attn_pd(cfg, cross), dtype=dtype, device=device)

    def forward(self, x, cfg, spec, **kw):
        return attn_apply(self, x, cfg, spec, **kw)


def attn_apply(p: Attention, x: Tensor, cfg: ModelConfig, spec: LayerSpec, *,
               positions: Tensor, kv_x: Tensor | None = None, cache: dict | None = None,
               pos_scalar: Tensor | None = None):
    """Returns (out, new_cache).

    * train / prefill: ``cache is None`` or Sq > 1 — full-sequence attention
      (dense, or chunked online softmax above ``cfg.dense_attn_max_seq``);
      prefill writes the block's k/v at position 0 of the cache.
    * decode: x is (B, 1, D); ``cache`` holds k/v at capacity S_max and
      ``pos_scalar`` is the write index. Cross layers reuse the image k/v
      held in the cache.
    ``positions``: (Sq,) absolute positions of the query tokens. Cache
    writes are in place.
    """
    B, Sq, D = x.shape
    Hkv, dh = cfg.n_kv_heads, cfg.d_head
    Hq = cfg.padded_heads
    G = Hq // Hkv
    cross = spec.kind == "cross"
    window = cfg.sliding_window if spec.kind == "sliding" else 0

    q = _project(x, p.wq, "heads")
    if "bq" in p._pds:
        q = q + p.bq

    if cross:
        if cache is not None and kv_x is None:
            k, v = cache["k"], cache["v"]          # static image kv
            new_cache = cache
        else:
            k = _project(kv_x, p.wk, "kv_heads")
            v = _project(kv_x, p.wv, "kv_heads")
            new_cache = {"k": k, "v": v}
        if "q_norm" in p._pds:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)
            k = rms_norm(k, p.k_norm, cfg.norm_eps)
        q = lshard(q, ("batch", None, "heads", None))
        o = local_apply(lambda q, k, v: _sdpa(q, k, v, None),
                        (q, _expand_kv(k, G), _expand_kv(v, G)), (HEADS,) * 3, HEADS)
    else:
        k = _project(x, p.wk, "kv_heads")
        v = _project(x, p.wv, "kv_heads")
        if "bk" in p._pds:
            k, v = k + p.bk, v + p.bv
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)     # new tokens only
        q = lshard(q, ("batch", None, "heads", None))

        if cache is not None and Sq > 1:
            # prefill: write the whole kv block at 0, attend over fresh kv
            new_cache = {"k": _block_write(cache["k"], k), "v": _block_write(cache["v"], v)}
            o = _self_attend(q, _expand_kv(k, G), _expand_kv(v, G), positions, cfg, window)
        elif cache is not None:
            # decode: write new kv at pos_scalar, attend over the cache
            idx = pos_scalar
            kc = _masked_write(cache["k"], k, idx)
            vc = _masked_write(cache["v"], v, idx)
            new_cache = {"k": kc, "v": vc}
            kc = lshard(kc, ("batch", "kv_seq", "kv_heads", None))
            vc = lshard(vc, ("batch", "kv_seq", "kv_heads", None))
            k_pos = torch.arange(kc.shape[1], device=x.device)
            valid = k_pos <= idx
            if window > 0:
                valid &= k_pos > idx - window
            # grouped form: each kv head against its G query heads (on a
            # mesh q's heads split only as the cache's kv heads do)
            qg = _heads_as_cache(q, kc).reshape(B, Sq, Hkv, G, dh)
            o = _local_kv_heads(lambda qg, kc, vc: _grouped_decode(qg, kc, vc, valid, dh),
                                qg, kc, vc)
        else:
            new_cache = None
            o = _self_attend(q, _expand_kv(k, G), _expand_kv(v, G), positions, cfg, window)

    o = _zero_dummy_heads(o.reshape(B, Sq, Hq, dh), cfg)
    out = torch.einsum("bshk,hkd->bsd", o, p.wo)
    if cross and "gate" in p._pds:
        out = out * torch.tanh(p.gate)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style latent attention)
# ---------------------------------------------------------------------------
def mla_pd(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.padded_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rp, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": PD((D, r_q), ("embed", None)),
        "q_a_norm": PD((r_q,), (None,), "ones"),
        "wq_b": PD((r_q, H, nope + rp), (None, "heads", None)),
        "w_dkv": PD((D, r_kv), ("embed", None)),
        "kv_a_norm": PD((r_kv,), (None,), "ones"),
        "w_krope": PD((D, rp), ("embed", None)),
        "w_uk": PD((r_kv, H, nope), (None, "heads", None)),
        "w_uv": PD((r_kv, H, vd), (None, "heads", None)),
        "wo": PD((H, vd, D), ("heads", None, "embed")),
    }


class MLA(ParamModule):
    """Multi-head latent attention: expanded keys for train / prefill, the
    absorbed form over the compressed cache for decode."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__(mla_pd(cfg), dtype=dtype, device=device)

    def forward(self, x, cfg, **kw):
        return mla_apply(self, x, cfg, **kw)


def mla_apply(p: MLA, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
              cache: dict | None = None, pos_scalar: Tensor | None = None):
    B, Sq, D = x.shape
    H = cfg.padded_heads
    nope, rp = cfg.qk_nope_dim, cfg.qk_rope_dim

    qa = rms_norm(x @ p.wq_a, p.q_a_norm, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", qa, p.wq_b)                   # (B,S,H,nope+rp)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    c_kv = rms_norm(x @ p.w_dkv, p.kv_a_norm, cfg.norm_eps)         # (B,S,r_kv)
    k_rope = x @ p.w_krope                                           # (B,S,rp)

    if cache is None or Sq > 1:
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        k_rope = rope(k_rope, positions, cfg.rope_theta)
        new_cache = None
        if cache is not None:   # prefill: store the compressed kv at position 0
            new_cache = {"c_kv": _block_write(cache["c_kv"], c_kv),
                         "k_rope": _block_write(cache["k_rope"], k_rope)}
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p.w_uk)
        v = torch.einsum("bsr,rhk->bshk", c_kv, p.w_uv)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, Sq, H, rp)], -1)
        qfull = torch.cat([q_nope, q_rope], -1)
        o = _self_attend(qfull, k, v, positions, cfg, 0)
    else:
        # absorbed decode: scores in the latent space (B,S,r_kv)
        idx = pos_scalar
        q_rope = rope(q_rope, idx.reshape(1), cfg.rope_theta)
        k_rope = rope(k_rope, idx.reshape(1), cfg.rope_theta)
        ckv_c = _masked_write(cache["c_kv"], c_kv, idx)
        krope_c = _masked_write(cache["k_rope"], k_rope, idx)
        new_cache = {"c_kv": ckv_c, "k_rope": krope_c}
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.w_uk)       # absorb W_uk
        s = (torch.einsum("bshr,btr->bhst", q_lat, ckv_c)
             + torch.einsum("bshk,btk->bhst", q_rope, krope_c)).float()
        s = s / _sqrt(nope + rp)
        valid = torch.arange(ckv_c.shape[1], device=x.device) <= idx
        s = torch.where(valid[None, None, None, :], s, NEG)
        w = torch.softmax(s, -1).to(x.dtype)
        o_lat = torch.einsum("bhst,btr->bshr", w, ckv_c)            # (B,1,H,r_kv)
        o = torch.einsum("bshr,rhk->bshk", o_lat, p.w_uv)           # absorb W_uv

    o = _zero_dummy_heads(o, cfg)
    return torch.einsum("bshk,hkd->bsd", o, p.wo), new_cache
