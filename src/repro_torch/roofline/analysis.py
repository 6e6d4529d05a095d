"""Roofline derivation from a counted step, at the H100's constants.

Counterpart of ``repro/roofline/analysis.py``. Three terms per (arch x
shape x mesh) cell:

    compute    = flops_per_device / peak_flops        [s]
    memory     = bytes_per_device / HBM_BW            [s]
    collective = collective_bytes_per_device / NVLINK_BW  [s]

The reference reads them from XLA (``compiled.cost_analysis()`` and the
post-partitioning HLO text); the port reads them from ``op_cost.analyze``,
which counts the ops one rank runs, the local shards' shapes after
DTensor's sharding propagation. Collective bytes are the operand bytes of
the local shards, keyed by the reference's kinds (the counterpart of
``parse_collective_bytes``: ``OpCost.collective_bytes``).

The constants are those of one H100 SXM 80GB from NVIDIA's data sheet
(dense rates, no sparsity, at the 700 W power limit): datasheet figures,
not measurements of this repository.
"""
from __future__ import annotations

import dataclasses
import math

# --- H100 SXM 80GB constants (per card; NVIDIA's data sheet) --------------
#: bf16 dense tensor-core peak, FLOP/s (datasheet, not measured)
PEAK_FLOPS = 989.4e12
#: fp32 peak outside the tensor cores, FLOP/s: the 67 TFLOP/s PERF.md's
#: kernel bounds use (datasheet, not measured)
PEAK_FLOPS_FP32 = 66.9e12
#: HBM3 bandwidth, bytes/s (datasheet, not measured)
HBM_BW = 3.35e12
#: NVLink bandwidth a card, each direction, bytes/s (datasheet: 900 GB/s
#: both ways; not measured)
NVLINK_BW = 450e9
#: device memory a card, bytes (datasheet: 80 GB)
HBM_BYTES = 80e9


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6 N D (global, per step)
    useful_flops_ratio: float     # model_flops / (flops_per_device * chips)
    chips: int
    xla_flops_once: float         # the same count as flops_per_device (see below)
    unbounded_whiles: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def derive_roofline(cost, *, chips: int, model_flops: float,
                    peak_flops: float = PEAK_FLOPS) -> Roofline:
    """The three terms from an ``op_cost.OpCost`` of one rank's step.

    The fields and their names are the reference's, so artifacts compare
    field for field. ``xla_flops_once`` (XLA's loop-body-once count in the
    reference) holds the same count as ``flops_per_device`` and
    ``unbounded_whiles`` is 0: an eager op count has no loop bodies counted
    once. ``peak_flops`` is the compute term's rate: the bf16 tensor-core
    peak by default, ``PEAK_FLOPS_FP32`` for an fp32 solve."""
    flops = float(cost.flops)
    byts = float(cost.bytes)
    compute_s = flops / peak_flops
    memory_s = byts / HBM_BW
    collective_s = cost.collective_total / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    global_flops = flops * chips
    ratio = model_flops / global_flops if global_flops else 0.0
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes={k: float(v) for k, v in cost.collective_bytes.items()},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_ratio=ratio,
        chips=chips,
        xla_flops_once=flops,
        unbounded_whiles=int(cost.unbounded_whiles),
    )


def memory_report(cost) -> dict:
    """The reference's ``memory_analysis`` keys from an ``OpCost``'s memory
    (one rank's storages, counted as the step runs): arguments are the
    state and the batch on one rank; alias is what the step updates in
    place (the port's step writes parameters, optimizer state and cache in
    place, where the reference donates them); temp is the peak above the
    arguments and the fresh outputs. So ``total_per_device`` is the peak."""
    mem = cost.memory
    rep = {
        "argument_size_in_bytes": int(mem.arguments),
        "output_size_in_bytes": int(mem.outputs),
        "temp_size_in_bytes": int(mem.temp),
        "alias_size_in_bytes": int(mem.aliased),
        "generated_code_size_in_bytes": 0,
    }
    rep["total_per_device"] = (rep["argument_size_in_bytes"] +
                               rep["output_size_in_bytes"] +
                               rep["temp_size_in_bytes"] -
                               rep["alias_size_in_bytes"])
    return rep


def train_model_flops(cfg, tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D_tokens (fwd+bwd)."""
    return 6.0 * cfg.param_count(active_only=bool(cfg.n_experts)) * tokens


def decode_model_flops(cfg, batch: int, kv_len: int) -> float:
    """One decode step: 2 * N_active matmul flops + attention over the cache
    (2 * 2 * H*dh * kv_len per layer per sequence, q@k and p@v)."""
    n_active = cfg.param_count(active_only=bool(cfg.n_experts))
    flops = 2.0 * n_active * batch
    attn_layers = sum(1 for s in cfg.layer_pattern if s.kind in ("full", "sliding"))
    if cfg.use_mla:
        per = 2 * 2 * cfg.n_heads * cfg.kv_lora_rank * kv_len
    else:
        per = 2 * 2 * cfg.n_heads * cfg.d_head * kv_len
    flops += attn_layers * per * batch
    return flops


# ---------------------------------------------------------------------------
# Analytic per-device memory: parameter, optimizer and cache bytes computed
# exactly from the parameter descriptors and the sharding rules, on the
# reference's stacked trees, plus the reference's coarse activation model.
# ---------------------------------------------------------------------------
def _pd_device_bytes(pd_tree, rules, dtype_bytes: float) -> float:
    from repro_torch.distributed.mesh import named_sizes
    from repro_torch.models.params import tree_map

    sizes = named_sizes(rules.mesh)
    total = 0.0

    def leaf(pd):
        nonlocal total
        shards = 1
        for entry in rules.spec_for(pd.shape, pd.axes):
            if entry is None:
                continue
            for nm in (entry if isinstance(entry, tuple) else (entry,)):
                shards *= sizes[nm]
        total += float(math.prod(pd.shape)) * dtype_bytes / shards

    tree_map(leaf, pd_tree)
    return total


def analytic_memory(cfg, cell, rules, *, microbatch: int = 1) -> dict:
    """Per-device GB (3 decimals): exact parameters, optimizer state,
    gradients and cache, plus coarse activations: the reference's model."""
    from repro_torch.distributed.mesh import named_sizes
    from repro_torch.models.model import split_periods, stacked_cache_pd, stacked_model_pd

    pd_tree = stacked_model_pd(cfg)
    params = _pd_device_bytes(pd_tree, rules, 2.0)          # bf16
    out = {"params": params}
    if cell.kind == "train":
        out["grads"] = params
        if cfg.optimizer == "adamw":
            out["opt"] = _pd_device_bytes(pd_tree, rules, 8.0)  # fp32 mu+nu
        elif cfg.optimizer == "adafactor":
            out["opt"] = params * 0.06                       # row+col factors
        else:
            out["opt"] = params * 2
    else:
        out["grads"] = out["opt"] = 0.0
    if cell.kind == "decode":
        out["cache"] = _pd_device_bytes(
            stacked_cache_pd(cfg, cell.global_batch, cell.seq_len), rules, 2.0)
    else:
        out["cache"] = 0.0
    # activations: tokens/device (per microbatch) x d_model x live-layer count
    sizes = named_sizes(rules.mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in sizes:
            dp *= sizes[a]
    if cell.kind == "train":
        tok = cell.global_batch * cell.seq_len / dp / max(microbatch, 1)
        period, n_per, tail = split_periods(cfg.layer_pattern)
        a = max(1, int(math.sqrt(n_per)))
        live = (a + n_per // a + len(tail)) + 12   # carries + transients
        out["activations"] = tok * cfg.d_model * 2.0 * live
    elif cell.kind == "prefill":
        tok = cell.global_batch * cell.seq_len / dp
        out["activations"] = tok * cfg.d_model * 2.0 * 10
    else:
        out["activations"] = cell.global_batch * cfg.d_model * 2.0 * 64
    out["total"] = sum(out.values())
    return {k: round(v / 1e9, 3) for k, v in out.items()}
