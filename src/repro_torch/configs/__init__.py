"""Config registry: the 10 assigned architectures.

Counterpart of ``repro/configs/__init__.py``, with the same configs.

``get_config(arch)`` returns the full assigned config; ``reduced_config(arch)``
a structurally-identical tiny config (same layer-pattern family, small dims)
for the CPU smoke tests — full configs are only exercised via the dry-run.
"""
from __future__ import annotations

import dataclasses

from .base import (LayerSpec, ModelConfig, SHAPES, ShapeCell, batch_sample, input_specs,
                   torch_dtype)

from . import (
    gemma3_1b,
    gemma3_4b,
    granite_moe_3b_a800m,
    jamba_1_5_large_398b,
    kimi_k2_1t_a32b,
    llama_3_2_vision_90b,
    mamba2_370m,
    minicpm3_4b,
    musicgen_large,
    qwen2_72b,
)

_MODULES = {
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "gemma3-1b": gemma3_1b,
    "qwen2-72b": qwen2_72b,
    "minicpm3-4b": minicpm3_4b,
    "gemma3-4b": gemma3_4b,
    "mamba2-370m": mamba2_370m,
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
    "musicgen-large": musicgen_large,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return _MODULES[arch].get_config()


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config: 2 periods + tail of the real layer pattern,
    small widths, few experts — one CPU train/serve step in seconds."""
    from repro_torch.models.model import split_periods

    cfg = get_config(arch)
    period, n_per, tail = split_periods(cfg.layer_pattern)
    n_keep = min(n_per, 2)
    pattern = period * n_keep + tail
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(pattern), layer_pattern=pattern,
        d_model=64, n_heads=heads, n_kv_heads=kv, d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        d_expert=32 if cfg.n_experts else 0,
        n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
        # lossless capacity (C >= worst-case expert load) so decode ==
        # teacher-forced forward exactly; the full configs keep 1.25.
        capacity_factor=float(min(cfg.n_experts, 4)) if cfg.n_experts else 1.25,
        vocab=512, vocab_pad_multiple=64,
        sliding_window=8,
        q_lora_rank=32 if cfg.use_mla else 0,
        kv_lora_rank=16 if cfg.use_mla else 0,
        qk_nope_dim=16 if cfg.use_mla else 0,
        qk_rope_dim=8 if cfg.use_mla else 0,
        v_head_dim=16 if cfg.use_mla else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        n_image_tokens=16 if cfg.n_image_tokens else 0,
        d_vision=32 if cfg.d_vision else 0,
        dense_attn_max_seq=64,   # exercise the chunked-attention path too
        attn_chunk=16,
        dtype="float32", remat="none", fsdp=False,
    )


__all__ = ["ARCH_IDS", "LayerSpec", "ModelConfig", "SHAPES", "ShapeCell", "batch_sample",
           "get_config", "input_specs", "reduced_config", "torch_dtype"]
