"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE. [arXiv:2501.kimi2]
Per the assignment table this build uses GQA (kv=8), not K2's MLA.
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_head=112,
        d_ff=0,
        d_expert=2048,
        n_experts=384,
        top_k=8,
        vocab=163840,
        layer_pattern=tuple(LayerSpec("full", moe=True) for _ in range(61)),
        fsdp=True,
        optimizer="adafactor",
        skip_shapes=("long_500k",),
    )
