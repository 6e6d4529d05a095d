"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8. [hf:ibm-granite/granite-3.0-3b-a800m-base; hf]
(Assignment header lists both "40e top-8" and "32 experts top-8"; we follow the
primary spec: 40 experts, top-8 — matching the HF granite-3.0-3b-a800m card.)
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
        d_ff=0, d_expert=512, n_experts=40, top_k=8,
        vocab=49155,
        layer_pattern=tuple(LayerSpec("full", moe=True) for _ in range(32)),
        skip_shapes=("long_500k",),   # pure full attention
    )
