"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global. [hf:google/gemma-3-4b-pt] Window 1024, head_dim 256.
"""
from .base import LayerSpec, ModelConfig


def _pattern(n):
    return tuple(LayerSpec("full" if i % 6 == 5 else "sliding") for i in range(n))


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=10240,
        vocab=262144,
        layer_pattern=_pattern(34),
        sliding_window=1024,
        rope_theta=1_000_000.0,
    )
