"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding window, 128k context. [hf:google/gemma-3-1b-pt]
Pattern: (5 sliding + 1 full) x 4 + 2 sliding tail; window 512.
head_dim 256 (gemma3 uses wide heads: q width 1024 != d_model, fine).
"""
from .base import LayerSpec, ModelConfig


def _pattern(n):
    out = []
    for i in range(n):
        out.append(LayerSpec("full" if i % 6 == 5 else "sliding"))
    return tuple(out)


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_head=256,
        d_ff=6912, vocab=262144,
        layer_pattern=_pattern(26), sliding_window=512,
        rope_theta=1_000_000.0,
        # runs long_500k: 5/6 of layers are O(window); the global layers
        # attend to a ("data","model")-sharded cache.
    )
