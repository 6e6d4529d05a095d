"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens. [arXiv:2306.05284]
Frontend is a stub per the assignment: input_specs() provides precomputed
frame embeddings (the 4-codebook delay-pattern sum); the decode path embeds
EnCodec code ids through the (vocab=2048) table.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab=2048,
        n_codebooks=4,
        frontend="embeds",
        act="gelu",
        skip_shapes=("long_500k",),
    )
