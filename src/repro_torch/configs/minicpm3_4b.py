"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.
[hf:openbmb/MiniCPM3-4B] MLA: q_lora 768, kv_lora 256, nope 64, rope 32, v 64.
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_head=64,
        d_ff=6400,
        vocab=73448,
        use_mla=True,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        skip_shapes=("long_500k",),
    )
