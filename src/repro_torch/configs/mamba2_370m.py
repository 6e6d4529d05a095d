"""mamba2-370m [ssm] — 48L d_model=1024 (attn-free) d_ff=0 vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]
expand=2 -> d_inner 2048, head_dim 64 -> 32 heads. No MLP (d_ff=0).
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=32, n_kv_heads=32, d_head=32,
        d_ff=0, vocab=50280,
        layer_pattern=tuple(LayerSpec("mamba") for _ in range(48)),
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
        ssm_chunk=256,
        # runs long_500k: O(1) recurrent state.
    )
