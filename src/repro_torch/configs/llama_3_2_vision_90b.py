"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers. [hf:meta-llama/Llama-3.2-90B-Vision]
Pattern: every 5th layer is gated cross-attention to the (stubbed) vision
frontend: input_specs provides precomputed patch embeddings (1601 x 1280).
"""
from .base import LayerSpec, ModelConfig


def _pattern(n):
    return tuple(LayerSpec("cross" if i % 5 == 4 else "full") for i in range(n))


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=28672,
        vocab=128256,
        layer_pattern=_pattern(100),
        frontend="tokens+vision",
        n_image_tokens=1601,
        d_vision=1280,
        fsdp=True,
        optimizer="adafactor",
        skip_shapes=("long_500k",),
    )
