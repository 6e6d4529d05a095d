"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave. [arXiv:2403.19887]
Period of 8: [attn, mamba x7], MoE on every other layer (odd in-period index).
SSM: d_state 16, conv 4, expand 2 (d_inner 16384, 256 heads of 64).
"""
from .base import LayerSpec, ModelConfig


def _pattern(n):
    out = []
    for i in range(n):
        kind = "full" if i % 8 == 0 else "mamba"
        out.append(LayerSpec(kind, moe=(i % 2 == 1)))
    return tuple(out)


def get_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=24576, d_expert=24576, n_experts=16, top_k=2,
        vocab=65536,
        layer_pattern=_pattern(72),
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
        ssm_chunk=128,
        fsdp=True, optimizer="adafactor",
        # runs long_500k: hybrid 1:7 attn:mamba.
    )
