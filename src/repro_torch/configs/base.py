"""ModelConfig, the assigned input shapes and ``input_specs``.

Counterpart of ``repro/configs/base.py``. Every assigned architecture is a
``ModelConfig``; the four assigned shape cells are ``SHAPES``.
``input_specs(cfg, shape)`` returns tensors on the ``meta`` device for every
model input: the shapes and dtypes of the inputs, with no allocation.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

# ---------------------------------------------------------------------------
# Shapes (assigned): seq_len x global_batch
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "full"        # "full" | "sliding" | "mamba" | "cross"
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # moe|dense|ssm|vlm|audio|hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    layer_pattern: tuple[LayerSpec, ...] = ()
    # attention
    sliding_window: int = 4096
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    attn_chunk: int = 1024            # online-softmax KV chunk for long seq
    dense_attn_max_seq: int = 2048    # above this, use chunked attention
    # (keeps the (S, S) fp32 score tensor out of HBM for the 4k train cells;
    # the chunked path's masked-chunk compute waste is a perf-pass item)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    expert_pad_multiple: int = 16     # pad E so expert dims shard (e.g. 40->48)
    head_pad_multiple: int = 16       # pad q heads so attention shards (40->48)
    # MLA (minicpm3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # modality frontend stubs
    n_image_tokens: int = 0           # vlm: precomputed patch embeddings
    d_vision: int = 0
    n_codebooks: int = 0              # audio: EnCodec streams (frontend stub)
    frontend: str = "tokens"          # "tokens" | "embeds" | "tokens+vision"
    # numerics / training
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    act: str = "swiglu"
    vocab_pad_multiple: int = 256
    remat: str = "full"               # "none" | "full"
    optimizer: str = "adamw"
    fsdp: bool = False
    skip_shapes: tuple[str, ...] = ()  # e.g. ("long_500k",) for full-attn

    def __post_init__(self):
        if not self.layer_pattern:
            object.__setattr__(
                self, "layer_pattern", tuple(LayerSpec() for _ in range(self.n_layers))
            )
        assert len(self.layer_pattern) == self.n_layers

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def padded_heads(self) -> int:
        """Query heads padded to a model-axis-shardable multiple; dummy head
        outputs are masked, so the function computed is the true-head model.
        Must stay a multiple of n_kv_heads for the flat-head KV expand."""
        m = self.head_pad_multiple
        hp = -(-self.n_heads // m) * m
        while hp % max(self.n_kv_heads, 1):
            hp += m
        return hp

    @property
    def padded_experts(self) -> int:
        m = self.expert_pad_multiple
        return -(-self.n_experts // m) * m if self.n_experts else 0

    @property
    def d_inner(self) -> int:          # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def group_size(self) -> int:       # GQA group
        return self.n_heads // max(self.n_kv_heads, 1)

    def runnable_shapes(self) -> list[str]:
        return [s for s in SHAPES if s not in self.skip_shapes]

    # --- parameter count (for MODEL_FLOPS = 6 N D) ----------------------
    def param_count(self, active_only: bool = False) -> int:
        n = 0
        emb = self.padded_vocab * self.d_model
        if self.frontend != "embeds":
            n += emb                      # token embedding
        n += emb                          # lm head
        if self.frontend == "tokens+vision":
            n += self.d_vision * self.d_model
        for spec in self.layer_pattern:
            if spec.kind == "mamba":
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                n += self.d_model * (2 * di + 2 * N + H)   # in_proj(x,z,B,C,dt)
                n += self.ssm_conv * (di + 2 * N)          # depthwise conv
                n += H + H                                  # A_log, D skip
                n += di * self.d_model                      # out_proj
            elif self.use_mla:
                qd = self.qk_nope_dim + self.qk_rope_dim
                n += self.d_model * self.q_lora_rank
                n += self.q_lora_rank * self.n_heads * qd
                n += self.d_model * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim
                )
                n += self.n_heads * self.v_head_dim * self.d_model
            else:
                n += self.d_model * self.n_heads * self.d_head      # q
                n += 2 * self.d_model * self.n_kv_heads * self.d_head  # k,v
                n += self.n_heads * self.d_head * self.d_model      # o
            # mlp
            if spec.kind != "mamba" or True:
                if spec.moe:
                    k = self.top_k if active_only else self.n_experts
                    n += k * 3 * self.d_model * self.d_expert
                    n += self.d_model * self.n_experts    # router
                else:
                    n += 3 * self.d_model * self.d_ff
            n += 2 * self.d_model                          # norms
        return n


# ---------------------------------------------------------------------------
# input_specs: meta-device stand-ins for the inputs
# ---------------------------------------------------------------------------
def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def input_specs(cfg: ModelConfig, shape: "str | ShapeCell") -> dict[str, torch.Tensor]:
    """Model inputs for one (arch x shape) cell (a name of ``SHAPES`` or a
    ``ShapeCell``), as ``meta`` tensors: the shapes and dtypes of the real
    inputs, no allocation."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    f = torch_dtype(cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        if cfg.frontend == "embeds":       # audio backbone: frame embeddings
            specs = {"embeds": meta((B, S, cfg.d_model), f), "labels": meta((B, S), i32)}
        else:
            specs = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
        if cfg.frontend == "tokens+vision":
            specs["vision_embeds"] = meta((B, cfg.n_image_tokens, cfg.d_vision), f)
        return specs

    # decode: one new token (the cache's specs come from models.cache_specs)
    return {"token": meta((B,), i32)}


def batch_sample(cfg: ModelConfig, shape: str, generator: torch.Generator) -> dict:
    """Materialized random batch (small shapes only), on the generator's
    device: token ids uniform over the vocab, embeddings N(0, 0.02^2)."""
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype.is_floating_point:
            out[name] = (torch.randn(s.shape, generator=generator, device=generator.device)
                         * 0.02).to(s.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, s.shape, generator=generator,
                                      device=generator.device, dtype=s.dtype)
    return out
