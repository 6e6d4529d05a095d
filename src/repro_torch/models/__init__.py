"""Model zoo for the assigned architectures (see repro_torch.configs):
counterpart of ``repro.models``, with ``nn.Module`` layers."""
from .model import (
    Block,
    Model,
    cache_pspecs,
    cache_specs,
    decode_step,
    forward,
    init_cache,
    loss_fn,
    model_param_pspecs,
    model_param_structs,
    model_params,
    prefill,
    split_periods,
)

__all__ = ["Block", "Model", "cache_pspecs", "cache_specs", "decode_step", "forward",
           "init_cache", "loss_fn", "model_param_pspecs", "model_param_structs",
           "model_params", "prefill", "split_periods"]
