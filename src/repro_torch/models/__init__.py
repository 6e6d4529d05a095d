"""Model zoo for the assigned architectures (see repro_torch.configs):
counterpart of ``repro.models``, with ``nn.Module`` layers."""
from .params import LeafGroup, place_module
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
    param_tree,
    prefill,
    split_periods,
    stacked_model_pd,
)

__all__ = ["Block", "LeafGroup", "Model", "cache_pspecs", "cache_specs", "decode_step",
           "forward", "init_cache", "loss_fn", "model_param_pspecs", "model_param_structs",
           "model_params", "param_tree", "place_module", "prefill", "split_periods",
           "stacked_model_pd"]
