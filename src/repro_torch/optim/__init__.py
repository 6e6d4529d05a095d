"""Optimizers and schedules: counterpart of ``repro.optim``."""
from .optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgdm,
    tree_leaves,
    warmup_cosine,
)

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm", "global_norm",
           "make_optimizer", "sgdm", "tree_leaves", "warmup_cosine"]
