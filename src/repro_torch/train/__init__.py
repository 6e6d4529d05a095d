"""LM training: the train step, its state and the Trainer loop, counterpart
of ``repro.train``."""
from .steps import (
    TrainConfig,
    TrainState,
    batch_pspecs,
    init_train_state,
    make_serve_step,
    make_train_step,
    state_tree,
    train_state_pspecs,
    train_state_structs,
)
from .trainer import Trainer, TrainerConfig

__all__ = ["TrainConfig", "TrainState", "Trainer", "TrainerConfig", "batch_pspecs",
           "init_train_state", "make_serve_step", "make_train_step", "state_tree",
           "train_state_pspecs", "train_state_structs"]
