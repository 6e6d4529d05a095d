"""Per-leaf checkpoints with an async writer: counterpart of ``repro.checkpoint``."""
from .checkpoint import latest_step, load_checkpoint, save_checkpoint, step_dir

__all__ = ["latest_step", "load_checkpoint", "save_checkpoint", "step_dir"]
