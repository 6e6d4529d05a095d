"""Trainer loop: checkpoints, restart, preemption and straggler detection.

Counterpart of ``repro/train/trainer.py``:

* periodic async checkpoints (one file a leaf, atomic rename), keeping the
  last ``keep_last``;
* restart from the latest checkpoint when the trainer is built (crash and
  preemption recovery);
* a preemption hook (a SIGTERM-style flag) that ends ``fit`` with a
  blocking save;
* straggler detection: a z-score of each step's wall time against an
  exponentially weighted mean and variance, reported to a callback.

Each step ends with a device synchronise before its clock stops, so the
z-score reads the step's time on the card, not its launch time.

On a mesh (``mesh=``, ``rules=``; every rank builds the same Trainer) the
state is placed by ``place_train_state``, each step runs under
``use_rules(rules)`` with gradients at their parameters' shardings, and a
batch that is not yet a DTensor is the global batch, the same on every
rank, placed by ``batch_pspecs``. A save gathers every leaf and rank 0
writes it; ``restore`` places each leaf at the state's sharding, which is
the elastic restore when the checkpoint came from another mesh.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (latest_step, load_checkpoint, save_checkpoint,
                                               step_dir)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.falkon import resolve_device
from repro_torch.distributed.compression import _tree_map
from repro_torch.distributed.mesh import NamedSharding, placements_for, use_rules
from repro_torch.optim.optimizers import is_param
from .steps import (TrainConfig, TrainState, batch_pspecs, init_train_state, make_train_step,
                    param_shardings, place_train_state, state_shardings, state_tree)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    async_ckpt: bool = True
    keep_last: int = 2
    straggler_zscore: float = 3.0
    straggler_warmup: int = 5


class Trainer:
    """Train ``cfg`` under ``tcfg``, checkpointing per ``rcfg``. Without
    ``state`` the model is drawn from seed 0 on ``device`` (the card unless
    the caller asks for the CPU) and the latest checkpoint under
    ``rcfg.ckpt_dir``, if any, is restored into it. With ``mesh`` and
    ``rules`` (an ``AxisRules`` on that mesh) the state, given or drawn,
    is placed on the mesh."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, rcfg: TrainerConfig, *,
                 mesh=None, rules=None, state: TrainState | None = None,
                 straggler_cb: Callable[[int, float, float], None] | None = None,
                 device: str | torch.device = "cuda"):
        if (mesh is None) != (rules is None) or (rules is not None and rules.mesh is not mesh):
            raise ValueError("Trainer: give mesh and rules together, rules on that mesh")
        self.cfg, self.tcfg, self.rcfg = cfg, tcfg, rcfg
        self.mesh, self.rules = mesh, rules
        self.straggler_cb = straggler_cb
        self.straggler_events: list[tuple[int, float]] = []
        self.step_seconds: list[float] = []      # each fitted step's synchronised time
        self._pending_save = None
        self.preempted = False

        fresh = state is None
        if fresh:
            dev = resolve_device(device)
            state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, tcfg)
        if mesh is not None:
            state = place_train_state(state, cfg, tcfg, rules)
            step_fn = make_train_step(cfg, tcfg, param_shardings(state.params, cfg))

            def wrapped(st, batch):     # refers to no Trainer: no cycle to hold a state
                with use_rules(rules):
                    return step_fn(st, batch)
            self.step_fn = wrapped
        else:
            self.step_fn = make_train_step(cfg, tcfg)
        self.state = state
        self.device = self.state.step.device
        if fresh and (last := latest_step(rcfg.ckpt_dir)) is not None:
            self.restore(last)

    # -- fault tolerance --------------------------------------------------
    def save(self, blocking: bool | None = None):
        step = int(self.state.step)
        path = step_dir(self.rcfg.ckpt_dir, step)
        os.makedirs(self.rcfg.ckpt_dir, exist_ok=True)
        blocking = (not self.rcfg.async_ckpt) if blocking is None else blocking
        self._wait_save()
        self._pending_save = save_checkpoint(path, state_tree(self.state, self.cfg), step,
                                             blocking=blocking)
        self._gc()

    def _wait_save(self):
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None
        if self.mesh is not None:     # rank 0 writes; the others wait for it
            torch.distributed.barrier()

    def _gc(self):
        root = self.rcfg.ckpt_dir
        if not os.path.isdir(root):
            return
        steps = sorted(int(d.split("_")[-1]) for d in os.listdir(root)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.rcfg.keep_last]:
            shutil.rmtree(step_dir(root, s), ignore_errors=True)

    def restore(self, step: int | None = None, shardings=None):
        """Load a checkpoint (the latest without ``step``) into the state's
        tensors, in place, each leaf at ``shardings`` (default: the state's
        own). Returns the step."""
        self._wait_save()
        step = step if step is not None else latest_step(self.rcfg.ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore under {self.rcfg.ckpt_dir}")
        like = state_tree(self.state, self.cfg)
        if shardings is None and self.mesh is not None:
            shardings = state_shardings(self.state, self.cfg)
        loaded, _ = load_checkpoint(step_dir(self.rcfg.ckpt_dir, step), like,
                                    shardings=shardings)
        with torch.no_grad():
            _tree_map(lambda dst, src: dst.copy_(src), like, loaded, is_leaf=is_param)
        return step

    def request_preemption(self):
        """SIGTERM handler target: finish the current step, save, stop."""
        self.preempted = True

    # -- loop --------------------------------------------------------------
    def _place(self, batch: dict) -> dict:
        """The batch's arrays as tensors on the state's device; on a mesh, a
        plain array (the global batch) placed by ``batch_pspecs``."""
        from torch.distributed.tensor import DTensor
        out = {k: v if isinstance(v, DTensor) else torch.as_tensor(v).to(self.device)
               for k, v in batch.items()}
        if self.mesh is not None:
            plain = {k: v for k, v in out.items() if not isinstance(v, DTensor)}
            for k, spec in batch_pspecs(self.cfg, plain, self.rules).items():
                out[k] = NamedSharding(self.mesh, placements_for(self.mesh, spec),
                                       spec).place(plain[k])
        return out

    def fit(self, data: Iterator[dict], steps: int) -> list[dict]:
        history = []
        ewma_t, ewma_v = None, 0.0
        for i, batch in enumerate(data):
            if i >= steps or self.preempted:
                break
            batch = self._place({k: v for k, v in batch.items() if k != "step"})
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.step_seconds.append(dt)

            # straggler detection (per-step latency z-score)
            if i >= self.rcfg.straggler_warmup and ewma_t is not None:
                sd = max(np.sqrt(ewma_v), 1e-6)
                z = (dt - ewma_t) / sd
                if z > self.rcfg.straggler_zscore:
                    self.straggler_events.append((i, dt))
                    if self.straggler_cb:
                        self.straggler_cb(i, dt, z)
            ewma_t = dt if ewma_t is None else 0.9 * ewma_t + 0.1 * dt
            ewma_v = 0.9 * ewma_v + 0.1 * (dt - ewma_t) ** 2

            history.append({k: float(v) for k, v in metrics.items()})
            step = int(self.state.step)
            if self.rcfg.ckpt_every and step % self.rcfg.ckpt_every == 0:
                self.save()
        if self.preempted:
            self.save(blocking=True)    # preemption-safe final save
        self._wait_save()
        return history
