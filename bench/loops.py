"""What the traffic kinds share. A mix's ``"kind"`` names the code that
drives it, ``kinds/<kind>.py`` (found by name, as metrics are), whose
``Loop`` class has four phases:

- ``setup(warm)`` makes the rows from the seed on the device and warms up
  every shape the window uses;
- ``window(seconds)`` runs the program back to back for ``seconds`` (the
  call running when they expire finishes and counts; the window closes at
  its end) and keeps, drawn from the seed, the answers the check reads;
- ``check()`` runs once the window has closed and the program's state is
  freed: the plain reference recomputes the kept answers and returns each
  compared number;
- ``control()`` puts the control's answers (the plain reference in float32
  with TF32 products) where ``window`` keeps the program's.
"""
from __future__ import annotations

import dataclasses
import time

import torch

#: keys of a configuration file that describe it and are not run
ABOUT = frozenset({"name", "source", "deployment", "reduced", "assumed"})
#: keys that size and shape the synthetic rows (``reference/data.py``)
DATA = frozenset({"task", "n", "n_test", "d", "data", "noise", "target_offset"})
#: FalkonConfig fields the harness sets itself
HARNESS = frozenset({"kernel_params", "ops_impl", "device", "mesh", "data_axes"})
#: the only choices the plain reference follows
HELD = {"kernel": "gaussian", "center_selection": "uniform"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def falkon_config(cfg: dict, ops_impl: str, device: torch.device):
    """The FalkonConfig of every key the configuration states: its rows'
    and its descriptive keys aside, ``sigma`` the Gaussian kernel's, each
    other key a FalkonConfig field. An unknown key is refused, not
    dropped."""
    from repro_torch.core import FalkonConfig
    fields = {f.name for f in dataclasses.fields(FalkonConfig)} - HARNESS
    run = {k: v for k, v in cfg.items() if k not in ABOUT | DATA | {"sigma"}}
    unknown = sorted(set(run) - fields)
    if unknown:
        raise ValueError(f"configuration keys {unknown} are not FalkonConfig fields "
                         f"{sorted(fields)}, nor the rows' {sorted(DATA)}, nor {sorted(ABOUT)}")
    if any(run.get(k, v) != v for k, v in HELD.items()):
        raise ValueError(f"the benchmark's reference follows {HELD} only")
    return FalkonConfig(kernel_params=(("sigma", cfg["sigma"]),), ops_impl=ops_impl,
                        device=str(device), **run)


def closed_loop(mix: dict) -> None:
    """The one arrival pattern the kinds build so far: one caller, closed loop."""
    if mix.get("loop") != "closed" or mix.get("callers") != 1:
        raise ValueError(f"traffic {mix}: only a closed loop of one caller is built")


def center_seed(seed: int, i: int) -> int:
    """The generator seed of the i-th fit's centers (i < 0: the warm-up)."""
    return (int(seed) * 4096 + 2 + i) % 2**63


class KeepOps:
    """Pure delegation that keeps the inputs and the output of the sweep
    calls whose numbers (in call order) are in ``keep``, for the check."""

    def __init__(self, ops, keep: set[int]):
        self.ops, self.keep, self.calls, self.kept = ops, keep, 0, []

    def __getattr__(self, name):
        if name == "ops":
            raise AttributeError(name)
        return getattr(self.ops, name)

    def sweep(self, X, C, u, v=None, row_mask=None):
        w = self.ops.sweep(X, C, u, v, row_mask)
        if self.calls in self.keep:
            self.kept.append((u, v, w))
        self.calls += 1
        return w


class Clock:
    """Seconds of each phase of a check, synchronised."""

    def __init__(self, device):
        self.device, self.seconds, self.t = device, {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
