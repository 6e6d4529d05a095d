"""FALKON in PyTorch with hand-written CUDA kernels for the NVIDIA H100.

The port of the JAX package ``repro`` (which stays the reference). Module
names follow ``repro``'s, so each module's counterpart is easy to find:

* ``repro_torch.core``    — kernels, CG, preconditioner, Nystrom, the fit,
  the lam path and the baselines;
* ``repro_torch.ops``     — the ``KernelOps`` registry: ``"torch"`` (plain
  reference) and ``"cuda"`` (the hand-written kernels);
* ``repro_torch.kernels`` — the CUDA kernels' wrappers, their plain twins,
  the dense oracles and the build;
* ``repro_torch.data``    — chunk sources and loaders, synthetic datasets
  and the LM token stream;
* ``repro_torch.configs``, ``repro_torch.models`` — the ten LM
  architectures' configs and models (forward, loss, prefill, decode);
* ``repro_torch.optim``, ``repro_torch.checkpoint``, ``repro_torch.train``
  — LM training: the optimizers and schedule, per-leaf checkpoints, the
  train step and the ``Trainer``;
* ``repro_torch.serve``, ``repro_torch.launch`` — the coalescing predict
  server, the serving and training launchers and the mesh helper;
* ``repro_torch.convert`` — state carried across from ``repro`` as numpy.

Importing the package compiles nothing: the kernels build at first launch.
"""
from repro_torch.core import (
    FalkonConfig,
    FalkonEstimator,
    FalkonPathResult,
    FalkonState,
    falkon_fit,
    falkon_fit_path,
    falkon_solve,
    falkon_solve_path,
    make_kernel,
)

__all__ = ["FalkonConfig", "FalkonEstimator", "FalkonPathResult", "FalkonState",
           "falkon_fit", "falkon_fit_path", "falkon_solve", "falkon_solve_path",
           "make_kernel"]
