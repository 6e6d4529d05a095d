"""The cells' synthetic rows, made from the seed on the seed's device.

A frozen copy of the port's ``make_kernel_dataset`` recipe (X ~ N(0, I_d);
the target a random Fourier feature mixture, an RKHS member of the
Gaussian kernel): both the program and the reference are handed the rows
this module makes. Train and test rows share one target function, drawn by
its own generator.
"""
from __future__ import annotations

import math

import torch

#: random Fourier features in the target function
N_FEATURES = 64


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


def make_rows(gen: torch.Generator, fn_gen: torch.Generator, n: int, cfg: dict):
    """``n`` rows and targets of the configuration's task ("binary": +-1
    labels with a share ``noise`` flipped; "regression": the target plus
    Gaussian noise of scale ``noise`` and ``target_offset``)."""
    dev = gen.device
    d = cfg["d"]
    X = torch.randn(n, d, generator=gen, device=dev)
    W = torch.randn(d, N_FEATURES, generator=fn_gen, device=dev) / cfg["sigma"]
    b = torch.rand(N_FEATURES, generator=fn_gen, device=dev) * (2 * math.pi)
    phi = torch.cos(X @ W + b) * math.sqrt(2.0 / N_FEATURES)
    w = torch.randn(N_FEATURES, generator=fn_gen, device=dev)
    f = phi @ w
    if cfg["task"] == "binary":
        flip = torch.rand(n, generator=gen, device=dev) < cfg["noise"]
        y = torch.where(torch.logical_xor(f > 0, flip), 1.0, -1.0)
    elif cfg["task"] == "regression":
        y = f + cfg["noise"] * torch.randn(n, generator=gen, device=dev)
        y = y + cfg.get("target_offset", 0.0)
    else:
        raise ValueError(f"unknown task {cfg['task']!r}")
    return X.contiguous(), y.contiguous()


def make_split(seed: int, cfg: dict, device):
    """The configuration's train and test rows from ``seed``: (X, y, Xt, yt)."""
    gen = _generator(seed, device)
    X, y = make_rows(gen, _generator(seed + 1, device), cfg["n"], cfg)
    Xt, yt = make_rows(gen, _generator(seed + 1, device), cfg["n_test"], cfg)
    return X, y, Xt, yt


def center_indices(center_seed: int, n: int, M: int, device) -> torch.Tensor:
    """The documented uniform rule (paper Alg. 1): M distinct rows of n,
    the first M of a random permutation drawn by a generator on the rows'
    device seeded with ``center_seed``."""
    gen = _generator(center_seed, device)
    return torch.randperm(n, generator=gen, device=device)[:M]


def predict_inputs(seed: int, cfg: dict, mix: dict, device):
    """The scoring cell's inputs: ``distinct_batches`` batches of
    ``batch_rows`` rows, M centers drawn from further rows, and alpha,
    all from ``seed``."""
    gen = _generator(seed, device)
    rows = mix["batch_rows"] * mix["distinct_batches"]
    X = torch.randn(rows, cfg["d"], generator=gen, device=device)
    C = torch.randn(cfg["num_centers"], cfg["d"], generator=gen, device=device)
    alpha = torch.randn(cfg["num_centers"], generator=gen, device=device)
    return X.reshape(mix["distinct_batches"], mix["batch_rows"], cfg["d"]), C, alpha
