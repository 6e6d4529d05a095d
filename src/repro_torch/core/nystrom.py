"""Nystrom center selection (paper Appendix A).

Counterpart of the uniform part of ``repro/core/nystrom.py``: a uniformly
random subset of M training points (Alg. 1 setting), D = I. The indices come
from ``torch.randperm`` on an explicit ``torch.Generator``; they cannot match
``jax.random`` draws, so parity tests hand the reference's centers over.
Approximate-leverage-score sampling is ROADMAP item A6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class NystromCenters(NamedTuple):
    centers: Tensor       # (M, d)
    indices: Tensor       # (M,) indices into X
    D: Tensor | None      # (M,) Def. 2 diagonal; None for uniform sampling


def uniform_centers(generator: torch.Generator, X: Tensor, M: int) -> NystromCenters:
    """M distinct rows of X, uniformly at random (without replacement)."""
    n = X.shape[0]
    perm = torch.randperm(n, generator=generator, device=generator.device)
    idx = perm[:M].to(X.device)
    return NystromCenters(centers=X[idx], indices=idx, D=None)


def select_centers(generator: torch.Generator, X: Tensor, M: int, *,
                   scheme: str = "uniform") -> NystromCenters:
    if scheme == "uniform":
        return uniform_centers(generator, X, M)
    if scheme == "leverage":
        raise NotImplementedError(
            "leverage-score center selection is not ported yet: ROADMAP.md item A6")
    raise ValueError(f"unknown center-selection scheme {scheme!r}")
