"""Synthetic kernel-regression / classification datasets.

Counterpart of the kernel-task part of ``repro/data/synthetic.py``: the same
tasks and the same recipe — X ~ N(0, I_d), and a ground truth that is a
random Fourier feature mixture (an RKHS member for the Gaussian kernel) —
drawn from an explicit ``torch.Generator``, on the generator's device. The
distribution is the reference's; the numbers are not (``jax.random`` and
torch draw different streams from one seed).
"""
from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class KernelTask:
    name: str
    n: int
    d: int
    task: str            # "regression" | "binary" | "multiclass"
    n_classes: int = 1
    noise: float = 0.1
    # paper-matched hyperparameters (Sect. 5)
    sigma: float = 5.0
    lam: float = 1e-6
    num_centers: int = 1024


# Scaled-down analogues of the paper's experiments, as in the JAX package
# (a caller passes ``n`` for a full-size run: SUSY has 4e6 training rows).
PAPER_TASKS = {
    "millionsongs": KernelTask("millionsongs", n=40_000, d=90,
                               task="regression", sigma=6.0, lam=1e-6,
                               num_centers=1_000),
    "yelp":         KernelTask("yelp", n=30_000, d=512, task="regression",
                               sigma=0.0, lam=1e-6, num_centers=1_000),
    "timit":        KernelTask("timit", n=20_000, d=120, task="multiclass",
                               n_classes=10, sigma=15.0, lam=1e-9,
                               num_centers=1_500),
    "susy":         KernelTask("susy", n=50_000, d=18, task="binary",
                               sigma=4.0, lam=1e-6, num_centers=1_000),
    "higgs":        KernelTask("higgs", n=40_000, d=28, task="binary",
                               sigma=5.0, lam=1e-8, num_centers=1_500),
    "imagenet":     KernelTask("imagenet", n=15_000, d=256, task="multiclass",
                               n_classes=20, sigma=19.0, lam=1e-9,
                               num_centers=1_500),
}


def make_kernel_dataset(generator: torch.Generator, task: KernelTask,
                        n: int | None = None, *,
                        fn_generator: torch.Generator | None = None,
                        return_clean: bool = False):
    """X ~ N(0, I_d); f* = random Fourier feature mixture, float32.

    ``fn_generator`` draws the ground-truth function (W, b, w) apart from the
    sample, so train and test sets share one f*; ``return_clean``
    additionally returns noiseless regression targets. Binary labels are
    +-1; multiclass labels are int64 class indices.
    """
    n = n or task.n
    g = generator
    fg = fn_generator if fn_generator is not None else generator
    dev = g.device
    n_feat = 64
    sigma = task.sigma if task.sigma > 0 else math.sqrt(task.d)
    X = torch.randn(n, task.d, generator=g, device=dev)
    W = torch.randn(task.d, n_feat, generator=fg, device=dev) / sigma
    # the phases belong to f* too (the JAX recipe draws them from the sample
    # key, so its train and test sets differ in f* by their phases)
    b = torch.rand(n_feat, generator=fg, device=dev) * (2 * math.pi)
    phi = torch.cos(X @ W + b) * math.sqrt(2.0 / n_feat)

    if task.task == "regression":
        w = torch.randn(n_feat, generator=fg, device=dev)
        clean = phi @ w
        y = clean + task.noise * torch.randn(n, generator=g, device=dev)
        if task.name == "millionsongs":
            y, clean = y + 10.0, clean + 10.0   # positive (year-like) targets
        return (X, y, clean) if return_clean else (X, y)
    if task.task == "binary":
        w = torch.randn(n_feat, generator=fg, device=dev)
        margin = phi @ w
        flip = torch.rand(n, generator=g, device=dev) < task.noise
        y = torch.where(torch.logical_xor(margin > 0, flip), 1.0, -1.0)
        return X, y
    W2 = torch.randn(n_feat, task.n_classes, generator=fg, device=dev)
    logits = phi @ W2 / task.noise
    y = torch.multinomial(torch.softmax(logits, dim=1), 1, generator=g)[:, 0]
    return X, y
